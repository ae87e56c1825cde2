"""The port's hot path (`repro_torch.core.hotpath.FusedHotPath` on the
megakernel backend, the decision kernel's plain version on the CPU)
against the JAX reference's (`repro.core.hotpath`, its default "fused"
backend): one runner a cell across sims, the dead-roster refusal, and
the hot path at `hyperfleet_10k`'s roster bucket (10,000 instances, I =
16,384: the delta lanes' capacity of 8,192 and the 16,384-row sketch
staging of the affinity term).

The port takes the reference's ingest embeddings and a bundle bridged
from its weights; choices must be identical, `l_chosen` within rtol
1e-5 as the kernel tests hold it (at the 16,384 bucket against the
reference's IEEE float32 spelling, its staged numpy backend: see that
test).
"""
import numpy as np
import pytest

import repro_torch.core as P
from torch_scenario_parity import port_bundle


@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    return dict(bundle=port_bundle(small_ctx["bundle"], small_ctx["tiers"],
                                   small_ctx["names"]),
                ds=build_dataset(world, n=400), tiers=paper_pool_tiers(),
                names=names)


def test_fused_runner_cached_across_sims(small_ctx, port):
    """Repeated cells over one bundle, roster and config each build their
    own runner (the reference caches one on the bundle; the port, which
    compiles nothing per shape, keeps none) and repeat the trajectory,
    which is the reference's."""
    from repro.core import RBConfig, RouteBalance, make_requests, run_cell
    from repro.serving.workload import poisson_arrivals as r_arrivals
    from repro_torch.serving.workload import poisson_arrivals
    rreqs = make_requests(small_ctx["ds"], "test", r_arrivals(10.0, 30,
                                                              seed=4))
    run_cell(RouteBalance(RBConfig(decision_backend="fused",
                                   charge_compute=False),
                          small_ctx["bundle"], small_ctx["tiers"]),
             small_ctx["tiers"], small_ctx["names"], rreqs)
    out = []
    for _ in range(2):
        reqs = P.make_requests(port["ds"], "test",
                               poisson_arrivals(10.0, 30, seed=4))
        reqs[0].cols.emb = rreqs[0].cols.emb
        rb = P.RouteBalance(P.RBConfig(charge_compute=False),
                            port["bundle"], port["tiers"])
        P.run_cell(rb, port["tiers"], port["names"], reqs)
        out.append((rb._fused, [r.instance for r in reqs]))
    assert out[0][0] is not out[1][0]       # a runner a cell
    assert out[0][1] == out[1][1] == [r.instance for r in rreqs]
    assert out[1][0].stats["calls"] == len(rb.compute_log)   # this cell's


def test_fused_raises_on_dead_roster(small_ctx, port):
    """A decision over a roster with no alive instance raises in both
    packages, before any kernel call."""
    from repro.core import RBConfig, RouteBalance, make_requests
    from repro.serving.cluster import ClusterSim as RSim
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.serving.cluster import ClusterSim
    calls = mk.decision_megakernel.plain_calls
    for rb, Sim, make, ds in (
            (RouteBalance(RBConfig(decision_backend="fused"),
                          small_ctx["bundle"], small_ctx["tiers"]), RSim,
             make_requests, small_ctx["ds"]),
            (P.RouteBalance(P.RBConfig(), port["bundle"], port["tiers"]),
             ClusterSim, P.make_requests, port["ds"])):
        rb.sim = Sim(rb.tiers, small_ctx["names"], seed=0)
        for inst in rb.sim.instances:
            inst.fail()
        with pytest.raises(RuntimeError, match="no alive instances"):
            rb._decide_core(make(ds, "test", np.zeros(4)))
    assert mk.decision_megakernel.plain_calls == calls


@pytest.fixture(scope="module")
def fleet():
    """`hyperfleet_10k`'s roster (16 tiers, 10,000 instances) in both
    packages with a small dataset: the reference's bundle and the
    port's bridged from it."""
    from repro.core import EstimatorBundle
    from repro.serving.scenarios import synthetic_pool as r_pool
    from repro.serving.world import build_dataset as r_build
    from repro_torch.serving.scenarios import synthetic_pool
    from repro_torch.serving.world import build_dataset
    r_tiers, r_names, r_world = r_pool(16, 10000, seed=7)
    tiers, names, world = synthetic_pool(16, 10000, seed=7)
    r_ds = r_build(r_world, n=150, seed=3)
    r_bundle = EstimatorBundle.train(r_ds, r_tiers, r_names)
    return dict(r_tiers=r_tiers, r_names=r_names, r_ds=r_ds,
                r_bundle=r_bundle, tiers=tiers, names=names,
                ds=build_dataset(world, n=150, seed=3),
                bundle=port_bundle(r_bundle, r_tiers, r_names))


@pytest.mark.parametrize("w_aff", [0.0, 0.5], ids=["plain", "affinity"])
def test_hot_path_at_the_16384_bucket_matches_reference(fleet, w_aff):
    """One controller's hot path over 10,000 instances: a full reseed,
    then a delta of 3,000 dirty rows (inside the 8,192 lanes), then a
    mostly dirty mirror (a reseed). Each batch's choices are the
    reference's IEEE float32 spelling of the decision (its staged numpy
    backend, reading the same telemetry and prefix sketches directly),
    and the mirror's reseed / delta counts its fused hot path's. (At
    this width the reference's XLA-compiled backends can leave that
    spelling: XLA on the CPU contracts Eq. 1's multiply-adds, and a
    one-ulp score can cross a quantization edge. The port, the card's
    kernel included, keeps IEEE rounding.)"""
    from repro.core import RBConfig, RouteBalance
    from repro.core import make_requests as r_make
    from repro.core.hotpath import FusedHotPath as RHot
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import randomize_prefix_state as r_prefix
    from repro.serving.scenarios import randomize_telemetry as r_rand
    from repro_torch.core.hotpath import FusedHotPath
    from repro_torch.serving.affinity import SKETCH_SLOTS
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import (randomize_prefix_state,
                                               randomize_telemetry)
    f = fleet
    rreqs = r_make(f["r_ds"], "test", np.zeros(48))
    preqs = P.make_requests(f["ds"], "test", np.zeros(48))
    rreqs[0].cols.ensure_embeddings(f["r_bundle"].encoder)
    preqs[0].cols.emb = np.asarray(rreqs[0].cols.emb)
    rsim = r_rand(RSim(f["r_tiers"], f["r_names"], seed=0), 3, 0.1)
    psim = randomize_telemetry(ClusterSim(f["tiers"], f["names"], seed=0),
                               3, 0.1)
    if w_aff:
        r_prefix(rsim, rreqs[0].cols, seed=3)
        randomize_prefix_state(psim, preqs[0].cols, seed=3)
    rfp = RHot(f["r_bundle"], rsim.instances,
               RBConfig(decision_backend="fused", affinity_weight=w_aff))
    ieee = RouteBalance(RBConfig(decision_backend="numpy",
                                 affinity_weight=w_aff), f["r_bundle"],
                        f["r_tiers"])
    ieee.sim = rsim
    fp = FusedHotPath(f["bundle"], psim.instances,
                      P.RBConfig(affinity_weight=w_aff))
    assert (fp._Itot, fp._Kcap) == (16384, 8192)
    if w_aff:
        assert tuple(fp._pstage[0].shape) == (16384, SKETCH_SLOTS)
    rng = np.random.default_rng(1)
    for step, (lo, hi, dirty) in enumerate(((0, 16, 0), (16, 29, 3000),
                                            (29, 48, 6000))):
        rows = rng.choice(10000, dirty, replace=False)
        for sim in (rsim, psim):
            for j, slot in enumerate(rows):
                sim.tel.write(int(slot), pending=float(j % 900), batch=3,
                              free=j % 4, ctx=float(64 + j % 800), queue=0,
                              t=1.0 + step)
        rfp.decide(rreqs[lo:hi], rsim.tel)
        _, choice, l_chosen = ieee._decide_core(rreqs[lo:hi])
        got = fp.decide(preqs[lo:hi], psim.tel)
        np.testing.assert_array_equal(
            got[0], np.flatnonzero(rsim.tel.alive)[choice])
        np.testing.assert_allclose(got[1], l_chosen, rtol=1e-5, atol=0)
    assert fp.stats["full_reseed"] == 2 and fp.stats["delta_sync"] == 1
    assert fp.stats["delta_rows"] == 3000
    for k in ("full_reseed", "delta_sync", "delta_rows"):
        assert fp.stats[k] == rfp.stats[k], k
