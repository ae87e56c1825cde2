"""The port's serving path end to end against the JAX reference.

`run_cell(RouteBalance(RBConfig(), bundle, tiers), ...)` on the port
(the decision kernel's plain version on the CPU, bundle bridged from the
reference's weights) against the reference's `RBConfig(decision_backend=
"fused")` — bitwise equal to its megakernel — on the `small_ctx` world
with `poisson_arrivals(10.0, 80, seed=s)`, `charge_compute=False`. Two
stages, so that a disagreement can be pinned to its stage: first with
the ingest embeddings taken from the reference's encoder, then with the
port's own encoder. The instance chosen for every request must be
identical, and every `aggregate` metric equal.
"""
import jax
import numpy as np
import pytest

import repro_torch.core as P
from repro_torch.estimators.bridge import bundle_from_arrays
from repro_torch.kernels import decision_megakernel as mk


@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    ref = small_ctx["bundle"]
    tiers = small_ctx["tiers"]
    heads = [{"name": t.name, "nominal_tpot": ref.heads[t.name].nominal_tpot,
              "packed": ref.heads[t.name].model.pack()} for t in tiers]
    bundle = bundle_from_arrays(
        jax.tree_util.tree_map(np.asarray, ref.encoder.params), ref.knn._x,
        ref.knn._quality, ref.knn._length, heads, small_ctx["names"],
        device="cpu")
    world, names = paper_world(seed=0)
    return dict(bundle=bundle, ds=build_dataset(world, n=400),
                tiers=paper_pool_tiers(), names=names)


def _reference_run(ctx, seed):
    from repro.core import RBConfig, RouteBalance, make_requests, run_cell
    from repro.serving.workload import poisson_arrivals
    reqs = make_requests(ctx["ds"], "test", poisson_arrivals(10.0, 80,
                                                             seed=seed))
    m = run_cell(RouteBalance(RBConfig(decision_backend="fused",
                                       charge_compute=False),
                              ctx["bundle"], ctx["tiers"]),
                 ctx["tiers"], ctx["names"], reqs)
    return reqs, m


def _port_run(port, seed, emb=None):
    from repro_torch.serving.workload import poisson_arrivals
    reqs = P.make_requests(port["ds"], "test",
                           poisson_arrivals(10.0, 80, seed=seed))
    if emb is not None:
        reqs[0].cols.emb = emb              # the reference's ingest rows
    rb = P.RouteBalance(P.RBConfig(charge_compute=False), port["bundle"],
                        port["tiers"])
    m = P.run_cell(rb, port["tiers"], port["names"], reqs)
    return reqs, m, rb


def _assert_same(ref, got):
    (rreqs, rm), (preqs, pm) = ref, got
    assert [r.instance for r in preqs] == [r.instance for r in rreqs]
    assert [r.pred_len for r in preqs] == pytest.approx(
        [r.pred_len for r in rreqs], rel=1e-5)
    skip = {"measured_decide_ms_mean", "measured_decide_ms_per_req"}
    for k, v in rm.items():
        if k in skip:
            continue
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(pm[k]), k
        else:
            assert pm[k] == v, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_serving_matches_reference(small_ctx, port, seed):
    ref = _reference_run(small_ctx, seed)
    emb = ref[0][0].cols.emb
    launches = mk.decision_megakernel.launches
    preqs, pm, rb = _port_run(port, seed, emb=emb)
    _assert_same(ref, (preqs, pm))                  # stage 1
    assert mk.decision_megakernel.launches == launches   # CPU: plain only
    assert rb._fused.stats["calls"] == len(rb.compute_log)
    preqs2, pm2, _ = _port_run(port, seed)
    np.testing.assert_allclose(preqs2[0].cols.emb, emb, rtol=1e-5, atol=1e-6)
    _assert_same(ref, (preqs2, pm2))                # stage 2


def test_delta_sync_equals_reseed(port):
    """The mirror refreshed by dirty-row deltas decides exactly like a
    freshly reseeded one, and roster churn adds no shape variant."""
    from repro_torch.core.hotpath import FusedHotPath
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.workload import poisson_arrivals
    reqs = P.make_requests(port["ds"], "test",
                           poisson_arrivals(10.0, 24, seed=4),
                           encoder=port["bundle"].encoder)
    sim = ClusterSim(port["tiers"], port["names"])
    cfg = P.RBConfig(weights=(0.8, 0.1, 0.1))
    hp = FusedHotPath(port["bundle"], sim.instances, cfg)
    hp.decide(reqs[:8], sim.tel)                       # full reseed
    rng = np.random.default_rng(0)
    for slot in (1, 5, 9):
        sim.tel.write(slot, pending=float(rng.uniform(0, 900)), batch=3,
                      free=5, ctx=float(rng.uniform(64, 900)), queue=0,
                      t=1.0)
    delta = hp.decide(reqs[8:16], sim.tel)
    assert hp.stats["delta_sync"] == 1 and hp.stats["delta_rows"] == 3
    fresh = FusedHotPath(port["bundle"], sim.instances, cfg)
    again = fresh.decide(reqs[8:16], sim.tel)
    for a, b in zip(delta, again):
        np.testing.assert_array_equal(a, b)
    sim.instances[0].fail()
    hp.decide(reqs[16:19], sim.tel)
    assert hp.stats["roster_reseed"] == 1 and hp.shape_variants() == 1


def test_unported_options_refuse():
    """The hierarchy's options are ported: `cell_tag` is accepted, and
    `shard_cells > 1` (a power of two) needs the staged torch backend,
    refused by name on any other; the reference's backend names name
    the port's counterpart; window coalescing is ported."""
    assert P.RBConfig(cell_tag=3).cell_tag == 3
    assert P.RBConfig(shard_cells=2, cell_tag=1,
                      decision_backend="torch").shard_cells == 2
    for backend in ("megakernel", "numpy"):
        with pytest.raises(ValueError, match="'torch'"):
            P.RBConfig(shard_cells=2, decision_backend=backend)
    with pytest.raises(ValueError, match="power of two"):
        P.RBConfig(shard_cells=3, decision_backend="torch")
    assert P.RBConfig(window_coalesce=2).window_coalesce == 2
    for kw, counterpart in ((dict(decision_backend="fused"), "megakernel"),
                            (dict(decision_backend="jax"), "torch"),
                            (dict(knn_backend="pallas"), "kernel"),
                            (dict(knn_backend="jax"), "torch")):
        with pytest.raises(ValueError, match=repr(counterpart)):
            P.RBConfig(**kw)
