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

Then the reference's `tests/test_serving.py` cases that exercise the
serving path and the simulator's edge cases (tier loss, bursty
arrivals, the zero-token clamp, the zero-length pending decode, failure
finish times, FIFO admission), each on both packages with the same
inputs and the same assertions, and the two results compared.
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
    """The hierarchy's options are ported: `shard_cells > 1` (a power of
    two) needs the staged torch backend, refused by name on any other;
    the reference's backend names name the port's counterpart."""
    assert P.RBConfig(shard_cells=2,
                      decision_backend="torch").shard_cells == 2
    for backend in ("megakernel", "numpy"):
        with pytest.raises(ValueError, match="'torch'"):
            P.RBConfig(shard_cells=2, decision_backend=backend)
    with pytest.raises(ValueError, match="power of two"):
        P.RBConfig(shard_cells=3, decision_backend="torch")
    for kw, counterpart in ((dict(decision_backend="fused"), "megakernel"),
                            (dict(decision_backend="jax"), "torch"),
                            (dict(knn_backend="pallas"), "kernel"),
                            (dict(knn_backend="jax"), "torch")):
        with pytest.raises(ValueError, match=repr(counterpart)):
            P.RBConfig(**kw)


# -- the reference's serving cases (`tests/test_serving.py`) on both -----------

def _pair_reqs(small_ctx, port, arrivals):
    """The same request stream in both packages (the port's holding the
    reference's ingest embeddings)."""
    from repro.core import make_requests
    rreqs = make_requests(small_ctx["ds"], "test", arrivals)
    preqs = P.make_requests(port["ds"], "test", arrivals)
    rreqs[0].cols.ensure_embeddings(small_ctx["bundle"].encoder)
    preqs[0].cols.emb = np.asarray(rreqs[0].cols.emb)
    return rreqs, preqs


def _cells(small_ctx, port, arrivals, rb_kw=None, **cell_kw):
    """One `run_cell` on each package's default backend (the reference's
    "fused", the port's megakernel), `charge_compute=False`."""
    from repro.core import RBConfig, RouteBalance, run_cell
    rb_kw = dict(rb_kw or {}, charge_compute=False)
    rreqs, preqs = _pair_reqs(small_ctx, port, arrivals)
    rm = run_cell(RouteBalance(RBConfig(**rb_kw), small_ctx["bundle"],
                               small_ctx["tiers"]),
                  small_ctx["tiers"], small_ctx["names"], rreqs, **cell_kw)
    pm = P.run_cell(P.RouteBalance(P.RBConfig(**rb_kw), port["bundle"],
                                   port["tiers"]),
                    port["tiers"], port["names"], preqs, **cell_kw)
    _assert_same((rreqs, rm), (preqs, pm))
    return preqs, pm


def test_tier_loss_graceful(small_ctx, port):
    """Every 72B instance killed at t = 0 on the quality preset: a
    capacity event, not an availability one (none fails, none lands on
    the 72B tier), as in the reference."""
    from repro.serving.workload import poisson_arrivals
    from repro_torch.core import PRESETS
    iids = [f"{t.name}#{j}" for t in port["tiers"] if "72b" in t.name
            for j in range(t.n_instances)]
    assert iids
    _, m = _cells(small_ctx, port, poisson_arrivals(10.0, 150, seed=0),
                  dict(weights=PRESETS["quality"]),
                  fail_at={"time": 0.0, "instances": iids})
    assert m["failed"] == 0
    assert not any("72b" in k for k in m["mix"])


@pytest.mark.parametrize("kind", ["gamma", "square"])
def test_nonstationary_arrivals_complete(small_ctx, port, kind):
    """Bursty and square-wave arrivals: every request served, the
    reference's choices."""
    from repro.serving.workload import make_arrivals
    _, m = _cells(small_ctx, port, make_arrivals(kind, 12.0, 100, seed=2))
    assert m["n"] == 100 and m["failed"] == 0


def _lone_pair(small_ctx, port, n, lam=10.0):
    """A one-tier, one-instance sim in each package and n requests each
    (`tests/test_serving.py::_lone_instance`)."""
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import synthetic_pool as r_pool
    from repro.serving.workload import poisson_arrivals
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import synthetic_pool
    rreqs, preqs = _pair_reqs(small_ctx, port,
                              poisson_arrivals(lam, n, seed=0))
    out = []
    for pool, Sim, reqs in ((r_pool, RSim, rreqs),
                            (synthetic_pool, ClusterSim, preqs)):
        tiers, names, _ = pool(1, 1, seed=0)
        sim = Sim(tiers, names, seed=0)
        out.append((sim, sim.instances[0], reqs))
    return out


def _lives(reqs):
    return [(r.tokens_out, r.finish_time, bool(r.failed),
             bool(r.exhausted)) for r in reqs]


def test_zero_token_clamp_is_not_unlimited(small_ctx, port):
    """max_tokens = 0 is a one-token clamp, not "unlimited"."""
    lives = []
    for sim, inst, reqs in _lone_pair(small_ctx, port, 1):
        r = reqs[0]
        r.true_length = np.full_like(r.true_length, 500.0)
        inst.submit(r, 0.0, pred_len=5.0, max_tokens=0)
        sim.run()
        assert r.tokens_out == 1 and r.exhausted and not r.failed
        assert r.finish_time is not None
        lives.append(_lives(reqs))
    assert lives[0] == lives[1]


def test_zero_pred_len_pending_decode_is_one(small_ctx, port):
    """pred_len = 0.0 counts as one pending decode token in the
    telemetry snapshot, not as the dispatch clamp."""
    snaps = []
    for sim, inst, reqs in _lone_pair(small_ctx, port, 1):
        r = reqs[0]
        r.true_length = np.full_like(r.true_length, 500.0)
        inst.submit(r, 0.0, pred_len=0.0, max_tokens=None)
        sim.run(until=0.0)                 # admit + 1 token
        assert len(inst.running) == 1
        assert inst.snapshot["pending_decode"] == 1.0
        snaps.append(dict(inst.snapshot))
    assert snaps[0] == snaps[1]


def test_fail_stamps_finish_time_on_queued_and_running(small_ctx, port):
    """`Instance.fail()` stamps the failure instant as every queued and
    running request's finish time, and `aggregate` counts them."""
    from repro.serving.metrics import aggregate as r_aggregate
    from repro_torch.serving.metrics import aggregate
    ms = []
    for (sim, inst, reqs), agg in zip(_lone_pair(small_ctx, port, 3, 50.0),
                                      (r_aggregate, aggregate)):
        inst.busy_until = 100.0            # pin admission: all three queue
        for r in reqs:
            inst.submit(r, r.arrival, pred_len=20.0, max_tokens=None)
        sim.push(2.5, lambda t, inst=inst: inst.fail())
        sim.run(until=3.0)
        assert all(r.failed and r.finish_time == 2.5 for r in reqs)
        m = agg(reqs, sim.tiers, sim.model_names, wall=None)
        assert m["failed"] == 3 and np.isfinite(m["throughput"])
        ms.append(m)
    from torch_scenario_parity import assert_metrics_equal
    assert_metrics_equal(*ms)


def test_admission_queue_is_fifo(small_ctx, port):
    """One decode slot: requests finish in submission order, each after
    its 4 tokens, at the reference's times."""
    import collections
    import dataclasses
    lives = []
    for sim, inst, reqs in _lone_pair(small_ctx, port, 4, 100.0):
        assert isinstance(inst.queue, collections.deque)
        inst.tier = dataclasses.replace(inst.tier, max_batch=1)
        for r in reqs:
            r.true_length = np.full_like(r.true_length, 4.0)
            inst.submit(r, r.arrival, pred_len=4.0, max_tokens=None)
        sim.run()
        finishes = [r.finish_time for r in reqs]
        assert all(f is not None for f in finishes)
        assert finishes == sorted(finishes)
        assert [r.tokens_out for r in reqs] == [4] * 4
        lives.append(_lives(reqs))
    assert lives[0] == lives[1]
