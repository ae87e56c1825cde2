"""The port's baseline policies and station deployments against the
reference's, mirroring `tests/test_engine_parity.py`.

Both packages serve the same seeded stream (`small_ctx`, the reference's
weights bridged into the port, the reference's ingest embeddings), with
routers fitted through `train_data` on the same bundle arrays, through
`ServingEngine` with the same policy: every router x dispatcher pair of
the registry on the windowed deployment (`charge_compute=False`, so no
wall clock enters the simulation), and the BEST-Route and Avengers-Pro
baselines under `serial_published`, `concurrent`, `microbatch` and a
bounded `queue_capacity`. Per-request trajectories (instance, model,
dispatch and finish times, tokens, failure, router queue wait), `failed`
counts and every `aggregate` metric must be identical. The BEST-Route
scorer is the port's torch KNN against the reference's jitted one, so
its quality estimates agree to float32 rounding only; the choices must
still be identical.
"""
import warnings

import jax
import numpy as np
import pytest

import repro_torch.core as P
from repro_torch.estimators.bridge import bundle_from_arrays
from repro_torch.kernels import knn_topk as K

ROUTER_KW = {"avengers": dict(p_w=0.8, n_clusters=16),
             "bestroute": dict(threshold=0.5),
             "passthrough": {}}
GRID = [f"{r}-{d}" for r in ("avengers", "bestroute", "passthrough")
        for d in ("rr", "sq", "random")]


def _bridge(small_ctx, backend="torch"):
    """The port's bundle from the reference's arrays, on the CPU."""
    ref = small_ctx["bundle"]
    heads = [{"name": t.name, "nominal_tpot": ref.heads[t.name].nominal_tpot,
              "packed": ref.heads[t.name].model.pack()}
             for t in small_ctx["tiers"]]
    return bundle_from_arrays(
        jax.tree_util.tree_map(np.asarray, ref.encoder.params), ref.knn._x,
        ref.knn._quality, ref.knn._length, heads, small_ctx["names"],
        device="cpu", backend=backend)


@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    return dict(bundle=_bridge(small_ctx), ds=build_dataset(world, n=400),
                tiers=paper_pool_tiers(), names=names)


def _kw(name, port_side):
    kw = dict(ROUTER_KW[name.rsplit("-", 1)[0]])
    if port_side and name.startswith("bestroute"):
        kw["device"] = "cpu"
    return kw


def _trajectory(reqs):
    return [(r.rid, r.instance, r.model_idx, r.dispatch_time,
             r.finish_time, r.tokens_out, bool(r.failed),
             round(r.router_queue_wait, 12)) for r in reqs]


def _run_pair(small_ctx, port, name, deployment, lam=16.0, n=80, seed=0,
              queue_capacity=None, serial_scoring_s=None, bundle=None):
    """The same seeded stream through the reference's engine and the
    port's (on `bundle`, default the bridged one); returns both
    (trajectory, metrics) and the port's engine."""
    import repro.core as R
    from repro.serving.workload import poisson_arrivals
    bundle = port["bundle"] if bundle is None else bundle
    cfg = dict(deployment=deployment, queue_capacity=queue_capacity,
               charge_compute=False)
    rreqs = R.make_requests(small_ctx["ds"], "test",
                            poisson_arrivals(lam, n, seed=seed))
    rpol = R.fit_policy(name, small_ctx["bundle"], small_ctx["tiers"],
                        small_ctx["names"], small_ctx["ds"],
                        **_kw(name, False))
    preqs = P.make_requests(port["ds"], "test",
                            poisson_arrivals(lam, n, seed=seed))
    ppol = P.fit_policy(name, bundle, port["tiers"], port["names"],
                        port["ds"], **_kw(name, True))
    if serial_scoring_s is not None:
        rpol.router.serial_scoring_s = serial_scoring_s
        ppol.router.serial_scoring_s = serial_scoring_s
    rm = R.run_cell(R.ServingEngine(rpol, small_ctx["bundle"],
                                    small_ctx["tiers"], R.EngineConfig(**cfg)),
                    small_ctx["tiers"], small_ctx["names"], rreqs, seed=0)
    preqs[0].cols.emb = rreqs[0].cols.emb      # the reference's ingest rows
    eng = P.ServingEngine(ppol, bundle, port["tiers"], P.EngineConfig(**cfg))
    pm = P.run_cell(eng, port["tiers"], port["names"], preqs, seed=0)
    return (_trajectory(rreqs), rm), (_trajectory(preqs), pm), eng


def _assert_same(ref, got):
    (rtraj, rm), (ptraj, pm) = ref, got
    assert ptraj == rtraj
    skip = {"measured_decide_ms_mean", "measured_decide_ms_per_req"}
    assert set(pm) == set(rm)
    for k, v in rm.items():
        if k in skip:
            continue
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(pm[k]), k
        else:
            assert pm[k] == v, k


@pytest.mark.parametrize("name", GRID)
def test_grid_windowed_matches_reference(small_ctx, port, name):
    knn = K.knn_topk.plain_calls
    ref, got, eng = _run_pair(small_ctx, port, name, "windowed")
    _assert_same(ref, got)
    assert got[1]["policy"] == ref[1]["policy"]
    assert got[1]["deployment"] == "windowed"
    assert K.knn_topk.plain_calls == knn         # the bundle's KNN: torch
    assert len(eng.compute_log) == eng.batches > 0


@pytest.mark.parametrize("deployment", ["serial_published", "concurrent",
                                        "microbatch"])
@pytest.mark.parametrize("name", ["bestroute-sq", "avengers-rr"])
def test_station_deployments_match_reference(small_ctx, port, name,
                                             deployment):
    ref, got, eng = _run_pair(small_ctx, port, name, deployment)
    _assert_same(ref, got)
    assert got[1]["deployment"] == deployment
    assert got[1]["residual_router_queue"] > 0.0
    assert len(eng.compute_log) == eng.batches > 0
    if deployment == "serial_published":        # one scoring call each
        assert eng.batches == eng.decisions == 80


@pytest.mark.slow
@pytest.mark.parametrize("deployment", ["serial_published", "microbatch",
                                        "concurrent"])
def test_station_deployments_full_grid(small_ctx, port, deployment):
    for name in GRID:
        ref, got, _ = _run_pair(small_ctx, port, name, deployment, lam=14.0,
                                n=120, seed=3)
        _assert_same(ref, got)


@pytest.mark.parametrize("name", ["bestroute-sq", "avengers-rr"])
def test_bounded_queue_drops_match_reference(small_ctx, port, name):
    """The vLLM-SR arm: an overloaded bounded queue drops exactly the
    same requests."""
    ref, got, _ = _run_pair(small_ctx, port, name, "serial_published",
                            lam=20.0, n=100, queue_capacity=8,
                            serial_scoring_s=0.5)
    _assert_same(ref, got)
    assert 0 < got[1]["failed"] < 100


def test_kernel_knn_feeds_the_baselines(small_ctx, port):
    """With the bundle's KNN on "kernel", a baseline makes one K2 call
    (its plain version here) per scored group and the same choices: the
    lengths only set each request's predicted length."""
    bundle = _bridge(small_ctx, backend="kernel")
    assert bundle.knn.backend == "kernel"
    plain = K.knn_topk.plain_calls
    ref, got, eng = _run_pair(small_ctx, port, "passthrough-sq",
                              "concurrent", bundle=bundle)
    assert K.knn_topk.plain_calls - plain == len(eng.compute_log) > 0
    assert got[1]["failed"] == 0
    assert [t[1] for t in got[0]] == [t[1] for t in ref[0]]


# -- registry and shim ---------------------------------------------------------

def test_policies_registry_covers_grid_and_routebalance():
    expect = set(GRID) | {"routebalance"}
    assert expect == set(P.POLICIES)
    rb = P.make_policy("routebalance", weights=(0.5, 0.3, 0.2),
                       decision_backend="numpy")
    assert isinstance(rb, P.RouteBalancePolicy)
    for name in GRID:
        p = P.make_policy(name, **_kw(name, True))
        assert isinstance(p, P.RouterDispatchPolicy), name
        assert isinstance(p, P.SchedulingPolicy)
        assert p.name.split("-")[-1] == name.split("-")[-1]
    with pytest.raises(KeyError, match="unknown policy"):
        P.make_policy("nope")


def test_register_policy_refuses_a_duplicate():
    from repro_torch.core.policies import POLICIES, register_policy
    with pytest.raises(ValueError, match="already registered"):
        register_policy("bestroute-sq", lambda **kw: None)
    name = "torch-test-passthrough"
    try:
        register_policy(name, POLICIES["passthrough-rr"])
        assert isinstance(P.make_policy(name), P.RouterDispatchPolicy)
    finally:
        POLICIES.pop(name, None)


def test_pipeline_shim_is_engine_and_warns(port):
    from repro_torch.core.dispatchers import RoundRobin
    from repro_torch.core.policies import train_data
    router = P.BestRouteRouter(threshold=0.5, device="cpu").fit(
        *train_data(port["bundle"], port["ds"], port["tiers"],
                    port["names"]))
    with pytest.warns(DeprecationWarning):
        sched = P.PipelineScheduler(router, RoundRobin(), port["bundle"],
                                    port["tiers"],
                                    P.PipelineConfig(deployment="serial"))
    assert isinstance(sched, P.ServingEngine)
    assert sched.ecfg.deployment == "serial_published"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="deployment"):
            P.ServingEngine(P.make_policy("passthrough-rr"), port["bundle"],
                            port["tiers"], P.EngineConfig(deployment="nope"))


def test_train_data_refuses_a_foreign_dataset(port):
    from repro_torch.core.policies import train_data
    from repro_torch.serving.world import build_dataset, paper_world
    other = build_dataset(paper_world(seed=0)[0], n=200)
    with pytest.raises(ValueError, match="train split"):
        train_data(port["bundle"], other, port["tiers"], port["names"])
