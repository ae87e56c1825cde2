"""The port's staged decision backends against the reference's, mirroring
`tests/test_decision_parity.py`.

Decision level, on random float32 inputs made with numpy from a seed:
the port's numpy loop `greedy_assign` is a copy, so its choices and
latencies are bitwise the reference's; its tensor core (`greedy_core`,
`decide_batch`, `decide`) must make choices identical to the reference's
numpy loop and jitted core across the four latency modes x budget
filter x LPT, with batch padding and `allowed` masks. The cost matrix
and the admission mask of `decide_batch` are equal to the jitted core's
to float32 rounding (rtol 1e-6: XLA may contract the cost's mul-add into
an FMA), the admission mask exactly.

System level, on the `small_ctx` world with `poisson_arrivals(10.0, 80,
seed=s)`, `charge_compute=False` and the reference's weights bridged
in: the port's `decision_backend="numpy"`/`"torch"` against the
reference's `"numpy"`/`"jax"`, with the KNN on `"torch"`/`"jax"`, must
choose the same instance for every request and give equal `aggregate`
metrics. With `knn_backend="kernel"` against `"pallas"` the bar is the
reference's own from `test_e2e_pallas_knn_feed`: quality within 0.01,
mean_e2e within rel 0.05.
"""
import jax
import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro.core import PRESETS
from repro.core import assignment as r_assign
from repro.core import decision_jax as r_dec
from repro.core.budget import admission_mask as r_admission_mask
from repro_torch.core import assignment as p_assign
from repro_torch.core import decision as p_dec
from repro_torch.core.budget import admission_mask as p_admission_mask
from repro_torch.estimators.bridge import bundle_from_arrays
from repro_torch.kernels import decision_megakernel as mk
from repro_torch.kernels import knn_topk as K

MODES = ("full", "off_reactive", "off_predictive", "static_prior")
WEIGHTS = (PRESETS["uniform"], (0.55, 0.25, 0.2), PRESETS["cost"])
f32 = np.float32


def _problem(seed, R=32, I=13):
    """`tests/test_decision_parity.py::_problem`, in float32."""
    rng = np.random.default_rng(seed)
    p = dict(
        q=rng.uniform(0, 1, (R, I)), ln=rng.uniform(20, 500, (R, I)),
        plm=rng.uniform(20, 600, R), tpot=rng.uniform(0.005, 0.05, I),
        nominal=rng.uniform(0.005, 0.05, I), d=rng.uniform(0, 3000, I),
        b=rng.integers(1, 12, I).astype(float),
        free=rng.integers(0, 6, I).astype(float), maxb=np.full(I, 16.0),
        price_in=rng.uniform(0.05, 0.5, I),
        price_out=rng.uniform(0.05, 0.5, I),
        budgets=np.where(rng.uniform(size=R) < 0.5,
                         rng.uniform(1e-5, 3e-4, R), np.nan),
        len_in=rng.uniform(10, 500, R))
    return {k: v.astype(f32) for k, v in p.items()}


def _staged(p, budget_filter, lpt):
    R, I = p["q"].shape
    if budget_filter:
        allowed, c_hat = r_admission_mask(p["budgets"], p["len_in"], p["ln"],
                                          p["price_in"], p["price_out"])
    else:
        allowed = np.ones((R, I), bool)
        c_hat = (p["len_in"][:, None] * p["price_in"][None, :]
                 + p["ln"] * p["price_out"][None, :]) * 1e-6
    return allowed, c_hat, r_assign.lpt_order(p["plm"], enable=lpt)


def _loop_args(p, order, c_hat):
    return (order, p["q"], c_hat, p["ln"], p["tpot"], p["d"], p["b"],
            p["free"], p["maxb"])


def _decide_args(p):
    return (p["q"], p["ln"], p["plm"], p["tpot"], p["nominal"], p["d"],
            p["b"], p["free"], p["maxb"], p["budgets"], p["len_in"],
            p["price_in"], p["price_out"])


def _T(a):
    return torch.from_numpy(np.array(a))


def _check_combo(mode, budget_filter, lpt):
    for seed, w in enumerate(WEIGHTS):
        p = _problem(seed)
        allowed, c_hat, order = _staged(p, budget_filter, lpt)
        pa, pc = p_admission_mask(p["budgets"], p["len_in"], p["ln"],
                                  p["price_in"], p["price_out"])
        if budget_filter:
            np.testing.assert_array_equal(pa, allowed)
            np.testing.assert_array_equal(pc, c_hat)
        loop = _loop_args(p, order, c_hat)
        kw = dict(latency_mode=mode, nominal_tpot=p["nominal"])
        ch_np, info = r_assign.greedy_assign(*loop, w, allowed, **kw)
        got, ginfo = p_assign.greedy_assign(*loop, w, allowed, **kw)
        np.testing.assert_array_equal(got, ch_np)
        np.testing.assert_array_equal(ginfo["est_latency"],
                                      info["est_latency"])
        # the tensor core, three ways in
        ch_t = p_assign.greedy_assign_torch(*loop, w, allowed, device="cpu",
                                            **kw)
        np.testing.assert_array_equal(ch_t, ch_np)
        wt = tuple(float(v) for v in w)
        ch_core, est_core = p_dec.greedy_core(
            _T(order), _T(p["q"]), _T(c_hat), _T(p["ln"]), _T(p["tpot"]),
            _T(p["nominal"]), _T(p["d"]), _T(p["b"]), _T(p["free"]),
            _T(p["maxb"]), wt, _T(allowed), latency_mode=mode)
        r_core, r_est = r_dec.greedy_core(
            order, p["q"], c_hat, p["ln"], p["tpot"], p["nominal"], p["d"],
            p["b"], p["free"], p["maxb"], wt, allowed, latency_mode=mode)
        np.testing.assert_array_equal(ch_core.numpy(), np.asarray(r_core))
        np.testing.assert_allclose(est_core.numpy(), np.asarray(r_est),
                                   rtol=1e-6)
        statics = dict(latency_mode=mode, lpt=lpt,
                       budget_filter=budget_filter)
        b_ch, _, b_c, b_a = p_dec.decide_batch(
            *(_T(a) for a in _decide_args(p)), wt, **statics)
        rb_ch, _, rb_c, rb_a = r_dec.decide_batch(*_decide_args(p), wt,
                                                  **statics)
        np.testing.assert_array_equal(b_ch.numpy(), np.asarray(rb_ch))
        np.testing.assert_array_equal(b_a.numpy(), np.asarray(rb_a))
        np.testing.assert_allclose(b_c.numpy(), np.asarray(rb_c), rtol=1e-6)
        ch, est = p_dec.decide(*_decide_args(p), w, device="cpu", **statics)
        r_ch, r_est = r_dec.decide(*_decide_args(p), w, **statics)
        assert ch.dtype == np.int64 and est.dtype == np.float64
        np.testing.assert_array_equal(ch, np.asarray(r_ch))
        np.testing.assert_allclose(est, r_est, rtol=1e-6)
        np.testing.assert_array_equal(ch, ch_np)


# tier-1: every mode with the filter and LPT on; each switch off once
@pytest.mark.parametrize("mode,budget_filter,lpt", [
    ("full", True, True), ("off_reactive", True, True),
    ("off_predictive", True, True), ("static_prior", True, True),
    ("full", False, True), ("full", True, False)])
def test_exact_assignment_parity(mode, budget_filter, lpt):
    _check_combo(mode, budget_filter, lpt)


@pytest.mark.slow
@pytest.mark.parametrize("lpt", [True, False], ids=["lpt", "fifo"])
@pytest.mark.parametrize("budget_filter", [True, False],
                         ids=["budget", "nobudget"])
@pytest.mark.parametrize("mode", MODES)
def test_exact_assignment_parity_grid(mode, budget_filter, lpt):
    _check_combo(mode, budget_filter, lpt)


def test_parity_with_batch_padding():
    """`decide` pads R to a power of two; pad rows must not leak into
    real assignments (they scan strictly after every real request)."""
    for R in (1, 5, 13, 33, 63):
        p = _problem(7 + R, R=R)
        w = PRESETS["uniform"]
        allowed, c_hat, order = _staged(p, True, True)
        ch_np, _ = r_assign.greedy_assign(
            *_loop_args(p, order, c_hat), w, allowed,
            nominal_tpot=p["nominal"])
        ch, _ = p_dec.decide(*_decide_args(p), w, device="cpu")
        r_ch, _ = r_dec.decide(*_decide_args(p), w)
        np.testing.assert_array_equal(ch, np.asarray(r_ch))
        np.testing.assert_array_equal(ch, ch_np)


def test_greedy_core_respects_allowed():
    p = _problem(42)
    R, I = p["q"].shape
    rng = np.random.default_rng(5)
    allowed = rng.uniform(size=(R, I)) < 0.3
    allowed[:, 2] = True
    order = r_assign.lpt_order(p["plm"])
    c_hat = (p["len_in"][:, None] * p["price_in"][None, :]
             + p["ln"] * p["price_out"][None, :]) * 1e-6
    w = tuple(float(v) for v in PRESETS["uniform"])
    choice, _ = p_dec.greedy_core(
        _T(order), _T(p["q"]), _T(c_hat), _T(p["ln"]), _T(p["tpot"]),
        _T(p["nominal"]), _T(p["d"]), _T(p["b"]), _T(p["free"]),
        _T(p["maxb"]), w, _T(allowed))
    choice = choice.numpy()
    assert all(allowed[r, choice[r]] for r in range(R))
    r_choice, _ = r_dec.greedy_core(order, p["q"], c_hat, p["ln"], p["tpot"],
                                    p["nominal"], p["d"], p["b"], p["free"],
                                    p["maxb"], w, allowed)
    np.testing.assert_array_equal(choice, np.asarray(r_choice))


def test_hungarian_is_the_reference():
    rng = np.random.default_rng(2)
    for n, m in ((4, 4), (5, 9), (1, 3)):
        C = rng.uniform(size=(n, m))
        np.testing.assert_array_equal(p_assign.hungarian(C),
                                      r_assign.hungarian(C))
    with pytest.raises(ValueError):
        p_assign.hungarian(np.zeros((3, 2)))


def test_score_helpers_are_the_reference():
    from repro.core import scoring as r_scoring
    from repro_torch.core import scoring as p_scoring
    rng = np.random.default_rng(4)
    q, c, t = (rng.uniform(0.01, 1, (6, 5)).astype(f32) for _ in range(3))
    mask = rng.uniform(size=(6, 5)) < 0.7
    mask[:, 0] = True
    aff = rng.uniform(0, 0.5, (6, 5)).astype(f32)
    w = (0.5, 0.3, 0.2)
    np.testing.assert_array_equal(
        p_scoring.score_matrix(q, c, t, w, mask, aff),
        r_scoring.score_matrix(q, c, t, w, mask, aff))
    np.testing.assert_array_equal(
        p_scoring.score_row(q[0], c[0], t[0], w),
        r_scoring.score_row(q[0], c[0], t[0], w))


# -- system level --------------------------------------------------------------

@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    ref = small_ctx["bundle"]
    heads = [{"name": t.name, "nominal_tpot": ref.heads[t.name].nominal_tpot,
              "packed": ref.heads[t.name].model.pack()}
             for t in small_ctx["tiers"]]
    bundle = bundle_from_arrays(
        jax.tree_util.tree_map(np.asarray, ref.encoder.params), ref.knn._x,
        ref.knn._quality, ref.knn._length, heads, small_ctx["names"],
        device="cpu")
    world, names = paper_world(seed=0)
    return dict(bundle=bundle, ds=build_dataset(world, n=400),
                tiers=paper_pool_tiers(), names=names)


def _ref_run(ctx, n, seed, **cfg):
    from repro.core import RBConfig, RouteBalance, make_requests, run_cell
    from repro.serving.workload import poisson_arrivals
    reqs = make_requests(ctx["ds"], "test", poisson_arrivals(10.0, n,
                                                             seed=seed))
    m = run_cell(RouteBalance(RBConfig(charge_compute=False, **cfg),
                              ctx["bundle"], ctx["tiers"]),
                 ctx["tiers"], ctx["names"], reqs)
    return reqs, m


def _port_run(port, n, seed, emb, **cfg):
    from repro_torch.serving.workload import poisson_arrivals
    reqs = P.make_requests(port["ds"], "test",
                           poisson_arrivals(10.0, n, seed=seed))
    reqs[0].cols.emb = emb                  # the reference's ingest rows
    rb = P.RouteBalance(P.RBConfig(charge_compute=False, **cfg),
                        port["bundle"], port["tiers"])
    return reqs, P.run_cell(rb, port["tiers"], port["names"], reqs), rb


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend,ref_backend",
                         [("numpy", "numpy"), ("torch", "jax")])
def test_e2e_staged_matches_reference(small_ctx, port, seed, backend,
                                      ref_backend):
    rreqs, rm = _ref_run(small_ctx, 80, seed, decision_backend=ref_backend)
    knn = (K.knn_topk.launches, K.knn_topk.plain_calls)
    launches = mk.decision_megakernel.launches + \
        mk.decision_megakernel.plain_calls
    preqs, pm, rb = _port_run(port, 80, seed, rreqs[0].cols.emb,
                              decision_backend=backend)
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
    # the staged path ran: no decision kernel, no K2 (KNN on "torch")
    assert rb._fused is None and len(rb.compute_log) > 0
    assert (mk.decision_megakernel.launches
            + mk.decision_megakernel.plain_calls) == launches
    assert (K.knn_topk.launches, K.knn_topk.plain_calls) == knn


def test_e2e_kernel_knn_feed(small_ctx, port):
    """The torch core fed by K2 (its plain version here) against the
    reference's jitted core fed by the Pallas knn_topk kernel: one K2
    call per decided batch."""
    rreqs, rm = _ref_run(small_ctx, 40, 3, decision_backend="jax",
                         knn_backend="pallas")
    plain = K.knn_topk.plain_calls
    _, pm, rb = _port_run(port, 40, 3, rreqs[0].cols.emb,
                          decision_backend="torch", knn_backend="kernel")
    assert K.knn_topk.plain_calls - plain == len(rb.compute_log) > 0
    assert pm["failed"] == 0 and pm["n"] == 40
    assert abs(pm["quality"] - rm["quality"]) < 0.01
    assert pm["mean_e2e"] == pytest.approx(rm["mean_e2e"], rel=0.05)


def test_knn_backend_override_does_not_mutate_bundle(port):
    before = port["bundle"].knn
    rb = P.RouteBalance(P.RBConfig(decision_backend="numpy",
                                   knn_backend="kernel"),
                        port["bundle"], port["tiers"])
    assert port["bundle"].knn is before and before.backend == "torch"
    assert rb.bundle.knn.backend == "kernel" and rb.bundle is not port[
        "bundle"]
    assert rb.bundle.knn._x is before._x        # the index is shared
