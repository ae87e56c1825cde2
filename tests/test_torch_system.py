"""The reference's end-to-end behaviour tests (`tests/test_system.py`)
and the property tests that reach port code (`tests/test_property.py`),
on the port.

Headline behaviours of the fused scheduler on the reference's small
world (1,500 prompts, the paper's pool), served by the port's default
backend (the decision kernel's plain version on the CPU) with the
estimator bundle bridged from the reference's trained weights: a
load-only balancer is Pareto-dominated by some weight vector, the
weight vector traces cost to quality, the latency term shifts the mix
off the slowest tier, a static prior comes close to the full objective,
and a run is deterministic given a seed (and, with `charge_compute=False`,
the reference's run metric for metric). The four that charge the
measured decision time run 12 cells of 200 requests on the wall clock:
they are `slow` (tier-1 keeps the deterministic run and the
properties).

The property tests (defined only where hypothesis imports, as the
reference's `importorskip` skips them, without taking the behaviour
tests with them): the greedy scan always assigns (and picks as the
reference's), the score is invariant to scaling costs or latencies,
admission keeps a candidate and respects budgets, `conv_step` walks
`causal_conv`, and the GBM lowers its training error.
"""
import numpy as np
import pytest

import repro_torch.core as P
from torch_scenario_parity import port_bundle


@pytest.fixture(scope="module")
def ctx():
    from repro.core import EstimatorBundle as RefBundle
    from repro.serving.tiers import paper_pool_tiers as ref_tiers
    from repro.serving.world import build_dataset as ref_ds
    from repro.serving.world import paper_world as ref_world
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    rworld, rnames = ref_world(seed=0)
    rds, rt = ref_ds(rworld, n=1500), ref_tiers()
    rbundle = RefBundle.train(rds, rt, rnames)
    world, names = paper_world(seed=0)
    tiers = paper_pool_tiers()
    return dict(names=names, ds=build_dataset(world, n=1500), tiers=tiers,
                bundle=port_bundle(rbundle, rt, rnames),
                ref=dict(names=rnames, ds=rds, tiers=rt, bundle=rbundle))


def _run(ctx, sched, lam=10.0, n=200, seed=0):
    from repro_torch.serving.workload import poisson_arrivals
    reqs = P.make_requests(ctx["ds"], "test",
                           poisson_arrivals(lam, n, seed=seed))
    return P.run_cell(sched, ctx["tiers"], ctx["names"], reqs)


def _rb(ctx, **kw):
    return P.RouteBalance(P.RBConfig(**kw), ctx["bundle"], ctx["tiers"])


@pytest.mark.slow
def test_fused_pareto_dominates_load_only(ctx):
    """Some point of the weight family matches the load-only balancer's
    quality at no more than 10% more latency, or beats it (§1, Fig 5)."""
    lb = _run(ctx, P.PipelineScheduler(
        P.PassthroughRouter(), P.ShortestQueue(), ctx["bundle"],
        ctx["tiers"], P.PipelineConfig(deployment="concurrent")))
    dominated = False
    for w in (P.PRESETS["uniform"], (0.55, 0.25, 0.2), P.PRESETS["quality"]):
        rb = _run(ctx, _rb(ctx, weights=w))
        if (rb["quality"] >= lb["quality"] - 0.005
                and rb["mean_e2e"] <= lb["mean_e2e"] * 1.10):
            dominated = True
            break
    assert dominated, (lb["quality"], lb["mean_e2e"])


@pytest.mark.slow
def test_weight_vector_traces_frontier(ctx):
    """Turning only the weight vector spans cost -> quality (§6.2)."""
    qs, costs = [], []
    for w in (P.PRESETS["cost"], P.PRESETS["uniform"], P.PRESETS["quality"]):
        m = _run(ctx, _rb(ctx, weights=w))
        qs.append(m["quality"])
        costs.append(m["cost_per_req"])
    assert qs[0] <= qs[1] <= qs[2] + 1e-9
    assert costs[0] <= costs[2]


@pytest.mark.slow
def test_latency_term_shifts_mix_off_slow_tier(ctx):
    """Pricing latency at model selection steers traffic off the slowest
    tier (§6.3 arm 1 vs arm 2)."""
    full = _run(ctx, _rb(ctx, latency_mode="full"))
    off = _run(ctx, _rb(ctx, latency_mode="off_reactive"))

    def share(m, tag):
        return sum(v for k, v in m["mix"].items() if tag in k)
    assert share(full, "72b") <= share(off, "72b") + 1e-9
    assert full["mean_e2e"] <= off["mean_e2e"] * 1.10


@pytest.mark.slow
def test_static_prior_close_to_full(ctx):
    """Arm 4: a static per-tier prior nearly reproduces the full
    objective (§6.3)."""
    full = _run(ctx, _rb(ctx, latency_mode="full"))
    prior = _run(ctx, _rb(ctx, latency_mode="static_prior"))
    assert abs(prior["quality"] - full["quality"]) < 0.05
    assert prior["mean_e2e"] < full["mean_e2e"] * 1.6


def test_deterministic_given_seed(ctx):
    """Two runs from one seed agree, and without the wall clock charged
    they are the reference's fused run, metric for metric."""
    import repro.core as R
    from repro.serving.workload import poisson_arrivals as ref_arrivals
    m1 = _run(ctx, _rb(ctx, charge_compute=False), seed=3)
    m2 = _run(ctx, _rb(ctx, charge_compute=False), seed=3)
    assert m1["quality"] == m2["quality"]
    assert m1["cost_per_req"] == m2["cost_per_req"]
    ref = ctx["ref"]
    reqs = R.make_requests(ref["ds"], "test", ref_arrivals(10.0, 200,
                                                           seed=3))
    rm = R.run_cell(R.RouteBalance(R.RBConfig(decision_backend="fused",
                                              charge_compute=False),
                                   ref["bundle"], ref["tiers"]),
                    ref["tiers"], ref["names"], reqs)
    assert rm["quality"] == m1["quality"]
    assert rm["cost_per_req"] == m1["cost_per_req"]
    assert rm["mix"] == m1["mix"]


# -- the property tests that reach port code ----------------------------------

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # tier-1 must collect without it
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @st.composite
    def weights_st(draw):
        a = draw(st.floats(0, 1))
        b = draw(st.floats(0, 1))
        c = draw(st.floats(0, 1))
        s = a + b + c
        if s == 0:
            return (1 / 3, 1 / 3, 1 / 3)
        return (a / s, b / s, c / s)

    @settings(max_examples=30, deadline=None)
    @given(weights_st(), st.integers(1, 10), st.integers(1, 6),
           st.integers(0, 10_000))
    def test_greedy_always_assigns(w, R_, I, seed):
        from repro.core.assignment import greedy_assign as ref_greedy
        rng = np.random.default_rng(seed)
        q = rng.uniform(0, 1, (R_, I))
        c = rng.uniform(1e-7, 1e-4, (R_, I))
        ln = rng.uniform(1, 600, (R_, I))
        tpot = rng.uniform(1e-3, 0.1, I)
        args = (P.lpt_order(ln.max(1)), q, c, ln, tpot,
                rng.uniform(0, 1e4, I), rng.integers(1, 16, I).astype(float),
                rng.integers(0, 8, I).astype(float), np.full(I, 32.0), w)
        choice, info = P.greedy_assign(*args)
        assert choice.min() >= 0 and choice.max() < I
        assert np.all(info["est_latency"] >= 0)
        ref_choice, ref_info = ref_greedy(*args)
        np.testing.assert_array_equal(choice, ref_choice)
        np.testing.assert_array_equal(info["est_latency"],
                                      ref_info["est_latency"])

    @settings(max_examples=30, deadline=None)
    @given(weights_st(), st.integers(2, 8), st.integers(2, 5),
           st.integers(0, 10_000))
    def test_score_normalization_invariant(w, R_, I, seed):
        """Scaling all costs (or latencies) by a constant leaves the score
        matrix as it was (per-request normalization, §4.1)."""
        rng = np.random.default_rng(seed)
        q = rng.uniform(0, 1, (R_, I))
        c = rng.uniform(1e-7, 1e-4, (R_, I))
        T = rng.uniform(1e-3, 60.0, (R_, I))
        s1 = P.score_matrix(q, c, T, w)
        s2 = P.score_matrix(q, c * 7.3, T * 0.11, w)
        np.testing.assert_allclose(s1, s2, rtol=1e-9, atol=1e-9)

    @settings(max_examples=25, deadline=None)
    @given(st.integers(1, 12), st.integers(2, 5), st.integers(0, 10_000))
    def test_budget_admission_soundness(R_, I, seed):
        rng = np.random.default_rng(seed)
        budgets = np.where(rng.uniform(size=R_) < 0.5,
                           rng.uniform(1e-6, 1e-4, R_), np.nan)
        len_in = rng.uniform(10, 500, R_)
        pred = rng.uniform(10, 800, (R_, I))
        p_in = rng.uniform(0.01, 0.5, I)
        p_out = rng.uniform(0.01, 0.5, I)
        allowed, c_hat = P.admission_mask(budgets, len_in, pred, p_in, p_out)
        assert allowed.any(axis=1).all()
        for r in range(R_):
            if np.isnan(budgets[r]) or allowed[r].sum() == 1:
                continue
            assert np.all(c_hat[r][allowed[r]] <= budgets[r] + 1e-12)

    @settings(max_examples=20, deadline=None)
    @given(st.integers(1, 3), st.integers(4, 24), st.integers(1, 8),
           st.integers(2, 4), st.integers(0, 1_000))
    def test_conv_step_matches_causal_conv(B, S, C, width, seed):
        import torch

        from repro_torch.models.blocks import causal_conv, conv_step
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(size=(B, S, C)).astype(np.float32))
        p = {"w": torch.from_numpy(rng.normal(size=(width, C))
                                   .astype(np.float32))}
        full = causal_conv(x, p, width)
        state = torch.zeros((B, width - 1, C), dtype=torch.float32)
        outs = []
        for t in range(S):
            y, state = conv_step(x[:, t], state, p, width)
            outs.append(y)
        np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(),
                                   rtol=1e-5, atol=1e-5)

    @settings(max_examples=15, deadline=None)
    @given(st.integers(8, 64), st.integers(2, 6), st.integers(0, 10_000))
    def test_gbm_reduces_training_error(n, f, seed):
        from repro_torch.estimators.gbm import GradientBoostedRegressor
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(max(n, 16), f)).astype(np.float32)
        y = (X[:, 0] * 2 + np.sin(X[:, 1 % f])).astype(np.float32)
        base_mse = float(np.mean((y - y.mean()) ** 2))
        g = GradientBoostedRegressor(n_trees=20, depth=3).fit(X, y)
        mse = float(np.mean((g.predict(X) - y) ** 2))
        assert mse <= base_mse + 1e-6
