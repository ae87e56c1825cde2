"""Multi-window dispatch on the decision kernel: K scheduler windows in
one call (`RouteBalancePolicy.assign_windows` ->
`FusedHotPath.decide_cols_multi`), against K separate `assign` calls on
the port and against the JAX reference's `fused` `assign` per window.

On the CPU the kernel's wrapper runs its plain version; windows pad to
a power of two (K = 3 takes one pad window of invalid rows) and rows to
the power of two above the largest window."""
import numpy as np
import pytest

from torch_scenario_parity import port_bundle

CUTS = {2: (0, 12, 21), 3: (0, 12, 24, 35), 4: (0, 12, 24, 35, 42)}


@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    return dict(bundle=port_bundle(small_ctx["bundle"], small_ctx["tiers"],
                                   small_ctx["names"]),
                ds=build_dataset(world, n=400), tiers=paper_pool_tiers(),
                names=names)


def _batch(pkg, ds, R, seed):
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    reqs = core.make_requests(ds, "test", np.zeros(R))
    rng = np.random.default_rng(seed)
    budgets = np.where(rng.uniform(size=R) < 0.5,
                       rng.uniform(1e-5, 3e-4, R), np.nan)
    for r, b in zip(reqs, budgets):
        r.budget = None if np.isnan(b) else float(b)
    return reqs


def _sim(pkg, ctx, seed=9):
    """A sim in package `pkg` with mid-run-looking telemetry (the same
    seeded state in both packages)."""
    import importlib
    cluster = importlib.import_module(f"{pkg}.serving.cluster")
    scen = importlib.import_module(f"{pkg}.serving.scenarios")
    return scen.randomize_telemetry(
        cluster.ClusterSim(ctx["tiers"], ctx["names"], seed=0), seed)


def _policy(ctx, sim, **cfg_kw):
    from repro_torch.core import RBConfig, RouteBalancePolicy
    from repro_torch.core.hotpath import FusedHotPath
    FusedHotPath.clear_cache(ctx["bundle"])   # a fresh hot path
    pol = RouteBalancePolicy(RBConfig(**cfg_kw))
    pol.prepare(ctx["bundle"], ctx["tiers"])
    pol.on_attach(sim)
    return pol


def _reference(small_ctx, K, R, seed):
    """The reference's windows, decided one `fused` `assign` each, and
    its requests (whose ingest embeddings the port takes)."""
    from repro.core import RBConfig, RouteBalancePolicy
    from repro.core.engine import BatchView
    reqs = _batch("repro", small_ctx["ds"], R, seed)
    sim = _sim("repro", small_ctx)
    pol = RouteBalancePolicy(RBConfig(decision_backend="fused"))
    pol.prepare(small_ctx["bundle"], small_ctx["tiers"])
    pol.on_attach(sim)
    cut = CUTS[K]
    out = [pol.assign(BatchView(reqs[a:b]), sim).fetch()
           for a, b in zip(cut, cut[1:])]
    return reqs, out


@pytest.mark.parametrize("K", [2, 3, 4])
def test_multi_window_matches_separate_and_reference(small_ctx, port, K):
    """K windows of unequal R in one call are bitwise K separate
    `assign` calls against the same telemetry, and choose what the
    reference's `fused` backend chooses window by window."""
    from repro_torch.core.engine import BatchView
    from repro_torch.kernels import decision_megakernel as mk
    cut = CUTS[K]
    rreqs, ref = _reference(small_ctx, K, cut[-1], seed=11)
    reqs = _batch("repro_torch", port["ds"], cut[-1], seed=11)
    reqs[0].cols.emb = rreqs[0].cols.emb
    sim = _sim("repro_torch", port)
    views = [BatchView(reqs[a:b]) for a, b in zip(cut, cut[1:])]
    pol = _policy(port, sim, window_coalesce=K)
    plain = mk.decision_megakernel.plain_calls
    multi = [r.fetch() for r in pol.assign_windows(views, sim)]
    assert mk.decision_megakernel.plain_calls == plain + 1
    st = pol._fused.stats
    assert st["multi_dispatch"] == 1 and st["calls"] == K
    assert pol._fused.shape_variants() == 1
    single = _policy(port, sim)
    sep = [single.assign(v, sim).fetch() for v in views]
    for (cm, lm), (cs, ls), (cr, lr), (a, b) in zip(multi, sep, ref,
                                                     zip(cut, cut[1:])):
        assert len(cm) == b - a
        np.testing.assert_array_equal(cm, cs)
        np.testing.assert_array_equal(lm, ls)
        np.testing.assert_array_equal(cm, cr)
        np.testing.assert_allclose(lm, lr, rtol=1e-5)


def test_pad_windows_and_post_state(port):
    """A pad window (K = 3 -> 4) holds only invalid rows and changes no
    window's answer; the post-scan state kept is the last real
    window's, and a single window goes through `decide_cols`."""
    from repro_torch.core.hotpath import FusedHotPath
    from repro_torch.core import RBConfig
    reqs = _batch("repro_torch", port["ds"], 20, seed=3)
    reqs[0].cols.ensure_embeddings(port["bundle"].encoder)
    cols = reqs[0].cols
    sim = _sim("repro_torch", port, seed=4)
    hp = FusedHotPath(port["bundle"], sim.instances, RBConfig())
    rows = [np.arange(0, 5), np.arange(5, 12), np.arange(12, 20)]
    multi = hp.decide_cols_multi([(cols, r) for r in rows], sim.tel)
    post = hp._post_state
    for r, lazy in zip(rows, multi):
        want = hp.decide_cols(cols, r, sim.tel).fetch()
        for a, b in zip(lazy.fetch(), want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(post, hp._post_state):        # last window: rows[2]
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    n = hp.stats["calls"]
    assert len(hp.decide_cols_multi([(cols, rows[0])], sim.tel)) == 1
    assert hp.stats["multi_dispatch"] == 1 and hp.stats["calls"] == n + 1
    # (K, R) buckets seen: (4, 8) for the three windows, (1, 8) singles
    assert hp.shape_variants() == 2


def test_wrapper_taps_see_each_call(port):
    """`decision_megakernel.tap` and `knn_topk.tap` are called once per
    wrapper call with the call's arguments, before it runs; with the tap
    unset nothing is recorded, and the counts are the calls'."""
    import torch
    from repro_torch.core import RBConfig
    from repro_torch.core.hotpath import FusedHotPath
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.kernels import knn_topk as kt
    reqs = _batch("repro_torch", port["ds"], 12, seed=5)
    reqs[0].cols.ensure_embeddings(port["bundle"].encoder)
    cols = reqs[0].cols
    sim = _sim("repro_torch", port, seed=6)
    hp = FusedHotPath(port["bundle"], sim.instances, RBConfig())
    seen = []
    plain = mk.decision_megakernel.plain_calls
    mk.decision_megakernel.tap = lambda args, kw: seen.append(
        ([tuple(t.shape) for t in args], kw))
    try:
        hp.decide_cols_multi([(cols, np.arange(0, 5)),
                              (cols, np.arange(5, 12)),
                              (cols, np.arange(0, 3))], sim.tel)
        hp.decide_cols(cols, np.arange(4), sim.tel)
    finally:
        mk.decision_megakernel.tap = None
    assert mk.decision_megakernel.plain_calls == plain + 2
    assert [shapes[0] for shapes, _ in seen] == [(4, 8, 128), (1, 8, 128)]
    assert seen[0][1]["k"] == hp._k
    hp.decide_cols(cols, np.arange(4), sim.tel)
    assert len(seen) == 2
    q, x = torch.randn(3, 128), torch.randn(50, 128)
    got = []
    kt.knn_topk.tap = lambda *a: got.append(a)
    try:
        d, i = kt.knn_topk(q, x, 5)
    finally:
        kt.knn_topk.tap = None
    assert len(got) == 1 and got[0][0] is q and got[0][1] is x
    assert got[0][2] == 5 and got[0][3] is None
    pd, pi = kt.knn_topk_plain(q, x, 5)
    assert torch.equal(i, pi) and torch.equal(d, pd)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_assign_windows_falls_back_per_window(small_ctx, port, backend):
    """The staged backends route each window through its own `assign`:
    coalescing is a kernel capability, not a different decision."""
    from repro_torch.core.engine import BatchView
    reqs = _batch("repro_torch", port["ds"], 16, seed=2)
    sim = _sim("repro_torch", port)
    views = [BatchView(reqs[:8]), BatchView(reqs[8:])]
    pol = _policy(port, sim, decision_backend=backend)
    coal = [r.fetch() for r in pol.assign_windows(views, sim)]
    sep = [pol.assign(v, sim).fetch() for v in views]
    assert pol._fused is None
    for (cm, lm), (cs, ls) in zip(coal, sep):
        np.testing.assert_array_equal(cm, cs)
        np.testing.assert_array_equal(lm, ls)


def test_window_coalesce_config():
    from repro_torch.core import RBConfig
    assert RBConfig(window_coalesce=4).window_coalesce == 4
    with pytest.raises(ValueError, match="megakernel"):
        RBConfig(window_coalesce=2, decision_backend="numpy")
    with pytest.raises(ValueError):
        RBConfig(window_coalesce=0)
