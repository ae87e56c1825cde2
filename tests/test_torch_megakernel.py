"""The port's decision kernel against the Pallas reference.

On the CPU the wrapper `repro_torch.kernels.decision_megakernel.
decision_megakernel` runs its plain version; it is held against
`repro.kernels.ops.decision_megakernel` (the Pallas kernel in interpret
mode) on the shapes of `tests/test_megakernel.py::_toy_world`: K=2
windows, a pad row per window, a dead instance, NaN and finite budgets,
GBM on and off, the four latency modes x LPT x budget filter, and the
affinity term. Tolerances: `choice`, `b1` and `f1` exact; `est_T`,
`l_chosen` and `d1` within rtol 1e-5, atol 1e-7 — the reference's
interpret-mode program is compiled by XLA, which contracts some
multiply-adds into FMAs and forms the neighbour distances with its own
matmul, so the float outputs may differ by an ulp or so.

The kernel itself (CUDA) is held against the plain version by the test
marked `cuda`, which skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decision_megakernel as mk

MODES = ("full", "off_reactive", "off_predictive", "static_prior")
f32 = np.float32


def _toy_world(seed=0, K=2, R=6, E=8, N=40, M=3, I=5, T=2, k=4,
               aff=False):
    """`tests/test_megakernel.py::_toy_world`, plus signatures for the
    affinity arm."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(K, R, E)).astype(f32)
    rv = np.ones((K, R), bool)
    rv[:, R - 1] = False                      # one pad row per window
    budgets = np.where(rng.uniform(size=(K, R)) < 0.5,
                       rng.uniform(1e-5, 3e-4, (K, R)), np.nan
                       ).astype(f32)
    len_in = rng.integers(8, 200, (K, R)).astype(f32)
    x = rng.normal(size=(N, E)).astype(f32)
    args = dict(
        emb=emb, row_valid=rv, budgets=budgets, len_in=len_in,
        psig=np.zeros((K, 1, 1), np.int32),
        d=rng.uniform(0, 300, I).astype(f32),
        b=rng.integers(1, 6, I).astype(f32),
        free=rng.integers(0, 4, I).astype(f32),
        ctx=rng.uniform(64, 900, I).astype(f32),
        alive=np.array([True] * (I - 1) + [False]),
        x=x, xsq=(x * x).sum(1).astype(f32),
        qual=rng.uniform(0, 1, (N, M)).astype(f32),
        leng=rng.uniform(20, 400, (N, M)).astype(f32),
        m_of_i=rng.integers(0, M, I).astype(np.int32),
        tier_of_i=(np.arange(I) % T).astype(np.int32),
        maxb=np.full(I, 8.0, f32),
        price_in=rng.uniform(1e-7, 1e-6, I).astype(f32),
        price_out=rng.uniform(1e-6, 1e-5, I).astype(f32),
        nominal=rng.uniform(0.01, 0.06, I).astype(f32),
        sig_plane=np.zeros((1, 1), np.int32))
    if aff:
        pool = rng.integers(1, 2 ** 31 - 1, 12).astype(np.int32)
        args["psig"] = pool[rng.integers(0, 12, (K, R, 8))]
        args["sig_plane"] = pool[rng.integers(0, 12, (I, 64))]
        args["sig_plane"][rng.uniform(size=(I, 64)) < 0.6] = 0
    return args


def _gbm(use_gbm, T=2):
    if not use_gbm:
        return [a.numpy() for a in mk.dummy_gbm()], 1, 0.1
    from repro_torch.estimators.gbm import (GradientBoostedRegressor,
                                            pack_ensemble)
    rng = np.random.default_rng(5)
    models = []
    for _ in range(T):
        X = rng.uniform(0, 900, (200, 4)).astype(f32)
        y = (0.02 + 1e-5 * X[:, 1] + 1e-4 * X[:, 0]).astype(f32)
        models.append(GradientBoostedRegressor(n_trees=8, depth=2).fit(X, y))
    st = pack_ensemble(models)
    return ([st["feature"].astype(np.int32), st["threshold"], st["leaf"],
             st["base"]], st["depth"], st["lr"])


def _statics(mode="full", lpt=True, budget_filter=True, w_aff=0.0):
    return dict(k=4, eps=1e-3, weights=(1 / 3, 1 / 3, 1 / 3),
                latency_mode=mode, lpt=lpt, budget_filter=budget_filter,
                w_aff=w_aff)


def _port(args, gbm, depth, lr, use_gbm, device="cpu", **statics):
    ts = [torch.as_tensor(np.array(a), device=device)
          for a in list(args.values()) + list(gbm)]
    out = mk.decision_megakernel(*ts, use_gbm=use_gbm, depth=depth, lr=lr,
                                 **statics)
    return [o.cpu().numpy() for o in out]


def _compare(got, ref):
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))   # choice
    for j in (1, 2, 3):                                         # est l d1
        np.testing.assert_allclose(got[j], np.asarray(ref[j]), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_array_equal(got[4], np.asarray(ref[4]))   # b1
    np.testing.assert_array_equal(got[5], np.asarray(ref[5]))   # f1


def _reference(args, gbm, depth, lr, use_gbm, **statics):
    from repro.kernels.ops import decision_megakernel as ref_mk
    return ref_mk(*args.values(), *gbm, use_gbm=use_gbm, depth=depth,
                  lr=lr, **statics)


def _case(seed, use_gbm, aff=False, **kw):
    args = _toy_world(seed, aff=aff)
    gbm, depth, lr = _gbm(use_gbm)
    statics = _statics(w_aff=0.35 if aff else 0.0, **kw)
    got = _port(args, gbm, depth, lr, use_gbm, **statics)
    ref = _reference(args, gbm, depth, lr, use_gbm, **statics)
    _compare(got, ref)
    assert not (got[0] == len(args["d"]) - 1).any()   # dead never chosen
    return got


# tier-1: every mode with the GBM on; each switch off once; affinity
@pytest.mark.parametrize("case", [
    dict(mode="full"), dict(mode="off_reactive"),
    dict(mode="off_predictive"), dict(mode="static_prior"),
    dict(mode="full", lpt=False), dict(mode="full", budget_filter=False),
    dict(mode="full", use_gbm=False), dict(mode="full", aff=True),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_plain_matches_pallas_reference(case):
    case = dict(case)
    use_gbm = case.pop("use_gbm", True)
    aff = case.pop("aff", False)
    _case(0, use_gbm, aff=aff, **case)


@pytest.mark.parametrize("case", [
    dict(mode="full"), dict(mode="off_reactive"), dict(mode="full", aff=True),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_plain_matches_pallas_reference_past_the_shared_carry(case):
    """A roster of MAX_SHARED_I + 1 instances (the kernel's cluster carry
    on the card), every fifth instance dead, K = 2 windows: the plain
    version against the Pallas reference at the same tolerances."""
    case = dict(case)
    aff = case.pop("aff", False)
    I = mk.MAX_SHARED_I + 1
    args = _toy_world(1, I=I, aff=aff)
    args["alive"] = np.arange(I) % 5 != 2
    gbm, depth, lr = _gbm(True)
    statics = _statics(w_aff=0.35 if aff else 0.0, **case)
    got = _port(args, gbm, depth, lr, True, **statics)
    _compare(got, _reference(args, gbm, depth, lr, True, **statics))
    assert args["alive"][got[0]].all()             # dead never chosen


@pytest.mark.slow
@pytest.mark.parametrize("use_gbm", [True, False], ids=["gbm", "nominal"])
@pytest.mark.parametrize("lpt", [True, False], ids=["lpt", "fifo"])
@pytest.mark.parametrize("budget_filter", [True, False],
                         ids=["budget", "nobudget"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_reference_grid(mode, budget_filter, lpt,
                                             use_gbm):
    for seed in (1, 2):
        _case(seed, use_gbm, mode=mode, budget_filter=budget_filter,
              lpt=lpt)


def test_cpu_tensors_count_plain_calls_not_launches():
    args = _toy_world(0)
    gbm, depth, lr = _gbm(False)
    before = (mk.decision_megakernel.launches,
              mk.decision_megakernel.plain_calls)
    _port(args, gbm, depth, lr, False, **_statics())
    assert mk.decision_megakernel.launches == before[0]
    assert mk.decision_megakernel.plain_calls == before[1] + 1


@pytest.mark.parametrize("rows,want", [(8, (4, 117, 2)), (16, (8, 117, 2)),
                                       (64, (8, 59, 4)), (256, (32, 30, 8)),
                                       (1, (1, 233, 1))])
def test_layout_follows_the_lookup_table(rows, want):
    """Stage 1 over K * R rows takes the KNN lookup's measured layout at
    that batch: (row tile, splits, 64-column tiles per split)."""
    from repro_torch.kernels import knn_topk as kt
    assert mk.layout(rows, 14886) == want
    assert mk.layout(rows, 14886) == (kt.row_tile(rows),
                                      *kt.knn_splits(rows, 14886))


def test_scratch_is_split_lists_tickets_and_mixes():
    # K = 2 windows of R = 64 rows (8-row tiles, 30 splits), M = 4, k = 10:
    # a ticket per row tile, per window and the trees'; the TPOT heads
    assert mk.scratch_sizes(2, 64, 4, 10, 14886, 16, "warp", False) == (
        128 * 30 * 10, 16 + 2 + 1, 128 * 9, 16, 0)
    # the main path's bucket: one window of 8 rows in 4-row tiles
    assert mk.scratch_sizes(1, 8, 4, 10, 14886, 16, "warp", False) == (
        8 * 117 * 10, 2 + 1 + 1, 8 * 9, 16, 0)
    # the global carry: the TPOT and b0, then a step's cost and latency
    # per window (32 rows take 8-row tiles and 59 splits)
    assert mk.scratch_sizes(2, 16, 4, 10, 14886, 16384, "global",
                            False) == (
        32 * 59 * 10, 4 + 2 + 1, 32 * 9, (2 + 2 * 2) * 16384, 0)
    assert mk.scratch_sizes(1, 16, 4, 10, 14886, 4096, "shared",
                            False)[3] == 4096
    # the affinity term: a factor per row of every window and instance,
    # on every carry, and nothing else moves
    for K, R, I, carry in ((2, 64, 16, "warp"), (1, 16, 1024, "shared"),
                           (2, 16, 16384, "global"), (1, 16, 4097, "global"),
                           (2, 16, 16384, "cluster")):
        off = mk.scratch_sizes(K, R, 4, 10, 14886, I, carry, False)
        on = mk.scratch_sizes(K, R, 4, 10, 14886, I, carry, True)
        assert off[4] == 0 and on[4] == K * R * I
        assert on[:4] == off[:4]


def test_scratch_of_the_cluster_carry_is_the_tpot_alone():
    """The cluster carry keeps its per-instance arrays in the cluster's
    shared memory: its scratch is the shared carry's (the TPOT heads, I
    floats), not the global carry's b0 and per-window cost and latency;
    the rest follows the rows alone."""
    for K, R, I in ((1, 16, 4097), (2, 16, 16384), (1, 128, 65536)):
        cl = mk.scratch_sizes(K, R, 16, 10, 14886, I, "cluster", False)
        gl = mk.scratch_sizes(K, R, 16, 10, 14886, I, "global", False)
        assert cl[3] == I and gl[3] == (2 + 2 * K) * I
        assert cl[:3] == gl[:3] and cl[4] == gl[4] == 0


H100_SMEM = 232448      # bytes a block may opt in to on an H100


@pytest.mark.parametrize("I, want", [
    (16, ("warp", 1)), (32, ("warp", 1)), (33, ("shared", 1)),
    (1024, ("shared", 1)), (4096, ("shared", 1)), (4097, ("cluster", 8)),
    (8192, ("cluster", 8)), (8193, ("cluster", 16)),
    (16384, ("cluster", 16)), (16385, ("cluster", 16)),
    (16 * 4096, ("cluster", 16)), (16 * 4096 + 1, ("global", 1)),
    (1 << 20, ("global", 1))])
def test_carry_of_follows_the_roster(I, want):
    """The carry a call's scan takes, from the roster alone at the
    benchmark's R = 16, M = 16, one window: the warp and the shared carry
    up to MAX_SHARED_I, then the smallest cluster that leaves a CTA at
    most CLUSTER_COLS columns, then the largest while a CTA holds at most
    MAX_SHARED_I, then the global carry."""
    assert (mk.MAX_SHARED_I, mk.MAX_CLUSTER, mk.CLUSTER_COLS) == (
        4096, 16, 1024)
    assert mk.carry_of(1, I, 16, 16, H100_SMEM) == want
    kind, C = want
    if kind == "cluster":
        assert C * mk.MAX_SHARED_I >= I > (C - 1) * -(-I // C)


def test_carry_of_narrows_with_the_device():
    """A device that holds no cluster of 16 (c_max 8) takes clusters of 8
    up to 8 x 4,096 instances, of 2,048 columns a CTA at I = 16,384; one
    that holds none (c_max 1) the global carry; more windows than the
    completion word's 32 bits, or slices that do not fit, the global
    carry; at or below MAX_SHARED_I the paths do not move."""
    assert mk.carry_of(1, 16384, 16, 16, H100_SMEM, 8) == ("cluster", 8)
    assert mk.carry_of(1, 8 * 4096 + 1, 16, 16, H100_SMEM, 8) == (
        "global", 1)
    assert mk.carry_of(1, 4097, 16, 16, H100_SMEM, 4) == ("cluster", 4)
    assert mk.carry_of(1, 16384, 16, 16, H100_SMEM, 1) == ("global", 1)
    assert mk.carry_of(32, 16384, 16, 16, H100_SMEM) == ("cluster", 16)
    assert mk.carry_of(33, 16384, 16, 16, H100_SMEM) == ("global", 1)
    for c_max in (1, 8, 16):
        assert mk.carry_of(1, 4096, 16, 16, H100_SMEM, c_max) == (
            "shared", 1)
    # R x M arrays too large for the slices beside them: a larger cluster,
    # then the global carry
    big = mk.scan_smem_bytes(4096, 8, 1024) - 1
    assert mk.carry_of(1, 16384, 4096, 8, big) == ("global", 1)
    assert mk.carry_of(1, 8192, 4096, 8, big) == ("cluster", 16)
    # the shared carry's own limit at I <= MAX_SHARED_I keeps today's
    # global fallback
    assert mk.carry_of(1, 4096, 16, 16, mk.scan_smem_bytes(16, 16, 4096)
                       - 1) == ("global", 1)


def test_scan_smem_bytes_counts_the_scan_words():
    """Rows' mixes, the R-length arrays and 96 reduction words, then seven
    floats a column: at the cells' R = 16, M = 16 the cluster carry's
    1,024 columns a CTA take 31,552 bytes, under stage 1's 43 KB at the
    4-row tile."""
    assert mk.scan_smem_bytes(16, 16, 0) == 4 * (512 + 112 + 96)
    assert mk.scan_smem_bytes(16, 16, 1024) == 31552
    assert mk.scan_smem_bytes(64, 16, 4096) - mk.scan_smem_bytes(
        64, 16, 0) == 7 * 4 * 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("aff", [False, True], ids=["noaff", "aff"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_on_card(cuda_device, mode, aff):
    """The CUDA kernel against its plain version on the same CUDA
    tensors: choice, b1, f1 exact, est_T/l_chosen/d1 within rtol 1e-5."""
    args = _toy_world(3, aff=aff)
    # dyadic embeddings (multiples of 1/8): every distance is exact in
    # float32 whatever the summation order, so the neighbours agree
    for name in ("emb", "x"):
        args[name] = (np.clip(np.round(args[name] * 8), -8, 8) / 8
                      ).astype(f32)
    args["xsq"] = (args["x"] * args["x"]).sum(1).astype(f32)
    gbm, depth, lr = _gbm(mode != "static_prior")
    statics = _statics(mode=mode, w_aff=0.35 if aff else 0.0)
    use_gbm = mode != "static_prior"
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, use_gbm, device=cuda_device,
                **statics)
    assert mk.decision_megakernel.launches == launches + 1
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + list(gbm)]
    want = [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=use_gbm, depth=depth, lr=lr, **statics)]
    _compare(got, want)


@pytest.mark.cuda
def test_kernel_takes_a_roster_past_the_shared_carry(cuda_device):
    """One instance past the shared carry (I = MAX_SHARED_I + 1) the
    wrapper launches once, on the cluster carry, and matches the plain
    version: choice, b1, f1 exact, est_T/l_chosen/d1 within rtol 1e-5."""
    args = _dyadic_world(0, I=mk.MAX_SHARED_I + 1)
    args["alive"] = np.ones(mk.MAX_SHARED_I + 1, bool)
    gbm, depth, lr = _gbm(False)
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, False, device=cuda_device, **_statics())
    assert mk.decision_megakernel.launches == launches + 1
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + list(gbm)]
    want = [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=False, depth=depth, lr=lr, **_statics())]
    _compare(got, want)


def _dyadic_world(seed, **kw):
    args = _toy_world(seed, **kw)
    for name in ("emb", "x"):
        args[name] = (np.clip(np.round(args[name] * 8), -8, 8) / 8
                      ).astype(f32)
    args["xsq"] = (args["x"] * args["x"]).sum(1).astype(f32)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "windows", "I128", "I4096",
                                  "I4097", "I16384"])
def test_kernel_matches_plain_on_card_shapes(cuda_device, case):
    """One request padded to the R = 8 bucket, K = 2 windows whose rows
    share row tiles, and rosters that take the block-wide scan (I = 128),
    the shared carry's largest (I = 4096) and the cluster carry (I = 4097
    and 16,384, K = 2 windows, each scanned by its cluster): exact
    against the plain version."""
    kw = dict(one_row=dict(K=1, R=8), windows=dict(K=2, R=12),
              I128=dict(K=1, R=16, I=128),
              I4096=dict(K=1, R=16, I=mk.MAX_SHARED_I),
              I4097=dict(K=2, R=16, I=mk.MAX_SHARED_I + 1),
              I16384=dict(K=2, R=16, I=16384))[case]
    args = _dyadic_world(11, **kw)
    if case == "one_row":
        args["row_valid"][:, 1:] = False
    if "I" in kw:
        args["alive"] = np.arange(kw["I"]) % 7 != 3
    gbm, depth, lr = _gbm(True)
    statics = _statics()
    got = _port(args, gbm, depth, lr, True, device=cuda_device, **statics)
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + list(gbm)]
    want = [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=True, depth=depth, lr=lr, **statics)]
    _compare(got, want)


def _tickets(dev):
    """The K1 scratch's tickets on the current stream of `dev`."""
    torch.cuda.synchronize(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return mk._scratch[(torch.cuda.current_device(), stream)][2]


@pytest.mark.cuda
def test_kernel_calls_in_a_row_agree(cuda_device):
    """The tickets reset themselves: every ticket (row tiles, windows,
    the trees') is 0 after each call, and a call on the same stream after
    calls at other shapes (the cluster carry's among them) repeats the
    first exactly."""
    gbm, depth, lr = _gbm(True)
    a1 = _dyadic_world(12, K=2, R=8)
    a2 = _dyadic_world(13, K=1, R=64)
    a3 = _dyadic_world(14, K=2, R=16, I=16384)
    outs = []
    for a in (a1, a2, a3, a1):
        outs.append(_port(a, gbm, depth, lr, True, device=cuda_device,
                          **_statics()))
        assert not _tickets(cuda_device).any()
    for g, h in zip(outs[0], outs[3]):
        np.testing.assert_array_equal(g, h)


def _forest(T, n_trees, depth, seed=0):
    """A packed random forest (features 0-3, thresholds across the
    telemetry's range): what a TPOT head costs the kernel is its walk,
    `n_trees` trees of `depth` levels per instance, whatever the values."""
    rng = np.random.default_rng(seed)
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    return ([rng.integers(0, 4, (T, n_trees, n_int)).astype(np.int32),
             rng.uniform(0, 300, (T, n_trees, n_int)).astype(f32),
             rng.uniform(-1e-3, 1e-3, (T, n_trees, n_leaf)).astype(f32),
             np.full(T, 0.03, f32)], depth, 0.1)


def _bitwise(got, want):
    """Every output bit for bit: choice, and the float outputs through an
    int32 view."""
    for g, h in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.int32),
                                      np.asarray(h).view(np.int32))


# (world, mode, use_gbm) of the card cases of the TPOT over the grid
GRID_CASES = {
    "I16_R8": (dict(K=1, R=8, I=16), "full", True),
    **{f"I1024_{m}": (dict(K=1, R=16, I=1024), m, True) for m in MODES},
    "I16384_K2": (dict(K=2, R=16, I=16384), "full", True),
    "I4097_nogbm": (dict(K=1, R=16, I=4097), "full", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID_CASES))
def test_kernel_tpot_over_the_grid_is_bitwise(cuda_device, case):
    """The TPOT heads walked by the grid's slices before stage 1: 60 trees
    of depth 3 over 4 tiers, every output bitwise the plain version's. At
    I = 16, R = 8 the grid has far more CTAs than instances; at I = 1,024
    (the shared carry) the last 24 instances are dead pads, which the off
    modes still read; at I = 16,384 two windows read one TPOT array on
    the cluster carry; at I = 4,097 the slices write the nominal TPOT."""
    world, mode, use_gbm = GRID_CASES[case]
    args = _dyadic_world(31, T=4, **world)
    I = world["I"]
    args["alive"] = (np.arange(I) < 1000) if I == 1024 else (
        np.arange(I) % 7 != 3)
    gbm, depth, lr = _forest(4, 60, 3, seed=2) if use_gbm else _gbm(False)
    statics = _statics(mode=mode)
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, use_gbm, device=cuda_device,
                **statics)
    assert mk.decision_megakernel.launches == launches + 1
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + list(gbm)]
    want = [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=use_gbm, depth=depth, lr=lr, **statics)]
    _bitwise(got, want)
    assert args["alive"][got[0]].all()             # dead never chosen
    assert not _tickets(cuda_device).any()


# (world, mode, budget filter) of the card cases of the affinity factors
# over the grid
AFF_GRID_CASES = {
    "I16_R8": (dict(K=1, R=8, I=16), "full", True),
    **{f"I1024_{m}": (dict(K=1, R=16, I=1024), m, True)
       for m in ("full", "off_reactive")},
    "I16384_K2": (dict(K=2, R=16, I=16384), "full", True),
    "I4097_nofilter": (dict(K=1, R=16, I=4097), "full", False),
}


def _aff_world(world, seed=41):
    """`_dyadic_world` with the term's inputs made to reach every branch
    of the hit: every third instance's plane fully filled and holding a
    row's eight signatures (a full run), a row with no signature, rows
    whose signatures end early in a 0, and signatures in no plane."""
    rng = np.random.default_rng(seed)
    args = _dyadic_world(seed, T=4, aff=True, **world)
    K, R, I = world["K"], world["R"], world["I"]
    psig, plane = args["psig"], args["sig_plane"]
    psig[:, 0, :] = 0                            # no signature at all
    psig[:, 1, 3:] = 0                           # a short prompt
    psig[:, 2, 0] = 2 ** 31 - 1                  # in no plane
    for i in range(0, I, 3):
        w, r = rng.integers(K), rng.integers(3, R)
        plane[i] = rng.integers(1, 2 ** 31 - 1, plane.shape[1])
        plane[i, rng.permutation(plane.shape[1])[:8]] = psig[w, r]
        plane[i][plane[i] == 0] = 1              # a 0 of psig ends a run
    args["alive"] = (np.arange(I) < I - 24) if I == 1024 else (
        np.arange(I) % 7 != 3)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(AFF_GRID_CASES))
def test_kernel_affinity_over_the_grid_is_bitwise(cuda_device, case):
    """The prefix-affinity factors written by the grid's slices before
    stage 1 (w_aff 0.35) and read by the scan, one float a column: every
    output bitwise the plain version's. At I = 16, R = 8 the warp scan
    reads them and the grid has more CTAs than instances; at I = 1,024
    (the shared carry) the last 24 instances are dead pads, in `full` and
    an off mode; at I = 16,384 two windows read their own factor rows on
    the cluster carry; at I = 4,097 the budget filter is off."""
    world, mode, budget_filter = AFF_GRID_CASES[case]
    args = _aff_world(world)
    gbm, depth, lr = _forest(4, 60, 3, seed=2)
    statics = _statics(mode=mode, budget_filter=budget_filter, w_aff=0.35)
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, True, device=cuda_device, **statics)
    assert mk.decision_megakernel.launches == launches + 1
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + list(gbm)]
    want = [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=True, depth=depth, lr=lr, **statics)]
    _bitwise(got, want)
    assert args["alive"][got[0]].all()             # dead never chosen
    assert not _tickets(cuda_device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("I, R, trees, depth, aff, budget_filter", [
    (16, 8, 1024, 8, False, True), (16384, 16, 60, 3, False, True),
    (16, 8, 1024, 8, True, False), (1024, 16, 60, 3, True, True),
    (16384, 16, 60, 3, True, False)],
    ids=["I16", "I16384", "I16-aff-nofilter", "I1024-aff",
         "I16384-aff-nofilter"])
def test_kernel_timers(cuda_device, I, R, trees, depth, aff, budget_filter):
    """K1's `%globaltimer` stamps: the outputs are bitwise the same with
    `timers` set and null, also with the affinity term on and without the
    budget filter (where a traced call adds a barrier after pass A); each
    call's stamps rise (entry, the end of the grid's last tree slice, the
    start of the scan, the end of the greedy loop) and its pass A time
    lies inside its scan; and over calls queued back to
    back behind a spin, the stamps' spans sum to within 5% of the calls'
    CUDA event time. The index is the main path's size (14,886 x 128);
    at I = 16 a deep forest makes each call long enough for launch gaps
    of a microsecond or two to stay inside the 5%."""
    args = _dyadic_world(21, K=1, R=R, E=128, N=14886, M=16, I=I, T=16,
                         aff=aff)
    args["alive"] = np.arange(I) % 7 != 3
    gbm, depth, lr = _forest(16, trees, depth)
    ts = [torch.as_tensor(np.array(a), device=cuda_device)
          for a in list(args.values()) + gbm]
    kw = dict(use_gbm=True, depth=depth, lr=lr,
              **_statics(budget_filter=budget_filter,
                         w_aff=0.35 if aff else 0.0))
    n = 6
    timers = torch.zeros((n, 5), dtype=torch.int64, device=cuda_device)
    bare = mk.decision_megakernel(*ts, **kw)
    stamped = mk.decision_megakernel(*ts, **kw, timers=timers[0])
    for a, b in zip(bare, stamped):
        np.testing.assert_array_equal(a.cpu().numpy().view(np.int32),
                                      b.cpu().numpy().view(np.int32))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)           # the launches queue behind it
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for j in range(n):
        mk.decision_megakernel(*ts, **kw, timers=timers[j])
    stop.record()
    torch.cuda.synchronize()
    t = timers.cpu().numpy()
    assert (np.diff(t[:, :4], axis=1) >= 0).all() and (t[:, 3] > t[:, 0]).all()
    assert ((t[:, 4] >= 0) & (t[:, 4] <= t[:, 3] - t[:, 2])).all(), t
    assert I <= 32 or (t[:, 4] > 0).all()    # the block scan's steps
    stamps_ms = float((t[:, 3] - t[:, 0]).sum()) * 1e-6
    event_ms = start.elapsed_time(stop)
    assert abs(stamps_ms - event_ms) <= 0.05 * event_ms, (stamps_ms,
                                                           event_ms)


def _plain_on_card(args, gbm, depth, lr, use_gbm, dev, **statics):
    ts = [torch.as_tensor(np.array(a), device=dev)
          for a in list(args.values()) + list(gbm)]
    return [o.cpu().numpy() for o in mk.decision_megakernel_plain(
        *ts, use_gbm=use_gbm, depth=depth, lr=lr, **statics)]


# (world, statics, C) of the card cases of the cluster carry: every
# latency mode, the term on and off, K = 1 and 2, R = 1 to 128, the
# budget filter with no row admitted, LPT and the filter off
CLUSTER_CASES = {
    "I4097_K2_R16": (dict(K=2, R=16, I=4097), dict(), 8),
    "I4097_K1_R64_aff": (dict(K=1, R=64, I=4097), dict(w_aff=0.35), 8),
    "I8192_K1_R64_off_reactive": (dict(K=1, R=64, I=8192),
                                  dict(mode="off_reactive"), 8),
    "I8192_K2_R16_aff_off_predictive": (
        dict(K=2, R=16, I=8192), dict(mode="off_predictive", w_aff=0.35),
        8),
    "I8192_K1_R16_nolpt": (dict(K=1, R=16, I=8192), dict(lpt=False), 8),
    "I16384_K2_R16_aff": (dict(K=2, R=16, I=16384), dict(w_aff=0.35), 16),
    "I16384_K1_R1": (dict(K=1, R=1, I=16384), dict(), 16),
    "I16384_K1_R128_static_prior": (dict(K=1, R=128, I=16384),
                                    dict(mode="static_prior"), 16),
    "I16384_K1_R64_off_reactive_aff": (
        dict(K=1, R=64, I=16384), dict(mode="off_reactive", w_aff=0.35),
        16),
    "I16384_K2_R16_nofilter": (dict(K=2, R=16, I=16384),
                               dict(budget_filter=False), 16),
    "I16384_K1_R16_none_admitted": (dict(K=1, R=16, I=16384), dict(), 16),
    "I4097_K1_R16_none_admitted_off_reactive": (
        dict(K=1, R=16, I=4097), dict(mode="off_reactive"), 8),
}


def _cluster_world(case):
    """A case's inputs: dyadic embeddings (with signatures that reach
    every branch of the affinity hit where the term is on), every
    seventh instance dead and the last 24 dead pad columns, as the hot
    path pads its roster; where no row is admitted, budgets below any
    cost, so that each step takes the cheapest instance (the `cs_i`
    path)."""
    world, statics, C = CLUSTER_CASES[case]
    statics = dict(statics)
    aff = statics.get("w_aff", 0.0) > 0.0
    args = (_aff_world(world) if aff
            else _dyadic_world(51, T=4, **world))
    I = world["I"]
    args["alive"] = (np.arange(I) % 7 != 3) & (np.arange(I) < I - 24)
    if world["R"] == 1:
        args["row_valid"][:] = True              # the window's one row
    if "none_admitted" in case:
        args["budgets"] = np.full_like(args["budgets"], 1e-30)
    use_gbm = statics.get("mode") != "static_prior"
    gbm, depth, lr = _forest(4, 60, 3, seed=2) if use_gbm else _gbm(False)
    return args, (gbm, depth, lr, use_gbm), _statics(**statics), C


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_cluster_carry_is_bitwise_the_plain_version(cuda_device, case):
    """Past MAX_SHARED_I the scan runs on a cluster of C CTAs, each holding
    its slice of the columns in shared memory: one launch, every output
    bitwise the plain version's, no dead or pad column chosen, every
    ticket left at 0."""
    args, (gbm, depth, lr, use_gbm), statics, C = _cluster_world(case)
    world = CLUSTER_CASES[case][0]
    assert mk.carry_on(cuda_device, world["K"], world["R"], 8, 3,
                       world["I"]) == ("cluster", C)
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, use_gbm, device=cuda_device,
                **statics)
    assert mk.decision_megakernel.launches == launches + 1
    _bitwise(got, _plain_on_card(args, gbm, depth, lr, use_gbm,
                                 cuda_device, **statics))
    assert args["alive"][got[0]].all()             # dead never chosen
    assert not _tickets(cuda_device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["I4097_K2_R16", "I8192_K1_R64_off_reactive",
                                  "I16384_K2_R16_aff",
                                  "I16384_K1_R16_none_admitted"])
def test_cluster_carry_is_bitwise_the_global_carry(cuda_device, case,
                                                   monkeypatch):
    """The same inputs with the global carry forced (no cluster allowed):
    every output bitwise the cluster carry's."""
    args, (gbm, depth, lr, use_gbm), statics, _ = _cluster_world(case)
    world = CLUSTER_CASES[case][0]
    cluster = _port(args, gbm, depth, lr, use_gbm, device=cuda_device,
                    **statics)
    monkeypatch.setattr(mk, "MAX_CLUSTER", 1)
    assert mk.carry_on(cuda_device, world["K"], world["R"], 8, 3,
                       world["I"]) == ("global", 1)
    _bitwise(cluster, _port(args, gbm, depth, lr, use_gbm,
                            device=cuda_device, **statics))


@pytest.mark.cuda
def test_roster_past_the_cluster_reach_takes_the_global_carry(cuda_device):
    """One instance past MAX_CLUSTER x MAX_SHARED_I the wrapper launches
    once on the global carry, bitwise the plain version."""
    I = mk.MAX_CLUSTER * mk.MAX_SHARED_I + 1
    assert mk.carry_on(cuda_device, 1, 16, 8, 3, I) == ("global", 1)
    args = _dyadic_world(61, K=1, R=16, I=I)
    args["alive"] = np.arange(I) % 7 != 3
    gbm, depth, lr = _gbm(True)
    launches = mk.decision_megakernel.launches
    got = _port(args, gbm, depth, lr, True, device=cuda_device, **_statics())
    assert mk.decision_megakernel.launches == launches + 1
    _bitwise(got, _plain_on_card(args, gbm, depth, lr, True, cuda_device,
                                 **_statics()))


@pytest.mark.cuda
def test_scan_smem_bytes_is_the_kernels(cuda_device):
    """The wrapper's count of the scan's shared memory, which `carry_of`
    reads, is the kernel's own where the scan's need is the larger."""
    lib = mk._library()
    for R, M, cols in ((16, 16, 4096), (128, 16, 2048), (64, 3, 1024)):
        want = max(mk.scan_smem_bytes(R, M, cols),
                   lib.rt_decision_smem(8, 128, 1, 1, 0))
        assert lib.rt_decision_smem(8, 128, R, M, cols) == want
