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
    """A roster of MAX_SHARED_I + 1 instances (the kernel's global carry
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
    # K = 2 windows of R = 64 rows (8-row tiles, 30 splits), M = 4, k = 10
    assert mk.scratch_sizes(2, 64, 4, 10, 14886, 16, True) == (
        128 * 30 * 10, 16 + 2, 128 * 9, 0)
    # the main path's bucket: one window of 8 rows in 4-row tiles
    assert mk.scratch_sizes(1, 8, 4, 10, 14886, 16, True) == (
        8 * 117 * 10, 2 + 1, 8 * 9, 0)
    # the global carry: four I-length arrays per window (32 rows take
    # 8-row tiles and 59 splits)
    assert mk.scratch_sizes(2, 16, 4, 10, 14886, 16384, False) == (
        32 * 59 * 10, 4 + 2, 32 * 9, 2 * 4 * 16384)
    assert mk.scratch_sizes(1, 16, 4, 10, 14886, 4096, True)[3] == 0


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
    wrapper launches once, on the global carry, and matches the plain
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
    the shared carry's largest (I = 4096) and the global carry (I = 4097
    and 16,384, K = 2 windows, each with its own scratch rows): exact
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


@pytest.mark.cuda
def test_kernel_calls_in_a_row_agree(cuda_device):
    """The tickets reset themselves: a second call on the same stream,
    after a call at another shape, repeats the first exactly."""
    gbm, depth, lr = _gbm(True)
    a1 = _dyadic_world(12, K=2, R=8)
    a2 = _dyadic_world(13, K=1, R=64)
    first = _port(a1, gbm, depth, lr, True, device=cuda_device, **_statics())
    _port(a2, gbm, depth, lr, True, device=cuda_device, **_statics())
    again = _port(a1, gbm, depth, lr, True, device=cuda_device, **_statics())
    for g, h in zip(first, again):
        np.testing.assert_array_equal(g, h)
