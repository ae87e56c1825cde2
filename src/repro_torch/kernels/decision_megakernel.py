"""The whole RouteBalance per-batch decision as one kernel call: KNN top-k
-> packed-GBM TPOT heads -> Eq. 2 admission (+ prefix affinity) -> LPT
greedy scan with dead reckoning, for K scheduler windows at once.

Port of `repro.kernels.decision_megakernel` (lines 72-362; numpy oracle
`repro.kernels.ref.decision_ref`). The Pallas kernel becomes
`csrc/decision_megakernel.cu`, hand-written CUDA for sm_90a (its header
says how it is laid out and what bounds it); `decision_megakernel` is
its wrapper, with the reference's signature and statics (the TPU-only
`knn_tile`/`topk_mode`/`interpret` aside):

  * on CUDA tensors it validates device, dtype, shape and contiguity,
    launches the kernel on the current stream and raises on any CUDA
    error — there is no fallback;
  * on CPU tensors it runs `decision_megakernel_plain`, the same
    function written with the port's plain torch stages, which is what
    the CPU tests hold against the JAX reference.

`decision_megakernel.launches` counts calls that went to the kernel
(one per decided batch, one `__global__` function, `decision_fused`,
each), `decision_megakernel.plain_calls` those that went to the plain
version. `decision_megakernel.tap`, None unless a caller sets it, is
called with each call's (args, statics) before the call runs, so that a
check can record the arguments the serving path passes and hold the
kernel against its plain version on them afterwards. Stage 1 takes its
layout (row tile and index splits) for the K * R rows from the KNN
lookup's measured table (`layout`); the kernel's scratch (split lists,
tickets, the rows' label mixes, the TPOT heads and the global carry's
per-instance arrays) lives per (device, stream), allocated once and
grown on demand, so a call allocates only its outputs and launches
nothing else. The TPOT heads are walked by the whole grid before stage 1,
as many CTAs as the roster needs at 8 instances a CTA (csrc header), and
with the affinity term on (`w_aff > 0`) the same warps write each
instance's discount factor for every row; the CTA that scans a window
reads both from scratch. With the term off the factors' scratch is not
allocated.

Any roster size I is taken. `carry_of` chooses where the scan keeps its
per-instance arrays, from the shapes alone (csrc/decision_megakernel.cu
says how each runs): up to `MAX_SHARED_I` instances, where they fit, in
one CTA's shared memory (the shared carry; one warp scans at I <= 32);
past that, up to `MAX_CLUSTER` x `MAX_SHARED_I`, spread over the shared
memory of a thread-block cluster of C CTAs (the cluster carry: the
smallest C that leaves a CTA at most `CLUSTER_COLS` columns, else the
largest); else in the outputs and in scratch (the global carry). The
three are bitwise equal. `carry_on` narrows the cluster where the
device cannot hold one of C CTAs at once. The wrapper raises only when
even the R-length arrays do not fit in a block's shared memory.

Per-window args carry a leading K axis — emb (K, R, E), row_valid
(K, R) bool, budgets/len_in (K, R) float32, psig (K, R, SIG_WIDTH)
int32 (any int32 dummy when `w_aff == 0`). The telemetry mirror
d/b/free/ctx (I,) float32 + alive (I,) bool and every estimator constant
are shared by the windows. GBM args may be `dummy_gbm()` when
`use_gbm` is False; neither path reads dummies. Returns (choice (K, R)
int32, est_T (K, R), l_chosen (K, R), d1/b1/f1 (K, I) post-scan state),
float32.

`timers`, a keyword the kernel alone reads (None by default, which is
what every untraced call passes), is an int64 CUDA tensor of at least
1 + 4 K elements: the kernel writes `%globaltimer` into it at its entry
(thread 0 of block (0, 0)); at 1 + 4w, for every window w, the end of
the last slice of TPOT trees and affinity factors over the grid (the
same stamp in each); at 2 + 4w the start of window w's scan, the end of
stage 1 for it; at 3 + 4w the end of its greedy loop, by the CTA that
scans the window (rank 0 of the cluster on the cluster carry); and at
4 + 4w a duration, not a stamp: the sum over the loop's steps of pass A
(each step's start to the end of its admission reduction: cost, latency
with its affinity factor read, and Eq. 2 over every instance). Nothing
else reads the buffer, so the
outputs are the same with and without it; the plain version has no
stamps and the tap does not see the keyword.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.decision import LATENCY_MODES, greedy_scan, lpt_admission
from ..estimators.gbm import predict_packed_gathered
from ..estimators.knn import topk_soft_lookup
from ..serving.affinity import hit_fraction
from .build import scratch, smem_limit
from .knn_topk import knn_splits, row_tile

# Largest roster the scan carries in one CTA's shared memory. A measured
# choice, not the hardware's limit (the shared carry still fits at I =
# 8,192 for R <= 16): chip_smoke.py's carry boundary times the carries on
# the same inputs, and the global one is the faster at I = 8,192, while
# at 4,096 the shared one is the faster for R >= 16 (PERF.md section 6).
MAX_SHARED_I = 4096
# The cluster carry: clusters of 2 to MAX_CLUSTER CTAs (16, the H100's
# non-portable limit), the smallest that leaves a CTA at most
# CLUSTER_COLS columns (PERF.md section 6 times C = 8 against 16); the
# windows a call completes are a bit each of a 32-bit word.
MAX_CLUSTER = 16
CLUSTER_COLS = 1024
MAX_CLUSTER_WINDOWS = 32
MAX_K_NEIGHBOURS = 32   # one lane per neighbour in the merge


def layout(rows: int, n_index: int) -> Tuple[int, int, int]:
    """(row tile, splits, 64-column tiles per split) of stage 1 over
    `rows` = K * R query rows: the KNN lookup's measured layout at that
    batch (`kernels.knn_topk.LAYOUTS`)."""
    return (row_tile(rows), *knn_splits(rows, n_index))


def scan_smem_bytes(R: int, M: int, cols: int) -> int:
    """Shared-memory bytes of the scan of R rows over M models with `cols`
    per-instance columns in a CTA's shared memory (I on the shared carry,
    ceil(I / C) on the cluster carry, 0 on the global one): the
    kernel's `scan_smem_words`, four bytes a word."""
    return 4 * (2 * R * M + 7 * R + 7 * cols + 96)


def carry_of(K: int, I: int, R: int, M: int, limit: int,
             c_max: int = MAX_CLUSTER) -> Tuple[str, int]:
    """(kind, C) of the scan of K windows of R rows over I instances, M
    models, with `limit` bytes of shared memory a block and clusters of at
    most `c_max` CTAs: ("warp", 1) at I <= 32 and ("shared", 1) up to
    `MAX_SHARED_I` where the arrays fit; past that ("cluster", C) for the
    smallest C in 2, 4, ..., c_max that leaves a CTA at most
    `CLUSTER_COLS` columns, else the largest, while a CTA holds at most
    `MAX_SHARED_I` columns, the slices fit and K <= 32; else ("global",
    1)."""
    if I <= MAX_SHARED_I:
        if scan_smem_bytes(R, M, I) <= limit:
            return ("warp" if I <= 32 else "shared"), 1
        return "global", 1
    if K <= MAX_CLUSTER_WINDOWS and I <= c_max * MAX_SHARED_I:
        C = 2
        while C <= c_max:
            cols = -(-I // C)
            if ((cols <= CLUSTER_COLS or 2 * C > c_max)
                    and cols <= MAX_SHARED_I
                    and scan_smem_bytes(R, M, cols) <= limit):
                return "cluster", C
            C *= 2
    return "global", 1


def scratch_sizes(K: int, R: int, M: int, k: int, n_index: int, I: int,
                  carry: str, use_aff: bool
                  ) -> Tuple[int, int, int, int, int]:
    """(split-list entries, tickets, label-mix floats, per-instance
    floats, affinity factors) of the kernel's scratch for K windows of R
    rows over I instances on the carry of kind `carry` (`carry_of`): k
    candidates per row and split, one ticket per row tile, per window and
    for the trees, each row's two label mixes (M each) and LPT key, and
    the TPOT heads (I), with the global carry also b0 (I) and per window a
    step's cost and latency (2 I; the carry itself lives in the outputs);
    with the affinity term on, each row's factor on each instance (K R I),
    else none."""
    rt, S, _ = layout(K * R, n_index)
    return (K * R * S * k, -(-K * R // rt) + K + 1, K * R * (2 * M + 1),
            (2 + 2 * K) * I if carry == "global" else I,
            K * R * I if use_aff else 0)


def dummy_gbm() -> Tuple[torch.Tensor, ...]:
    """1-element placeholder GBM operands for `use_gbm=False` calls."""
    return (torch.zeros((1, 1, 1), dtype=torch.int32),
            torch.zeros((1, 1, 1), dtype=torch.float32),
            torch.zeros((1, 1, 1), dtype=torch.float32),
            torch.zeros(1, dtype=torch.float32))


# -- plain version -------------------------------------------------------------

def decision_megakernel_plain(emb, row_valid, budgets, len_in, psig,
                              d, b, free, ctx, alive,
                              x, xsq, qual, leng,
                              m_of_i, tier_of_i, maxb, price_in, price_out,
                              nominal, sig_plane, gfeat, gthr, gleaf, gbase,
                              *, k, eps, weights, latency_mode, lpt,
                              budget_filter, w_aff, use_gbm, depth, lr):
    """The kernel's function in plain torch, stage by stage, on any
    device: the KNN lookup, the packed GBM, Eq. 2 admission, the
    affinity hit and the greedy scan of the port's core modules."""
    K = emb.shape[0]
    m_idx = m_of_i.long()
    # the state-dependent TPOT is window-invariant: every window scans
    # from the same telemetry snapshot
    b_eff = torch.clamp_min(b, 1.0)
    ctx_eff = torch.clamp_min(ctx, 64.0)
    if use_gbm:
        feats = torch.stack([b_eff, d, ctx_eff, b_eff * ctx_eff], dim=1)
        stacked = {"feature": gfeat, "threshold": gthr, "leaf": gleaf,
                   "base": gbase, "lr": lr, "depth": depth}
        tpot = torch.clamp_min(
            predict_packed_gathered(stacked, tier_of_i.long(), feats), 1e-4)
    else:
        tpot = nominal
    outs = ([], [], [], [], [], [])
    for wi in range(K):
        rv = row_valid[wi]
        qmix, lmix = topk_soft_lookup(emb[wi], x, xsq, qual, leng, k, eps)
        q_inst, l_inst = qmix[:, m_idx], lmix[:, m_idx]
        pred_len_max = torch.where(rv, lmix.amax(dim=1), -1e30)
        order, allowed, c_hat = lpt_admission(
            pred_len_max, l_inst, budgets[wi], len_in[wi], price_in,
            price_out, lpt, budget_filter, valid=alive)
        aff = None
        if w_aff > 0.0:
            hit = hit_fraction(psig[wi], len_in[wi], sig_plane)
            aff = w_aff * torch.where(alive[None, :], hit, 0.0)
        choice, est_T, (d1, b1, f1) = greedy_scan(
            order, q_inst, c_hat, l_inst, tpot, nominal, d, b_eff, free,
            maxb, weights, allowed, latency_mode, row_valid=rv,
            affinity=aff)
        l_chosen = l_inst.gather(1, choice[:, None])[:, 0]
        for o, v in zip(outs, (choice.to(torch.int32), est_T, l_chosen,
                               d1, b1, f1)):
            o.append(v)
    return tuple(torch.stack(o) for o in outs)


# -- the kernel ------------------------------------------------------------------

class _Params(ctypes.Structure):
    """Mirror of `RtDecisionParams` in csrc/decision_megakernel.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "emb", "row_valid", "budgets", "len_in", "psig",
        "d", "b", "free_", "ctx", "alive",
        "x", "xsq", "qual", "leng",
        "m_of_i", "tier_of_i", "maxb", "price_in", "price_out", "nominal",
        "sig_plane", "gfeat", "gthr", "gleaf", "gbase",
        "cand_d", "cand_i", "tickets", "wtickets", "qmix", "lmix", "plm",
        "tpot", "scan_i", "aff", "choice", "est", "lchosen", "d1", "b1",
        "f1", "timers")]
        + [(n, ctypes.c_int) for n in (
            "K", "R", "E", "N", "M", "I", "k", "per_split", "sig_w",
            "sig_slots",
            "n_trees", "n_internal", "n_leaves", "depth",
            "mode", "lpt", "budget_filter", "use_gbm", "use_aff")]
        + [(n, ctypes.c_float) for n in (
            "eps", "wq", "wl", "wc", "w_aff", "lr")])


_lib = None
# (device, stream) -> (cand_d, cand_i, tickets, mixes, inst, aff)
_scratch = {}
# (device, row tile, C, dynamic shared bytes) -> clusters resident at once
_resident = {}


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("decision_megakernel")
        lib.rt_decision_megakernel.argtypes = [ctypes.POINTER(_Params),
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        lib.rt_decision_megakernel.restype = ctypes.c_int
        lib.rt_decision_smem.argtypes = [ctypes.c_int] * 5
        lib.rt_decision_smem.restype = ctypes.c_size_t
        lib.rt_decision_resident_clusters.argtypes = [ctypes.c_int,
                                                      ctypes.c_int,
                                                      ctypes.c_size_t]
        lib.rt_decision_resident_clusters.restype = ctypes.c_int
        _lib = lib
    return _lib


def carry_on(dev, K: int, R: int, E: int, M: int, I: int) -> Tuple[str, int]:
    """`carry_of` for a call on the CUDA device `dev`: its shared-memory
    limit, and the cluster halved until the device can hold one of C CTAs
    of that kernel at once (a global carry if none)."""
    lib, limit, RT = _library(), smem_limit(dev), row_tile(K * R)
    c_max = MAX_CLUSTER
    while True:
        kind, C = carry_of(K, I, R, M, limit, c_max)
        if kind != "cluster":
            return kind, C
        smem = lib.rt_decision_smem(RT, E, R, M, -(-I // C))
        key = (dev.index, RT, C, smem)
        if key not in _resident:
            with torch.cuda.device(dev):
                n = lib.rt_decision_resident_clusters(RT, C, smem)
            if n < 0:
                raise RuntimeError(f"decision_megakernel: cudaError {-n} "
                                   f"asking for clusters of {C}")
            _resident[key] = n
        if _resident[key] > 0:
            return kind, C
        c_max = C // 2


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(emb, row_valid, budgets, len_in, psig, d, b, free, ctx, alive,
            x, xsq, qual, leng, m_of_i, tier_of_i, maxb, price_in,
            price_out, nominal, sig_plane, gfeat, gthr, gleaf, gbase, *,
            k, eps, weights, latency_mode, lpt, budget_filter, w_aff,
            use_gbm, depth, lr, timers=None):
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    if emb.dim() != 3:
        raise ValueError(f"emb must be (K, R, E), got {tuple(emb.shape)}")
    K, R, E = emb.shape
    I = d.shape[0]
    N, M = qual.shape
    dev = emb.device
    args = dict(emb=emb, row_valid=row_valid, budgets=budgets,
                len_in=len_in, psig=psig, d=d, b=b, free=free, ctx=ctx,
                alive=alive, x=x, xsq=xsq, qual=qual, leng=leng,
                m_of_i=m_of_i, tier_of_i=tier_of_i, maxb=maxb,
                price_in=price_in, price_out=price_out, nominal=nominal,
                sig_plane=sig_plane, gfeat=gfeat, gthr=gthr, gleaf=gleaf,
                gbase=gbase)
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, emb on {dev}")
    if timers is not None:
        _check(timers, "timers", torch.int64)
        if timers.device != dev or timers.numel() < 1 + 4 * K:
            raise ValueError(f"timers must hold 1 + 4 K = {1 + 4 * K} "
                             f"int64 on {dev}")
    _check(emb, "emb", f32)
    _check(row_valid, "row_valid", u8, (K, R))
    for name in ("budgets", "len_in"):
        _check(args[name], name, f32, (K, R))
    for name in ("d", "b", "free", "ctx", "maxb", "price_in", "price_out",
                 "nominal"):
        _check(args[name], name, f32, (I,))
    _check(alive, "alive", u8, (I,))
    _check(m_of_i, "m_of_i", i32, (I,))
    _check(tier_of_i, "tier_of_i", i32, (I,))
    _check(x, "x", f32, (N, E))
    _check(xsq, "xsq", f32, (N,))
    _check(qual, "qual", f32, (N, M))
    _check(leng, "leng", f32, (N, M))
    if E % 4 or any(t.data_ptr() % 16 for t in (emb, x)):
        raise ValueError("the kernel reads emb and x as float4: E must be "
                         "a multiple of 4 and both 16-byte aligned")
    if not 1 <= k <= min(MAX_K_NEIGHBOURS, N):
        raise ValueError(f"k={k} outside [1, min({MAX_K_NEIGHBOURS}, N)]")
    if latency_mode not in LATENCY_MODES:
        raise ValueError(latency_mode)
    use_aff = w_aff > 0.0
    if use_aff:
        _check(psig, "psig", i32)
        _check(sig_plane, "sig_plane", i32)
        if psig.shape[:2] != (K, R) or sig_plane.shape[0] != I:
            raise ValueError("psig must be (K, R, W) and sig_plane (I, S)")
    n_trees = n_internal = n_leaves = 0
    if use_gbm:
        _check(gfeat, "gfeat", i32)
        _check(gthr, "gthr", f32, gfeat.shape)
        _check(gleaf, "gleaf", f32)
        _check(gbase, "gbase", f32, gfeat.shape[:1])
        _, n_trees, n_internal = gfeat.shape
        n_leaves = gleaf.shape[2]
        if n_internal != 2 ** depth - 1 or n_leaves != 2 ** depth:
            raise ValueError("GBM arrays do not match depth")
    lib = _library()
    RT, S, per = layout(K * R, N)
    kind, C = carry_on(dev, K, R, E, M, I)
    if scan_smem_bytes(R, M, 0) > smem_limit(dev):
        raise ValueError(f"(R={R}, M={M}) needs more shared memory than a "
                         f"block has ({smem_limit(dev)} B)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_cand, n_tickets, n_mix, n_inst, n_aff = scratch_sizes(
        K, R, M, k, N, I, kind, use_aff)
    cand_d, cand_i, tickets, mix, inst, aff = scratch(
        _scratch, dev, stream, ((n_cand, f32, False), (n_cand, i32, False),
                                (n_tickets, i32, True), (n_mix, f32, False),
                                (n_inst, f32, False), (n_aff, f32, False)))
    n_tiles = n_tickets - K - 1
    outs = (torch.empty((K, R), dtype=i32, device=dev),
            *(torch.empty((K, R), dtype=f32, device=dev) for _ in range(2)),
            *(torch.empty((K, I), dtype=f32, device=dev) for _ in range(3)))
    wq, wl, wc = (float(w) for w in weights)
    mix0 = mix.data_ptr()
    p = _Params(
        *(t.data_ptr() for t in args.values()), cand_d.data_ptr(),
        cand_i.data_ptr(), tickets.data_ptr(),
        tickets.data_ptr() + 4 * n_tiles, mix0, mix0 + 4 * K * R * M,
        mix0 + 8 * K * R * M, inst.data_ptr(),
        inst.data_ptr() + 4 * I if kind == "global" else None,
        aff.data_ptr() if use_aff else None,
        *(o.data_ptr() for o in outs),
        None if timers is None else timers.data_ptr(),
        K, R, E, N, M, I, k, per,
        psig.shape[2] if use_aff else 0,
        sig_plane.shape[1] if use_aff else 0,
        n_trees, n_internal, n_leaves, depth if use_gbm else 0,
        LATENCY_MODES.index(latency_mode), int(lpt), int(budget_filter),
        int(use_gbm), int(use_aff), eps, wq, wl, wc, w_aff, lr)
    err = lib.rt_decision_megakernel(ctypes.byref(p), RT, S, C, stream)
    if err != 0:
        raise RuntimeError(f"decision_megakernel launch failed: cudaError "
                           f"{err}")
    return outs


def decision_megakernel(emb, row_valid, budgets, len_in, psig,
                        d, b, free, ctx, alive,
                        x, xsq, qual, leng,
                        m_of_i, tier_of_i, maxb, price_in, price_out,
                        nominal, sig_plane, gfeat, gthr, gleaf, gbase,
                        *, k, eps, weights, latency_mode, lpt,
                        budget_filter, w_aff, use_gbm, depth, lr,
                        timers=None):
    """One decision call for K windows: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors (see the module docstring)."""
    args = (emb, row_valid, budgets, len_in, psig, d, b, free, ctx, alive,
            x, xsq, qual, leng, m_of_i, tier_of_i, maxb, price_in,
            price_out, nominal, sig_plane, gfeat, gthr, gleaf, gbase)
    kw = dict(k=k, eps=eps, weights=weights, latency_mode=latency_mode,
              lpt=lpt, budget_filter=budget_filter, w_aff=w_aff,
              use_gbm=use_gbm, depth=depth, lr=lr)
    if decision_megakernel.tap is not None:
        decision_megakernel.tap(args, kw)
    if emb.device.type == "cuda":
        out = _launch(*args, **kw, timers=timers)
        decision_megakernel.launches += 1
        return out
    if emb.device.type == "cpu":
        decision_megakernel.plain_calls += 1
        return decision_megakernel_plain(*args, **kw)
    raise ValueError(f"no decision kernel for device {emb.device}")


decision_megakernel.launches = 0
decision_megakernel.plain_calls = 0
decision_megakernel.tap = None


def reset_counts():
    decision_megakernel.launches = 0
    decision_megakernel.plain_calls = 0
