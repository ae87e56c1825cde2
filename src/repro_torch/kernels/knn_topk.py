"""The KNN index lookup as one kernel call: for each query row, the k
nearest index rows by squared L2 distance, ascending.

Port of `repro.kernels.knn_topk` (lines 26-106; oracle
`repro.kernels.ref.knn_topk_ref`). The Pallas kernel becomes
`csrc/knn_topk.cu`, hand-written CUDA for sm_90a (its header says how
it is laid out and what bounds it); `knn_topk` is its wrapper:

  * it checks device, dtype, shape, contiguity and 16-byte alignment
    (the kernel reads float4 rows) on every call, and raises on anything
    the kernel does not take;
  * on CUDA tensors it launches the kernel on the current stream and
    raises on a nonzero `cudaError_t` — there is no fallback;
  * on CPU tensors it runs `knn_topk_plain`, the same function in plain
    torch, which the CPU tests hold against the Pallas kernel.

The distance is the TPU kernel's association, d2 = (|q|^2 + |x|^2) -
2 q.x; the norms are taken in the input dtype and then cast to float32,
as the reference does for bf16 input (`xsq` may be passed precomputed,
which saves reading the index twice). Results are ordered by (distance,
index). The Pallas kernel's replace-worst merge can keep a later index
over an earlier one among exactly equal distances at the k-th place;
this port keeps the lower index (see ROADMAP queue 3).

`knn_topk.launches` counts calls that went to the kernel (one
__global__ function each), `knn_topk.plain_calls` those that went to
the plain version. On float32 input the wrapper launches nothing else
and allocates only the two outputs: |q|^2 is summed in the kernel, and
the kernel's scratch (per-split candidates and one ticket per row tile)
is allocated once per (device, stream) and grown on demand.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import smem_limit

MAX_K = 32              # one lane per neighbour in the merges
COLS = 64               # index columns per tile of K2


# (largest batch, row tile, index tiles per split): the fastest layout
# per batch in `tools/knn_tile_sweep.py`'s sweep on an H100 (PERF.md,
# section 5); row tiles are those csrc/knn_topk.cu is built for
LAYOUTS = ((1, 1, 1), (2, 2, 1), (4, 4, 1), (12, 4, 2), (24, 8, 2),
           (64, 8, 4), (128, 8, 8), (None, 32, 8))


def _layout(B: int):
    return next((rt, per) for b, rt, per in LAYOUTS if b is None or B <= b)


def row_tile(B: int) -> int:
    """Query rows per CTA of K2 at batch B."""
    return _layout(B)[0]


def knn_splits(B: int, n_index: int):
    """(S splits, tiles per split) of K2's index at batch B, each split
    whole 64-column tiles: 233 splits of one tile at B <= 4 and
    N = 14,886, fewer and longer as B grows, since the last CTA of a row
    tile merges S lists for each of its rows."""
    n_ct = -(-n_index // COLS)
    per = min(_layout(B)[1], n_ct)
    return -(-n_ct // per), per


def _norms(q, x, xsq):
    """(q, qsq, x, xsq) in float32, the norms summed in the input dtype
    and cast afterwards (reference lines 80-81, 101-102)."""
    qsq = (q * q).sum(1).float()
    if xsq is None:
        xsq = (x * x).sum(1).float()
    return q.float(), qsq, x.float(), xsq


def knn_topk_plain(q: torch.Tensor, x: torch.Tensor, k: int = 10,
                   xsq: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, on any device: all N
    distances, then a stable sort (ties by index). Returns (d2 (B, k)
    float32, idx (B, k) int32)."""
    qf, qsq, xf, xsq = _norms(q, x, xsq)
    d2 = (qsq[:, None] + xsq[None, :]) - 2.0 * (qf @ xf.T)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    return d2s[:, :k].contiguous(), order[:, :k].to(torch.int32)


def _validate(q, x, k, xsq):
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q must be (B, E) and x (N, E), got "
                         f"{tuple(q.shape)} and {tuple(x.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or x.dtype != q.dtype:
        raise TypeError(f"q and x must both be float32 or both bfloat16, "
                        f"got {q.dtype} and {x.dtype}")
    if x.device != q.device:
        raise ValueError(f"x is on {x.device}, q on {q.device}")
    (B, E), N = q.shape, x.shape[0]
    if B < 1:
        raise ValueError("q has no rows")
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"k={k} outside [1, min({MAX_K}, N={N})]")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("q and x must be contiguous")
    # bf16 input is cast to fresh float32 tensors before the launch
    if E % 4 or (q.dtype == torch.float32
                 and (q.data_ptr() % 16 or x.data_ptr() % 16)):
        raise ValueError("the kernel reads rows as float4: E must be a "
                         "multiple of 4 and q, x 16-byte aligned")
    if xsq is not None:
        if xsq.dtype != torch.float32 or tuple(xsq.shape) != (N,):
            raise ValueError(f"xsq must be float32 of shape ({N},)")
        if xsq.device != q.device or not xsq.is_contiguous():
            raise ValueError("xsq must be contiguous, on q's device")


_lib = None
_scratch = {}           # (device, stream) -> (cand_d, cand_i, tickets)


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("knn_topk")
        lib.rt_knn_topk.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p] * 6)
        lib.rt_knn_topk.restype = ctypes.c_int
        lib.rt_knn_topk_smem.argtypes = [ctypes.c_int] * 2
        lib.rt_knn_topk_smem.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _scratch_for(dev, stream, n_cand: int, n_tiles: int):
    """The kernel's scratch on this (device, stream), grown to hold
    `n_cand` candidates and `n_tiles` tickets. The tickets start at 0 and
    every launch leaves them at 0; calls on one stream run in order."""
    key = (dev.index, stream)
    have = _scratch.get(key)
    if have is None or have[0].numel() < n_cand or have[2].numel() < n_tiles:
        n_cand = max(n_cand, have[0].numel() if have else 0)
        n_tiles = max(n_tiles, have[2].numel() if have else 0)
        have = _scratch[key] = (
            torch.empty(n_cand, dtype=torch.float32, device=dev),
            torch.empty(n_cand, dtype=torch.int32, device=dev),
            torch.zeros(n_tiles, dtype=torch.int32, device=dev))
    return have


def _launch(q, x, k, xsq):
    lib = _library()
    (B, E), N = q.shape, x.shape[0]
    RT, limit = row_tile(B), smem_limit(q.device)
    if lib.rt_knn_topk_smem(RT, E) > limit:
        raise ValueError(f"E={E} needs more shared memory than a block "
                         f"has ({limit} B)")
    qsq = None                           # float32: |q|^2 in the kernel
    if q.dtype != torch.float32:         # the reference's bf16 norms
        q, qsq, x, xsq = _norms(q, x, xsq)
    elif xsq is None:
        xsq = (x * x).sum(1)
    dev = q.device
    S, per = knn_splits(B, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cand_d, cand_i, tickets = _scratch_for(dev, stream, B * S * k,
                                           -(-B // RT))
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    err = lib.rt_knn_topk(
        q.data_ptr(), None if qsq is None else qsq.data_ptr(), x.data_ptr(),
        xsq.data_ptr(), B, N, E, k, RT, S, per, cand_d.data_ptr(),
        cand_i.data_ptr(), tickets.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk launch failed: cudaError {err}")
    return out_d, out_i


def knn_topk(q: torch.Tensor, x: torch.Tensor, k: int = 10,
             xsq: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, E), x (N, E), both float32 or both bfloat16; optional xsq
    (N,) float32 = |x|^2. Returns (d2 (B, k) float32, idx (B, k) int32)
    ascending: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors (see the module docstring)."""
    _validate(q, x, k, xsq)
    if q.device.type == "cuda":
        out = _launch(q, x, k, xsq)
        knn_topk.launches += 1
        return out
    if q.device.type == "cpu":
        knn_topk.plain_calls += 1
        return knn_topk_plain(q, x, k, xsq)
    raise ValueError(f"no knn_topk kernel for device {q.device}")


knn_topk.launches = 0
knn_topk.plain_calls = 0


def reset_counts():
    knn_topk.launches = 0
    knn_topk.plain_calls = 0
