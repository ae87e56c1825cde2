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

`knn_topk.launches` counts calls that went to the kernel (each starts
two __global__ functions), `knn_topk.plain_calls` those that went to
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MAX_K = 32              # one lane per neighbour in the merges
MAX_SPLITS = 32         # one lane per index split in the merge
SMEM_LIMIT = 232448     # bytes of shared memory a block may use (sm_90)


def n_splits(rows: int, n_index: int, device) -> int:
    """Index splits of the partial top-k pass: enough CTAs for two waves
    over the SMs, at most one per merge lane, and no split narrower than
    the 32 columns a warp takes at a time."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-rows // 8)
    want = -(-2 * sms // tiles)
    return max(1, min(MAX_SPLITS, want, -(-n_index // 32)))


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


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("knn_topk")
        lib.rt_knn_topk.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p] * 5)
        lib.rt_knn_topk.restype = ctypes.c_int
        lib.rt_knn_topk_smem.argtypes = [ctypes.c_int]
        lib.rt_knn_topk_smem.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _launch(q, x, k, xsq):
    lib = _library()
    qf, qsq, xf, xsq = _norms(q, x, xsq)
    (B, E), N = qf.shape, xf.shape[0]
    if lib.rt_knn_topk_smem(E) > SMEM_LIMIT:
        raise ValueError(f"E={E} needs more shared memory than a block "
                         f"has ({SMEM_LIMIT} B)")
    dev = q.device
    S = n_splits(B, N, dev)
    cand_d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_knn_topk(qf.data_ptr(), qsq.data_ptr(), xf.data_ptr(),
                          xsq.data_ptr(), B, N, E, k, S, cand_d.data_ptr(),
                          cand_i.data_ptr(), out_d.data_ptr(),
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
