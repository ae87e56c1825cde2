"""Mamba-2 SSD chunked scan (forward) as one kernel call (K4).

Port of `repro.kernels.ssd_scan` (lines 26-108; oracles
`repro.kernels.ref.ssd_recurrent_ref` and the model's
`repro.models.blocks._ssd_chunked`). The Pallas kernel becomes
`csrc/ssd_scan.cu`, hand-written CUDA for sm_90a (its header says how it
is laid out and what bounds it); `ssd_scan` is its wrapper:

  * it checks device, dtype, shape and contiguity on every call and
    raises on anything the kernel does not take;
  * on CUDA tensors it launches the kernel on the current stream and
    raises on a nonzero `cudaError_t`: there is no fallback;
  * on CPU tensors it runs `ssd_scan_plain`, the same function in plain
    torch, which the CPU tests hold against the Pallas kernel.

The kernel is one `__global__` function, `ssd_scan_chunks`, one CTA per
(row, head, chunk): the chunks of a (row, head) pass the carried state
along a chain through a slot in device memory (see the source). Its
tiles take chunk <= 128, P <= 64 and N <= 128, P and N multiples of 4;
the wrapper refuses other shapes on either device, and on CUDA tensors
also a device whose blocks cannot have the kernel's shared memory (one
layout for every shape, two CTAs to an H100 SM). The
scratch (one P x N slot and one flag per (row, head), and the work
counter) lives per (device, stream), allocated once and grown on
demand; a call allocates only y and the final state.

B and C come grouped, (B, S, G, N) with nh % G == 0, and head h reads
group h // (nh / G): G = nh is the Pallas kernel's signature, and the
model passes its G groups without repeating them over the heads, which
is what `_ssd_chunked` does in effect (its `jnp.repeat`).

Per chunk of Q tokens and head, with cum the running sum of dt * A:
  y[q]  = sum_{k<=q} (C[q].B[k]) exp(cum[q]-cum[k]) dt[k] x[k]
          + (C[q] exp(cum[q])) . state
  state = state exp(cum[Q-1]) + sum_k (B[k] dt[k] exp(cum[Q-1]-cum[k])) x[k]
all in float32, y cast to x's dtype at the end (the Pallas kernel's
arithmetic, lines 34-72). The decay exp(cum[q] - cum[k]) is taken only
for k <= q: the Pallas body exponentiates the whole Q x Q block, whose
upper triangle can overflow before its `where`. The intra-chunk product
stays in float32 as in the Pallas kernel; `_ssd_chunked` rounds it to
x's dtype first (its line 287), so on bfloat16 input the model's two
paths round differently.

`ssd_scan.launches` counts calls that went to the kernel, and
`ssd_scan.plain_calls` those that went to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import scratch, smem_limit

SMEM_LIMIT = 232448     # bytes a block may opt in to on an H100 (sm_90)
SM_SMEM = 233472        # bytes of shared memory an H100 SM has
CTA_RESERVED = 1024     # bytes the runtime keeps per resident CTA
QT, PT, NT = 128, 64, 128   # csrc/ssd_scan.cu's tiles: chunk, P, N
NC = 32                 # state columns per streamed stage of C and B
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes() -> int:
    """Dynamic shared memory of the kernel, the same at every shape it
    takes (csrc/ssd_scan.cu computes the same): x as float32 (QT x PT),
    four per-token vectors, and a work area reused phase by phase, the
    largest of two C/B stages (QT x (NC + 4) each), M (QT x (QT + 4)),
    B (QT x NT), and S_in (NT x PT) with two C stages."""
    cs = NC + 4
    work = max(4 * QT * cs, QT * (QT + 4), QT * NT, NT * PT + 2 * QT * cs)
    return 4 * (QT * PT + 4 * QT + work)


def work_item(i: int, Bsz: int, nh: int) -> Tuple[int, int, int]:
    """(row, head, chunk) of the kernel's work id i, chunk slowest: the
    CTA holding id i waits only on id i - Bsz * nh (the same row and
    head, one chunk earlier), which drew its id first and so is running
    or done, and started about a wave earlier."""
    c, bh = divmod(i, Bsz * nh)
    b, h = divmod(bh, nh)
    return b, h, c


def scratch_sizes(Bsz: int, nh: int, P: int, N: int) -> Tuple[int, int]:
    """(float32 slot elements, int32 flags + counter) of the kernel's
    scratch: one P x N state slot and one flag per (row, head), and the
    work counter."""
    return Bsz * nh * P * N, Bsz * nh + 1


def check_smem(limit: int) -> None:
    """Raise unless a block may have the kernel's shared memory."""
    if smem_bytes() > limit:
        raise ValueError(f"the SSD scan kernel needs {smem_bytes()} B of "
                         f"shared memory; a block has {limit} B")


def ssd_scan_plain(xh, Bm, Cm, dt, A, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, on any device, one chunk at
    a time. Returns (y (B, S, nh, P) in xh's dtype, final state
    (B, nh, P, N) float32)."""
    Bsz, S, nh, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = nh // G
    Q = min(chunk, S)
    dev = xh.device
    state = torch.zeros((Bsz, nh, P, N), dtype=torch.float32, device=dev)
    y = torch.empty_like(xh)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    Af = A.float()
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq = xh[:, sl].float()                              # (B, Q, nh, P)
        Bq = Bm[:, sl].float().repeat_interleave(rep, dim=2)
        Cq = Cm[:, sl].float().repeat_interleave(rep, dim=2)
        dtq = dt[:, sl].float()                             # (B, Q, nh)
        cum = torch.cumsum((dtq * Af).transpose(1, 2), -1)  # (B, nh, Q)
        seg = cum[..., :, None] - cum[..., None, :]
        L = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
        scores = torch.einsum("bqhn,bkhn->bhqk", Cq, Bq)
        M = scores * L * dtq.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhqk,bkhp->bqhp", M, xq)
        y_inter = torch.einsum(
            "bqhn,bhpn->bqhp",
            Cq * torch.exp(cum).transpose(1, 2)[..., None], state)
        y[:, sl] = (y_intra + y_inter).to(xh.dtype)
        contrib = dtq * torch.exp(cum[..., -1:] - cum).transpose(1, 2)
        st = torch.einsum("bqhn,bqhp->bhpn", Bq * contrib[..., None], xq)
        state = state * torch.exp(cum[..., -1])[..., None, None] + st
    return y, state


def _validate(xh, Bm, Cm, dt, A, chunk):
    if xh.dim() != 4 or Bm.dim() != 4 or dt.dim() != 3 or A.dim() != 1:
        raise ValueError("xh must be (B, S, nh, P), Bm/Cm (B, S, G, N), "
                         "dt (B, S, nh) and A (nh,)")
    Bsz, S, nh, P = xh.shape
    G = Bm.shape[2]
    if (tuple(Bm.shape[:2]) != (Bsz, S) or tuple(Cm.shape) != tuple(Bm.shape)
            or tuple(dt.shape) != (Bsz, S, nh) or tuple(A.shape) != (nh,)):
        raise ValueError(f"shapes do not fit: xh {tuple(xh.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}")
    if G < 1 or nh % G:
        raise ValueError(f"nh={nh} is not a multiple of G={G}")
    if xh.dtype not in DTYPES:
        raise TypeError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    if any(t.dtype != torch.float32 for t in (Bm, Cm, dt, A)):
        raise TypeError("Bm, Cm, dt and A must be float32")
    if not all(t.device == xh.device for t in (Bm, Cm, dt, A)):
        raise ValueError("all inputs must share a device")
    if not all(t.is_contiguous() for t in (xh, Bm, Cm, dt, A)):
        raise ValueError("all inputs must be contiguous")
    Q = min(chunk, S)
    if S < 1 or S % Q:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q}: "
                         f"pad the sequence")
    N = Bm.shape[-1]
    if Q > QT or not 4 <= P <= PT or not 4 <= N <= NT or P % 4 or N % 4:
        raise ValueError(f"chunk {Q}, P={P}, N={N} outside the kernel's "
                         f"tiles: chunk <= {QT}, P <= {PT}, N <= {NT}, P "
                         f"and N multiples of 4")
    if xh.device.type == "cuda":
        check_smem(smem_limit(xh.device))
        if any(t.data_ptr() % 16 for t in (xh, Bm, Cm)):
            raise ValueError("xh, Bm and Cm must be 16-byte aligned (the "
                             "kernel reads them in 8- and 16-byte vectors)")


_lib = None
_scratch = {}           # (device, stream) -> (slots, flags + counter)


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("ssd_scan")
        lib.rt_ssd_scan.argtypes = ([ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 8
                                    + [ctypes.c_void_p] * 6)
        lib.rt_ssd_scan.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(xh, Bm, Cm, dt, A, chunk):
    lib = _library()
    Bsz, S, nh, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    y = torch.empty_like(xh)
    state = torch.empty((Bsz, nh, P, N), dtype=torch.float32,
                        device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    n_slot, n_flags = scratch_sizes(Bsz, nh, P, N)
    # the work counter is the flags' last int (it stays last as they grow)
    slots, flags = scratch(_scratch, xh.device, stream,
                           ((n_slot, torch.float32, False),
                            (n_flags, torch.int32, True)))
    err = lib.rt_ssd_scan(xh.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                          dt.data_ptr(), A.data_ptr(), Bsz, S, nh, P, G, N,
                          Q, DTYPES[xh.dtype], y.data_ptr(),
                          state.data_ptr(), slots.data_ptr(),
                          flags.data_ptr(),
                          flags.data_ptr() + 4 * (flags.numel() - 1), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    return y, state


def ssd_scan(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B, S, nh, P) float32 or bfloat16; Bm/Cm (B, S, G, N), dt
    (B, S, nh) and A (nh,) float32; S a multiple of min(chunk, S).
    Returns (y (B, S, nh, P) in xh's dtype, final state (B, nh, P, N)
    float32): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _validate(xh, Bm, Cm, dt, A, chunk)
    if xh.device.type == "cuda":
        out = _launch(xh, Bm, Cm, dt, A, chunk)
        ssd_scan.launches += 1
        return out
    if xh.device.type == "cpu":
        ssd_scan.plain_calls += 1
        return ssd_scan_plain(xh, Bm, Cm, dt, A, chunk)
    raise ValueError(f"no ssd_scan kernel for device {xh.device}")


ssd_scan.launches = 0
ssd_scan.plain_calls = 0


def reset_counts():
    ssd_scan.launches = 0
    ssd_scan.plain_calls = 0
