"""GQA single-token decode attention as one kernel call (K3).

Port of `repro.kernels.decode_attention` (lines 24-108; oracle
`repro.kernels.ref.decode_attention_ref`, which is the model's
`decode_attention`). The Pallas kernel becomes
`csrc/decode_attention.cu`, hand-written CUDA for sm_90a (its header
says how it is laid out and what bounds it); `decode_attention` is its
wrapper:

  * it checks device, dtype, shape and contiguity on every call and
    raises on anything the kernel does not take;
  * on CUDA tensors it launches the kernel on the current stream and
    raises on a nonzero `cudaError_t`: there is no fallback;
  * on CPU tensors it runs `decode_attention_plain`, the same function
    in plain torch, which the CPU tests hold against the Pallas kernel.

The Pallas kernel walks the cache in order on one core with an online
softmax. The port splits the cache into `SPLIT`-slot pieces that run in
parallel (flash-decoding): each piece keeps its own float32 (m, l, acc)
and a merge combines them. The plain version spells the same split and
the same merge. Numerics kept from the Pallas kernel: the scale d^-0.5
multiplies the float32 dot (line 46); masked scores are -1e30 (a slot
is valid when its position is >= 0, <= pos and, with a window, > pos -
window); p is cast to v's dtype before the PV product while l sums the
float32 p (lines 52-55); the output divides by max(l, 1e-30) (line 63).
A masked slot contributes p = 0, so a fully masked row gives 0 (the
Pallas kernel's exp(0) for a row masked to its end gives the mean of v
there; the model never attends such a row, since decode writes slot pos
first) and every other row is unchanged by it.

`decode_attention.launches` counts calls that went to the kernel (each
starts two __global__ functions), `decode_attention.plain_calls` those
that went to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
SPLIT = 64          # cache slots per CTA (and per piece of the plain version)
MAX_G = 32          # query heads per kv head
MAX_D = 256         # head dim
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _valid(positions, pos: int, window: int):
    valid = (positions >= 0) & (positions <= pos)
    if window > 0:
        valid &= positions > pos - window
    return valid


def decode_attention_plain(q, k_cache, v_cache, positions, pos: int,
                           window: int = 0):
    """The kernel's function in plain torch, on any device: the cache
    cut into SPLIT-slot pieces (the last padded with empty slots), a
    float32 (m, l, acc) per piece, then the merge. Returns (B, H, d) in
    q's dtype."""
    B, H, d = q.shape
    C, K = k_cache.shape[1], k_cache.shape[2]
    g = H // K
    S = -(-C // SPLIT)
    pad = S * SPLIT - C
    kf, vf = k_cache.float(), v_cache
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
        positions = torch.nn.functional.pad(positions, (0, pad), value=-1)
    kf = kf.view(B, S, SPLIT, K, d)
    vr = vf.view(B, S, SPLIT, K, d)
    qf = q.float().view(B, K, g, d)
    s = torch.einsum("bkgd,bsckd->bksgc", qf, kf) * (d ** -0.5)
    valid = _valid(positions, pos, window).view(1, 1, S, 1, SPLIT)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                        # (B, K, S, g)
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(-1)
    pr = p.to(v_cache.dtype).float()
    acc = torch.einsum("bksgc,bsckd->bksgd", pr, vr.float())
    M = m.amax(2, keepdim=True)
    w = torch.exp(m - M)                                  # (B, K, S, g)
    L = (l * w).sum(2)
    A = (acc * w[..., None]).sum(2)
    o = A / L.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, d).to(q.dtype)


def _validate(q, k_cache, v_cache, positions, pos, window):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, H, d) and the caches (B, C, K, d), "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, d = q.shape
    _, C, K, dk = k_cache.shape
    if (k_cache.shape[0] != B or dk != d
            or tuple(v_cache.shape) != tuple(k_cache.shape)):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must share float32 or bfloat16, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (C,):
        raise ValueError(f"positions must be int32 of shape ({C},)")
    if not (k_cache.device == v_cache.device == positions.device
            == q.device):
        raise ValueError("q, the caches and positions must share a device")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, positions)):
        raise ValueError("q, the caches and positions must be contiguous")
    if H // K > MAX_G or d > MAX_D or C < 1 or B < 1:
        raise ValueError(f"the kernel takes H/K <= {MAX_G}, d <= {MAX_D} "
                         f"and a non-empty cache")
    if not isinstance(pos, int) or not isinstance(window, int):
        raise TypeError("pos and window must be Python ints")


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("decode_attention")
        lib.rt_decode_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_void_p] * 5)
        lib.rt_decode_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q, k_cache, v_cache, positions, pos, window):
    lib = _library()
    B, H, d = q.shape
    _, C, K, _ = k_cache.shape
    g = H // K
    S = -(-C // SPLIT)
    dev = q.device
    part_m = torch.empty((B, K, S, g), dtype=torch.float32, device=dev)
    part_l = torch.empty((B, K, S, g), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, K, S, g, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        positions.data_ptr(), B, H, K, C, d, S, pos, window,
        DTYPES[q.dtype], d ** -0.5, part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     pos: int, window: int = 0) -> torch.Tensor:
    """q (B, H, d); caches (B, C, K, d) in q's dtype (float32 or
    bfloat16); positions (C,) int32, -1 for an empty slot; pos and
    window Python ints. Returns (B, H, d) in q's dtype: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    _validate(q, k_cache, v_cache, positions, pos, window)
    if q.device.type == "cuda":
        out = _launch(q, k_cache, v_cache, positions, pos, window)
        decode_attention.launches += 1
        return out
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, positions, pos,
                                      window)
    raise ValueError(f"no decode_attention kernel for device {q.device}")


decode_attention.launches = 0
decode_attention.plain_calls = 0


def reset_counts():
    decode_attention.launches = 0
    decode_attention.plain_calls = 0
