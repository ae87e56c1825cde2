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
softmax. The port cuts the cache of each (row, kv head) into `pieces`
of whole `TILE`-slot tiles that run in parallel as one thread-block
cluster (flash-decoding): each piece keeps its own float32 (m, l, acc)
and the cluster merges them on chip. A piece longer than the score
buffer is walked in segments of U tiles, each with its own softmax,
folded in order into the piece's running (m, l, acc). The plain version
spells the same pieces, segments and merges. Numerics kept from the
Pallas kernel: the scale d^-0.5 multiplies the float32 dot (line 46);
masked scores are -1e30 (a slot is valid when its position is >= 0,
<= pos and, with a window, > pos - window); p is cast to v's dtype
before the PV product while l sums the float32 p (lines 52-55); the
output divides by max(l, 1e-30) (line 63). A masked slot contributes
p = 0 and is never read, so a fully masked row gives 0 (the Pallas
kernel's exp(0) for a row masked to its end gives the mean of v there;
the model never attends such a row, since decode writes slot pos first)
and every other row is unchanged by it.

With `stats=True` the call also returns each head's float32 (M, L): the
merged running max of the scaled scores and the sum of exp(s - M) over
the valid slots (-1e30 and 0 where none is). Outputs of caches held
apart merge with them: M* = max M_r, o = sum_r o_r L_r e^(M_r - M*) /
sum_r L_r e^(M_r - M*) (`models.attention.split_decode_attention`).

`decode_attention.launches` counts calls that went to the kernel (one
__global__ function each), `decode_attention.plain_calls` those that
went to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .build import smem_limit

NEG_INF = -1e30
TILE = 64           # cache slots per tile (csrc/decode_attention.cu)
MAX_PIECES = 8      # the portable thread-block cluster size
SMS = 132           # an H100 SXM's SMs, a constant: the layout is the shape's
SCORE_SLOTS = 8192  # float32 scores a CTA keeps in shared memory (32 KB)
MAX_G = 32          # query heads per kv head
MAX_D = 256         # head dim
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pieces(B: int, K: int, C: int, g: int):
    """The kernel's layout of a (B, C, K) cache with g query heads per kv
    head: (S pieces per (row, kv head), n_per tiles per piece, U tiles per
    segment). S starts from min(8, tiles, ceil(2 * 132 / (B K))), enough
    CTAs for about two waves on an H100 and no more than a portable
    cluster; the pieces then take ceil(tiles / S) whole tiles each (the
    last the rest), so S may shrink. A segment holds at most SCORE_SLOTS
    / g slots of scores. Depends on the shape alone, never on the device,
    so the plain version lays the cache out the same way on any host."""
    n_tiles = -(-C // TILE)
    s0 = min(MAX_PIECES, n_tiles, -(-2 * SMS // (B * K)))
    n_per = -(-n_tiles // s0)
    S = -(-n_tiles // n_per)
    U = min(n_per, max(1, SCORE_SLOTS // (TILE * g)))
    return S, n_per, U


def _valid(positions, pos: int, window: int):
    valid = (positions >= 0) & (positions <= pos)
    if window > 0:
        valid &= positions > pos - window
    return valid


def _dots(qf, kf):
    """q . k in the kernel's order, (B, K, S, J, g, UL) from q (B, K, g, d)
    and k (B, S, J, UL, K, d) in float32: eight partial sums, the x-th
    over elements e = x mod 8, each a product and an add per step of 8,
    e ascending, each rounded; then the eight added in order. So the
    scores, and with them the rounding of p, are the kernel's to the bit
    wherever exp is."""
    B, K, g, d = qf.shape
    _, S, J, UL = kf.shape[:4]
    qb = qf.view(B, K, 1, 1, g, 1, d // 8, 8).movedim(-2, 0)
    kb = kf.permute(0, 4, 1, 2, 3, 5).reshape(
        B, K, S, J, 1, UL, d // 8, 8).movedim(-2, 0).contiguous()
    part = torch.zeros((B, K, S, J, g, UL, 8), device=qf.device)
    for e8 in range(d // 8):                 # one contiguous step each
        part = part + qb[e8] * kb[e8]
    dot = part[..., 0]
    for x in range(1, 8):
        dot = dot + part[..., x]
    return dot


def decode_attention_plain(q, k_cache, v_cache, positions, pos: int,
                           window: int = 0, stats: bool = False):
    """The kernel's function in plain torch, on any device, in its
    layout (`pieces`): per piece and segment a float32 softmax over the
    segment's slots (scores summed in the kernel's order, `_dots`;
    masked slots -1e30, p = 0, zeroed and so never read), p rounded to
    the cache dtype before the PV product; the
    segments of a piece folded in order into a running (m, l, acc); then
    the pieces merged. Returns (B, H, d) in q's dtype, and with `stats`
    also the merged (M, L), float32 (B, H, 2)."""
    B, H, d = q.shape
    C, K = k_cache.shape[1], k_cache.shape[2]
    g = H // K
    S, n_per, U = pieces(B, K, C, g)
    J, UL = -(-n_per // U), U * TILE
    dev = q.device
    # slot of (piece, segment, place in segment), and whether it is valid
    c = torch.arange(UL, device=dev)
    j = torch.arange(J, device=dev)[:, None]
    s_ = torch.arange(S, device=dev)[:, None, None]
    in_piece = j * UL + c < n_per * TILE
    slot = (s_ * n_per + j * U) * TILE + c                # (S, J, UL)
    idx = slot.clamp(max=C - 1)
    valid = in_piece & (slot < C) & _valid(positions[idx], pos, window)
    vm = valid[None, :, :, :, None, None]
    kf = torch.where(vm, k_cache[:, idx], 0).float()      # (B,S,J,UL,K,d)
    vf = torch.where(vm, v_cache[:, idx], 0).float()
    s = _dots(q.float().view(B, K, g, d), kf) * (d ** -0.5)
    vs = valid.view(1, 1, S, J, 1, UL)
    s = torch.where(vs, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                        # (B, K, S, J, g)
    p = torch.where(vs, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    pr = p.to(v_cache.dtype).float()
    acc = torch.einsum("bksjgc,bsjckd->bksjgd", pr, vf)
    # a piece's segments in order: the running merge
    Mr, Lr, Ar = m[:, :, :, 0], l[:, :, :, 0], acc[:, :, :, 0]
    for jj in range(1, J):
        mj = m[:, :, :, jj]
        M2 = torch.maximum(Mr, mj)
        al, be = torch.exp(Mr - M2), torch.exp(mj - M2)
        Lr = Lr * al + l[:, :, :, jj] * be
        Ar = Ar * al[..., None] + acc[:, :, :, jj] * be[..., None]
        Mr = M2
    # the cluster's pieces
    M = Mr.amax(2, keepdim=True)
    w = torch.exp(Mr - M)                                 # (B, K, S, g)
    L = (Lr * w).sum(2)
    A = (Ar * w[..., None]).sum(2)
    o = (A / L.clamp_min(1e-30)[..., None]).reshape(B, H, d).to(q.dtype)
    if stats:
        return o, torch.stack([M[:, :, 0], L], -1).reshape(B, H, 2)
    return o


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
    if H // K > MAX_G or d > MAX_D or d % 8 or C < 1 or B < 1:
        raise ValueError(f"the kernel takes H/K <= {MAX_G}, d <= {MAX_D} "
                         f"a multiple of 8 and a non-empty cache")
    if not isinstance(pos, int) or not isinstance(window, int):
        raise TypeError("pos and window must be Python ints")


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("decode_attention")
        lib.rt_decode_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float]
            + [ctypes.c_void_p] * 3)
        lib.rt_decode_attention.restype = ctypes.c_int
        lib.rt_decode_attention_smem.argtypes = [ctypes.c_int] * 4
        lib.rt_decode_attention_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q, k_cache, v_cache, positions, pos, window, stats):
    lib = _library()
    B, H, d = q.shape
    _, C, K, _ = k_cache.shape
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("the kernel reads q and the caches 16 bytes at a "
                         "time: they must be 16-byte aligned")
    S, n_per, U = pieces(B, K, C, H // K)
    dt = DTYPES[q.dtype]
    limit = smem_limit(q.device)
    if lib.rt_decode_attention_smem(H // K, d, U, dt) > limit:
        raise ValueError(f"H/K={H // K}, d={d} need more shared memory "
                         f"than a block has ({limit} B)")
    out = torch.empty_like(q)
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=q.device) \
        if stats else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        positions.data_ptr(), B, H, K, C, d, S, n_per, U, pos, window, dt,
        d ** -0.5, out.data_ptr(), ml.data_ptr() if stats else None, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    return (out, ml) if stats else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     pos: int, window: int = 0, stats: bool = False):
    """q (B, H, d); caches (B, C, K, d) in q's dtype (float32 or
    bfloat16); positions (C,) int32, -1 for an empty slot; pos and
    window Python ints. Returns (B, H, d) in q's dtype, and with `stats`
    also each head's float32 (M, L) as (B, H, 2) (module docstring): the
    CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    _validate(q, k_cache, v_cache, positions, pos, window)
    if q.device.type == "cuda":
        out = _launch(q, k_cache, v_cache, positions, pos, window,
                      bool(stats))
        decode_attention.launches += 1
        return out
    if q.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q, k_cache, v_cache, positions, pos,
                                      window, bool(stats))
    raise ValueError(f"no decode_attention kernel for device {q.device}")


decode_attention.launches = 0
decode_attention.plain_calls = 0


def reset_counts():
    decode_attention.launches = 0
    decode_attention.plain_calls = 0
