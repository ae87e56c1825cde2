"""Attention: blocked (flash) attention with its hand-written backward,
head repetition for GQA, and single-token decode attention through
kernel K3.

Port of `repro.models.attention` (lines 28-255). `flash_attention` is
the reference's `jax.custom_vjp` (lines 42-203) as a
`torch.autograd.Function` in plain torch (the reference writes it in
jnp, not Pallas): the forward is the blocked online softmax and saves
only (q, k, v, o, lse), lse blocked (B, nq, H, bq); the backward
recomputes each block's scores, walking KV blocks outside and Q blocks
inside, with D = rowsum(dO * O), p = exp(s - lse), and dq / dk / dv
accumulated in float32, then cast to the inputs' dtypes. No tensor of
S x S elements is kept between the two. Prefill and training call the
same function. `decode_attention` keeps the reference's (B, 1, H, d)
signature and goes to K3 (`repro_torch.kernels.decode_attention`): the
CUDA kernel on CUDA tensors, its plain version on CPU tensors. Neither
calls a library attention. On meta tensors (the dry run) both return
an empty result and report their FLOPs and bytes from the shapes
(`cost.fused`): the live blocks' two products, q, k, v read and o
written once.

Blocks that the causal or window mask empties whole are skipped, in
both directions: the reference's `skip_masked_blocks` (lines 206-220,
off there by default). The result is the same: every causal row sees
its own key, so once a row's running max is finite a masked block adds
exp(-1e30 - m) = 0 to l and acc and leaves m, and a block masked
before the row's first live one is wiped by that block's alpha = 0; in
the backward a masked block's p is exactly 0.

Layouts are the reference's: q, k, v (B, S, H, hd); decode caches
(B, C, K, hd) with (C,) int32 slot positions, -1 for an empty slot.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..distributed.shardctx import all_gather
from ..kernels import decode_attention as k3
from . import cost

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, kv_len: int, causal: bool, window: int):
    """(bq, bkv) bool mask of allowed positions."""
    m = (k_pos[None, :] < kv_len)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _live_pairs(nq, nkv, bq, bkv, kv_len, causal, window):
    """(i, j, whole) over the (Q block, KV block) pairs that hold an
    allowed position; whole where every position is allowed."""
    for i in range(nq):
        q0, q1 = i * bq, (i + 1) * bq - 1
        for j in range(nkv):
            k0, k1 = j * bkv, (j + 1) * bkv - 1
            if (causal and k0 > q1) or (window > 0 and k1 <= q0 - window):
                continue
            yield i, j, (k1 < kv_len and (not causal or k1 <= q0)
                         and (window <= 0 or k0 > q1 - window))


def _blocks(nq, nkv, bq, bkv, kv_len, causal, window, device):
    """{(i, j): mask} over the live pairs (`_live_pairs`); mask None
    where every position is allowed."""
    return {(i, j): None if whole else _block_mask(
        torch.arange(i * bq, (i + 1) * bq, device=device),
        torch.arange(j * bkv, (j + 1) * bkv, device=device),
        kv_len, causal, window)
        for i, j, whole in _live_pairs(nq, nkv, bq, bkv, kv_len, causal,
                                       window)}


def _masked(s, mask):
    return s if mask is None else torch.where(mask, s, NEG_INF)


def _heads_first(x):
    """(B, S, H, d) -> (B, H, S, d) float32, contiguous."""
    return x.float().transpose(1, 2).contiguous()


class _Flash(torch.autograd.Function):
    """The reference's `flash` with its VJP; statics after the tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, bq, bkv):
        B, Sq, H, d = q.shape
        nq, nkv = Sq // bq, k.shape[1] // bkv
        scale = d ** -0.5
        blocks = _blocks(nq, nkv, bq, bkv, kv_len, causal, window, q.device)
        qf, kf = _heads_first(q), _heads_first(k)
        vt = v.transpose(1, 2)
        o = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, nq, H, bq), dtype=torch.float32,
                          device=q.device)
        for i in range(nq):
            q_i = qf[:, :, i * bq:(i + 1) * bq]
            m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, H, bq, d), dtype=torch.float32,
                              device=q.device)
            for j in range(nkv):
                if (i, j) not in blocks:
                    continue
                s = q_i @ kf[:, :, j * bkv:(j + 1) * bkv].transpose(-1, -2)
                s = _masked(s * scale, blocks[i, j])
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                v_j = vt[:, :, j * bkv:(j + 1) * bkv]
                pv = p.to(v.dtype).float() @ v_j.float()
                acc = acc * alpha[..., None] + pv
                m = m_new
            l_safe = l.clamp_min(1e-30)
            o[:, :, i * bq:(i + 1) * bq] = (acc / l_safe[..., None]).to(
                q.dtype)
            lse[:, i] = m + torch.log(l_safe)
        o = o.transpose(1, 2).contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.statics = (causal, window, kv_len, bq, bkv)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, kv_len, bq, bkv = ctx.statics
        B, Sq, H, d = q.shape
        nq, nkv = Sq // bq, k.shape[1] // bkv
        scale = d ** -0.5
        blocks = _blocks(nq, nkv, bq, bkv, kv_len, causal, window, q.device)
        qf, kf, vf, gf = (_heads_first(t) for t in (q, k, v, g))
        # D_i = rowsum(dO * O): (B, H, Sq)
        D = (g.float() * o.float()).sum(-1).transpose(1, 2)
        dq = torch.zeros_like(qf)
        dk = torch.empty_like(kf)
        dv = torch.empty_like(vf)
        for j in range(nkv):
            k_j = kf[:, :, j * bkv:(j + 1) * bkv]
            v_j = vf[:, :, j * bkv:(j + 1) * bkv]
            dk_j = torch.zeros_like(k_j)
            dv_j = torch.zeros_like(v_j)
            for i in range(nq):
                if (i, j) not in blocks:
                    continue
                rows = slice(i * bq, (i + 1) * bq)
                q_i, g_i = qf[:, :, rows], gf[:, :, rows]
                s = _masked((q_i @ k_j.transpose(-1, -2)) * scale,
                            blocks[i, j])
                p = torch.exp(s - lse[:, i][..., None])    # (B, H, bq, bkv)
                dv_j = dv_j + p.transpose(-1, -2) @ g_i
                dp = g_i @ v_j.transpose(-1, -2)
                ds = p * (dp - D[:, :, rows][..., None]) * scale
                dq[:, :, rows] += ds @ k_j
                dk_j = dk_j + ds.transpose(-1, -2) @ q_i
            dk[:, :, j * bkv:(j + 1) * bkv] = dk_j
            dv[:, :, j * bkv:(j + 1) * bkv] = dv_j
        return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, block_q: int = 512,
                    block_kv: int = 512):
    """Blocked attention, differentiable. q, k, v: (B, S, H, hd) with the
    KV heads already repeated to H. A block size that does not divide its
    length becomes the whole length (reference lines 206-220). Scores,
    the running (m, l, acc) and the PV product accumulate in float32; p
    is cast to v's dtype before the PV product. Queries start at
    position 0 (the reference's `q_offset` has no caller)."""
    Sq, Sk = q.shape[1], k.shape[1]
    bq = block_q if Sq % block_q == 0 else Sq
    bkv = block_kv if Sk % block_kv == 0 else Sk
    kv_len = Sk if kv_len is None else int(kv_len)
    if q.is_meta:
        B, _, H, d = q.shape
        pairs = sum(1 for _ in _live_pairs(Sq // bq, Sk // bkv, bq, bkv,
                                           kv_len, causal, window))
        o = torch.empty_like(q)
        cost.fused(4 * B * H * bq * bkv * d * pairs, (q, k, v), (o,))
        return o
    return _Flash.apply(q, k, v, bool(causal), int(window), kv_len, bq, bkv)


def repeat_kv(x, n_rep: int):
    """(B, S, K, d) -> (B, S, K*n_rep, d) by head repetition (GQA)."""
    if n_rep == 1:
        return x
    B, S, K, d = x.shape
    return x[:, :, :, None, :].expand(B, S, K, n_rep, d).reshape(
        B, S, K * n_rep, d)


def decode_attention(q, k_cache, v_cache, cache_positions, pos: int, *,
                     window: int = 0, stats: bool = False):
    """Single-token GQA decode attention, no head repetition. q
    (B, 1, H, d); caches (B, C, K, d); cache_positions (C,) int32; pos
    the current position. Returns (B, 1, H, d) in q's dtype, and with
    `stats` also each head's float32 (max, exp-sum) as (B, H, 2) (K3's
    `stats`)."""
    if q.is_meta:
        B, _, H, d = q.shape
        o = torch.empty_like(q)
        ml = q.new_empty((B, H, 2), dtype=torch.float32)
        cost.fused(4 * B * H * k_cache.shape[1] * d,
                   (q, k_cache, v_cache, cache_positions),
                   (o, ml) if stats else (o,))
        return (o, ml) if stats else o
    out = k3.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                              cache_positions, int(pos), int(window),
                              bool(stats))
    if stats:
        return out[0][:, None], out[1]
    return out[:, None]


def split_decode_attention(q, k_cache, v_cache, positions, pos: int,
                           heads, window: int = 0, split: bool = True):
    """Single-token GQA decode attention for the query heads [h0, h1) =
    `heads` of q (B, 1, H, d) when the plan cuts the KV heads over
    "model". With `split` the caches (B, C_local, K, d) and `positions`
    (C_local,) are this rank's share of the slots: K3 attends every head
    over them and returns its (max, exp-sum) too; the ranks' outputs
    and stats are all-gathered over "model" and merged in rank order
    (o = sum_r o_r l_r e^(m_r - M) / sum_r l_r e^(m_r - M)). Without
    `split` every rank holds the whole cache and K3 attends the KV heads
    that [h0, h1) read, with their whole query groups, no collective.
    Returns (B, 1, h1 - h0, d) in q's dtype."""
    B, _, H, d = q.shape
    K = k_cache.shape[2]
    g = H // K
    h0, h1 = heads
    if not split:
        k0, k1 = h0 // g, -(-h1 // g)
        if (k0, k1) != (0, K):
            k_cache = k_cache[:, :, k0:k1].contiguous()
            v_cache = v_cache[:, :, k0:k1].contiguous()
        o = decode_attention(q[:, :, k0 * g:k1 * g], k_cache, v_cache,
                             positions, pos, window=window)
        return o[:, :, h0 - k0 * g:h1 - k0 * g]
    o, ml = decode_attention(q, k_cache, v_cache, positions, pos,
                             window=window, stats=True)
    part = all_gather(torch.cat([o[:, 0].float(), ml], -1)[None], "model",
                      0)[:, :, h0:h1]
    m, l = part[..., d], part[..., d + 1]
    w = l * torch.exp(m - m.amax(0))
    o = (part[..., :d] * w[..., None]).sum(0) \
        / w.sum(0).clamp_min(1e-30)[..., None]
    return o[:, None].to(q.dtype)
