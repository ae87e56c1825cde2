"""Attention: the blocked (flash) forward for prefill, head repetition
for GQA, and single-token decode attention through kernel K3.

Port of `repro.models.attention` (lines 28-255). `flash_attention` is
the reference's blocked online softmax, forward only, in plain torch
(the reference writes it in jnp, not Pallas); its hand-written VJP
belongs to training and is not ported yet. `decode_attention` keeps the
reference's (B, 1, H, d) signature and goes to K3
(`repro_torch.kernels.decode_attention`): the CUDA kernel on CUDA
tensors, its plain version on CPU tensors. Neither calls a library
attention.

Layouts are the reference's: q, k, v (B, S, H, hd); decode caches
(B, C, K, hd) with (C,) int32 slot positions, -1 for an empty slot.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import decode_attention as k3

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, kv_len: int, causal: bool, window: int):
    """(bq, bkv) bool mask of allowed positions."""
    m = (k_pos[None, :] < kv_len)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None, block_q: int = 512,
                    block_kv: int = 512):
    """Blocked attention, forward. q, k, v: (B, S, H, hd) with the KV
    heads already repeated to H. A block size that does not divide its
    length becomes the whole length (reference lines 206-220). Scores,
    the running (m, l, acc) and the PV product accumulate in float32; p
    is cast to v's dtype before the PV product. Queries start at
    position 0 (the reference's `q_offset` has no caller)."""
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    bq = block_q if Sq % block_q == 0 else Sq
    bkv = block_kv if Sk % block_kv == 0 else Sk
    kv_len = Sk if kv_len is None else int(kv_len)
    scale = d ** -0.5
    dev = q.device
    kf = k.float()
    out = torch.empty_like(q)
    for i in range(Sq // bq):
        q_i = q[:, i * bq:(i + 1) * bq].float()
        q_pos = i * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, bq, H, d), dtype=torch.float32, device=dev)
        for j in range(Sk // bkv):
            k_j = kf[:, j * bkv:(j + 1) * bkv]
            v_j = v[:, j * bkv:(j + 1) * bkv]
            k_pos = j * bkv + torch.arange(bkv, device=dev)
            s = torch.einsum("bqhd,bchd->bhqc", q_i, k_j) * scale
            mask = _block_mask(q_pos, k_pos, kv_len, causal, window)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhqc,bchd->bqhd", p.to(v_j.dtype).float(),
                              v_j.float())
            acc = acc * alpha.transpose(1, 2)[..., None] + pv
            m = m_new
        o = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
        out[:, i * bq:(i + 1) * bq] = o.to(q.dtype)
    return out


def repeat_kv(x, n_rep: int):
    """(B, S, K, d) -> (B, S, K*n_rep, d) by head repetition (GQA)."""
    if n_rep == 1:
        return x
    B, S, K, d = x.shape
    return x[:, :, :, None, :].expand(B, S, K, n_rep, d).reshape(
        B, S, K * n_rep, d)


def decode_attention(q, k_cache, v_cache, cache_positions, pos: int, *,
                     window: int = 0):
    """Single-token GQA decode attention, no head repetition. q
    (B, 1, H, d); caches (B, C, K, d); cache_positions (C,) int32; pos
    the current position. Returns (B, 1, H, d) in q's dtype."""
    o = k3.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                            cache_positions, int(pos), int(window))
    return o[:, None]
