"""Layer blocks: the attention, RG-LRU and SSD mixers and the dense or
MoE MLP.

Port of `repro.models.blocks` (lines 31-432). A block is
pre-norm -> mixer -> residual [-> pre-norm -> mlp -> residual]; mamba2
SSD blocks have no MLP. Every mixer runs in the reference's three
modes:

  train   - the full sequence, causal, no cache;
  prefill - the full prompt, causal, returns the populated cache;
  decode  - one token, reads and writes the cache.

Decode writes the new token's K/V slot (`slot = pos % C`, the ring
buffer of reference lines 89-99) into the cache's tensors in place
instead of returning updated copies, so a cache passed to decode must
not be reused afterwards; the SSD and RG-LRU states and conv windows
are replaced by new tensors. Train and prefill write into no tensor
that autograd saved. The SSD prefill pads the prompt to its chunk with
dt = 0 (exact no-op steps, reference lines 263-272) and runs kernel K4
(`repro_torch.kernels.ssd_scan`), which has no backward; training runs
the model's own chunked scan (`ssd_chunked_train`, the reference's
`_ssd_chunked`, lines 252-308) in torch under autograd: every chunk's
state-independent products at once under `torch.utils.checkpoint` (the
reference's chunk body sits under `jax.checkpoint`), then the state
recurrence chunk by chunk. Its decode recurrence (lines 324-345) is
plain torch, as in the reference, which has no kernel there. The RG-LRU
(griffin / recurrentgemma, lines 146-211) is plain torch too: its
prefill and train scan is the reference's log-depth `associative_scan`
spelled in torch ops (`_lru_scan`), so products and sums associate as
the reference's do.

Under a mesh pinned with `distributed.shardctx.sharding_rules` the
blocks run the Megatron plan of `launch.sharding` on the pieces a rank
holds (`sharding.shard_params`): the attention's and the SSD's
projections split by columns and `wo` / `out_proj` by rows, each mixer
on its local heads, its output summed over "model"; the RG-LRU on its
share of the channels (`rglru_forward`); the shares are read from the
weights' shapes, so without a mesh (every share whole) the code
computes exactly what it did before. The dense MLP is `layers.mlp`'s.
In train mode the same code runs under autograd: the collectives carry
their backward (`distributed.shardctx`: Megatron's "f" in front of
every column-split product, `copy_to`, and "g" after every row-split
one, `all_reduce`).

`block_forward` returns (x, new_cache, aux): aux is the MoE layer's
load-balance loss, a float32 scalar, and 0.0 for a dense MLP or none.
The MoE MLP drops pairs past the capacity in train and prefill and none
at decode (`no_drop=(mode == "decode")`, reference line 424).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.shardctx import all_gather, all_reduce, axis_size, \
    copy_to, kv_cache_dim, local_range, share
from ..kernels import ssd_scan as k4
from . import cost
from .attention import decode_attention, flash_attention, repeat_kv, \
    split_decode_attention
from .config import BlockCfg, ModelConfig
from .layers import apply_act, apply_norm, apply_rope, dense_init, mlp, \
    mlp_params, norm_params, remat
from .moe import moe_layer_sharded, moe_params

MODES = ("train", "prefill", "decode")


# -- causal depthwise conv (width w) ------------------------------------------

def conv_params(gen, width: int, channels: int, dtype):
    return {"w": dense_init(gen, (width, channels), scale=0.5, dtype=dtype)}


def causal_conv(x, p, width: int):
    """x: (B, S, C) full-sequence causal depthwise conv, in x's dtype."""
    pad = F.pad(x, (0, 0, width - 1, 0))
    S = x.shape[1]
    return sum(pad[:, i:i + S] * p["w"][i] for i in range(width))


def conv_step(x_t, state, p, width: int):
    """x_t: (B, C) one step; state: (B, width-1, C) past inputs."""
    full = torch.cat([state, x_t[:, None]], dim=1)          # (B, w, C)
    out = torch.einsum("bwc,wc->bc", full, p["w"])
    return out, full[:, 1:]


# -- attention block ----------------------------------------------------------

def attn_params(gen, cfg: ModelConfig, dtype=None):
    dtype = dtype or cfg.dtype
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (D, H * hd), dtype=dtype),
         "wk": dense_init(gen, (D, K * hd), dtype=dtype),
         "wv": dense_init(gen, (D, K * hd), dtype=dtype),
         "wo": dense_init(gen, (H * hd, D), dtype=dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
    return p


def _qk_norm(x, scale, eps):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def _prefill_cache(k, v, C: int):
    """The ring cache of a prompt's k, v (B, S, K, hd) in C slots."""
    S, dev = k.shape[1], k.device
    if S <= C:
        padw = (0, 0, 0, 0, 0, C - S)
        return {"k": F.pad(k, padw), "v": F.pad(v, padw),
                "positions": torch.cat([
                    torch.arange(S, dtype=torch.int32, device=dev),
                    torch.full((C - S,), -1, dtype=torch.int32,
                               device=dev)])}
    # windowed: slot j holds the latest position p with p % C == j
    j = torch.arange(C, device=dev)
    p_j = (S - 1) - ((S - 1 - j) % C)
    return {"k": k[:, p_j].contiguous(), "v": v[:, p_j].contiguous(),
            "positions": p_j.to(torch.int32)}


def whole_columns(parts, axis: str = "model", grad: str = "scatter"):
    """Whole tensors from this rank's column shares. `parts` holds (local
    tensor, full width) pairs; the shares that are split go through one
    all-gather over `axis` (of their concatenation), the others are
    whole already. `grad` is the all-gather's backward
    (`shardctx.all_gather`): "scatter" where each rank reads the whole
    tensors differently (its heads, its channels' gates), "slice" where
    every rank computes the same from them."""
    out = [t for t, _ in parts]
    cut = [i for i, (t, full) in enumerate(parts) if t.shape[-1] != full]
    if not cut:
        return out
    got = all_gather(torch.cat([out[i] for i in cut], -1)[None], axis, 0,
                     grad=grad)
    for i, piece in zip(cut, got.split([out[i].shape[-1] for i in cut], -1)):
        out[i] = piece.movedim(0, -2).flatten(-2)     # rank order
    return out


def attn_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                 pos: int, pad_to: int = 0):
    """Under a pinned mesh `p` holds this rank's shares: `wq` / `wk` /
    `wv` columns and `wo` rows (`launch.sharding`). Where they are whole
    heads, this rank attends its heads (K3 at decode, its KV heads'
    cache); otherwise (the plan cuts a head, e.g. 8 KV heads over 16
    ranks) the projections are gathered to whole heads over "model"
    (`whole_columns`, one all-gather) and `_attn_cut` runs. The output
    is summed over "model" where `wo` is split (one all-reduce). Under
    autograd the input's gradient is summed over "model" where the
    projections are split (`shardctx.copy_to`)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wq, wo = p["wq"], p["wo"]
    if wq.shape[1] != H * hd or p["wk"].shape[1] != K * hd:
        x = copy_to(x, "model")
    q, k, v = x @ wq, x @ p["wk"], x @ p["wv"]
    Hc, Kc = q.shape[-1], k.shape[-1]
    if Hc % hd == 0 and Kc % hd == 0 and Hc * K == Kc * H:
        o, new_cache = _attn_heads(q.view(B, S, Hc // hd, hd),
                                   k.view(B, S, Kc // hd, hd),
                                   v.view(B, S, Kc // hd, hd), p, cfg, blk,
                                   mode, cache, pos, pad_to)
        out = o.reshape(B, S, Hc) @ wo
    else:
        lo, hi = local_range(H * hd, wo.shape[0])
        q, k, v = whole_columns(
            [(q, H * hd), (k, K * hd), (v, K * hd)],
            grad="scatter" if hi - lo < H * hd else "slice")
        o, new_cache = _attn_cut(
            q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd),
            lo // hd, -(-hi // hd), p, cfg, blk, mode, cache, pos, pad_to)
        h0 = lo // hd * hd
        out = o.reshape(B, S, -1)[..., lo - h0:hi - h0] @ wo
    if wo.shape[0] != H * hd:
        out = all_reduce(out, "model")
    return out, new_cache


def _rope(q, k, blk: BlockCfg, mode: str, pos: int, S: int):
    at = (torch.full((1, 1), pos, device=q.device) if mode == "decode"
          else torch.arange(S, device=q.device)[None, :])
    return apply_rope(q, at, blk.rope_theta), apply_rope(k, at, blk.rope_theta)


def _qk(q, k, p, cfg: ModelConfig, split: bool = False):
    """The q/k norms; `split` where this rank attends a share of the
    heads, whose gradient of the (whole) norm scales is summed over
    "model"."""
    if cfg.qk_norm:
        qs, ks = p["q_norm"], p["k_norm"]
        if split:
            qs, ks = copy_to(torch.stack([qs, ks]), "model").unbind(0)
        q = _qk_norm(q, qs, cfg.norm_eps)
        k = _qk_norm(k, ks, cfg.norm_eps)
    return q, k


def _attn_heads(q, k, v, p, cfg: ModelConfig, blk: BlockCfg, mode: str,
                cache, pos: int, pad_to: int):
    """Whole heads: q (B, S, Hl, hd) against this rank's KV heads k, v
    (B, S, Kl, hd). Returns (o (B, S, Hl, hd), new cache)."""
    S = q.shape[1]
    q, k = _rope(*_qk(q, k, p, cfg, q.shape[2] != cfg.n_heads), blk, mode,
                 pos, S)
    if mode == "decode":
        C = cache["k"].shape[1]
        slot = pos % C
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["positions"][slot] = pos
        o = decode_attention(q, cache["k"], cache["v"], cache["positions"],
                             pos, window=blk.window)
        return o, cache
    g = q.shape[2] // k.shape[2]
    o = flash_attention(q, repeat_kv(k, g), repeat_kv(v, g), causal=True,
                        window=blk.window, block_q=min(cfg.attn_chunk, S),
                        block_kv=min(cfg.attn_chunk, S))
    if mode == "train":
        return o, None
    return o, _prefill_cache(k, v, blk.cache_len(max(pad_to, S)))


def _attn_cut(q, k, v, h0: int, h1: int, p, cfg: ModelConfig,
              blk: BlockCfg, mode: str, cache, pos: int, pad_to: int):
    """Heads cut by the plan: q (B, S, H, hd), k, v (B, S, K, hd) whole
    on every rank; the rank attends heads [h0, h1), those its `wo` rows
    read. Its cache holds what `cache_pspecs` places on it: a share of
    the slots (the KV heads do not divide; `shardctx.kv_cache_dim`), or
    all of them. At decode K3 attends every head over the rank's slots
    and the ranks' outputs merge over "model" by their (max, exp-sum)
    (`attention.split_decode_attention`, one all-gather), or, over a
    whole cache, K3 attends the rank's heads. Returns (o
    (B, S, h1 - h0, hd), new cache)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    q, k = _rope(*_qk(q, k, p, cfg, h1 - h0 < H), blk, mode, pos, S)
    kv_dim = kv_cache_dim(blk.cache_len(max(pad_to, S)) if mode != "decode"
                          else cache["positions"].shape[0], K, hd,
                          axis_size("model"))
    if kv_dim == -1:
        raise NotImplementedError("a KV cache split over head_dim")
    if mode == "decode":
        C = cache["positions"].shape[0]
        lo, hi = local_range(C, cache["k"].shape[1])
        slot = pos % C
        if lo <= slot < hi:
            cache["k"][:, slot - lo] = k[:, 0]
            cache["v"][:, slot - lo] = v[:, 0]
        cache["positions"][slot] = pos
        o = split_decode_attention(q, cache["k"], cache["v"],
                                   cache["positions"][lo:hi], pos, (h0, h1),
                                   blk.window, split=hi - lo < C)
        return o, cache
    heads = torch.arange(h0, h1, device=q.device) // (H // K)
    o = flash_attention(q[:, :, h0:h1], k.index_select(2, heads),
                        v.index_select(2, heads), causal=True,
                        window=blk.window, block_q=min(cfg.attn_chunk, S),
                        block_kv=min(cfg.attn_chunk, S))
    if mode == "train":
        return o, None
    new_cache = _prefill_cache(k, v, blk.cache_len(max(pad_to, S)))
    if kv_dim == -3:
        C = new_cache["positions"].shape[0]
        lo, hi = share(C)
        new_cache["k"] = new_cache["k"][:, lo:hi].contiguous()
        new_cache["v"] = new_cache["v"][:, lo:hi].contiguous()
    return o, new_cache


def attn_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                    device=None):
    C = blk.cache_len(ctx)
    shape = (B, C, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "positions": torch.full((C,), -1, dtype=torch.int32,
                                    device=device)}


# -- RG-LRU (griffin / recurrentgemma) recurrent block -----------------------

_LRU_C = 8.0


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_params(gen, cfg: ModelConfig, dtype=None):
    dtype = dtype or cfg.dtype
    D, W = cfg.d_model, cfg.lru_width or cfg.d_model
    lam = torch.rand(W, generator=gen, dtype=torch.float32,
                     device=gen.device) * (0.999 - 0.9) + 0.9
    return {"w_in": dense_init(gen, (D, W), dtype=dtype),
            "w_gate_branch": dense_init(gen, (D, W), dtype=dtype),
            "w_out": dense_init(gen, (W, D), dtype=dtype),
            "w_i": dense_init(gen, (W, W), dtype=dtype),
            "w_r": dense_init(gen, (W, W), dtype=dtype),
            "lam": lam,
            "conv": conv_params(gen, cfg.conv_width, W, dtype)}


def _lru_gates(u, p, W: int):
    """(a, b) of h_t = a_t h_(t-1) + b_t, float32. The square root is
    taken in float64 and rounded once (XLA's is correctly rounded). `u`
    may be this rank's share of the W channels: the gates' products read
    every channel, so u is gathered over "model" for them (one
    all-gather, its gradient reduce-scattered back), and the rest is
    per channel."""
    uf = u.float()
    uw, = whole_columns([(u, W)])
    uw = uw.float()
    i_t = torch.sigmoid(uw @ p["w_i"].float())
    r_t = torch.sigmoid(uw @ p["w_r"].float())
    lam = p["lam"]
    log_sig = -_softplus(-torch.log(lam / (1 - lam)))     # jax log_sigmoid
    log_a = _LRU_C * log_sig * r_t                         # (..., W) < 0
    a = torch.exp(log_a)
    root = torch.sqrt((1.0 - torch.exp(2.0 * log_a)).clamp_min(1e-12)
                      .double()).float()
    return a, root * (i_t * uf)


def _interleave(x, y):
    """[x0, y0, x1, y1, ...] along dim 1; x has as many or one more."""
    out = x.new_empty((x.shape[0], x.shape[1] + y.shape[1]) + x.shape[2:])
    out[:, 0::2] = x
    out[:, 1::2] = y
    return out


def _lru_scan(a, b):
    """Inclusive scan of h_t = a_t h_(t-1) + b_t (h_(-1) = 0) along dim 1:
    `jax.lax.associative_scan` with the combine (a1 a2, a2 b1 + b2), its
    odd/even recursion spelled out (log2(S) levels), so every product and
    sum is the reference's. Returns (cumulative a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def combine(a1, b1, a2, b2):
        return a1 * a2, a2 * b1 + b2
    odd_a, odd_b = _lru_scan(*combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                      a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_b = combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2],
                             b[:, 2::2])
    else:
        ev_a, ev_b = combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def rglru_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                  pos: int, pad_to: int = 0):
    """Under a pinned mesh `p` holds this rank's W / model channels
    (`w_in`, `w_gate_branch`, `lam` and the columns of `w_i` / `w_r`;
    `w_out`'s rows; the conv's, except where the plan keeps a stacked
    leaf's conv whole (its rule reads two dimensions), which the rank
    then reads its share of; `launch.sharding`): the conv, the gates'
    elementwise terms, the scan and the `h` / `conv` caches run on those
    channels, the gates' products read all of u (`_lru_gates`: one
    all-gather) and the output is summed over "model" (one
    all-reduce)."""
    w, W = cfg.conv_width, cfg.lru_width or cfg.d_model
    split = p["w_in"].shape[1] != W
    conv = {"w": p["conv"]["w"]}
    if split:
        x = copy_to(x, "model")
        if conv["w"].shape[1] == W:     # kept whole: a stacked leaf's plan
            lo, hi = local_range(W, p["w_in"].shape[1])
            conv["w"] = copy_to(conv["w"], "model")[:, lo:hi]
    u_in = x @ p["w_in"]
    gate = apply_act(x @ p["w_gate_branch"], "gelu")
    if mode == "decode":
        u, conv_state = conv_step(u_in[:, 0], cache["conv"], conv, w)
        a, b = _lru_gates(u, p, W)
        h = a * cache["h"] + b
        y = h[:, None].to(x.dtype)
        new_cache = {"h": h, "conv": conv_state}
    else:
        a, b = _lru_gates(causal_conv(u_in, conv, w), p, W)
        _, h = _lru_scan(a, b)
        y = h.to(x.dtype)
        new_cache = None if mode == "train" else {
            "h": h[:, -1].contiguous(),
            "conv": u_in[:, -(w - 1):].contiguous()}
    out = (y * gate) @ p["w_out"]
    return (all_reduce(out, "model") if split else out), new_cache


def rglru_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                     device=None):
    W = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((B, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, W), dtype=cfg.dtype,
                                device=device)}


# -- SSD (mamba2) block -------------------------------------------------------

def ssd_params(gen, cfg: ModelConfig, dtype=None):
    """Projections per logical segment (z / x / B / C / dt), as the
    reference stores them."""
    dtype = dtype or cfg.dtype
    D, di, N, G, nh = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_groups, cfg.ssm_heads)
    dev, f32 = gen.device, torch.float32
    return {
        "in_z": dense_init(gen, (D, di), dtype=dtype),
        "in_x": dense_init(gen, (D, di), dtype=dtype),
        "in_B": dense_init(gen, (D, G * N), dtype=dtype),
        "in_C": dense_init(gen, (D, G * N), dtype=dtype),
        "in_dt": dense_init(gen, (D, nh), dtype=dtype),
        "conv_x": conv_params(gen, cfg.conv_width, di, dtype),
        "conv_B": conv_params(gen, cfg.conv_width, G * N, dtype),
        "conv_C": conv_params(gen, cfg.conv_width, G * N, dtype),
        "A_log": torch.zeros(nh, dtype=f32, device=dev),
        "dt_bias": torch.zeros(nh, dtype=f32, device=dev),
        "D_skip": torch.ones(nh, dtype=f32, device=dev),
        "out_norm": torch.zeros(di, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, D), dtype=dtype),
    }


def _pad_to_chunk(xh, Bm, Cm, dt, chunk: int):
    """Zero-pad the sequence axis to a multiple of the chunk: dt = 0
    makes the padded steps exact no-ops (decay 1, input 0)."""
    pad = (-xh.shape[1]) % chunk
    if not pad:
        return xh, Bm, Cm, dt
    return (F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(Bm, (0, 0, 0, 0, 0, pad)),
            F.pad(Cm, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)))


def ssd_chunked(xh, Bm, Cm, dt, A, chunk: int):
    """The prefill scan: pad S to the chunk with dt = 0 (decay 1, input
    0: exact no-op steps), run K4, cut the padding. xh (B, S, nh, P);
    Bm/Cm (B, S, G, N) float32; dt (B, S, nh) float32; A (nh,) float32.
    Returns (y (B, S, nh, P) in xh's dtype, final state (B, nh, P, N))."""
    S = xh.shape[1]
    xh, Bm, Cm, dt = _pad_to_chunk(xh, Bm, Cm, dt, chunk)
    if xh.is_meta:
        return _ssd_meta(xh, Bm, Cm, dt, A, chunk, S)
    y, state = k4.ssd_scan(xh.contiguous(), Bm.contiguous(),
                           Cm.contiguous(), dt.contiguous(), A, chunk=chunk)
    return y[:, :S], state


def _ssd_meta(xh, Bm, Cm, dt, A, chunk: int, S: int):
    """K4's results on meta tensors, its products counted from the shapes
    (`cost.fused`): per row, chunk and head C B^T (Q x Q x N), the masked
    product with x (Q x Q x P), the state read (Q x P x N) and written
    (P x N x Q); its inputs read and outputs written once."""
    Bsz, Sp, nh, P = xh.shape
    N, Q = Bm.shape[3], chunk
    y = torch.empty_like(xh)
    state = torch.empty((Bsz, nh, P, N), dtype=torch.float32,
                        device=xh.device)
    cost.fused(2 * Bsz * (Sp // Q) * nh * (Q * Q * (N + P) + 2 * Q * P * N),
               (xh, Bm, Cm, dt, A), (y, state))
    return y[:, :S], state


def _segsum(dA):
    """(..., Q) -> (..., Q, Q): cs_q - cs_k on and below the diagonal,
    -inf above it (cs the cumulative sum)."""
    Q = dA.shape[-1]
    cs = dA.cumsum(-1)
    keep = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(keep, cs[..., :, None] - cs[..., None, :],
                       -torch.inf)


def _ssd_local(xc, Bc, Cc, dtc, dAc):
    """Every chunk's state-independent work at once (reference lines
    280-300): the masked intra-chunk product, the decays and each
    chunk's own state contribution. xc (B, nc, Q, nh, P); Bc/Cc
    (B, nc, Q, nh, N) float32; dtc/dAc (B, nc, Q, nh) float32. Returns
    (y_intra (B, nc, Q, nh, P), st (B, nc, nh, P, N), decay_in
    (B, nc, Q, nh), chunk_decay (B, nc, nh)), float32."""
    dA_t = dAc.transpose(2, 3)                              # (B, nc, nh, Q)
    cum = dA_t.cumsum(-1)
    L = torch.exp(_segsum(dA_t))                            # (B,nc,nh,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    M = scores * L * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M.to(xc.dtype).float(),
                           xc.float())
    decay_out = torch.exp(cum[..., -1:] - cum)              # (B, nc, nh, Q)
    contrib = dtc * decay_out.transpose(2, 3)               # (B, nc, Q, nh)
    st = torch.einsum("bcqhn,bcqhp->bchpn", Bc * contrib[..., None],
                      xc.float())
    return (y_intra, st, torch.exp(cum).transpose(2, 3),
            torch.exp(cum[..., -1]))


def ssd_chunked_train(xh, Bm, Cm, dt, A, chunk: int):
    """The training scan, differentiable: the reference's `_ssd_chunked`
    in torch. Each chunk's state-independent work (`_ssd_local`) runs for
    all chunks at once and again in the backward (`remat`, as the
    reference's chunk body under `jax.checkpoint`), so no chunk's (Q, Q)
    products are kept; only the state recurrence walks the chunks in
    order, state_c = state_(c-1) exp(sum dA_c) + st_c, from zero. Same
    arguments and results as `ssd_chunked`."""
    Bsz, S, nh, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xh, Bm, Cm, dt = _pad_to_chunk(xh, Bm, Cm, dt, chunk)
    nc = xh.shape[1] // chunk
    xc = xh.reshape(Bsz, nc, chunk, nh, P)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(nh // G, dim=3)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(nh // G, dim=3)
    dtc = dt.reshape(Bsz, nc, chunk, nh)
    y_intra, st, decay_in, chunk_decay = remat(True, _ssd_local, xc, Bc, Cc,
                                               dtc, dtc * A)
    state = torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                        device=xh.device)
    entering = []
    # unbind: one backward node for all chunks, not a full-size zero
    # fill per chunk as indexing's backward would make
    for st_c, decay_c in zip(st.unbind(1), chunk_decay.unbind(1)):
        entering.append(state)
        state = state * decay_c[:, :, None, None] + st_c
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc * decay_in[..., None],
                           torch.stack(entering, 1))
    y = (y_intra + y_inter).to(xh.dtype)
    return y.reshape(Bsz, nc * chunk, nh, P)[:, :S], state


def _share_of(t, lo: int, hi: int, full: int, dim: int = 0):
    """A per-head (or per-channel) parameter as this rank reads it: its
    [lo, hi) where the plan keeps the parameter whole, as it is where the
    plan gives the rank that share."""
    return t.narrow(dim, lo, hi - lo) if t.shape[dim] == full else t


def _norm_sum(t):
    """The gated norm's sum of squares over "model" (its width split).
    Each rank scales its own channels by the result, so its gradient is
    summed over "model" too."""
    return copy_to(all_reduce(t, "model"), "model")


def ssd_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                pos: int, pad_to: int = 0):
    """Under a pinned mesh `p` holds this rank's shares (`in_z` / `in_x`
    / `in_dt` / `conv_x` columns, `out_norm`, `out_proj` rows): the rank
    scans its heads [lo, hi) with K4 and reads its share of the per-head
    parameters the plan keeps whole. The gated RMSNorm takes its mean
    over the whole d_inner, so its sum of squares is summed over "model"
    before the rsqrt (one all-reduce), and so is the output (one more).
    `in_B` / `in_C` are whole; where the plan splits their conv caches
    over "model", a decode step convolves the rank's channels and
    gathers the others (one all-gather for both).

    Under autograd, where the heads are split, the gradients that each
    rank holds a part of are summed over "model": the input's of the
    split projections, that of the (whole) B / C after their conv, and
    that of the per-head parameters the plan keeps whole (one all-reduce
    each, `shardctx.copy_to`)."""
    B, S, _ = x.shape
    di, N, G, nh, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    w, GN = cfg.conv_width, G * N
    split = p["in_dt"].shape[-1] != nh
    xc = copy_to(x, "model") if split else x
    z = xc @ p["in_z"]
    xr = xc @ p["in_x"]
    Br = x @ p["in_B"]
    Cr = x @ p["in_C"]
    dt_raw = xc @ p["in_dt"]
    lo, hi = local_range(nh, dt_raw.shape[-1])
    nhl, rep = hi - lo, nh // G
    g0, g1 = lo // rep, -(-hi // rep)
    if xr.shape[-1] != nhl * P or (G > 1 and (lo % rep or hi % rep)):
        raise NotImplementedError("a plan that cuts an SSD head or group")
    heads = torch.stack([p["A_log"], p["dt_bias"], p["D_skip"]])
    if split:
        heads = copy_to(heads, "model")
    A_log, dt_bias, D_skip = (_share_of(t, lo, hi, nh)
                              for t in heads.unbind(0))
    A = -torch.exp(A_log)                                  # (nhl,)
    conv_x = {"w": _share_of(p["conv_x"]["w"], lo * P, hi * P, di, 1)}
    clo, chi = share(GN)              # the conv_B / conv_C caches' share

    if mode == "decode":
        xt, cs_x = conv_step(xr[:, 0], cache["conv_x"], conv_x, w)
        Bt, cs_B = conv_step(Br[:, 0, clo:chi], cache["conv_B"],
                             {"w": p["conv_B"]["w"][:, clo:chi]}, w)
        Ct, cs_C = conv_step(Cr[:, 0, clo:chi], cache["conv_C"],
                             {"w": p["conv_C"]["w"][:, clo:chi]}, w)
        Bt, Ct = whole_columns([(Bt, GN), (Ct, GN)])
        xh = apply_act(xt, "silu").view(B, nhl, P)
        Bm = apply_act(Bt, "silu").view(B, G, N)[:, g0:g1].float() \
            .repeat_interleave(nhl // (g1 - g0), dim=1)
        Cm = apply_act(Ct, "silu").view(B, G, N)[:, g0:g1].float() \
            .repeat_interleave(nhl // (g1 - g0), dim=1)
        dt = _softplus(dt_raw[:, 0].float() + dt_bias)
        dA = torch.exp(dt * A)                               # (B, nhl)
        state = cache["state"] * dA[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xh.float(), Bm, dt)
        y = torch.einsum("bhpn,bhn->bhp", state, Cm)
        y = y + D_skip[None, :, None] * xh.float()
        y = y.reshape(B, 1, nhl * P).to(x.dtype)
        new_cache = {"state": state, "conv_x": cs_x, "conv_B": cs_B,
                     "conv_C": cs_C}
    else:
        xh = apply_act(causal_conv(xr, conv_x, w), "silu")
        Bm = apply_act(causal_conv(Br, p["conv_B"], w), "silu")
        Cm = apply_act(causal_conv(Cr, p["conv_C"], w), "silu")
        if split:
            Bm, Cm = copy_to(Bm, "model"), copy_to(Cm, "model")
        xh = xh.reshape(B, S, nhl, P)
        Bm = Bm.reshape(B, S, G, N)[:, :, g0:g1].float()
        Cm = Cm.reshape(B, S, G, N)[:, :, g0:g1].float()
        dt = _softplus(dt_raw.float() + dt_bias)
        scan = ssd_chunked_train if mode == "train" else ssd_chunked
        y, final_state = scan(xh, Bm, Cm, dt, A, min(cfg.ssm_chunk, S))
        y = y + D_skip[None, None, :, None] * xh.float()
        y = y.reshape(B, S, nhl * P).to(x.dtype)
        new_cache = None if mode == "train" else {"state": final_state,
                     "conv_x": xr[:, -(w - 1):].contiguous(),
                     "conv_B": Br[:, -(w - 1):, clo:chi].contiguous(),
                     "conv_C": Cr[:, -(w - 1):, clo:chi].contiguous()}
    # gated RMSNorm, then the out projection (mamba2)
    yf = y.float() * F.silu(z.float())
    if nhl == nh:
        var = yf.square().mean(-1, keepdim=True)
    else:
        var = _norm_sum(yf.square().sum(-1, keepdim=True)) / di
    yf = yf * torch.rsqrt(var + cfg.norm_eps) * (
        1.0 + _share_of(p["out_norm"], lo * P, hi * P, di).float())
    out = yf.to(x.dtype) @ p["out_proj"]
    if nhl != nh:
        out = all_reduce(out, "model")
    return out, new_cache


def ssd_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                   device=None):
    GN = cfg.ssm_groups * cfg.ssm_state
    w = cfg.conv_width - 1
    return {
        "state": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((B, w, cfg.d_inner), dtype=cfg.dtype,
                              device=device),
        "conv_B": torch.zeros((B, w, GN), dtype=cfg.dtype, device=device),
        "conv_C": torch.zeros((B, w, GN), dtype=cfg.dtype, device=device),
    }


# -- block = norm -> mixer -> residual [-> norm -> mlp -> residual] -----------

_MIXERS = {"attn": (attn_params, attn_forward, attn_cache_spec),
           "rglru": (rglru_params, rglru_forward, rglru_cache_spec),
           "ssd": (ssd_params, ssd_forward, ssd_cache_spec)}


def block_params(gen, cfg: ModelConfig, blk: BlockCfg):
    p = {"norm1": norm_params(cfg.d_model, cfg.norm, cfg.dtype, gen.device),
         "mixer": _MIXERS[blk.mixer][0](gen, cfg)}
    if blk.mlp != "none":
        p["norm2"] = norm_params(cfg.d_model, cfg.norm, cfg.dtype,
                                 gen.device)
        if blk.mlp == "moe":
            p["mlp"] = moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                  cfg.glu, cfg.dtype)
        else:
            p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.glu,
                                  cfg.dtype)
    return p


def block_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                  pos: int, pad_to: int = 0):
    """Returns (x, new_cache, aux); new_cache is None in train."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    h = apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    mix, new_cache = _MIXERS[blk.mixer][1](h, p["mixer"], cfg, blk, mode,
                                           cache, pos, pad_to)
    x = x + mix
    aux = 0.0
    if blk.mlp != "none":
        h2 = apply_norm(x, p["norm2"], cfg.norm, cfg.norm_eps)
        if blk.mlp == "moe":
            out, aux = moe_layer_sharded(
                h2, p["mlp"], top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, act=cfg.act,
                glu=cfg.glu, no_drop=(mode == "decode"))
        else:
            out = mlp(h2, p["mlp"], cfg.act, cfg.glu, d_ff=cfg.d_ff)
        x = x + out
    return x, new_cache, aux


def block_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                     device=None):
    return _MIXERS[blk.mixer][2](cfg, blk, B, ctx, device)
