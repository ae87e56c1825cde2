"""Whisper-style encoder-decoder: parameters, the encoder, the training
loss and the serving path (prefill, then decode steps).

Port of `repro.models.encdec` (lines 29-249; `_masked_logits` is
`model.masked_logits` on the tied table).
The audio frontend is the reference's stub: precomputed frames (B,
S_enc, frontend_dim) through one linear projection, plus a sinusoidal
position table. The encoder is bidirectional; the decoder
has causal self-attention over a ring of `dec_max_len` slots and
cross-attention over the encoded frames. Prefill runs the decoder
prefix in one pass through `flash_attention` (causal self-attention,
bidirectional cross-attention); each decode step makes two K3 calls per
decoder layer, self-attention over the ring and cross-attention over
the precomputed cross K/V with positions 0..enc_len-1 and pos =
enc_len, so every frame is valid.

Parameters are a tree {"frontend_proj", "embed", "pos_dec", "enc":
[layer, ...], "dec": [layer, ...], "enc_norm", "dec_norm"} (the
reference stacks `enc` and `dec` over their layers; here they are
lists, as the decoder-only model's `layers`). The cache keeps the
port's style: {"pos": int, "enc_len": int, "positions": (C,) int32
shared by the layers, "layers": [{"self_k", "self_v", "cross_k",
"cross_v"}, ...]}, the self-attention tensors and `positions` written
in place by decode, so a cache passed to `decode_step` must not be
reused. `loss_fn` (lines 112-137) runs the encoder and the decoder
over the whole sequence, causal self-attention and bidirectional
cross-attention through `flash_attention`, each layer under
`torch.utils.checkpoint` when `cfg.remat` and autograd records, as the
reference's scanned bodies sit under `jax.checkpoint`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.shardctx import all_reduce, axis_size, copy_to, \
    kv_cache_dim, local_range, share
from .attention import decode_attention, flash_attention, repeat_kv, \
    split_decode_attention
from .blocks import whole_columns
from .config import ModelConfig
from .layers import apply_norm, chunked_ce_loss, dense_init, embed_lookup, \
    mlp, mlp_params, norm_params, remat, sinusoidal_pos
from .model import masked_logits


def _attn_p(gen, cfg: ModelConfig, dtype):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": dense_init(gen, (D, H * hd), dtype=dtype),
            "wk": dense_init(gen, (D, K * hd), dtype=dtype),
            "wv": dense_init(gen, (D, K * hd), dtype=dtype),
            "wo": dense_init(gen, (H * hd, D), dtype=dtype)}


def _norm_p(cfg: ModelConfig, device):
    return norm_params(cfg.d_model, cfg.norm, cfg.dtype, device)


def _enc_layer_p(gen, cfg: ModelConfig):
    return {"norm1": _norm_p(cfg, gen.device),
            "attn": _attn_p(gen, cfg, cfg.dtype),
            "norm2": _norm_p(cfg, gen.device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.glu,
                              cfg.dtype)}


def _dec_layer_p(gen, cfg: ModelConfig):
    p = _enc_layer_p(gen, cfg)
    p["norm_x"] = _norm_p(cfg, gen.device)
    p["xattn"] = _attn_p(gen, cfg, cfg.dtype)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """The parameter tree, drawn from `gen` on its device."""
    return {
        "frontend_proj": dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                    dtype=cfg.dtype),
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                            scale=0.02, dtype=cfg.dtype),
        "pos_dec": dense_init(gen, (cfg.dec_max_len, cfg.d_model),
                              scale=0.02, dtype=cfg.dtype),
        "enc": [_enc_layer_p(gen, cfg) for _ in range(cfg.n_enc_layers)],
        "dec": [_dec_layer_p(gen, cfg) for _ in range(cfg.n_layers)],
        "enc_norm": _norm_p(cfg, gen.device),
        "dec_norm": _norm_p(cfg, gen.device),
    }


def _qkv(x_q, x_kv, p, cfg: ModelConfig):
    """This rank's attention inputs under the pinned plan (all of them
    without one): q (B, Sq, h, hd) unless `x_q` is None, and k, v
    (B, Skv, k, hd) unless `x_kv` is None, with `cut` None where `wq` /
    `wk` / `wv` hold whole heads (the rank's own), else the [lo, hi) of
    `wo`'s rows: the projections are then gathered to whole heads over
    "model" (`blocks.whole_columns`; self-attention's three in one
    all-gather). Under autograd the replicated inputs' gradients are
    summed over "model" where the projections are split (once for
    self-attention, whose `x_kv` is `x_q`)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Hc, Kc = p["wq"].shape[1], p["wk"].shape[1]
    split = Hc != H * hd or Kc != K * hd

    def proj(x, names):
        if x is None:
            return [None] * len(names)
        x = copy_to(x, "model") if split else x
        return [x @ p[n] for n in names]
    if x_kv is x_q:
        q, k, v = proj(x_q, ("wq", "wk", "wv"))
    else:
        (q,), (k, v) = proj(x_q, ("wq",)), proj(x_kv, ("wk", "wv"))
    cut = None
    if not (Hc % hd == 0 and Kc % hd == 0 and Hc * K == Kc * H):
        cut = local_range(H * hd, p["wo"].shape[0])
        grad = "scatter" if cut[1] - cut[0] < H * hd else "slice"
        full = (H * hd, K * hd, K * hd)
        out = [q, k, v]
        for group in ([0, 1, 2],) if x_kv is x_q else ([0], [1, 2]):
            if out[group[0]] is not None:
                got = whole_columns([(out[i], full[i]) for i in group],
                                    grad=grad)
                for i, t in zip(group, got):
                    out[i] = t
        q, k, v = out

    def heads(t):
        return None if t is None else t.view(t.shape[0], t.shape[1], -1, hd)
    return heads(q), heads(k), heads(v), cut


def _out(o, p, cfg: ModelConfig, cut):
    """o (B, S, h, hd) of the heads this rank attended -> the rank's
    `wo` rows' columns, through `wo`, summed over "model" where `wo` is
    split."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if cut is not None:
        lo, hi = cut
        h0 = lo // cfg.hd * cfg.hd
        o = o[..., lo - h0:hi - h0]
    out = o @ p["wo"]
    if p["wo"].shape[0] != cfg.n_heads * cfg.hd:
        out = all_reduce(out, "model")
    return out


def _attend(q, k, v, cfg: ModelConfig, cut, causal: bool, bq: int,
            bkv: int):
    """flash_attention of this rank's heads: its own (`cut` None), or
    the query heads [h0, h1) that its `wo` rows read of whole q, k, v."""
    if cut is not None:
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h0, h1 = cut[0] // hd, -(-cut[1] // hd)
        idx = torch.arange(h0, h1, device=q.device) // (H // K)
        q, k, v = q[:, :, h0:h1], k.index_select(2, idx), \
            v.index_select(2, idx)
    else:
        g = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, g), repeat_kv(v, g)
    return flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)


def _mha(x_q, x_kv, p, cfg: ModelConfig, *, causal: bool):
    q, k, v, cut = _qkv(x_q, x_kv, p, cfg)
    o = _attend(q, k, v, cfg, cut, causal, min(cfg.attn_chunk, q.shape[1]),
                min(cfg.attn_chunk, k.shape[1]))
    return _out(o, p, cfg, cut)


def _embed(params, cfg: ModelConfig, tokens, at):
    """Token rows (the table may be this rank's vocabulary share,
    `layers.embed_lookup`) plus the decoder's learned positions `at`."""
    return embed_lookup(tokens, params["embed"], rows=cfg.padded_vocab) \
        + params["pos_dec"][at][None]


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, frontend_dim) -> (B, S_enc, D). A
    `frontend_proj` split by columns is gathered over "model"."""
    x = frames.to(cfg.dtype) @ params["frontend_proj"]
    x, = whole_columns([(x, cfg.d_model)], grad="slice")
    x = x + sinusoidal_pos(x.shape[1], cfg.d_model, cfg.dtype,
                           x.device)[None]

    def body(h, lp):
        s = apply_norm(h, lp["norm1"], cfg.norm, cfg.norm_eps)
        h = h + _mha(s, s, lp["attn"], cfg, causal=False)
        return h + mlp(apply_norm(h, lp["norm2"], cfg.norm, cfg.norm_eps),
                       lp["mlp"], cfg.act, cfg.glu, d_ff=cfg.d_ff)
    for lp in params["enc"]:
        x = remat(cfg.remat, body, x, lp)
    return apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: frames (B, S_enc, frontend_dim), tokens (B, S_dec), labels
    (B, S_dec), optional loss_mask. Returns (ce, {"ce", "aux": 0})."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens, slice(0, tokens.shape[1]))

    def body(h, lp):
        s = apply_norm(h, lp["norm1"], cfg.norm, cfg.norm_eps)
        h = h + _mha(s, s, lp["attn"], cfg, causal=True)
        c = apply_norm(h, lp["norm_x"], cfg.norm, cfg.norm_eps)
        h = h + _mha(c, enc_out, lp["xattn"], cfg, causal=False)
        return h + mlp(apply_norm(h, lp["norm2"], cfg.norm, cfg.norm_eps),
                       lp["mlp"], cfg.act, cfg.glu, d_ff=cfg.d_ff)
    for lp in params["dec"]:
        x = remat(cfg.remat, body, x, lp)
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    ce = chunked_ce_loss(x, params["embed"], batch["labels"],
                         batch.get("loss_mask"), cfg.loss_chunk,
                         valid_vocab=cfg.vocab, rows=cfg.padded_vocab)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def init_cache(cfg: ModelConfig, batch: int, enc_len: int, device=None):
    K, hd, C = cfg.n_kv_heads, cfg.hd, cfg.dec_max_len

    def zeros(n):
        return torch.zeros((batch, n, K, hd), dtype=cfg.dtype, device=device)
    return {"pos": 0, "enc_len": enc_len,
            "positions": torch.full((C,), -1, dtype=torch.int32,
                                    device=device),
            "layers": [{"self_k": zeros(C), "self_v": zeros(C),
                        "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}
                       for _ in range(cfg.n_layers)]}


def _cache_share(t, cut):
    """A (B, C, k, hd) cache tensor as this rank holds it: as it is where
    the heads are its own (`cut` None), else, from whole heads, its piece
    where `cache_pspecs` splits it over "model" (the slots; head_dim is
    refused)."""
    if cut is None:
        return t
    d = kv_cache_dim(t.shape[1], t.shape[2], t.shape[3],
                     axis_size("model"))
    if d == -1:
        raise NotImplementedError("a KV cache split over head_dim")
    if d is None:
        return t
    lo, hi = share(t.shape[d])
    return t.narrow(d, lo, hi - lo).contiguous()


def prefill(params, cfg: ModelConfig, frames, tokens):
    """Encode the frames, precompute each decoder layer's cross K/V, run
    the decoder prefix tokens (B, S0) in one pass. Returns (logits (B, V)
    float32 at the last prefix token, cache). Under a plan the logits
    are this rank's vocabulary share and the caches its pieces."""
    B, S0 = tokens.shape
    C = cfg.dec_max_len
    enc_out = encode(params, cfg, frames)
    enc_len = enc_out.shape[1]
    x = _embed(params, cfg, tokens, slice(0, S0))
    padw = (0, 0, 0, 0, 0, C - S0)
    layers = []
    for lp in params["dec"]:
        s = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
        q, k, v, cut = _qkv(s, s, lp["attn"], cfg)
        o = _attend(q, k, v, cfg, cut, True, S0, S0)
        x = x + _out(o, lp["attn"], cfg, cut)
        c = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
        x = x + _mha(c, enc_out, lp["xattn"], cfg, causal=False)
        x = x + mlp(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps),
                    lp["mlp"], cfg.act, cfg.glu, d_ff=cfg.d_ff)
        _, ck, cv, xcut = _qkv(None, enc_out, lp["xattn"], cfg)
        layers.append({
            "self_k": _cache_share(F.pad(k, padw), cut),
            "self_v": _cache_share(F.pad(v, padw), cut),
            "cross_k": _cache_share(ck, xcut),
            "cross_v": _cache_share(cv, xcut)})
    positions = torch.cat([
        torch.arange(S0, dtype=torch.int32, device=x.device),
        torch.full((C - S0,), -1, dtype=torch.int32, device=x.device)])
    cache = {"pos": S0, "enc_len": enc_len, "positions": positions,
             "layers": layers}
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    return masked_logits(x[:, -1], params["embed"], cfg), cache


def _decode_attend(q, k_cache, v_cache, positions, pos: int, cfg, cut):
    """K3 for one decode token: over this rank's heads and cache
    (`cut` None), or, for the query heads its `wo` rows read, over its
    share of the slots (merged over "model" by each head's (max,
    exp-sum)) or the whole cache (`attention.split_decode_attention`)."""
    if cut is None:
        return decode_attention(q, k_cache, v_cache, positions, pos)
    hd = cfg.hd
    C = positions.shape[0]
    lo, hi = local_range(C, k_cache.shape[1])
    return split_decode_attention(q, k_cache, v_cache, positions[lo:hi],
                                  pos, (cut[0] // hd, -(-cut[1] // hd)),
                                  split=hi - lo < C)


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) decoder tokens. Returns (logits (B, V) float32, new
    cache); the self-attention ring and `positions` are written in
    place (under a plan, a slot this rank's share of the slots holds)."""
    pos, enc_len = cache["pos"], cache["enc_len"]
    dec_pos = min(max(pos, 0), cfg.dec_max_len - 1)
    x = _embed(params, cfg, tokens, slice(dec_pos, dec_pos + 1))
    positions = cache["positions"]
    C = positions.shape[0]
    slot = pos % C
    positions[slot] = pos
    enc_positions = torch.arange(enc_len, dtype=torch.int32,
                                 device=x.device)
    for lp, lc in zip(params["dec"], cache["layers"]):
        s = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
        q, k, v, cut = _qkv(s, s, lp["attn"], cfg)
        lo, hi = local_range(C, lc["self_k"].shape[1])
        if lo <= slot < hi:
            lc["self_k"][:, slot - lo] = k[:, 0]
            lc["self_v"][:, slot - lo] = v[:, 0]
        o = _decode_attend(q, lc["self_k"], lc["self_v"], positions, pos,
                           cfg, cut)
        x = x + _out(o, lp["attn"], cfg, cut)
        c = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
        qx, _, _, xcut = _qkv(c, None, lp["xattn"], cfg)
        ox = _decode_attend(qx, lc["cross_k"], lc["cross_v"],
                            enc_positions, enc_len, cfg, xcut)
        x = x + _out(ox, lp["xattn"], cfg, xcut)
        x = x + mlp(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps),
                    lp["mlp"], cfg.act, cfg.glu, d_ff=cfg.d_ff)
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    return masked_logits(x[:, 0], params["embed"], cfg), \
        dict(cache, pos=pos + 1)
