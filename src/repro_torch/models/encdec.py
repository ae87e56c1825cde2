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

from .attention import decode_attention, flash_attention, repeat_kv
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


def _mha(x_q, x_kv, p, cfg: ModelConfig, *, causal: bool):
    B, Sq, _ = x_q.shape
    Skv = x_kv.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x_q @ p["wq"]).view(B, Sq, H, hd)
    k = (x_kv @ p["wk"]).view(B, Skv, K, hd)
    v = (x_kv @ p["wv"]).view(B, Skv, K, hd)
    o = flash_attention(q, repeat_kv(k, H // K), repeat_kv(v, H // K),
                        causal=causal, block_q=min(cfg.attn_chunk, Sq),
                        block_kv=min(cfg.attn_chunk, Skv))
    return o.reshape(B, Sq, H * hd) @ p["wo"]


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, frontend_dim) -> (B, S_enc, D)."""
    x = frames.to(cfg.dtype) @ params["frontend_proj"]
    x = x + sinusoidal_pos(x.shape[1], cfg.d_model, cfg.dtype,
                           x.device)[None]

    def body(h, lp):
        s = apply_norm(h, lp["norm1"], cfg.norm, cfg.norm_eps)
        h = h + _mha(s, s, lp["attn"], cfg, causal=False)
        return h + mlp(apply_norm(h, lp["norm2"], cfg.norm, cfg.norm_eps),
                       lp["mlp"], cfg.act, cfg.glu)
    for lp in params["enc"]:
        x = remat(cfg.remat, body, x, lp)
    return apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: frames (B, S_enc, frontend_dim), tokens (B, S_dec), labels
    (B, S_dec), optional loss_mask. Returns (ce, {"ce", "aux": 0})."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    x = embed_lookup(tokens, params["embed"]) \
        + params["pos_dec"][None, :tokens.shape[1]]

    def body(h, lp):
        s = apply_norm(h, lp["norm1"], cfg.norm, cfg.norm_eps)
        h = h + _mha(s, s, lp["attn"], cfg, causal=True)
        c = apply_norm(h, lp["norm_x"], cfg.norm, cfg.norm_eps)
        h = h + _mha(c, enc_out, lp["xattn"], cfg, causal=False)
        return h + mlp(apply_norm(h, lp["norm2"], cfg.norm, cfg.norm_eps),
                       lp["mlp"], cfg.act, cfg.glu)
    for lp in params["dec"]:
        x = remat(cfg.remat, body, x, lp)
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    ce = chunked_ce_loss(x, params["embed"], batch["labels"],
                         batch.get("loss_mask"), cfg.loss_chunk,
                         valid_vocab=cfg.vocab)
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


def prefill(params, cfg: ModelConfig, frames, tokens):
    """Encode the frames, precompute each decoder layer's cross K/V, run
    the decoder prefix tokens (B, S0) in one pass. Returns (logits (B, V)
    float32 at the last prefix token, cache)."""
    B, S0 = tokens.shape
    H, K, hd, C = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.dec_max_len
    enc_out = encode(params, cfg, frames)
    enc_len = enc_out.shape[1]
    x = params["embed"][tokens] + params["pos_dec"][None, :S0]
    padw = (0, 0, 0, 0, 0, C - S0)
    layers = []
    for lp in params["dec"]:
        s = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
        q = (s @ lp["attn"]["wq"]).view(B, S0, H, hd)
        k = (s @ lp["attn"]["wk"]).view(B, S0, K, hd)
        v = (s @ lp["attn"]["wv"]).view(B, S0, K, hd)
        o = flash_attention(q, repeat_kv(k, H // K), repeat_kv(v, H // K),
                            causal=True, block_q=S0, block_kv=S0)
        x = x + o.reshape(B, S0, H * hd) @ lp["attn"]["wo"]
        c = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
        x = x + _mha(c, enc_out, lp["xattn"], cfg, causal=False)
        x = x + mlp(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps),
                    lp["mlp"], cfg.act, cfg.glu)
        layers.append({
            "self_k": F.pad(k, padw), "self_v": F.pad(v, padw),
            "cross_k": (enc_out @ lp["xattn"]["wk"]).view(B, enc_len, K, hd),
            "cross_v": (enc_out @ lp["xattn"]["wv"]).view(B, enc_len, K, hd)})
    positions = torch.cat([
        torch.arange(S0, dtype=torch.int32, device=x.device),
        torch.full((C - S0,), -1, dtype=torch.int32, device=x.device)])
    cache = {"pos": S0, "enc_len": enc_len, "positions": positions,
             "layers": layers}
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    return masked_logits(x[:, -1], params["embed"], cfg), cache


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) decoder tokens. Returns (logits (B, V) float32, new
    cache); the self-attention ring and `positions` are written in
    place."""
    B = tokens.shape[0]
    pos, enc_len = cache["pos"], cache["enc_len"]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dec_pos = min(max(pos, 0), cfg.dec_max_len - 1)
    x = params["embed"][tokens] + params["pos_dec"][dec_pos][None, None]
    positions = cache["positions"]
    slot = pos % positions.shape[0]
    positions[slot] = pos
    enc_positions = torch.arange(enc_len, dtype=torch.int32,
                                 device=x.device)
    for lp, lc in zip(params["dec"], cache["layers"]):
        s = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
        q = (s @ lp["attn"]["wq"]).view(B, 1, H, hd)
        lc["self_k"][:, slot] = (s[:, 0] @ lp["attn"]["wk"]).view(B, K, hd)
        lc["self_v"][:, slot] = (s[:, 0] @ lp["attn"]["wv"]).view(B, K, hd)
        o = decode_attention(q, lc["self_k"], lc["self_v"], positions, pos)
        x = x + o.reshape(B, 1, H * hd) @ lp["attn"]["wo"]
        c = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
        qx = (c @ lp["xattn"]["wq"]).view(B, 1, H, hd)
        ox = decode_attention(qx, lc["cross_k"], lc["cross_v"],
                              enc_positions, enc_len)
        x = x + ox.reshape(B, 1, H * hd) @ lp["xattn"]["wo"]
        x = x + mlp(apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps),
                    lp["mlp"], cfg.act, cfg.glu)
    x = apply_norm(x, params["dec_norm"], cfg.norm, cfg.norm_eps)
    return masked_logits(x[:, 0], params["embed"], cfg), \
        dict(cache, pos=pos + 1)
