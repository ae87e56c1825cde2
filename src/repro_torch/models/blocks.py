"""Layer blocks: the attention and SSD mixers and the dense MLP.

Port of `repro.models.blocks` (lines 31-130, 206-432). A block is
pre-norm -> mixer -> residual [-> pre-norm -> mlp -> residual]; mamba2
SSD blocks have no MLP. Two modes are ported, the serving ones:

  prefill - the full prompt, causal, returns the populated cache;
  decode  - one token, reads and writes the cache.

Decode writes the new token's K/V slot (`slot = pos % C`, the ring
buffer of reference lines 89-99) into the cache's tensors in place
instead of returning updated copies, so a cache passed to decode must
not be reused afterwards; the SSD state and conv windows are replaced
by new tensors. The SSD prefill pads the prompt to its chunk with
dt = 0 (exact no-op steps, reference lines 263-272) and runs kernel K4
(`repro_torch.kernels.ssd_scan`); its decode recurrence (lines 324-345)
is plain torch, as in the reference, which has no kernel there.

`block_forward` returns (x, new_cache): the reference's third output,
the MoE auxiliary loss, is 0 for every block ported here. The RG-LRU
mixer and the MoE MLP raise NotImplementedError (ROADMAP queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan as k4
from .attention import decode_attention, flash_attention, repeat_kv
from .config import BlockCfg, ModelConfig
from .layers import apply_act, apply_norm, apply_rope, dense_init, mlp, \
    mlp_params, norm_params

MODES = ("prefill", "decode")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, the model zoo's "
        f"training slice)")


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


def attn_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                 pos: int, pad_to: int = 0):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, K, hd)
    v = (x @ p["wv"]).view(B, S, K, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)

    if mode == "decode":
        at = torch.full((1, 1), pos, device=x.device)
        q = apply_rope(q, at, blk.rope_theta)
        k = apply_rope(k, at, blk.rope_theta)
        C = cache["k"].shape[1]
        slot = pos % C
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["positions"][slot] = pos
        o = decode_attention(q, cache["k"], cache["v"], cache["positions"],
                             pos, window=blk.window)
        new_cache = cache
    else:
        positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, blk.rope_theta)
        k = apply_rope(k, positions, blk.rope_theta)
        o = flash_attention(q, repeat_kv(k, H // K), repeat_kv(v, H // K),
                            causal=True, window=blk.window,
                            block_q=min(cfg.attn_chunk, S),
                            block_kv=min(cfg.attn_chunk, S))
        C = blk.cache_len(max(pad_to, S))
        if S <= C:
            padw = (0, 0, 0, 0, 0, C - S)
            new_cache = {
                "k": F.pad(k, padw), "v": F.pad(v, padw),
                "positions": torch.cat([
                    torch.arange(S, dtype=torch.int32, device=x.device),
                    torch.full((C - S,), -1, dtype=torch.int32,
                               device=x.device)])}
        else:
            # windowed: slot j holds the latest position p with p % C == j
            j = torch.arange(C, device=x.device)
            p_j = (S - 1) - ((S - 1 - j) % C)
            new_cache = {"k": k[:, p_j].contiguous(),
                         "v": v[:, p_j].contiguous(),
                         "positions": p_j.to(torch.int32)}
    out = o.reshape(B, S, H * hd) @ p["wo"]
    return out, new_cache


def attn_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                    device=None):
    C = blk.cache_len(ctx)
    shape = (B, C, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "positions": torch.full((C,), -1, dtype=torch.int32,
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


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(xh, Bm, Cm, dt, A, chunk: int):
    """The prefill scan: pad S to the chunk with dt = 0 (decay 1, input
    0: exact no-op steps), run K4, cut the padding. xh (B, S, nh, P);
    Bm/Cm (B, S, G, N) float32; dt (B, S, nh) float32; A (nh,) float32.
    Returns (y (B, S, nh, P) in xh's dtype, final state (B, nh, P, N))."""
    S = xh.shape[1]
    pad = (-S) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = k4.ssd_scan(xh.contiguous(), Bm.contiguous(),
                           Cm.contiguous(), dt.contiguous(), A, chunk=chunk)
    return y[:, :S], state


def ssd_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                pos: int, pad_to: int = 0):
    B, S, _ = x.shape
    di, N, G, nh, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    w = cfg.conv_width
    z = x @ p["in_z"]
    xr = x @ p["in_x"]
    Br = x @ p["in_B"]
    Cr = x @ p["in_C"]
    dt_raw = x @ p["in_dt"]
    A = -torch.exp(p["A_log"])                               # (nh,)

    if mode == "decode":
        xt, cs_x = conv_step(xr[:, 0], cache["conv_x"], p["conv_x"], w)
        Bt, cs_B = conv_step(Br[:, 0], cache["conv_B"], p["conv_B"], w)
        Ct, cs_C = conv_step(Cr[:, 0], cache["conv_C"], p["conv_C"], w)
        xh = apply_act(xt, "silu").view(B, nh, P)
        Bm = apply_act(Bt, "silu").view(B, G, N).float().repeat_interleave(
            nh // G, dim=1)
        Cm = apply_act(Ct, "silu").view(B, G, N).float().repeat_interleave(
            nh // G, dim=1)
        dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])
        dA = torch.exp(dt * A)                               # (B, nh)
        state = cache["state"] * dA[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xh.float(), Bm, dt)
        y = torch.einsum("bhpn,bhn->bhp", state, Cm)
        y = y + p["D_skip"][None, :, None] * xh.float()
        y = y.reshape(B, 1, di).to(x.dtype)
        new_cache = {"state": state, "conv_x": cs_x, "conv_B": cs_B,
                     "conv_C": cs_C}
    else:
        xh = apply_act(causal_conv(xr, p["conv_x"], w), "silu")
        Bm = apply_act(causal_conv(Br, p["conv_B"], w), "silu")
        Cm = apply_act(causal_conv(Cr, p["conv_C"], w), "silu")
        xh = xh.reshape(B, S, nh, P)
        Bm = Bm.reshape(B, S, G, N).float()
        Cm = Cm.reshape(B, S, G, N).float()
        dt = _softplus(dt_raw.float() + p["dt_bias"])
        y, final_state = ssd_chunked(xh, Bm, Cm, dt, A,
                                     min(cfg.ssm_chunk, S))
        y = y + p["D_skip"][None, None, :, None] * xh.float()
        y = y.reshape(B, S, di).to(x.dtype)
        new_cache = {"state": final_state,
                     "conv_x": xr[:, -(w - 1):].contiguous(),
                     "conv_B": Br[:, -(w - 1):].contiguous(),
                     "conv_C": Cr[:, -(w - 1):].contiguous()}
    # gated RMSNorm, then the out projection (mamba2)
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p["out_norm"].float())
    return yf.to(x.dtype) @ p["out_proj"], new_cache


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
           "ssd": (ssd_params, ssd_forward, ssd_cache_spec)}


def _mixer(blk: BlockCfg):
    if blk.mixer not in _MIXERS:
        raise _not_ported(f"the {blk.mixer!r} mixer")
    if blk.mlp == "moe":
        raise _not_ported("the MoE MLP")
    return _MIXERS[blk.mixer]


def block_params(gen, cfg: ModelConfig, blk: BlockCfg):
    mixer_init = _mixer(blk)[0]
    p = {"norm1": norm_params(cfg.d_model, cfg.norm, cfg.dtype, gen.device),
         "mixer": mixer_init(gen, cfg)}
    if blk.mlp != "none":
        p["norm2"] = norm_params(cfg.d_model, cfg.norm, cfg.dtype,
                                 gen.device)
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.glu, cfg.dtype)
    return p


def block_forward(x, p, cfg: ModelConfig, blk: BlockCfg, mode: str, cache,
                  pos: int, pad_to: int = 0):
    """Returns (x, new_cache)."""
    if mode not in MODES:
        raise _not_ported(f"mode {mode!r}")
    mixer_fwd = _mixer(blk)[1]
    h = apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    mix, new_cache = mixer_fwd(h, p["mixer"], cfg, blk, mode, cache, pos,
                               pad_to)
    x = x + mix
    if blk.mlp != "none":
        h2 = apply_norm(x, p["norm2"], cfg.norm, cfg.norm_eps)
        x = x + mlp(h2, p["mlp"], cfg.act, cfg.glu)
    return x, new_cache


def block_cache_spec(cfg: ModelConfig, blk: BlockCfg, B: int, ctx: int,
                     device=None):
    return _mixer(blk)[2](cfg, blk, B, ctx, device)
