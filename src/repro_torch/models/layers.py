"""Shared layers: init, norms, RoPE and (gated) MLPs.

Port of `repro.models.layers` (lines 19-115; `sinusoidal_pos`, the
encoder-decoder's position table, lines 79-88). Parameters are plain
tensors in nested dicts, laid out as the reference's (`x @ W`, W of
shape (in, out)); functions are pure. Compute follows the input dtype
with float32 statistics where the reference takes them (norms, RoPE).
The chunked cross-entropy loss is training and is not ported yet; the
embedding is a plain row index (`model._embed`), which returns the same
rows as the reference's one-hot matmul.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.bfloat16):
    """Normal(0, scale^2) in float32 from `gen`, cast to `dtype`, on
    the generator's device; scale defaults to fan_in^-0.5."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (1.0 / fan_in) ** 0.5 if scale is None else scale
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with the scale stored as (1 + scale)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dt)


def norm_params(d: int, kind: str, dtype, device):
    if kind == "layer":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(x, p, kind: str, eps: float = 1e-6):
    if kind == "layer":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions broadcastable to (..., S). Float32,
    split-half rotation, result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * freqs           # (..., S, hd/2)
    ang = ang[..., None, :]                              # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d: int, dtype=torch.bfloat16, device=None):
    """(seq_len, d) table: sin at even columns, cos at odd, computed in
    float32 as the reference computes it, cast to `dtype`."""
    f32 = torch.float32
    pos = torch.arange(seq_len, dtype=f32, device=device)[:, None]
    step = -torch.log(torch.tensor(10_000.0, dtype=f32)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=f32, device=device)
                    * step.to(device))
    pe = torch.zeros((seq_len, d), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def mlp_params(gen, d: int, f: int, glu: bool, dtype):
    p = {"up": dense_init(gen, (d, f), dtype=dtype),
         "down": dense_init(gen, (f, d), dtype=dtype)}
    if glu:
        p["gate"] = dense_init(gen, (d, f), dtype=dtype)
    return p


def apply_act(x, act: str):
    """silu, or gelu in its tanh form (jax.nn.gelu's default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(x, p, act: str = "silu", glu: bool = True):
    up = x @ p["up"]
    h = apply_act(x @ p["gate"], act) * up if glu else apply_act(up, act)
    return h @ p["down"]
