"""Model and shape configuration for the model zoo.

Port of `repro.models.config` (lines 1-196): one `ModelConfig` describes
any architecture of the zoo as a repeating `pattern` of `BlockCfg`
slots (mixer + mlp). The only change is the type of `dtype`, a torch
dtype (`torch.bfloat16` by default, the reference's `jnp.bfloat16` at
line 87).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class BlockCfg:
    """One layer slot in the repeating layer pattern."""

    mixer: str = "attn"          # attn | rglru | ssd
    window: int = 0              # 0 = full attention; >0 = sliding window
    mlp: str = "dense"           # dense | moe | none
    rope_theta: float = 10_000.0

    def cache_len(self, seq_len: int) -> int:
        """KV-cache length this slot needs for a context of `seq_len`."""
        if self.mixer != "attn":
            return 0
        if self.window > 0:
            return min(self.window, seq_len)
        return seq_len


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    pattern: Tuple[BlockCfg, ...] = (BlockCfg(),)
    norm: str = "rms"             # rms | layer
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU / plain)
    glu: bool = True              # gated MLP vs plain 2-layer
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1
    conv_width: int = 4
    # --- hybrid (RG-LRU / griffin) ---
    lru_width: int = 0
    # --- enc-dec ---
    n_enc_layers: int = 0         # >0 => encoder-decoder; n_layers = decoder
    dec_max_len: int = 448
    # --- vlm / audio stub frontends ---
    frontend: str = "none"        # none | vision | audio
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    embed_scale: float = 1.0      # gemma-style sqrt(d_model) embed scaling
    # --- numerics / lowering ---
    vocab_pad_to: int = 1         # pad embedding rows to a multiple
    dtype: Any = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 8192
    attn_chunk: int = 512         # flash-attention KV block
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def layer_types(self) -> Tuple[BlockCfg, ...]:
        """Per-layer BlockCfg, the pattern cycled over n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> dict:
        """Total and active parameters (MoE: top_k experts active)."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        H, K = self.n_heads, self.n_kv_heads
        total = V * D
        if not self.tie_embeddings:
            total += V * D
        active = total
        for blk in self.layer_types:
            n = 2 * D
            if blk.mixer == "attn":
                n += D * H * hd + 2 * D * K * hd + H * hd * D
                if self.qk_norm:
                    n += 2 * hd
            elif blk.mixer == "ssd":
                di, N, G, nh = (self.d_inner, self.ssm_state,
                                self.ssm_groups, self.ssm_heads)
                n += D * (2 * di + 2 * G * N + nh)
                n += self.conv_width * (di + 2 * G * N)
                n += di * D + di + 2 * nh
            elif blk.mixer == "rglru":
                W = self.lru_width or D
                n += 2 * D * W + W * D + 2 * W * W + 3 * W \
                    + self.conv_width * W
            n_active = n
            if blk.mlp == "dense":
                n += (3 if self.glu else 2) * D * F
                n_active = n
            elif blk.mlp == "moe":
                e = (3 if self.glu else 2) * D * F
                n += self.n_experts * e + D * self.n_experts
                n_active += self.top_k * e + D * self.n_experts
            total += n
            active += n_active
        if self.is_encdec:
            enc = self.n_enc_layers * (
                D * H * hd + 2 * D * K * hd + H * hd * D + 2 * D * F + 4 * D)
            cross = self.n_layers * (D * H * hd + 2 * D * K * hd
                                     + H * hd * D + 2 * D)
            total += enc + cross
            active += enc + cross
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str = "train") -> ShapeSpec:
    return ShapeSpec(f"smoke_{kind}", 128, 2, kind)
