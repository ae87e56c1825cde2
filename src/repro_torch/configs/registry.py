"""Architecture registry: the ten assigned configs, the paper's Qwen2.5
routing pool and the smoke-reduced variants.

Port of `repro.configs.registry` (lines 1-150 and 199-215) without jax:
the same entries, field for field. `input_specs` (abstract inputs for
the dry run) is not ported here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..models.config import BlockCfg, ModelConfig

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# [hf:ibm-granite/granite-3.0-2b-base; hf] - dense GQA
_register(ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155,
    pattern=(BlockCfg(mixer="attn"),)))

# [hf:Qwen/Qwen3-8B; hf] - qk_norm, GQA
_register(ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=3072, vocab=151936, qk_norm=True,
    pattern=(BlockCfg(mixer="attn"),)))

# [arXiv:2404.14219; unverified] - RoPE SwiGLU GQA (kv=32 => MHA)
_register(ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    pattern=(BlockCfg(mixer="attn"),)))

# [hf:google/gemma-3-1b-pt; unverified] - 5:1 local:global, 128k
_register(ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
    embed_scale=math.sqrt(5376.0),
    pattern=tuple([BlockCfg(mixer="attn", window=1024,
                            rope_theta=10_000.0)] * 5
                  + [BlockCfg(mixer="attn", rope_theta=1_000_000.0)])))

# [arXiv:2402.19427; hf] - RG-LRU + local attn, 1:2
_register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, lru_width=2560,
    act="gelu", embed_scale=math.sqrt(2560.0),
    pattern=(BlockCfg(mixer="rglru"), BlockCfg(mixer="rglru"),
             BlockCfg(mixer="attn", window=2048))))

# [hf:microsoft/Phi-3-vision-128k-instruct; hf] - phi3-mini + CLIP stub
_register(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    frontend="vision", frontend_dim=1024, n_frontend_tokens=576,
    pattern=(BlockCfg(mixer="attn"),)))

# [arXiv:2212.04356; unverified] - enc-dec, conv frontend (stub)
_register(ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, n_enc_layers=4,
    norm="layer", act="gelu", glu=False, frontend="audio", frontend_dim=80,
    dec_max_len=448, pattern=(BlockCfg(mixer="attn"),)))

# [arXiv:2405.21060; unverified] - SSD (state-space duality), attn-free
_register(ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280, ssm_state=128,
    ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    pattern=(BlockCfg(mixer="ssd", mlp="none"),)))

# [arXiv:2401.04088; hf] - 8 experts top-2, SWA (window 4096)
_register(ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    n_experts=8, top_k=2,
    pattern=(BlockCfg(mixer="attn", window=4096, mlp="moe"),)))

# [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] - 40 experts top-8
_register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    pattern=(BlockCfg(mixer="attn", mlp="moe"),)))


# Paper routing pool: Qwen2.5 3B/7B/14B/72B [Qwen2.5 technical report],
# read by the serving tiers' roofline TPOT model.
QWEN25_POOL: Dict[str, ModelConfig] = {
    cfg.name: cfg for cfg in (
        ModelConfig(name="qwen2.5-3b", family="dense", n_layers=36,
                    d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
                    vocab=151936, pattern=(BlockCfg(mixer="attn"),)),
        ModelConfig(name="qwen2.5-7b", family="dense", n_layers=28,
                    d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
                    vocab=152064, pattern=(BlockCfg(mixer="attn"),)),
        ModelConfig(name="qwen2.5-14b", family="dense", n_layers=48,
                    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
                    vocab=152064, pattern=(BlockCfg(mixer="attn"),)),
        ModelConfig(name="qwen2.5-72b", family="dense", n_layers=80,
                    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
                    vocab=152064, pattern=(BlockCfg(mixer="attn"),)),
    )}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Same family, tiny widths, CPU-runnable (one cycle of the pattern
    plus one remainder layer)."""
    pat = tuple(dataclasses.replace(b, window=(16 if b.window else 0))
                for b in cfg.pattern)
    return cfg.replace(
        n_layers=len(cfg.pattern) + 1, d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512, pattern=pat, embed_scale=1.0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        lru_width=64 if cfg.lru_width else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8, ssm_chunk=16,
        n_enc_layers=2 if cfg.n_enc_layers else 0, dec_max_len=16,
        frontend_dim=12 if cfg.frontend_dim else 0,
        n_frontend_tokens=4 if cfg.n_frontend_tokens else 0,
        attn_chunk=16, loss_chunk=64, remat=False)


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in QWEN25_POOL:
        return QWEN25_POOL[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def list_archs():
    return sorted(ARCHS)
