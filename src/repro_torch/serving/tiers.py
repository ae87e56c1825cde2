"""Heterogeneous serving tiers: (model, TPU-slice) pairs with a decode
roofline TPOT model and public per-token prices.

Port of `repro.serving.tiers` (numpy). The reference reaches its
hardware constants through `repro.launch.mesh` and its model shapes
through `repro.models.config` / `repro.configs.registry`, both of which
import jax; this module keeps its own copy of the four Qwen2.5 shapes
and of the dense-attention parameter count instead.

The tiers describe the *simulated* fleet of the paper's Table 1 pool
mapped to TPU v5e slices. Those constants are properties of the
simulated cluster, not of the device the scheduler runs on, and stay
exactly the reference's so that both simulations agree request for
request.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

# TPU v5e-class constants of the simulated fleet (repro.launch.mesh).
PEAK_FLOPS_BF16 = 197e12        # per chip, bf16
HBM_BW = 819e9                  # bytes/s per chip


@dataclasses.dataclass(frozen=True)
class DenseModelShape:
    """The dense-attention subset of `repro.models.config.ModelConfig`
    that the tier roofline reads: tied embeddings, gated MLP, no qk-norm
    (the reference's defaults for the Qwen2.5 pool)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def param_counts(self) -> Dict[str, int]:
        """`ModelConfig.param_counts` for a dense, tied, gated model."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        H, K = self.n_heads, self.n_kv_heads
        per_layer = (2 * D + D * H * hd + 2 * D * K * hd + H * hd * D
                     + 3 * D * F)
        total = V * D + self.n_layers * per_layer
        return {"total": int(total), "active": int(total)}


# Paper routing pool: Qwen2.5 3B/7B/14B/72B [Qwen2.5 technical report]
# (repro.configs.registry.QWEN25_POOL).
QWEN25_POOL: Dict[str, DenseModelShape] = {
    m.name: m for m in (
        DenseModelShape("qwen2.5-3b", 36, 2048, 16, 2, 11008, 151936),
        DenseModelShape("qwen2.5-7b", 28, 3584, 28, 4, 18944, 152064),
        DenseModelShape("qwen2.5-14b", 48, 5120, 40, 8, 13824, 152064),
        DenseModelShape("qwen2.5-72b", 80, 8192, 64, 8, 29568, 152064),
    )}


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str                 # e.g. "qwen2.5-72b/v5e-16"
    model: str                # model name in the routing pool
    model_cfg: Optional[DenseModelShape]
    n_chips: int
    n_instances: int
    price_in: float           # USD per 1M input tokens
    price_out: float          # USD per 1M output tokens
    bw_eff: float             # calibrated HBM efficiency
    flops_eff: float = 0.5
    overhead_s: float = 0.002
    max_batch: int = 48
    n_params: float = 0.0     # active params
    kv_bytes_per_token: float = 0.0

    def tpot(self, batch_size: float, mean_ctx: float) -> float:
        """Roofline decode-iteration time (s) = max of three terms."""
        b = max(batch_size, 1.0)
        weight_read = 2.0 * self.n_params / (HBM_BW * self.n_chips
                                             * self.bw_eff)
        kv_read = (b * mean_ctx * self.kv_bytes_per_token
                   / (HBM_BW * self.n_chips * self.bw_eff))
        compute = (2.0 * self.n_params * b
                   / (PEAK_FLOPS_BF16 * self.n_chips * self.flops_eff))
        return max(weight_read, kv_read, compute) + self.overhead_s

    def prefill_time(self, prompt_tokens: float) -> float:
        flops = 2.0 * self.n_params * prompt_tokens
        return flops / (PEAK_FLOPS_BF16 * self.n_chips * 0.45) + 0.004

    def cost(self, tokens_in: float, tokens_out: float) -> float:
        return (tokens_in * self.price_in
                + tokens_out * self.price_out) / 1e6


def _mk(name, model, cfg, chips, inst, pin, pout, bw_eff, **kw) -> Tier:
    n_params = cfg.param_counts()["active"] if cfg else 0
    kvb = 0.0
    if cfg:
        kvb = (cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * 2)  # bf16 k+v
    return Tier(name=name, model=model, model_cfg=cfg, n_chips=chips,
                n_instances=inst, price_in=pin, price_out=pout,
                bw_eff=bw_eff, n_params=n_params,
                kv_bytes_per_token=kvb, **kw)


def paper_pool_tiers() -> List[Tier]:
    """The 13-instance, 4-tier pool of Table 1, mapped to v5e slices.

    bw_eff calibrated so tpot(b=8, ctx=500) ~ Table 1's measured TPOT
    (41.6 / 13.9 / 19.6 / 10.2 ms).
    """
    pool = QWEN25_POOL
    return [
        _mk("qwen2.5-72b/v5e-16", "qwen2.5-72b",
            pool["qwen2.5-72b"], 16, 2, 0.38, 0.40, bw_eff=0.28),
        _mk("qwen2.5-14b/v5e-4", "qwen2.5-14b",
            pool["qwen2.5-14b"], 4, 3, 0.15, 0.15, bw_eff=0.75),
        _mk("qwen2.5-7b/v5e-1", "qwen2.5-7b",
            pool["qwen2.5-7b"], 1, 5, 0.07, 0.07, bw_eff=1.00),
        _mk("qwen2.5-3b/v5e-1", "qwen2.5-3b",
            pool["qwen2.5-3b"], 1, 3, 0.06, 0.06, bw_eff=0.80),
    ]
