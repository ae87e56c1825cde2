"""The inputs the benchmark makes for the program's estimators, handed to
the program and to the reference alike: the sentence encoder's weights
and each tier's TPOT training pairs.

`tier_sweep` is a frozen copy of the program's tier-local sweep
(`core.scheduler._tier_sweep`) with the tier's decode roofline
(`serving.tiers.Tier.tpot`): the same generator state gives the same
pairs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# TPU v5e-class constants of the simulated fleet (the tiers' roofline)
PEAK_FLOPS_BF16 = 197e12
HBM_BW = 819e9


def tier_tpot(tier: Dict, batch_size: float, mean_ctx: float) -> float:
    """The simulated tier's decode-iteration time (s)."""
    b = max(batch_size, 1.0)
    bw = HBM_BW * tier["n_chips"] * tier["bw_eff"]
    weight_read = 2.0 * tier["n_params"] / bw
    kv_read = b * mean_ctx * tier["kv_bytes_per_token"] / bw
    compute = (2.0 * tier["n_params"] * b
               / (PEAK_FLOPS_BF16 * tier["n_chips"]
                  * tier.get("flops_eff", 0.5)))
    return max(weight_read, kv_read, compute) + tier["overhead_s"]


def tpot_features(batch_size, pending_tokens, mean_ctx) -> np.ndarray:
    return np.array([batch_size, pending_tokens, mean_ctx,
                     batch_size * mean_ctx], np.float32)


def tier_sweep(tier: Dict, rng, rows: int = 2000
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(features (rows, 4) float32, true TPOT (rows,) float32)."""
    feats, ys = [], []
    for _ in range(rows):
        b = rng.integers(1, tier["max_batch"] + 1)
        ctx = rng.uniform(32, 2048)
        pend = b * rng.uniform(8, 600)
        feats.append(tpot_features(b, pend, ctx))
        ys.append(tier_tpot(tier, b, ctx) * np.exp(rng.normal(0, 0.03)))
    return np.stack(feats), np.asarray(ys, np.float32)


def training_pairs(tiers: List[Dict], seed: int, rows: int
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every tier's pairs, drawn in roster order from one generator."""
    rng = np.random.default_rng(seed)
    return [tier_sweep(t, rng, rows) for t in tiers]


def encoder_params(enc: Dict, seed: int) -> Dict:
    """Random frozen encoder weights, float32, in the tree
    `SentenceEncoder.load_params` takes."""
    rng = np.random.default_rng(seed)
    h, V, L, D = enc["hidden"], enc["hash_vocab"], enc["max_len"], enc["dim"]
    s = h ** -0.5

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    params = {"embed": draw((V, h), s), "pos": draw((L, h), s * 0.1),
              "out": draw((h, D), s), "layers": []}
    for _ in range(enc["n_layers"]):
        params["layers"].append({
            "wq": draw((h, h), s), "wk": draw((h, h), s),
            "wv": draw((h, h), s), "wo": draw((h, h), s),
            "w1": draw((h, 2 * h), s),
            "w2": draw((2 * h, h), (2 * h) ** -0.5)})
    return params
