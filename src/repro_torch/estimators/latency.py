"""Per-tier TPOT heads + the analytical end-to-end latency combine (§4.2).

Port of `repro.estimators.latency` (numpy, unchanged).

T̂(r, i) = TPOT̂_i * (d_i / b_i + L̂_{r, m(i)})

where d_i is the instance's (dead-reckoned) pending decode tokens and b_i
its decode batch size: d_i/b_i is the number of decode iterations the
request waits through before its own L̂ steps. If the instance has a free
decode slot only the second term applies (the request joins immediately).

TPOT heads are per-(model, hardware) tier GradientBoostedRegressors
trained on a tier-local QPS sweep (features: decode batch size, pending
tokens, mean context). One head query per TIER per scheduler batch — not
per instance (§4.2 cost model). A static analytic prior (nominal roofline
TPOT) is available as the paper's arm-4 variant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .gbm import GradientBoostedRegressor


def tpot_features(batch_size: float, pending_tokens: float,
                  mean_ctx: float) -> np.ndarray:
    return np.array([batch_size, pending_tokens, mean_ctx,
                     batch_size * mean_ctx], np.float32)


@dataclasses.dataclass
class LatencyHead:
    tier: str
    model: Optional[GradientBoostedRegressor] = None
    nominal_tpot: float = 0.02      # seconds/token — static prior

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.model = GradientBoostedRegressor(n_trees=60, depth=3).fit(X, y)
        return self

    def tpot(self, batch_size, pending_tokens, mean_ctx,
             learned: bool = True) -> float:
        if learned and self.model is not None:
            x = tpot_features(batch_size, pending_tokens, mean_ctx)[None]
            return float(np.maximum(self.model.predict(x)[0], 1e-4))
        return self.nominal_tpot

    def tpot_batch(self, feats: np.ndarray, learned: bool = True
                   ) -> np.ndarray:
        if learned and self.model is not None:
            return np.maximum(self.model.predict(feats), 1e-4)
        return np.full(feats.shape[0], self.nominal_tpot, np.float32)


def analytic_latency(tpot: np.ndarray, pending_tokens: np.ndarray,
                     batch_size: np.ndarray, pred_len: np.ndarray,
                     has_free_slot: np.ndarray) -> np.ndarray:
    """Vectorized T̂ over (R, I): all args broadcastable to (R, I)."""
    wait_iters = np.where(has_free_slot, 0.0,
                          pending_tokens / np.maximum(batch_size, 1.0))
    return tpot * (wait_iters + pred_len)


def mae(pred, true) -> float:
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(true))))


def mape(pred, true) -> float:
    t = np.asarray(true, np.float64)
    return float(np.mean(np.abs(np.asarray(pred) - t)
                         / np.maximum(np.abs(t), 1e-9)))
