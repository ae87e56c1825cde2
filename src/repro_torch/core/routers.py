"""Decoupled model routers (baseline policies, §5-§6) — composed with
a dispatcher into a `RouterDispatchPolicy` (`repro_torch.core.policies`)
and served through the shared `ServingEngine`.

Port of `repro.core.routers` (lines 1-145). `Router`,
`PassthroughRouter` and `AvengersProRouter` are numpy copies;
`BestRouteRouter` scores with a `KNNEstimator(backend="torch")` on its
device, the counterpart of the reference's "jax" scorer.

All consume the SAME supervision as RouteBalance's KNN estimator (the
paper's fairness control: identical labels, identical train split) and
are instance-blind — they pick a model index; the dispatcher picks a
replica. Each carries its serial per-request scoring time
(`serial_scoring_s`, what the engine's `deployment="serial_published"`
arm charges per request, §6.3).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Router:
    name = "router"
    serial_scoring_s = 0.0         # per-request serial scoring service time

    def fit(self, emb: np.ndarray, quality: np.ndarray,
            lengths: np.ndarray, prices: np.ndarray):
        return self

    def route(self, emb: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class PassthroughRouter(Router):
    """No model selection; candidates = whole pool (dispatcher decides)."""
    name = "passthrough"
    serial_scoring_s = 0.0

    def route(self, emb: np.ndarray) -> np.ndarray:
        return np.full(emb.shape[0], -1, np.int64)


class AvengersProRouter(Router):
    """k-means over embeddings + per-cluster quality/efficiency mix.

    As published, scoring is one request at a time (embedding + cluster
    assign); its measured residual climbs 258 ms -> 2.79 s under load
    (§6.3). serial_scoring_s models the embedding forward on the
    baseline's own stack.
    """
    name = "avengers-pro"
    serial_scoring_s = 0.080

    def __init__(self, p_w: float = 0.8, n_clusters: int = 64,
                 seed: int = 0, iters: int = 25):
        self.p_w = p_w
        self.k = n_clusters
        self.seed = seed
        self.iters = iters
        self.centroids: Optional[np.ndarray] = None
        self.cluster_quality: Optional[np.ndarray] = None
        self.efficiency: Optional[np.ndarray] = None

    def fit(self, emb, quality, lengths, prices):
        rng = np.random.default_rng(self.seed)
        n = emb.shape[0]
        c = emb[rng.choice(n, self.k, replace=False)].copy()
        for _ in range(self.iters):
            d = ((emb[:, None, :] - c[None]) ** 2).sum(-1) \
                if n * self.k * emb.shape[1] < 5e7 else None
            if d is None:
                d = (emb ** 2).sum(1)[:, None] - 2 * emb @ c.T \
                    + (c ** 2).sum(1)[None]
            a = d.argmin(1)
            for j in range(self.k):
                m = a == j
                if m.any():
                    c[j] = emb[m].mean(0)
        self.centroids = c
        M = quality.shape[1]
        cq = np.zeros((self.k, M))
        for j in range(self.k):
            m = a == j
            cq[j] = quality[m].mean(0) if m.any() else quality.mean(0)
        self.cluster_quality = cq
        # efficiency: inverse expected cost (per-model mean length x price)
        mean_cost = lengths.mean(0) * prices
        eff = 1.0 / np.maximum(mean_cost, 1e-9)
        self.efficiency = (eff - eff.min()) / max(eff.max() - eff.min(),
                                                  1e-9)
        return self

    def route(self, emb):
        d = (emb ** 2).sum(1)[:, None] - 2 * emb @ self.centroids.T \
            + (self.centroids ** 2).sum(1)[None]
        cl = d.argmin(1)
        q = self.cluster_quality[cl]                       # (R, M)
        qn = (q - q.min(1, keepdims=True)) / np.maximum(
            q.max(1, keepdims=True) - q.min(1, keepdims=True), 1e-9)
        s = self.p_w * qn + (1 - self.p_w) * self.efficiency[None]
        return s.argmax(1)


class BestRouteRouter(Router):
    """Quality-scorer + threshold cascade (BEST-Route analogue).

    Routes to the CHEAPEST model whose predicted quality >= best - (1-t) *
    spread; t=1 -> always best model, t=0 -> always cheapest. The scorer
    is a KNN head on the shared supervision (the paper refits BEST-Route's
    DeBERTa on the same labels; ours matches that control). As published
    the scorer runs one generative-classifier forward per request:
    431 ms single-threaded (§6.3).
    """
    name = "best-route"
    serial_scoring_s = 0.431

    def __init__(self, threshold: float = 0.5, k: int = 10, device=None):
        """`device=None` means the card (RuntimeError without one)."""
        from .device import resolve_device
        self.t = threshold
        self.k = k
        self.device = resolve_device(device)
        self._knn = None
        self.price_order: Optional[np.ndarray] = None

    def fit(self, emb, quality, lengths, prices):
        from ..estimators.knn import KNNEstimator
        self._knn = KNNEstimator(k=self.k, backend="torch",
                                 device=self.device).fit(
            emb, quality, lengths)
        self.price_order = np.argsort(prices)     # cheapest first
        return self

    def route(self, emb):
        q, _ = self._knn.query(emb)               # (R, M)
        best = q.max(1, keepdims=True)
        spread = best - q.min(1, keepdims=True)
        ok = q >= best - (1.0 - self.t) * spread - 1e-12
        # cheapest acceptable: reorder the mask cheapest-first, argmax
        # picks the first acceptable column (every row has one — the
        # best model always passes its own threshold)
        return self.price_order[ok[:, self.price_order].argmax(1)]
