"""Distance-weighted KNN quality + output-length estimator (FAISS stand-in).

Port of `repro.estimators.knn` (lines 22-66) in torch. One lookup over
the training split returns, for every candidate model, a predicted
quality in [0,1] and an expected output length (§4.2).

The plain lookup orders neighbours by (distance, index) with a stable
sort — `lax.top_k`'s order; `torch.topk` does not order ties — and sums
the k weights and the label mixes one neighbour at a time, which is the
order XLA reduces them in and the order the decision kernel uses. The
distance matrix itself goes through a float32 matmul, whose summation
order differs between libraries, so the port's neighbour distances
agree with the reference's to float32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` one element at a time, left to right (XLA's order
    for these short reductions; torch's own `sum` pairs them up)."""
    acc = v.select(dim, 0)
    for j in range(1, v.shape[dim]):
        acc = acc + v.select(dim, j)
    return acc


def distance_weights(d2: torch.Tensor, eps: float) -> torch.Tensor:
    """Inverse-distance weights over the k neighbours, normalized to sum
    to 1 along the trailing axis. The square root is taken in float64
    and rounded once to float32, which is the correctly rounded float32
    root: torch's vectorized float32 sqrt on the CPU can be an ulp off."""
    dist = torch.sqrt(torch.clamp_min(d2, 0.0).double()).to(torch.float32)
    w = 1.0 / (dist + eps)
    return w / _seq_sum(w, -1)[..., None]


def label_mix(labels: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """(N, M) labels, (B, k) neighbour rows and weights -> (B, M)."""
    return _seq_sum(labels[idx] * w[..., None], 1)


def topk_soft_lookup(q, x, xsq, quality, length, k: int, eps: float):
    """The KNN query body: squared distances via the
    ||q-x||² = ||x||² - 2 q·x + ||q||² expansion (the reference's
    association), the k nearest by (distance, index), then the
    distance-weighted label mix. Returns (quality (B, M), length (B, M))."""
    d2 = xsq[None, :] - 2.0 * (q @ x.T) + (q * q).sum(-1, keepdim=True)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    d2k, idx = d2s[:, :k], order[:, :k]
    w = distance_weights(d2k, eps)
    return label_mix(quality, idx, w), label_mix(length, idx, w)


class KNNEstimator:
    def __init__(self, k: int = 10, eps: float = 1e-6, device=None):
        self.k = k
        self.eps = eps
        self.device = torch.device(device) if device is not None else None
        self._x: Optional[np.ndarray] = None          # (N, E)
        self._quality: Optional[np.ndarray] = None    # (N, M)
        self._length: Optional[np.ndarray] = None     # (N, M)
        self._sq: Optional[np.ndarray] = None         # (N,)
        self._dev = None

    # -- index build ---------------------------------------------------------
    def fit(self, embeddings: np.ndarray, quality: np.ndarray,
            lengths: np.ndarray) -> "KNNEstimator":
        self._x = np.ascontiguousarray(embeddings, np.float32)
        self._quality = np.asarray(quality, np.float32)
        self._length = np.asarray(lengths, np.float32)
        self._sq = (self._x ** 2).sum(-1)
        self._dev = None
        return self

    @property
    def n_models(self) -> int:
        return self._quality.shape[1]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(x, xsq, quality, length) resident on the estimator's device,
        uploaded once."""
        if self._dev is None:
            self._dev = tuple(torch.as_tensor(a, device=self.device)
                              for a in (self._x, self._sq, self._quality,
                                        self._length))
        return self._dev

    # -- query ----------------------------------------------------------------
    @torch.no_grad()
    def query(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """q: (B, E) -> (quality (B, M), length (B, M)) as numpy."""
        x, sq, qual, leng = self.tensors()
        qt = torch.as_tensor(np.asarray(q, np.float32), device=x.device)
        qa, la = topk_soft_lookup(qt, x, sq, qual, leng, self.k, self.eps)
        return qa.cpu().numpy(), la.cpu().numpy()
