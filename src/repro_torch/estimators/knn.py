"""Distance-weighted KNN quality + output-length estimator (FAISS stand-in).

Port of `repro.estimators.knn` (lines 22-151). One lookup over the
training split returns, for every candidate model, a predicted quality
in [0,1] and an expected output length (§4.2).

Backends, each the counterpart of one of the reference's:
  * numpy  — exact brute force on the host (a copy of `_query_np`);
  * torch  — `topk_soft_lookup` on the estimator's device (the
             reference's jitted "jax" backend), the batch pow2-padded to
             the buckets the decision kernel is called at;
  * kernel — the K2 kernel `repro_torch.kernels.knn_topk` through
             `kernels.ops.build_query` (the reference's "pallas").

The torch lookup orders neighbours by (distance, index) with a stable
sort — `lax.top_k`'s order; `torch.topk` does not order ties — and sums
the k weights and the label mixes one neighbour at a time, which is the
order XLA reduces them in and the order the decision kernel uses. The
distance matrix itself goes through a float32 matmul, whose summation
order differs between libraries, so the port's neighbour distances
agree with the reference's to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

BACKENDS = ("numpy", "torch", "kernel")
# the reference's backend names, with the port's counterpart
REFERENCE_NAMES = {"jax": "torch", "pallas": "kernel"}


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


def check_backend(backend: str) -> str:
    """`backend` if the port has it; the reference's names raise
    ValueError naming the port's counterpart."""
    if backend in REFERENCE_NAMES:
        raise ValueError(f"KNN backend {backend!r} is the reference's; the "
                         f"port's counterpart is {REFERENCE_NAMES[backend]!r}")
    if backend not in BACKENDS:
        raise ValueError(f"KNN backend {backend!r} not in {BACKENDS}")
    return backend


class KNNEstimator:
    def __init__(self, k: int = 10, backend: str = "torch",
                 eps: float = 1e-6, device=None):
        """`device=None` means the card (RuntimeError without one)."""
        from ..core.device import resolve_device   # core imports this module
        self.k = k
        self.backend = check_backend(backend)
        self.eps = eps
        self.device = resolve_device(device)
        self._x: Optional[np.ndarray] = None          # (N, E)
        self._quality: Optional[np.ndarray] = None    # (N, M)
        self._length: Optional[np.ndarray] = None     # (N, M)
        self._sq: Optional[np.ndarray] = None         # (N,)
        self._dev = None
        self._kq = None

    # -- index build ---------------------------------------------------------
    def fit(self, embeddings: np.ndarray, quality: np.ndarray,
            lengths: np.ndarray) -> "KNNEstimator":
        self._x = np.ascontiguousarray(embeddings, np.float32)
        self._quality = np.asarray(quality, np.float32)
        self._length = np.asarray(lengths, np.float32)
        self._sq = (self._x ** 2).sum(-1)
        self._dev = None
        self._kq = None
        return self

    @property
    def n_models(self) -> int:
        return self._quality.shape[1]

    def with_backend(self, backend: str) -> "KNNEstimator":
        """Copy sharing the fitted index (and its device copy) but
        querying via `backend`."""
        knn = copy.copy(self)
        knn.backend = check_backend(backend)
        knn._kq = None
        return knn

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
        q = np.asarray(q, np.float32)
        if self.backend == "numpy":
            return self._query_np(q)
        if self.backend == "torch":
            return self._query_torch(q)
        return self._query_kernel(q)

    def _query_np(self, q):
        d2 = self._sq[None, :] - 2.0 * q @ self._x.T \
            + (q ** 2).sum(-1, keepdims=True)
        idx = np.argpartition(d2, self.k, axis=1)[:, :self.k]
        d2k = np.take_along_axis(d2, idx, axis=1)
        order = np.argsort(d2k, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        d2k = np.take_along_axis(d2k, order, axis=1)
        w = 1.0 / (np.sqrt(np.maximum(d2k, 0.0)) + self.eps)
        w = w / w.sum(-1, keepdims=True)
        qual = (self._quality[idx] * w[..., None]).sum(1)
        leng = (self._length[idx] * w[..., None]).sum(1)
        return qual, leng

    def _query_torch(self, q):
        # pow2-pad the batch (>= 8) as the reference's jax backend does,
        # so the staged lookup sees the decision kernel's matmul shapes
        B = q.shape[0]
        Bb = max(1 << (B - 1).bit_length(), 8) if B else 8
        if Bb != B:
            q = np.concatenate(
                [q, np.zeros((Bb - B, q.shape[1]), np.float32)])
        x, sq, qual, leng = self.tensors()
        qa, la = topk_soft_lookup(torch.as_tensor(q, device=self.device),
                                  x, sq, qual, leng, self.k, self.eps)
        return qa[:B].cpu().numpy(), la[:B].cpu().numpy()

    def _query_kernel(self, q):
        if self._kq is None:
            from ..kernels.ops import build_query
            x, sq, qual, leng = self.tensors()
            self._kq = build_query(x, qual, leng, self.k, self.eps, xsq=sq)
        # a fresh tensor: the kernel wants 16-byte aligned rows, which a
        # view into a caller's array need not have
        qa, la = self._kq(torch.tensor(q, device=self.device))
        return qa.cpu().numpy(), la.cpu().numpy()

    # -- diagnostics ----------------------------------------------------------
    def best_model_accuracy(self, q_emb, true_quality) -> float:
        qual, _ = self.query(q_emb)
        return float((qual.argmax(1)
                      == np.asarray(true_quality).argmax(1)).mean())
