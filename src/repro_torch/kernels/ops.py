"""The KNN estimator's feed through the K2 kernel.

Port of `repro.kernels.ops` (lines 65-81): `build_query` binds the
index and its labels, on their device, to a callable that runs
`knn_topk` (the CUDA kernel on CUDA tensors, its plain version on CPU
tensors), then the inverse-distance weights and the label mix.
"""
from __future__ import annotations

from ..estimators.knn import distance_weights, label_mix
from .knn_topk import knn_topk


def build_query(x, quality, lengths, k: int, eps: float, xsq=None):
    """x (N, E), quality/lengths (N, M) and optionally xsq (N,) = |x|^2,
    float32 tensors on one device. Returns a callable q (B, E) -> (quality
    (B, M), length (B, M)) on that device."""
    def run(q):
        d2, idx = knn_topk(q, x, k=k, xsq=xsq)
        w = distance_weights(d2, eps)
        idx = idx.long()
        return label_mix(quality, idx, w), label_mix(lengths, idx, w)
    return run
