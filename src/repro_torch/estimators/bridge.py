"""Carry trained estimator weights across, as numpy arrays only.

The reference trains its encoder weights from `jax.random`, which torch
cannot re-sample, so runs that must compare the two packages build the
port's `EstimatorBundle` from the reference's arrays instead of
training it. Nothing here imports the reference: callers hand over
plain numpy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.device import resolve_device
from .embedding import SentenceEncoder
from .gbm import GradientBoostedRegressor
from .knn import KNNEstimator
from .latency import LatencyHead


def bundle_from_arrays(encoder_params: Dict, knn_x: np.ndarray,
                       knn_quality: np.ndarray, knn_length: np.ndarray,
                       heads: Sequence[Dict], model_names: List[str],
                       device=None, k: int = 10, eps: float = 1e-6,
                       backend: str = "torch"):
    """The port's `EstimatorBundle` from numpy weights.

    encoder_params: the encoder's tree — {"embed", "pos", "out",
    "layers": [{"wq", "wk", "wv", "wo", "w1", "w2"}, ...]}; knn_x (N, E),
    knn_quality / knn_length (N, M): the KNN index and its labels;
    heads: one {"name", "nominal_tpot", "packed"} per tier, where
    "packed" is a booster's `pack()` output (None for an unfitted head).
    `backend` is the KNN estimator's ("numpy", "torch" or "kernel").
    `device=None` means the card."""
    from ..core.scheduler import EstimatorBundle
    dev = resolve_device(device)
    p = encoder_params
    hidden = np.asarray(p["embed"]).shape[1]
    enc = SentenceEncoder(
        dim=np.asarray(p["out"]).shape[1], hidden=hidden,
        n_layers=len(p["layers"]), hash_vocab=np.asarray(p["embed"]).shape[0],
        max_len=np.asarray(p["pos"]).shape[0], device=dev).load_params(p)
    knn = KNNEstimator(k=k, backend=backend, eps=eps, device=dev).fit(
        knn_x, knn_quality, knn_length)
    out = {}
    for h in heads:
        model = (None if h["packed"] is None
                 else GradientBoostedRegressor.from_packed(h["packed"]))
        out[h["name"]] = LatencyHead(h["name"], model=model,
                                     nominal_tpot=float(h["nominal_tpot"]))
    return EstimatorBundle(enc, knn, out, list(model_names), dev)
