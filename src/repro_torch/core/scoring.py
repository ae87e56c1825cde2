"""Equation 1: the fused quality-latency-cost score over request-instance
pairs, with per-request normalization of cost and latency by candidate
maxima (§4.1).

Port of `repro.core.scoring` (lines 39-112). The reference writes these
once over an array namespace `xp`; torch does not fit that mould
(`max(..., keepdims=)` returns a pair, `maximum` rejects a Python
float), so the torch functions are written out here with the
reference's operation order, which is what keeps the port's scores
bitwise the reference's. `score_matrix` and `score_row` are the numpy
copies the host greedy loop (`core.assignment.greedy_assign`) calls.

Scores are epsilon-quantized to a 2^-13 grid before they are returned
(see the reference's module docstring for why): `torch.round` rounds
half to even, as `jnp.round` does, and the pow2 scale keeps the snap
exact.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

SCORE_QUANTUM = 2.0 ** -13
_INV_QUANTUM = 2.0 ** 13


def quantize_scores(s: torch.Tensor) -> torch.Tensor:
    """Snap Eq. 1 scores to the shared epsilon grid (half to even).
    -inf (masked candidates) passes through."""
    return torch.round(s * _INV_QUANTUM) * SCORE_QUANTUM


def masked_score(q, c, t, weights, mask) -> torch.Tensor:
    """Eq. 1 over the trailing candidate axis, any leading batch shape.

    q/c/t/mask broadcastable tensors whose last axis enumerates the
    candidate instances; weights = (w_qual, w_lat, w_cost). Cost and
    latency are normalized per request by the max over *allowed*
    candidates; disallowed pairs come back -inf."""
    wq, wl, wc = weights
    neg = float("-inf")
    cmax = torch.clamp_min(
        torch.where(mask, c, neg).amax(dim=-1, keepdim=True), 1e-12)
    tmax = torch.clamp_min(
        torch.where(mask, t, neg).amax(dim=-1, keepdim=True), 1e-12)
    s = wq * q + wc * (1.0 - c / cmax) + wl * (1.0 - t / tmax)
    return torch.where(mask, quantize_scores(s), neg)


def affinity_discount(t, affinity) -> torch.Tensor:
    """The prefix-affinity term: discount the predicted latency by the
    matched-prefix reuse score before Eq. 1 normalizes it. The
    multiplicative form keeps `affinity == 0` exactly the undiscounted
    arithmetic (t * 1.0 is an IEEE identity)."""
    return t * (1.0 - affinity)


# -- numpy copies for the host greedy loop -----------------------------------

def _masked_score_np(q, c, t, weights, mask) -> np.ndarray:
    """`masked_score` in numpy (reference `masked_score` with xp=np)."""
    wq, wl, wc = weights
    neg = -np.inf
    cmax = np.maximum(
        np.max(np.where(mask, c, neg), axis=-1, keepdims=True), 1e-12)
    tmax = np.maximum(
        np.max(np.where(mask, t, neg), axis=-1, keepdims=True), 1e-12)
    s = wq * q + wc * (1.0 - c / cmax) + wl * (1.0 - t / tmax)
    return np.where(mask, np.round(s * _INV_QUANTUM) * SCORE_QUANTUM, neg)


def _affinity_discount_np(t, affinity):
    return t * (np.float32(1.0) - affinity)


def score_matrix(q_hat: np.ndarray, c_hat: np.ndarray, t_hat: np.ndarray,
                 weights, allowed: Optional[np.ndarray] = None,
                 affinity: Optional[np.ndarray] = None) -> np.ndarray:
    """q_hat: (R, I) quality of instance's model per request in [0,1];
    c_hat, t_hat: (R, I) positive; weights = (w_qual, w_lat, w_cost);
    affinity: optional (R, I) prefix-reuse discount applied to t_hat.
    Returns (R, I) scores with disallowed pairs at -inf."""
    mask = np.ones(c_hat.shape, bool) if allowed is None else allowed
    if affinity is not None:
        t_hat = _affinity_discount_np(t_hat, affinity)
    return _masked_score_np(q_hat, c_hat, t_hat, weights, mask)


def score_row(q: np.ndarray, c: np.ndarray, t: np.ndarray, weights,
              allowed: Optional[np.ndarray] = None,
              affinity: Optional[np.ndarray] = None) -> np.ndarray:
    """Single-request variant used inside the greedy loop (t is
    state-dependent so it is recomputed per dispatch)."""
    mask = np.ones(c.shape, bool) if allowed is None else allowed
    if affinity is not None:
        t = _affinity_discount_np(t, affinity)
    return _masked_score_np(q, c, t, weights, mask)
