"""Equation 1: the fused quality-latency-cost score over request-instance
pairs, with per-request normalization of cost and latency by candidate
maxima (§4.1).

Port of `repro.core.scoring` (lines 39-87) in torch. The reference
writes these once over an array namespace `xp`; torch does not fit that
mould (`max(..., keepdims=)` returns a pair, `maximum` rejects a Python
float), so each is written out here with the reference's operation
order, which is what keeps the port's scores bitwise the reference's.

Scores are epsilon-quantized to a 2^-13 grid before they are returned
(see the reference's module docstring for why): `torch.round` rounds
half to even, as `jnp.round` does, and the pow2 scale keeps the snap
exact.
"""
from __future__ import annotations

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
