"""The prefix-cache affinity term of the decision, written from its
published description.

A prompt's prefix signatures: a rolling hash `h <- h * 2654435761 + tok
+ 1 (mod 2^32)` over its tokens, one 32-bit signature at each boundary
of a 16-token block, 8 columns (128 tokens). Column d holds the hash of
the first min(len, 16 (d + 1)) tokens, or 0 where the prompt does not
reach block d; 0 is the empty sentinel, so a hash that lands on 0 is
written as 1. An instance's prefix plane row holds the 64 signatures its
cache model keeps. A request's hit on an instance is the leading run of
its columns present anywhere in that row, times 16 tokens, capped at the
request's input length and divided by max(len_in, 1), in float32. The
decision discounts the predicted latency by it before Eq. 1:
T * (1 - w * hit).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

BLOCK = 16
WIDTH = 8
SLOTS = 64
_MULT = 2654435761
_MASK = 0xFFFFFFFF


def signatures(token_lists: Sequence[np.ndarray]) -> np.ndarray:
    """Ragged token lists -> (P, WIDTH) int32 prefix signatures."""
    P, span = len(token_lists), WIDTH * BLOCK
    lens = np.array([min(len(t), span) for t in token_lists], np.int64)
    toks = np.zeros((P, span), np.uint64)
    for i, t in enumerate(token_lists):
        toks[i, :lens[i]] = np.asarray(t[:lens[i]]).astype(np.uint32)
    out = np.zeros((P, WIDTH), np.int32)
    h = np.zeros(P, np.uint64)
    for t in range(span):
        step = (h * np.uint64(_MULT) + toks[:, t] + np.uint64(1)) \
            & np.uint64(_MASK)
        h = np.where(t < lens, step, h)
        if (t + 1) % BLOCK == 0:
            d = t // BLOCK
            sig = h.astype(np.uint32).view(np.int32).copy()
            sig[sig == 0] = 1
            out[:, d] = np.where(lens > d * BLOCK, sig, 0)
    return out


def hit_fraction(sig: np.ndarray, len_in: np.ndarray,
                 plane: np.ndarray) -> np.ndarray:
    """(R, WIDTH) signatures, (R,) input lengths and the (I, SLOTS)
    prefix plane -> (R, I) float32 hit fractions."""
    R, I = sig.shape[0], plane.shape[0]
    vals = np.unique(sig[sig != 0])
    # held[i, k]: instance i's row holds the batch's k-th distinct value
    held = np.zeros((I, len(vals) + 1), bool)
    if len(vals):
        pos = np.searchsorted(vals, plane)
        hit = (pos < len(vals)) & (vals[np.minimum(pos, len(vals) - 1)]
                                   == plane)
        ii, jj = np.nonzero(hit)
        held[ii, pos[ii, jj]] = True
    col = np.where(sig != 0, np.searchsorted(vals, sig), len(vals))
    present = held[:, col]                              # (I, R, WIDTH)
    run = np.cumprod(present, axis=2).sum(axis=2).T     # (R, I)
    f32 = np.float32
    lenf = np.maximum(np.asarray(len_in).astype(f32), f32(1.0))
    matched = np.minimum(run.astype(f32) * f32(BLOCK), lenf[:, None])
    return (matched / lenf[:, None]).astype(f32)
