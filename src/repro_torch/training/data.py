"""Deterministic synthetic token pipeline for the training substrate.

A copy of `repro.training.data` (numpy only), so the port imports
nothing of the reference: the same seed gives byte-identical batches.
Zipf-distributed token streams with enough structure (topic blocks +
local n-gram correlations) that a small LM's loss visibly decreases over
a few hundred steps. The iterator yields global batches of numpy
arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_topics: int = 8):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = global_batch
        self.rng = np.random.default_rng(seed)
        self.n_topics = n_topics
        self.block = max(vocab // (2 * n_topics), 8)

    def _seq(self) -> np.ndarray:
        t = self.rng.integers(0, self.n_topics)
        base = t * self.block
        # zipfian draws inside the topic block + bigram-ish repetition
        z = self.rng.zipf(1.3, self.seq_len + 1) % self.block
        toks = base + z
        rep = self.rng.uniform(size=self.seq_len + 1) < 0.25
        toks[1:][rep[1:]] = toks[:-1][rep[1:]]
        return toks.astype(np.int32) % self.vocab

    def batches(self, n_steps: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while n_steps is None or step < n_steps:
            arr = np.stack([self._seq() for _ in range(self.batch)])
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
            step += 1


def batch_for(cfg, seq_len: int, global_batch: int, seed: int = 0):
    """One batch shaped for an arbitrary zoo config (incl. frontends)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        dec = min(cfg.dec_max_len, seq_len)
        return {
            "frames": rng.normal(size=(global_batch, seq_len,
                                       cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab,
                                   (global_batch, dec)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab,
                                   (global_batch, dec)).astype(np.int32),
        }
    out = {}
    s = seq_len
    if cfg.frontend == "vision":
        nf = cfg.n_frontend_tokens
        out["frontend_embeds"] = rng.normal(
            size=(global_batch, nf, cfg.frontend_dim)).astype(np.float32)
        s = max(seq_len - nf, 1)
    ts = TokenStream(cfg.vocab, s, global_batch, seed)
    b = next(ts.batches(1))
    out.update(b)
    return out
