"""Synthetic prompt world with per-(prompt, model) ground truth.

Port of `repro.serving.world` (numpy, unchanged).

Replicates the *structure* of the paper's released dataset (18,608 prompts
from 7 public datasets, each broadcast to 4 Qwen2.5 candidates, scored
offline by a DeepEval judge; §6.1): each prompt carries a latent (topic,
difficulty, verbosity); tokens are drawn from topic+difficulty-conditioned
vocab regions so a frozen random-feature encoder recovers the latents by
similarity; true quality is a calibrated logistic in (model capacity −
difficulty) — larger models better on hard prompts, ties on easy ones —
and true output length is verbosity-scaled per model with bigger models
answering more concisely (the paper's cost observation, §2).

The estimator stack sees only embeddings + train-split labels; serving
reveals the true values. Greedy decoding makes the (prompt, model) lookup
deterministic — the paper's precompute-validity contract (§4.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

TOPICS = ("instruct", "code", "safety", "chat", "math", "reading", "reward")

# topic-conditioned generation parameters
_TOPIC_LEN_IN = (90, 160, 60, 120, 110, 260, 140)     # mean prompt tokens
_TOPIC_LEN_OUT = (220, 340, 90, 180, 260, 120, 160)   # mean response tokens
_TOPIC_DIFF_AB = ((2.0, 2.6), (2.6, 1.8), (1.6, 3.2), (1.8, 2.8),
                  (3.2, 1.5), (2.2, 2.4), (2.0, 2.2))  # Beta(a, b)
_TOPIC_BIAS = (0.02, -0.03, 0.05, 0.03, -0.06, 0.00, -0.01)

VOCAB = 4096
_TOPIC_BLOCK = 480          # tokens [t*B, (t+1)*B) signal the topic
_DIFF_BASE = 3400           # ids 3400..3900 encode difficulty


@dataclasses.dataclass
class Prompt:
    pid: int
    topic: int
    difficulty: float
    verbosity: float
    tokens: np.ndarray
    len_in: int
    safety_flagged: bool = False


class World:
    """Generative ground truth for a pool of M candidate models."""

    def __init__(self, capacities, verbosities, seed: int = 0,
                 quality_noise: float = 0.14, length_noise: float = 0.30,
                 slope: float = 5.5):
        self.capacity = np.asarray(capacities, np.float64)     # (M,)
        self.verbosity = np.asarray(verbosities, np.float64)   # (M,)
        self.M = len(capacities)
        self.rng = np.random.default_rng(seed)
        self.qn = quality_noise
        self.ln = length_noise
        self.slope = slope

    def sample(self, n: int, max_len: int = 128
               ) -> Tuple[List[Prompt], np.ndarray, np.ndarray]:
        """-> (prompts, quality (n, M) in [0,1], out_lengths (n, M))."""
        rng = self.rng
        prompts: List[Prompt] = []
        Q = np.zeros((n, self.M))
        L = np.zeros((n, self.M))
        topics = rng.integers(0, len(TOPICS), n)
        for i in range(n):
            t = int(topics[i])
            a, b = _TOPIC_DIFF_AB[t]
            z = float(rng.beta(a, b))
            v = float(np.exp(rng.normal(0.0, 0.35)))
            ln_in = int(np.clip(rng.lognormal(
                np.log(_TOPIC_LEN_IN[t]), 0.5), 8, 2048))
            ntok = min(ln_in, max_len)
            n_diff = max(2, ntok // 8)
            topic_tok = (t * _TOPIC_BLOCK
                         + rng.zipf(1.35, ntok - n_diff) % _TOPIC_BLOCK)
            diff_tok = (_DIFF_BASE + int(z * 480)
                        + rng.integers(-12, 13, n_diff))
            toks = np.concatenate([topic_tok, diff_tok]).astype(np.int32)
            rng.shuffle(toks)
            prompts.append(Prompt(
                pid=i, topic=t, difficulty=z, verbosity=v, tokens=toks,
                len_in=ln_in, safety_flagged=(t == 2)))
            # quality: logistic in (capacity - difficulty) + topic bias
            base = 1.0 / (1.0 + np.exp(-self.slope
                                       * (self.capacity - z)))
            q = 0.14 + 0.60 * base + _TOPIC_BIAS[t] \
                + rng.normal(0.0, self.qn, self.M)
            Q[i] = np.clip(q, 0.02, 0.98)
            # length: topic base x prompt verbosity x model verbosity
            mean = _TOPIC_LEN_OUT[t] * v * self.verbosity
            L[i] = np.clip(mean * np.exp(
                rng.normal(0.0, self.ln, self.M)), 8, 1536).round()
        return prompts, Q, L


@dataclasses.dataclass
class Dataset:
    prompts: List[Prompt]
    quality: np.ndarray        # (n, M)
    lengths: np.ndarray        # (n, M)
    train_idx: np.ndarray
    test_idx: np.ndarray

    def split(self, which: str):
        idx = self.train_idx if which == "train" else self.test_idx
        return ([self.prompts[i] for i in idx], self.quality[idx],
                self.lengths[idx])


def build_dataset(world: World, n: int = 18608, train_frac: float = 0.8,
                  seed: int = 1) -> Dataset:
    prompts, Q, L = world.sample(n)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * train_frac)
    return Dataset(prompts, Q, L, np.sort(perm[:n_train]),
                   np.sort(perm[n_train:]))


# The paper's four-model pool, calibrated so fixed-model means and the
# oracle headroom are in the paper's ballpark (§6.8: always-3B 0.346,
# always-14B 0.398, oracle 0.582).
PAPER_CAPACITIES = {"qwen2.5-3b": 0.30, "qwen2.5-7b": 0.41,
                    "qwen2.5-14b": 0.53, "qwen2.5-72b": 0.68}
PAPER_VERBOSITY = {"qwen2.5-3b": 1.15, "qwen2.5-7b": 1.10,
                   "qwen2.5-14b": 1.00, "qwen2.5-72b": 0.85}


def paper_world(seed: int = 0) -> Tuple[World, List[str]]:
    names = list(PAPER_CAPACITIES)
    w = World([PAPER_CAPACITIES[m] for m in names],
              [PAPER_VERBOSITY[m] for m in names], seed=seed)
    return w, names
