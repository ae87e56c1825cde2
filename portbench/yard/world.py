"""The synthetic prompt world and its dataset split, as arrays.

Frozen copy of the generator the program's scenarios use (the world of
`hyperfleet_10k`): each prompt has a latent topic, difficulty and
verbosity; its tokens come from topic- and difficulty-conditioned vocab
regions; quality and output length per model follow from the models'
capacities and verbosities. The same seed gives the same arrays as the
program's `serving.world.World.sample` and `build_dataset`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

VOCAB = 4096              # token ids lie in [0, VOCAB)
TOPICS = ("instruct", "code", "safety", "chat", "math", "reading", "reward")
_TOPIC_LEN_IN = (90, 160, 60, 120, 110, 260, 140)
_TOPIC_LEN_OUT = (220, 340, 90, 180, 260, 120, 160)
_TOPIC_DIFF_AB = ((2.0, 2.6), (2.6, 1.8), (1.6, 3.2), (1.8, 2.8),
                  (3.2, 1.5), (2.2, 2.4), (2.0, 2.2))
_TOPIC_BIAS = (0.02, -0.03, 0.05, 0.03, -0.06, 0.00, -0.01)
_TOPIC_BLOCK = 480
_DIFF_BASE = 3400


@dataclasses.dataclass
class WorldArrays:
    """n prompts: topic (n,), difficulty (n,), verbosity (n,), tokens
    (list of int32 arrays, at most `max_len` each), len_in (n,) true
    prompt length, quality and lengths (n, M), and the split."""
    topic: np.ndarray
    difficulty: np.ndarray
    verbosity: np.ndarray
    tokens: List[np.ndarray]
    len_in: np.ndarray
    quality: np.ndarray
    lengths: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray


def sample_world(capacities, verbosities, n: int, seed: int,
                 quality_noise: float = 0.14, length_noise: float = 0.30,
                 slope: float = 5.5, max_len: int = 128, train_frac=0.8,
                 split_seed: int = 1) -> WorldArrays:
    cap = np.asarray(capacities, np.float64)
    verb = np.asarray(verbosities, np.float64)
    M = len(cap)
    rng = np.random.default_rng(seed)
    Q = np.zeros((n, M))
    L = np.zeros((n, M))
    topic = rng.integers(0, len(TOPICS), n)
    diff = np.zeros(n)
    vb = np.zeros(n)
    len_in = np.zeros(n, np.int64)
    tokens = []
    for i in range(n):
        t = int(topic[i])
        a, b = _TOPIC_DIFF_AB[t]
        z = float(rng.beta(a, b))
        v = float(np.exp(rng.normal(0.0, 0.35)))
        ln_in = int(np.clip(rng.lognormal(np.log(_TOPIC_LEN_IN[t]), 0.5),
                            8, 2048))
        ntok = min(ln_in, max_len)
        n_diff = max(2, ntok // 8)
        topic_tok = (t * _TOPIC_BLOCK
                     + rng.zipf(1.35, ntok - n_diff) % _TOPIC_BLOCK)
        diff_tok = _DIFF_BASE + int(z * 480) + rng.integers(-12, 13, n_diff)
        toks = np.concatenate([topic_tok, diff_tok]).astype(np.int32)
        rng.shuffle(toks)
        tokens.append(toks)
        diff[i], vb[i], len_in[i] = z, v, ln_in
        base = 1.0 / (1.0 + np.exp(-slope * (cap - z)))
        q = 0.14 + 0.60 * base + _TOPIC_BIAS[t] \
            + rng.normal(0.0, quality_noise, M)
        Q[i] = np.clip(q, 0.02, 0.98)
        mean = _TOPIC_LEN_OUT[t] * v * verb
        L[i] = np.clip(mean * np.exp(rng.normal(0.0, length_noise, M)),
                       8, 1536).round()
    perm = np.random.default_rng(split_seed).permutation(n)
    n_train = int(n * train_frac)
    return WorldArrays(topic, diff, vb, tokens, len_in, Q, L,
                       np.sort(perm[:n_train]), np.sort(perm[n_train:]))


def world_from_config(cfg: dict) -> WorldArrays:
    """The world and split a configuration file names."""
    w, d = cfg["world"], cfg["dataset"]
    return sample_world(w["capacities"], w["verbosities"], d["n"],
                        w["seed"], w["quality_noise"], w["length_noise"],
                        w["slope"], w["max_len"], d["train_frac"],
                        d["split_seed"])


def pad_tokens(token_lists, max_len: int) -> np.ndarray:
    """Ragged token lists -> (B, max_len) int32, zero-padded."""
    out = np.zeros((len(token_lists), max_len), np.int32)
    for i, t in enumerate(token_lists):
        t = np.asarray(t, np.int32)[:max_len]
        out[i, :len(t)] = t
    return out
