"""Prefix-cache / session-affinity signal.

Port of `repro.serving.affinity`: `prefix_signatures`,
`prompt_signatures` and `PrefixSketch` are numpy copies (the sketch is
host-side dead reckoning); `hit_fraction`, the scoring-side lookup, is
written in torch over the same int32 signatures so it runs on the
decision's device.

  * `prefix_signatures` — a rolling-hash prefix sketch of a prompt:
    one 32-bit signature per `PREFIX_BLOCK`-token block boundary, so
    two prompts sharing a prefix share the leading signature columns.
  * `PrefixSketch` — the per-instance cache model: a flattened
    hash-trie with LRU eviction at `SKETCH_SLOTS` entries, rendered by
    `mirror()` as the fixed-width `prefix_sig` row of `TelemetryArrays`.
  * `hit_fraction` — matched-prefix fraction per (request, instance).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

PREFIX_BLOCK = 16     # tokens per hashed prefix block
SIG_WIDTH = 8         # signature columns per prompt (covers 128 tokens)
SKETCH_SLOTS = 64     # sketch capacity per instance = mirror row width

_MULT = np.uint32(2654435761)        # Knuth multiplicative constant
_ONE = np.uint32(1)


def prefix_signatures(tokens, lens) -> np.ndarray:
    """Rolling-hash prefix signatures.

    (P, L) token matrix + (P,) true token counts -> (P, SIG_WIDTH)
    int32. Column `d` holds the hash of the first
    min(len, (d+1)*PREFIX_BLOCK) tokens, or 0 where the prompt does
    not reach block `d` (0 is the empty-slot sentinel; real hashes
    that land on 0 are remapped to 1). Updates are masked by the true
    length, so zero-padded SoA token matrices and raw per-prompt
    arrays produce identical signatures — the dispatch path (which
    hashes single prompts) and the scoring path (which hashes the
    padded `RequestColumns.tokens` matrix) must agree exactly.
    """
    toks = np.atleast_2d(np.asarray(tokens))
    P, L = toks.shape
    lens_ = np.asarray(lens, np.int64).reshape(P)
    out = np.zeros((P, SIG_WIDTH), np.int32)
    h = np.zeros(P, np.uint32)
    width = min(L, SIG_WIDTH * PREFIX_BLOCK)
    for t in range(width):
        step = h * _MULT + toks[:, t].astype(np.uint32) + _ONE
        h = np.where(t < lens_, step, h)
        if (t + 1) % PREFIX_BLOCK == 0 or t + 1 == width:
            d = t // PREFIX_BLOCK
            sig = h.view(np.int32).copy()
            sig[sig == 0] = 1
            out[:, d] = np.where(lens_ > d * PREFIX_BLOCK, sig, 0)
    return out


def prompt_signatures(prompt) -> np.ndarray:
    """Signature row for one `Prompt`, memoized on the prompt object.

    The dispatch-side sketch update hashes at `Instance.submit` time —
    hedged re-dispatch submits directly to the target instance,
    bypassing the SoA columns entirely, so the sketch bookkeeping
    cannot rely on `RequestColumns` being present.
    """
    sig = getattr(prompt, "_prefix_sig", None)
    if sig is None:
        toks = np.asarray(prompt.tokens)
        sig = prefix_signatures(toks[None, :],
                                np.array([toks.size], np.int64))[0]
        prompt._prefix_sig = sig
    return sig


class PrefixSketch:
    """Dead-reckoned model of one instance's prefix cache.

    A flattened hash-trie: each stored signature encodes its entire
    path from the root (hash of all tokens up to that block boundary),
    so membership of the *longest matched run* of a prompt's signature
    columns is exactly a trie walk. LRU-evicts beyond `capacity` —
    matching the fixed-width `TelemetryArrays.prefix_sig` mirror row
    the scheduler scores against.
    """

    __slots__ = ("capacity", "slots", "_seq")

    def __init__(self, capacity: int = SKETCH_SLOTS):
        self.capacity = capacity
        self.slots: dict = {}        # sig -> last-touch sequence number
        self._seq = 0

    def __len__(self) -> int:
        return len(self.slots)

    def insert(self, sigs: Iterable[int]):
        """Credit the cache with a dispatched prompt's signature row
        (0 sentinels skipped). Touch order is the eviction order."""
        for s in sigs:
            s = int(s)
            if s == 0:
                continue
            self._seq += 1
            if s not in self.slots and len(self.slots) >= self.capacity:
                victim = min(self.slots, key=self.slots.get)
                del self.slots[victim]
            self.slots[s] = self._seq

    def hit_tokens(self, sigs: Iterable[int], len_in: float) -> int:
        """Matched-prefix tokens for one prompt: the leading run of
        signature columns present in the sketch, in token units,
        capped at the prompt length. Integer math — must agree with
        `hit_fraction`'s vectorized form."""
        run = 0
        for s in sigs:
            if int(s) == 0 or int(s) not in self.slots:
                break
            run += 1
        return int(min(run * PREFIX_BLOCK, int(len_in)))

    def clear(self):
        self.slots.clear()

    def mirror(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Fixed-width int32 render for `TelemetryArrays.prefix_sig`.
        Insertion-ordered and zero-padded; order is irrelevant to the
        scoring lookup (set membership) but keeps the mirror
        deterministic for checkpoint/restore bitwise identity."""
        if out is None:
            out = np.zeros(self.capacity, np.int32)
        out[:] = 0
        vals = list(self.slots)
        out[:len(vals)] = vals
        return out


def hit_fraction(req_sig, len_in, sig_plane):
    """Matched-prefix fraction per (request, instance), in torch.

    (R, SIG_WIDTH) int32 request signatures x (I, SKETCH_SLOTS) int32
    sketch mirrors -> (R, I) float32 in [0, 1]: leading-run block match,
    converted to tokens, capped at and normalized by the request's input
    length. Integer compares plus one IEEE float32 divide, the same
    expression as the reference's, so the two agree bit for bit. The 0
    sentinel (empty slot / absent signature column) never matches."""
    present = (req_sig[:, :, None, None]
               == sig_plane[None, None, :, :]).any(-1)     # (R, D, I)
    present = present & (req_sig != 0)[:, :, None]
    run = torch.cumprod(present.to(torch.int32), dim=1).sum(dim=1)
    lenf = torch.clamp_min(len_in.to(torch.float32), 1.0)
    matched = torch.minimum(run.to(torch.float32) * float(PREFIX_BLOCK),
                            lenf[:, None])
    return matched / lenf[:, None]
