"""Sentence encoder — the all-MiniLM-L6-v2 stand-in.

Port of `repro.estimators.embedding` (lines 23-117). A small frozen
transformer encoder with random weights: hashed token embeddings -> 2
encoder layers -> masked mean-pool -> L2 normalize. Frozen random
transformers preserve input similarity structure, which is all the KNN
estimator needs.

`SentenceEncoder` is an `nn.Module` whose weights come from a seeded
`torch.Generator` and live on the card unless `device="cpu"` is given;
they are not the reference's (which come from
`jax.random`); `load_params` installs the reference's weights from
numpy arrays when the two must be compared. The forward pass spells the
reference's: masked attention scores at -1e30, `gelu` with the tanh
approximation (jax's default), RMS normalization with +1e-6, masked
mean-pooling and `e / max(|e|, 1e-6)`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def pad_tokens(token_lists, max_len: int) -> np.ndarray:
    """Ragged token lists -> (B, max_len) int32, zero-padded."""
    n = len(token_lists)
    out = np.zeros((n, max_len), np.int32)
    if n == 0:
        return out
    lens = np.minimum(
        np.fromiter((len(t) for t in token_lists), np.int64, count=n),
        max_len)
    if lens.sum() == 0:
        return out
    mask = np.arange(max_len)[None, :] < lens[:, None]
    out[mask] = np.concatenate(
        [np.asarray(t[:l], np.int32) for t, l in zip(token_lists, lens)])
    return out


class _Layer(nn.Module):
    def __init__(self, hidden: int, g: torch.Generator):
        super().__init__()
        s = hidden ** -0.5
        for name, shape, scale in (
                ("wq", (hidden, hidden), s), ("wk", (hidden, hidden), s),
                ("wv", (hidden, hidden), s), ("wo", (hidden, hidden), s),
                ("w1", (hidden, 2 * hidden), s),
                ("w2", (2 * hidden, hidden), (2 * hidden) ** -0.5)):
            self.register_buffer(name, torch.randn(shape, generator=g)
                                 * scale)


class SentenceEncoder(nn.Module):
    def __init__(self, dim: int = 128, hidden: int = 128, n_layers: int = 2,
                 n_heads: int = 4, hash_vocab: int = 4096, seed: int = 7,
                 max_len: int = 128, device=None):
        super().__init__()
        self.dim = dim
        self.hidden = hidden
        self.max_len = max_len
        self.hash_vocab = hash_vocab
        self.n_heads = n_heads
        g = torch.Generator().manual_seed(seed)
        s = hidden ** -0.5
        self.register_buffer(
            "embed", torch.randn(hash_vocab, hidden, generator=g) * s)
        self.register_buffer(
            "pos", torch.randn(max_len, hidden, generator=g) * s * 0.1)
        self.register_buffer("out", torch.randn(hidden, dim, generator=g)
                             * s)
        self.layers = nn.ModuleList(_Layer(hidden, g)
                                    for _ in range(n_layers))
        from ..core.device import resolve_device   # core imports this module
        self.to(resolve_device(device))             # None -> the card

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def load_params(self, params) -> "SentenceEncoder":
        """Install weights given as the reference's `params` tree of
        numpy arrays ({"embed", "pos", "out", "layers": [{"wq", ...}]})."""
        def put(buf, a):
            a = np.array(a, np.float32)          # a writable copy
            assert buf.shape == a.shape, (buf.shape, a.shape)
            buf.copy_(torch.from_numpy(a))
        with torch.no_grad():
            for name in ("embed", "pos", "out"):
                put(getattr(self, name), params[name])
            assert len(params["layers"]) == len(self.layers)
            for layer, lp in zip(self.layers, params["layers"]):
                for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                    put(getattr(layer, name), lp[name])
        return self

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        """tokens: (B, L) int (already hashed); mask: (B, L) bool."""
        h = (self.embed[tokens % self.hash_vocab]
             + self.pos[None, :tokens.shape[1]])
        mf = mask[..., None].to(h.dtype)
        B, L, D = h.shape
        nh = self.n_heads
        hd = D // nh
        for lp in self.layers:
            q = (h @ lp.wq).reshape(B, L, nh, hd)
            k = (h @ lp.wk).reshape(B, L, nh, hd)
            v = (h @ lp.wv).reshape(B, L, nh, hd)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
            s = torch.where(mask[:, None, None, :], s, -1e30)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, D)
            h = h + o @ lp.wo
            h = h + F.gelu(h @ lp.w1, approximate="tanh") @ lp.w2
            h = h * torch.rsqrt(
                torch.mean(torch.square(h), -1, keepdim=True) + 1e-6)
        pooled = (h * mf).sum(1) / torch.clamp_min(mf.sum(1), 1.0)
        e = pooled @ self.out
        return e / torch.clamp_min(
            torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-6)

    @torch.no_grad()
    def encode(self, tokens: np.ndarray,
               lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """tokens: (B, L) int; lengths: (B,). One batched call (§4.2);
        returns (B, dim) float32 numpy."""
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        L = min(tokens.shape[1], self.max_len)
        tokens = tokens[:, :L]
        if lengths is None:
            mask = np.ones(tokens.shape, bool)
        else:
            mask = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
        dev = self.device
        out = self(torch.as_tensor(tokens, dtype=torch.int64, device=dev),
                   torch.as_tensor(mask, device=dev))
        return out.cpu().numpy()
