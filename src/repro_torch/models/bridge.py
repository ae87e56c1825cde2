"""Carry the reference's zoo weights and caches across, as numpy.

The reference draws its weights from `jax.random`, which torch cannot
re-sample, so runs that compare the two packages load the reference's
parameter tree into the port. Nothing here imports the reference:
callers hand over its tree with numpy leaves (`jax.tree.map(np.asarray,
params)`).

  * The reference stacks the layers of pattern slot s over cycles as
    `slot{s}` (leading axis n_cycles) and keeps the remainder layers as
    `rem{r}`; layer c * len(pattern) + s is `slot{s}[c]`, then come the
    `rem{r}` in order, as the reference's scan runs them. Every leaf of
    a layer comes across as it is: the MoE's float32 `router` (D, E)
    and its (E, ., .) `up`, `gate`, `down`, the RG-LRU's float32 `lam`
    and `conv.w`, and in the caches the RG-LRU's float32 `h` and its
    conv window.
  * The encoder-decoder stacks its encoder and decoder layers on a
    leading axis (`enc`, `dec`, and in the cache `self_k/v`,
    `cross_k/v`, each (L, B, ., K, hd)); they become the port's lists,
    beside `frontend_proj`, `pos_dec`, `enc_norm` and `dec_norm`, and
    the cache's shared `positions`, `pos` and `enc_len`.
  * Weights keep the reference's `x @ W` layout, (in, out): nothing is
    transposed.
  * bfloat16 leaves arrive as `ml_dtypes.bfloat16` arrays, which
    `torch.from_numpy` refuses; they are read through a 16-bit integer
    view of the same bits. Every other dtype comes across as it is, so
    any tree shaped like the parameters (their gradients, AdamW's
    float32 `m` and `v`, the compression error buffers) crosses with
    `params_from_jax` too, leaf for leaf under the same names;
    `opt_state_from_jax` carries a whole optimizer state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from .api import flatten_tree
from .config import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layers(tree: Dict, cfg: ModelConfig):
    """The per-layer subtrees in the reference's execution order."""
    layers = []
    for c in range(cfg.n_cycles):
        for s in range(len(cfg.pattern)):
            layers.append(_map(tree[f"slot{s}"], lambda a, c=c: a[c]))
    layers += [tree[f"rem{r}"] for r in range(cfg.n_rem)]
    return layers


def _unstack(tree: Dict, n: int):
    """A tree stacked over n layers on its leading axis, as n trees."""
    return [_map(tree, lambda a, i=i: a[i]) for i in range(n)]


def params_from_jax(tree: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves), or any tree shaped
    like it, as the port's state dict (CPU tensors named by leaf, dtypes
    kept; for `Model.load_state_dict`)."""
    if cfg.is_encdec:
        port = {k: tree[k] for k in ("frontend_proj", "embed", "pos_dec",
                                     "enc_norm", "dec_norm")}
        port["enc"] = _unstack(tree["enc"], cfg.n_enc_layers)
        port["dec"] = _unstack(tree["dec"], cfg.n_layers)
    else:
        port = {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                     "frontend_proj") if k in tree}
        port["layers"] = _layers(tree, cfg)
    return {k: _tensor(v) for k, v in flatten_tree(port)}


def opt_state_from_jax(state: Dict, cfg: ModelConfig) -> Dict:
    """The reference's AdamW state {"m", "v", "step"[, "ef"]} (numpy
    leaves) as the port's: each tree by leaf name, float32 kept, and
    `step` an int32 scalar tensor (CPU tensors; move them with the
    model)."""
    out = {k: params_from_jax(state[k], cfg)
           for k in ("m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out


def cache_from_jax(cache: Dict, cfg: ModelConfig, device=None) -> Dict:
    """The reference's cache (numpy leaves) as the port's: {"pos": int,
    "layers": [per-layer dict of tensors on `device`]}, and for the
    encoder-decoder also "enc_len" and the shared "positions". `device=None`
    means the card (RuntimeError without one), as at every entry point of
    the port."""
    device = resolve_device(device)

    def put(a):
        return _tensor(a).to(device)
    pos = int(np.asarray(cache["pos"]))
    if cfg.is_encdec:
        stacked = {k: cache[k] for k in ("self_k", "self_v", "cross_k",
                                         "cross_v")}
        return {"pos": pos, "enc_len": int(np.asarray(cache["enc_len"])),
                "positions": put(cache["positions"]),
                "layers": [_map(layer, put)
                           for layer in _unstack(stacked, cfg.n_layers)]}
    return {"pos": pos,
            "layers": [_map(layer, put) for layer in _layers(cache, cfg)]}
