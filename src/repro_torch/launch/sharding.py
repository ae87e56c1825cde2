"""Placement plans for every tree a cell's step reads.

Port of `repro.launch.sharding`. A plan entry names, for each dimension
of a tensor, the mesh axes that shard it (a tuple per dimension, () for
none); `to_named` turns entries into DTensor placements. The rules read
only axis names and sizes, so they run on a `DeviceMesh` or on a
mapping {axis: size} alike. The policy is the reference's:

  * params     - Megatron TP over "model" (attention heads, MLP hidden,
                 vocab), optional FSDP over "data" on the largest free
                 dimension;
  * opt state  - ZeRO: the moments take the parameter's entry plus
                 "data" on a free dimension;
  * batch      - the leading dimension over ("pod", "data") when it
                 divides;
  * KV caches  - the batch over the data axes, then KV heads over
                 "model" when they divide, else the cache's sequence,
                 else head_dim;
  * residual   - the (B, S, D) residual stream over the batch axes.

A dimension is sharded only when the axes' size divides it.

The reference stacks pattern slot s's layers over the cycles into one
leaf (`slot{s}`, and the encoder-decoder's `enc` / `dec`); the port
keeps a leaf per layer (`Model.stacked_leaves`). Parameters and their
optimizer state are planned per stacked group, over the stacked shape
(n_cycles,) + layer shape and under the reference's own path
(`['slot0']['mixer']['conv_x']['w']`), so that its substring rules and
FSDP's choice of dimension come out as on the reference's leaves. Where
that choice is the stack dimension (mamba2's `conv_x.w` and `out_norm`
under FSDP), the plan places whole layers on the "data" ranks, and the
per-device bytes count it so. Caches are planned per layer: the
reference never shards a cache's stack dimension.

`shard_params`, `shard_cache`, `shard_batch` and `shard_opt_state`
carry out a plan on one rank: they cut the one-process trees (a `Model` built or bridged as
for one device, a cache, a batch) into the pieces that rank holds, so
the tensor-parallel model code (`models.layers`, `models.blocks`,
`models.model`, `models.moe`) runs on them under
`shardctx.sharding_rules`. "model" shares are read by that code as
they are; a "data" (FSDP) share of a parameter is gathered over "data"
where the parameter is read (`models.api.Params.__getitem__`).

`cell_specs` is the layout of the hierarchy's cell-sharded decision
scan.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from ..distributed.shardctx import axis_sizes, batch_axes, divides, \
    kv_cache_dim, placements

Spec = Tuple[Tuple[str, ...], ...]


class Placed(NamedTuple):
    """One planned tensor: its (stacked) shape, dtype and plan entry."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec


def _axsize(mesh, names) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in ((names,) if isinstance(names, str) else names):
        n *= sizes[a]
    return n


def _div(dim: int, mesh, names) -> bool:
    return divides(dim, _axsize(mesh, names))


def _spec(ndim: int, dim: Optional[int] = None, axes=()) -> Spec:
    """An entry of `ndim` dimensions, dimension `dim` over `axes` (a name
    or a tuple of names), the others unsharded."""
    parts = [()] * ndim
    if dim is not None:
        parts[dim] = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(parts)


# ---------------------------------------------------------------------------
# the reference's leaf paths

def _path(parts) -> str:
    return "".join(f"['{p}']" for p in parts)


def reference_path(cfg, name: str) -> Tuple[str, bool]:
    """(the reference's `keystr` of the leaf that holds the port's
    parameter or cache leaf `name`, whether that leaf is stacked over
    layers)."""
    head, *rest = name.split(".")
    if cfg.is_encdec and head in ("enc", "dec"):
        return _path([head] + rest[1:]), True
    if cfg.is_encdec and head == "layers":            # decoder caches
        return _path(rest[1:]), True
    if head == "layers":
        i, n_pat = int(rest[0]), len(cfg.pattern)
        if i < cfg.n_cycles * n_pat:
            return _path([f"slot{i % n_pat}"] + rest[1:]), True
        return _path([f"rem{i - cfg.n_cycles * n_pat}"] + rest[1:]), False
    return _path([head] + rest), False


def stacked_shapes(cfg, leaves: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{reference path: (shape, dtype)} of a tree by leaf name (the
    parameters, or anything shaped like them): a stacked group's shape is
    (its layer count,) + the layer's."""
    out: Dict[str, list] = {}
    for name, t in leaves.items():
        path, stacked = reference_path(cfg, name)
        if path in out:
            out[path][0] += 1
        else:
            out[path] = [1 if stacked else 0, tuple(t.shape), t.dtype]
    return {p: (((n,) if n else ()) + shape, dtype)
            for p, (n, shape, dtype) in out.items()}


# ---------------------------------------------------------------------------
# parameter rules

def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    M, nd = "model", len(shape)

    def col():     # (.., D_in, D_out): shard the output dimension
        return _spec(nd, nd - 1, M) \
            if _div(shape[-1], mesh, M) else _spec(nd)

    def row():     # (.., D_in, D_out): shard the input dimension
        return _spec(nd, nd - 2, M) \
            if nd >= 2 and _div(shape[-2], mesh, M) else _spec(nd)

    if "embed" in path or "lm_head" in path:
        if _div(shape[0], mesh, M):
            return _spec(nd, 0, M)             # vocab-sharded
        if _div(shape[1], mesh, M):
            return _spec(nd, 1, M)
        return _spec(nd)
    if any(k in path for k in ("wq", "wk", "wv", "up", "gate",
                               "w_in", "w_gate_branch", "w_i", "w_r",
                               "in_z", "in_x", "in_dt", "frontend_proj")):
        return col()
    if any(k in path for k in ("wo", "down", "out_proj", "w_out")):
        return row()
    if "conv_x" in path:                            # (width, di)
        return col()
    if ("conv" in path and "conv_B" not in path and "conv_C" not in path
            and nd == 2):                           # rglru conv (width, W)
        return col()
    if ("out_norm" in path or "lam" in path) and _div(shape[-1], mesh, M):
        return _spec(nd, nd - 1, M)
    return _spec(nd)  # norms, routers, scalars, biases, pos_dec, in_B/in_C


def _with_fsdp(spec: Spec, shape, mesh) -> Spec:
    """Add "data" on the largest unsharded dimension it divides (the
    last of equals, as the reference's `max` over (size, index))."""
    cand = [(shape[i], i) for i in range(len(shape))
            if not spec[i] and _div(shape[i], mesh, "data")]
    if not cand:
        return spec
    _, i = max(cand)
    return spec[:i] + (("data",),) + spec[i + 1:]


def param_pspecs(model, mesh, fsdp: bool = False) -> Dict[str, Placed]:
    """The parameters' plan: {reference path: Placed} over the stacked
    groups of `model`'s `param_specs()`."""
    out = {}
    for path, (shape, dtype) in stacked_shapes(
            model.cfg, model.param_specs()).items():
        spec = param_spec(path, shape, mesh)
        # never FSDP the embedding: a d_model shard puts a data-axis sum
        # on every CE chunk, and a (model, data) vocab shard conflicts
        # with the data-sharded batch of the chunked-CE logits
        if fsdp and "embed" not in path and "lm_head" not in path:
            spec = _with_fsdp(spec, shape, mesh)
        out[path] = Placed(shape, dtype, spec)
    return out


def opt_pspecs(model, mesh) -> Dict[str, object]:
    """ZeRO: AdamW's float32 moments take the parameter's entry plus
    "data" on a free dimension; the step is replicated."""
    mv = {}
    for path, (shape, _) in stacked_shapes(
            model.cfg, model.param_specs()).items():
        spec = _with_fsdp(param_spec(path, shape, mesh), shape, mesh)
        mv[path] = Placed(shape, torch.float32, spec)
    return {"m": mv, "v": dict(mv), "step": Placed((), torch.int32, ())}


# ---------------------------------------------------------------------------
# batch / cache rules

def batch_pspecs(batch: Mapping[str, torch.Tensor], mesh
                 ) -> Dict[str, Placed]:
    ba = batch_axes(mesh)
    out = {}
    for k, t in batch.items():
        nd, lead = t.dim(), ()
        if nd and ba and _div(t.shape[0], mesh, ba):
            lead = ba
        elif nd and _div(t.shape[0], mesh, "data"):
            lead = ("data",)
        out[k] = Placed(tuple(t.shape), t.dtype,
                        _spec(nd, 0 if lead else None, lead))
    return out


def cache_pspecs(cache, mesh, batch: int) -> Dict[str, Placed]:
    """The decode cache's plan, per layer leaf by dotted name (the
    reference's entry for the stacked leaf less its stack dimension);
    the positions and the host-side counters (`pos`, `enc_len`, Python
    integers) are not planned."""
    from ..models.api import flatten_tree
    ba = batch_axes(mesh)
    bdim_shard = ba if (ba and batch % _axsize(mesh, ba) == 0) else \
        (("data",) if batch % _axsize(mesh, "data") == 0 else ())
    out = {}
    for name, t in flatten_tree(cache):
        if not isinstance(t, torch.Tensor):
            continue
        leaf, shp, nd = name.split(".")[-1], tuple(t.shape), t.dim()
        parts = [()] * nd
        if nd == 0 or leaf in ("positions", "pos", "enc_len"):
            out[name] = Placed(shp, t.dtype, tuple(parts))
            continue
        # the batch dimension: 0 in a layer's cache (the reference's rule
        # on its stacked leaves picks 1 there)
        bdim = 1 if (nd >= 2 and shp[0] != batch and shp[1] == batch) else 0
        if shp[bdim] == batch and bdim_shard:
            parts[bdim] = bdim_shard
        if leaf in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # KV heads first, else the cache's sequence, head_dim last
            # (sharding head_dim gathers the whole cache every step)
            d = kv_cache_dim(shp[-3], shp[-2], shp[-1],
                             _axsize(mesh, "model"))
            if d is not None:
                parts[d] = ("model",)
        elif leaf == "state":                       # (B, nh, P, N)
            if _div(shp[-3], mesh, "model"):
                parts[-3] = ("model",)
        elif leaf.startswith("conv") or leaf == "h":   # (.., W) channels
            if _div(shp[-1], mesh, "model"):
                parts[-1] = ("model",)
        out[name] = Placed(shp, t.dtype, tuple(parts))
    return out


# ---------------------------------------------------------------------------

def to_named(plan: Mapping[str, Placed], mesh) -> Dict[str, list]:
    """{name: the entry's DTensor placements over `mesh`}."""
    return {k: placements(p.spec, mesh) for k, p in plan.items()}


def bytes_per_device(plan: Mapping[str, Placed], mesh) -> int:
    """The bytes one device holds of `plan`'s tensors under their DTensor
    placements (each `Shard(d)` divides dimension d by its mesh
    dimension's size)."""
    sizes = list(axis_sizes(mesh).values())
    total = 0
    for name, pls in to_named(plan, mesh).items():
        p = plan[name]
        shape = list(p.shape)
        for size, pl in zip(sizes, pls):
            if isinstance(pl, Shard):
                shape[pl.dim] //= size
        n = p.dtype.itemsize
        for s in shape:
            n *= s
        total += n
    return total


def coordinates(mesh, rank: int) -> Dict[str, int]:
    """{axis: rank `rank`'s coordinate} on `mesh` (row-major over the
    axes, the `DeviceMesh` order of the default group's ranks)."""
    out = {}
    for a, n in reversed(list(axis_sizes(mesh).items())):
        out[a], rank = rank % n, rank // n
    return dict(reversed(list(out.items())))


def local_piece(t: torch.Tensor, spec: Spec, mesh, rank: int):
    """Rank `rank`'s piece of `t` under the plan entry `spec`: each
    sharded dimension narrowed to the rank's share of its axes (several
    axes on one dimension combine in the entry's order). A view of `t`:
    `_own` copies it, so the whole tensor's storage can go."""
    sizes, at = axis_sizes(mesh), coordinates(mesh, rank)
    for d, axes in enumerate(spec):
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + at[a]
        if n > 1:
            step = t.shape[d] // n
            t = t.narrow(d, i * step, step)
    return t


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a piece (a narrowed view shares, and keeps
    alive, the whole tensor's storage even where it is contiguous)."""
    return t.clone(memory_format=torch.contiguous_format)


def _layer_spec(cfg, name: str, plan: Mapping[str, Placed]) -> Spec:
    """The plan entry of port leaf `name`: its stacked group's less the
    stack dimension."""
    path, stacked = reference_path(cfg, name)
    spec = plan[path].spec
    if not stacked:
        return spec
    if spec[0]:
        raise NotImplementedError(
            f"{path} places whole layers on {spec[0]} ranks; the executed "
            "plans take a layer's parameters on every rank")
    return spec[1:]


def shard_params(model, plan: Mapping[str, Placed], mesh, rank: int):
    """Keep only rank `rank`'s pieces of `model`'s parameters under the
    parameter plan (`param_pspecs`), in place; returns the model. The
    pieces are new tensors, so the whole ones can go. A dimension
    FSDP-sharded over "data" is registered with its module, whose
    `__getitem__` gathers it over "data" where it is read; "model"
    shares stay as they are (the experts' among them: their d_ff slices,
    which `moe.moe_layer_sharded` reads with this rank's rows)."""
    for mname, mod in list(model.named_modules()):
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{mname}.{leaf}" if mname else leaf
            spec = _layer_spec(model.cfg, name, plan)
            piece = local_piece(p.data, spec, mesh, rank)
            if piece.shape != p.shape:
                setattr(mod, leaf, nn.Parameter(_own(piece),
                                                requires_grad=False))
            for d, axes in enumerate(spec):
                if "data" in axes:
                    mod.gathers = dict(mod.gathers, **{leaf: (d, "data")})
    return model


def shard_cache(cache, plan: Mapping[str, Placed], mesh, rank: int):
    """Rank `rank`'s pieces of a decode cache (`init_cache`'s or
    prefill's tree: the decoder-only model's, the RG-LRU's `h` / `conv`
    leaves included, or the encoder-decoder's list of layers) under
    `cache_pspecs`, as a new tree of the same form; the host-side
    counters are kept."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        name = prefix[:-1]
        if not isinstance(tree, torch.Tensor) or name not in plan:
            return tree
        return _own(local_piece(tree, plan[name].spec, mesh, rank))
    return walk(cache, "")


def stacked_groups(cfg, names) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """{reference path: (the port leaf names it holds, in layer order,
    whether it is stacked over layers)}: the groups the parameter and
    optimizer plans are made over."""
    out: Dict[str, list] = {}
    for n in names:
        path, stacked = reference_path(cfg, n)
        out.setdefault(path, [[], stacked])[0].append(n)
    return {p: (tuple(ns), st) for p, (ns, st) in out.items()}


def stack_group(leaves: Mapping[str, torch.Tensor], names, stacked: bool):
    """One group's tensors as the reference's leaf: stacked over layers,
    or the one tensor."""
    if stacked:
        return torch.stack([leaves[n] for n in names])
    return leaves[names[0]]


def local_shape(placed: Placed, mesh) -> Tuple[int, ...]:
    """The shape one rank holds of a planned tensor."""
    sizes, shape = axis_sizes(mesh), list(placed.shape)
    for d, axes in enumerate(placed.spec):
        for a in axes:
            shape[d] //= sizes[a]
    return tuple(shape)


def init_opt_pieces(opt_plan, mesh, device, compression: bool = False):
    """A rank's zero AdamW state under the optimizer plan (`opt_pspecs`):
    {"m", "v": {reference path: float32 piece}, "step"}, plus the int8
    codec's error pieces as "ef" with `compression`."""
    def zeros():
        return {k: torch.zeros(local_shape(p, mesh), dtype=torch.float32,
                               device=device)
                for k, p in opt_plan["m"].items()}
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compression:
        state["ef"] = zeros()
    return state


def shard_opt_state(state, plan, mesh, rank: int, cfg):
    """Rank `rank`'s pieces of a one-process optimizer state (keyed by
    the port's leaf names, `steps.init_opt_state` or
    `bridge.opt_state_from_jax`) under the optimizer plan (`opt_pspecs`):
    each stacked group's moments (and error buffers) stacked as the
    reference's leaf and cut to the rank's piece, keyed by the reference
    path; the step is kept."""
    groups = stacked_groups(cfg, state["m"])
    out = {"step": state["step"].clone()}
    for key in ("m", "v", "ef"):
        if key in state:
            out[key] = {p: _own(local_piece(
                stack_group(state[key], names, st), plan["m"][p].spec, mesh,
                rank)) for p, (names, st) in groups.items()}
    return out


def shard_batch(batch: Mapping[str, torch.Tensor],
                plan: Mapping[str, Placed], mesh, rank: int):
    """Rank `rank`'s rows of a batch under `batch_pspecs`."""
    return {k: _own(local_piece(v, plan[k].spec, mesh, rank))
            for k, v in batch.items()}


def residual_spec(mesh, seq_shard: bool = False) -> Spec:
    """The (B, S, D) residual stream: the batch over the batch axes, and
    with `seq_shard` the sequence over "model"."""
    return (batch_axes(mesh), ("model",) if seq_shard else (), ())


def cell_specs() -> Tuple[Placement, Placement, Placement]:
    """Layout of `core.decision.sharded_greedy_scan` over a ``("cell",)``
    mesh: the (R, C, Ic) request planes split on the cell axis
    (`Shard(1)`), the (C, Ic) instance state likewise (`Shard(0)`), the
    (R,) request vectors replicated. Returns (plane, state,
    replicated)."""
    return Shard(1), Shard(0), Replicate()
