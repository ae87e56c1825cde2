"""Sharding context: the mesh and the named placement rules a launcher
pins for code that does not take them as arguments.

Port of `repro.distributed.shardctx`. ``sharding_rules(mesh,
**rules)`` pins a `DeviceMesh` (or, for code that only reads axis names
and sizes, a mapping {axis: size}) and named rules for the duration of
a ``with`` block. A rule is a plan entry of `launch.sharding`: for each
dimension of a tensor, the mesh axes that shard it. ``current()``
returns the mesh, as the scheduler's span routing reads it
(`core.scheduler.RouteBalancePolicy`, a ``("cell",)`` mesh), and
``rules()`` the rules.

``constrain(x, name)`` is the model code's one hook (the residual
stream of the train/prefill cycles, `models.model`): without a mesh or
without the rule it returns x, so single-device runs take the exact
same code; under a mesh a `DTensor` is redistributed to the rule's
placements and a plain tensor, which holds this rank's piece already,
is returned as it is. ``batch_axes(mesh)`` names the mesh's batch axes,
``"pod"`` then ``"data"``; the sharded MoE (`models.moe`) reads them.

The tensor-parallel model code reads the pinned mesh through
``axis_size`` / ``axis_rank`` and ``local_range(full, local)``: the
[lo, hi) of a dimension of `full` elements that this rank holds when it
holds `local` of them (all of it, or its "model" coordinate's share).
``all_reduce``, ``all_gather`` and ``reduce_scatter`` run one collective
over a named axis of the pinned mesh and count it by kind in
``COLLECTIVES``: calls, payload bytes (the result's), link bytes (the
payload times the ring factor: all-gather 1, all-reduce 2,
reduce-scatter 1) and HBM bytes (operand read once, result written
once). An axis of size 1 is no collective and is not counted. On a fake
process group or meta tensors (the dry run) the call is counted and
communicates nothing; ``reset_collectives()`` zeroes the counts.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_STATE: Dict[str, Any] = {"mesh": None, "rules": {}}


def current() -> Optional[Any]:
    """The mesh of the innermost active `sharding_rules`, else None."""
    return _STATE["mesh"]


def rules() -> Dict[str, Any]:
    """The named rules of the innermost active `sharding_rules`."""
    return _STATE["rules"]


@contextlib.contextmanager
def sharding_rules(mesh, **named):
    old = (_STATE["mesh"], _STATE["rules"])
    _STATE["mesh"], _STATE["rules"] = mesh, dict(named)
    try:
        yield
    finally:
        _STATE["mesh"], _STATE["rules"] = old


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or of a mapping of them."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh=None) -> Tuple[str, ...]:
    mesh = mesh if mesh is not None else _STATE["mesh"]
    if mesh is None:
        return ()
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def placements(spec: Sequence[Tuple[str, ...]], mesh) -> list:
    """A plan entry as DTensor placements over `mesh`'s dimensions:
    `Shard(d)` on every mesh dimension that shards tensor dimension d
    (a dimension sharded over ``("pod", "data")`` is `Shard(d)` on both,
    in the mesh's order), `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def constrain(x, name: str):
    mesh, rule = current(), rules().get(name)
    if mesh is None or rule is None:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(rule, mesh))
    return x


# -- this rank's share and the counted collectives over a named axis ----------

def axis_size(name: str, mesh=None) -> int:
    """The size of axis `name` of `mesh` (the pinned one by default); 1
    without a mesh or without that axis."""
    mesh = mesh if mesh is not None else _STATE["mesh"]
    return 1 if mesh is None else axis_sizes(mesh).get(name, 1)


def axis_rank(name: str, mesh=None) -> int:
    """This rank's coordinate on axis `name`; 0 where the axis has size 1
    or the mesh is a mapping of sizes."""
    mesh = mesh if mesh is not None else _STATE["mesh"]
    if axis_size(name, mesh) == 1 or isinstance(mesh, Mapping):
        return 0
    return mesh.get_local_rank(name)


def local_range(full: int, local: int, axis: str = "model"
                ) -> Tuple[int, int]:
    """[lo, hi) of a dimension of `full` elements that this rank holds
    when it holds `local` of them: all of them, or its share of an even
    split over `axis` (ValueError for anything else)."""
    if local == full:
        return 0, full
    m = axis_size(axis)
    if local * m != full:
        raise ValueError(f"{local} of {full} is not a share of an even "
                         f"split over {m} {axis!r} ranks")
    r = axis_rank(axis)
    return r * local, (r + 1) * local


def divides(n: int, m: int) -> bool:
    """Whether the plans split a dimension of n over m ranks (m divides
    n, and n >= m)."""
    return n % m == 0 and n >= m


def share(n: int, axis: str = "model") -> Tuple[int, int]:
    """[lo, hi) of a dimension of n elements that the plans give this
    rank: its share of an even split over `axis` where the axis' size
    divides n, else all of it (`launch.sharding`'s rule)."""
    m = axis_size(axis)
    if m == 1 or not divides(n, m):
        return 0, n
    r, k = axis_rank(axis), n // m
    return r * k, (r + 1) * k


def kv_cache_dim(C: int, K: int, hd: int, m: int) -> Optional[int]:
    """The dimension of a (B, C, K, hd) KV cache that the plan splits over
    m "model" ranks: the KV heads (-2) where m divides them, else the
    slots (-3), else head_dim (-1), else none (`cache_pspecs`)."""
    for d, n in ((-2, K), (-3, C), (-1, hd)):
        if divides(n, m):
            return d
    return None


_RING = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0}
COLLECTIVES: Dict[str, Dict[str, float]] = {}


def reset_collectives():
    for kind in _RING:
        COLLECTIVES[kind] = {"count": 0, "bytes": 0, "link_bytes": 0.0,
                             "hbm_bytes": 0}


reset_collectives()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, operand, result):
    c = COLLECTIVES[kind]
    c["count"] += 1
    c["bytes"] += _nbytes(result)
    c["link_bytes"] += _nbytes(result) * _RING[kind]
    c["hbm_bytes"] += _nbytes(operand) + _nbytes(result)


def _group(axis: str, t):
    """(the axis' process group, whether it only records)."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            "the collectives have no backward: the train step under the "
            "tensor-parallel plan is not ported (ROADMAP queue 1 item 10)")
    group = _STATE["mesh"].get_group(axis)
    return group, dist.get_backend(group) == "fake"


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t, axis: str, op: str = "sum"):
    """`t` reduced over `axis` in place (and returned)."""
    if axis_size(axis) == 1:
        return t
    group, fake = _group(axis, t)
    if not (fake or t.is_meta):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    _record("all_reduce", t, t)
    return t


def all_gather(t, axis: str, dim: int = 0):
    """Every `axis` rank's `t` concatenated along `dim` in rank order."""
    m = axis_size(axis)
    if m == 1:
        return t
    group, fake = _group(axis, t)
    if fake or t.is_meta:
        shape = list(t.shape)
        shape[dim] *= m
        out = t.new_empty(shape)
    else:
        parts = [torch.empty_like(t) for _ in range(m)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out = torch.cat(parts, dim)
    _record("all_gather", t, out)
    return out


def reduce_scatter(t, axis: str, dim: int = 0):
    """The sum of every `axis` rank's `t`, cut evenly along `dim`: this
    rank's piece."""
    m = axis_size(axis)
    if m == 1:
        return t
    group, fake = _group(axis, t)
    if t.shape[dim] % m:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {m} {axis!r} ranks")
    shape = list(t.shape)
    shape[dim] //= m
    if fake or t.is_meta:
        out = t.new_empty(shape)
    else:
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((shape[dim],) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    _record("reduce_scatter", t, out)
    return out
