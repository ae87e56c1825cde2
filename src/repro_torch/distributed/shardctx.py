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

Under autograd each collective is a `torch.autograd.Function`, out of
place, with Megatron's rules for its backward (counted under the same
kinds, and moving nothing on a fake group either): a sum all-reduce
passes its gradient ("g": every rank consumes the sum alike), the
identity ``copy_to(x, axis)`` all-reduces it ("f": in front of work
each rank holds a part of, a column-split product or a share of heads),
an all-gather reduce-scatters it (each rank reads the whole tensor
differently) or, with ``grad="slice"``, takes this rank's slice (every
rank computes the same from it), a reduce-scatter all-gathers it; a max
or min takes none. Without autograd an all-reduce stays in place.
``data_axes()`` names the axes a train step's batch is split on (the
pinned "batch" rule), over which the loss is summed;
``piece_sum(parts)`` sums per-piece scalars over the mesh, each over the
axes its piece is split on (the optimizer's global norm).
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


def data_axes() -> Tuple[str, ...]:
    """The axes of size > 1 that the pinned "batch" rule splits a batch's
    rows over (a train step's data-parallel axes; the plan's entry for
    its tokens), else ()."""
    spec = _STATE["rules"].get("batch")
    if _STATE["mesh"] is None or not spec:
        return ()
    return tuple(a for a in spec[0] if axis_size(a) > 1)


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


def _group(axis: str):
    """(the axis' process group, whether it only records)."""
    group = _STATE["mesh"].get_group(axis)
    return group, dist.get_backend(group) == "fake"


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _reduce(t, axis: str, op: str = "sum"):
    """`t` reduced over `axis` in place, counted."""
    group, fake = _group(axis)
    if not (fake or t.is_meta):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    _record("all_reduce", t, t)
    return t


def _gather(t, axis: str, dim: int):
    m = axis_size(axis)
    group, fake = _group(axis)
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


def _scatter(t, axis: str, dim: int):
    m = axis_size(axis)
    group, fake = _group(axis)
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


def _records(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduce(torch.autograd.Function):
    """Sum over an axis whose result every rank consumes alike: the
    gradient passes as it is (Megatron's "g")."""

    @staticmethod
    def forward(ctx, t, axis):
        return _reduce(t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """The identity in front of work whose gradient each rank holds a
    part of: the gradient is summed over the axis (Megatron's "f")."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, grad):
        ctx.axis, ctx.dim, ctx.grad = axis, dim, grad
        ctx.n = t.shape[dim]
        return _gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "scatter":
            return _scatter(g, ctx.axis, ctx.dim), None, None, None
        r = axis_rank(ctx.axis)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _scatter(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


def all_reduce(t, axis: str, op: str = "sum"):
    """`t` reduced over `axis`. In place (and returned) unless autograd
    records `t`: then a new tensor, a sum's gradient passing unchanged
    (every rank consumes the sum alike); a max or min takes no
    gradient."""
    if axis_size(axis) == 1:
        return t
    if not _records(t):
        return _reduce(t, axis, op)
    if op != "sum":
        return _reduce(t.detach().clone(), axis, op)
    return _AllReduce.apply(t, axis)


def copy_to(t, axis: str = "model"):
    """`t` as it is; its gradient is summed over `axis` (each rank's
    consumers hold a part of it: a column-split product, a share of the
    heads, of the experts' d_ff or of the vocabulary)."""
    if axis_size(axis) == 1 or not _records(t):
        return t
    return _CopyTo.apply(t, axis)


def all_gather(t, axis: str, dim: int = 0, grad: str = "scatter"):
    """Every `axis` rank's `t` concatenated along `dim` in rank order.
    The gradient of this rank's piece is, with `grad="scatter"`, the sum
    over the ranks of their gradients at it (a reduce-scatter: each rank
    reads the whole tensor differently), with `grad="slice"` this rank's
    own slice of its gradient (every rank computes the same from it)."""
    if axis_size(axis) == 1:
        return t
    if not _records(t):
        return _gather(t, axis, dim)
    return _AllGather.apply(t, axis, dim, grad)


def reduce_scatter(t, axis: str, dim: int = 0):
    """The sum of every `axis` rank's `t`, cut evenly along `dim`: this
    rank's piece. Its gradient is all-gathered."""
    if axis_size(axis) == 1:
        return t
    if not _records(t):
        return _scatter(t, axis, dim)
    return _ReduceScatter.apply(t, axis, dim)


def piece_sum(parts) -> torch.Tensor:
    """The sum over the mesh of per-piece scalars: `parts` holds (a
    float32 scalar of this rank's piece, the axes that piece is split
    on); a piece replicated over an axis is counted once. The scalars
    that share their axes are added first, in order (without a split,
    the plain sum in `parts`' order), then each axis of size > 1 is
    summed over once, for the sums split on it (at most one all-reduce
    per axis, of a vector)."""
    by: Dict[Tuple[str, ...], Any] = {}
    for v, axes in parts:
        key = tuple(sorted(a for a in axes if axis_size(a) > 1))
        by[key] = by[key] + v if key in by else v
    total = by.pop((), None)
    if by:
        keys = sorted(by)
        vec = torch.stack([by[k] for k in keys])
        for a in sorted({a for k in keys for a in k}):
            idx = [i for i, k in enumerate(keys) if a in k]
            vec[idx] = all_reduce(vec[idx].clone(), a)
        rest = vec.sum()
        total = rest if total is None else total + rest
    return total
