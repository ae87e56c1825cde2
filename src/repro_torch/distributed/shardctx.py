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
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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
