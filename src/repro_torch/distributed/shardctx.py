"""Sharding context: the mesh a launcher pins for code that does not
take one as an argument.

Port of the mesh half of `repro.distributed.shardctx`.
``sharding_rules(mesh)`` pins a `DeviceMesh` for the duration of a
``with`` block and ``current()`` returns it; the scheduler's span
routing takes its mesh from there when its ``"cell"`` dimension has
``RBConfig.shard_cells`` ranks (`core.scheduler.RouteBalancePolicy`).
The named rules, `constrain` (a sharding constraint on an activation)
and `batch_axes` have no caller in the port yet: they need DTensor and
come with the model-distribution layer (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

_STATE = {"mesh": None}


def current() -> Optional[Any]:
    """The mesh of the innermost active `sharding_rules`, else None."""
    return _STATE["mesh"]


@contextlib.contextmanager
def sharding_rules(mesh):
    old = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = old
