"""The layout of the cell-sharded decision scan.

Port of `repro.launch.sharding.cell_specs` (lines 185-194), as
`torch.distributed` placements over the one dimension of a
`make_cell_mesh` mesh. The rest of that module (the parameter,
optimizer, batch and cache rules of the model zoo) belongs to the
model-distribution layer, which is not ported yet (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

from typing import Tuple

from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement


def cell_specs() -> Tuple[Placement, Placement, Placement]:
    """Layout of `core.decision.sharded_greedy_scan` over a ``("cell",)``
    mesh: the (R, C, Ic) request planes split on the cell axis
    (`Shard(1)`), the (C, Ic) instance state likewise (`Shard(0)`), the
    (R,) request vectors replicated. Returns (plane, state,
    replicated)."""
    return Shard(1), Shard(0), Replicate()
