"""The cell mesh of the hierarchy's span routing.

Port of `repro.launch.mesh.make_cell_mesh` (lines 31-41). The
production and host meshes and the TPU constants of that module belong
to the model-distribution layer, which is not ported yet (ROADMAP queue
1, item 7).
"""
from __future__ import annotations

import torch.distributed as dist


def make_cell_mesh(n_cells: int):
    """A one-dimensional `DeviceMesh` named ``("cell",)`` for the
    cell-sharded decision scan (`core.decision.sharded_greedy_scan`),
    one process per cell. Returns None unless the default process group
    is initialised with a world size of exactly `n_cells` (> 1); callers
    then run the bitwise-identical single-program emulation, the
    reference's rule for a host that lacks the devices.

    The mesh's device type follows the group's backend: "cuda" under
    NCCL, "cpu" under gloo, which stages every tensor, the card's too,
    through the host. Building the mesh is local to the calling process
    (the whole world is the default group), so the leader alone may
    call it."""
    if (n_cells <= 1 or not dist.is_available() or not dist.is_initialized()
            or dist.get_world_size() != n_cells):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_cells,),
                            mesh_dim_names=("cell",))
