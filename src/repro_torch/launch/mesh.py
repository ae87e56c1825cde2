"""Device meshes: the production meshes the zoo is planned for, the host
mesh, the cell mesh of the hierarchy's span routing, and the card's
constants.

Port of `repro.launch.mesh`. A mesh is a `DeviceMesh` over the default
process group, one rank per device. Building one is a function, never
an import side effect; the dry run (`launch.dryrun`) builds the
production meshes over a fake process group of 256 or 512 ranks.

The constants keep the reference's names with one NVIDIA H100 SXM's
values (the reference's are a TPU v5e's).
"""
from __future__ import annotations

from typing import Sequence

import torch.distributed as dist

# NVIDIA H100 SXM datasheet, dense rates without sparsity, at 700 W
PEAK_FLOPS_BF16 = 989e12        # per card, bf16 on the tensor cores
HBM_BW = 3.35e12                # bytes/s per card
ICI_BW = 450e9                  # NVLink 4, bytes/s per card, one direction
HBM_PER_CHIP = 80e9             # bytes


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A `DeviceMesh` of `shape` named `names` over the default process
    group, whose world size must be the product of `shape` (ValueError
    otherwise, or RuntimeError without a group). Its device type follows
    the group's backend, as `make_cell_mesh`'s does."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"default group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or with `multi_pod` (2, 16, 16)
    ``("pod", "data", "model")``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh():
    """``("data", "model")`` of (n, 1) over the group's n ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"))


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
