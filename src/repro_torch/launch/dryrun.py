"""Multi-pod dry run: every (arch x shape) cell planned on the production
meshes, and each serving cell's step run for rank 0 on the meta device.

Port of `repro.launch.dryrun`. For each cell it builds the production
mesh (16 x 16 ``("data", "model")``, or 2 x 16 x 16 with ``"pod"``)
over a fake process group of 256 or 512 ranks, runs
`launch.steps.lower_cell` on meta tensors and writes one JSON file per
cell under ``build/dryrun/``: the status (``ok``, ``skipped`` with the
reason, or ``error`` with the traceback), the reference's `meta`, the
chip count, and the bytes one device holds of the parameters, the
optimizer state (train), the batch and the decode cache, from the
plans' DTensor placements.

Where `lower_cell` returns a step (the prefill and decode cells of the
dense, MoE, vision and SSM archs), `step_costs` runs it for rank 0 on
meta tensors: the model cut to rank 0's pieces (`shard_params`), its
batch and cache likewise, the collectives recorded by the fake group
without communicating. Per device it records what the reference reads
from the compiled HLO: `flops_per_device` (2 x output elements x K of
every matmul, attention's and K4's products included, `models.cost`),
`hbm_bytes_per_device` (each matmul, fused call and collective reads
its operands once and writes its result once), `collectives` (count,
payload and link bytes per kind, ring factors all-gather 1, all-reduce
2, reduce-scatter 1) and `peak_bytes_per_device` (the high-water mark
of live meta-tensor bytes, parameters, batch and cache included, by
`torch.distributed._tools.mem_tracker.MemTracker`). The other cells
(train, the RG-LRU hybrid, the encoder-decoder) keep the plan's record
with `plan_only`, the reason and the slice that runs them.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
import traceback

import torch.distributed as dist

RUNS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of `n` ranks (this process rank 0):
    meshes build over it and no collective runs."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record; needs a default group of the mesh's size
    (`fake_world(512 if multi_pod else 256)`)."""
    from repro_torch.configs import SHAPES, get_config, skip_reason
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell, plan_only

    t0 = time.time()
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod)}
    reason = skip_reason(arch, shape_name)
    if reason:
        return dict(head, status="skipped", reason=reason)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    plan, meta, step = lower_cell(cfg, shape, mesh)
    trees = {"params": plan["params"], "batch": plan["batch"]}
    if "opt" in plan:
        o = plan["opt"]
        trees["opt"] = {**{f"m{k}": v for k, v in o["m"].items()},
                        **{f"v{k}": v for k, v in o["v"].items()},
                        "step": o["step"]}
    if "cache" in plan:
        trees["cache"] = plan["cache"]
    rec = dict(
        head, status="ok", meta=meta, n_chips=mesh.size(),
        bytes_per_device={k: shr.bytes_per_device(t, mesh)
                          for k, t in trees.items()},
        t_plan_s=round(time.time() - t0, 3))
    if step is None:
        rec["plan_only"] = plan_only(cfg, shape)
    else:
        t1 = time.time()
        rec.update(step_costs(cfg, shape, plan, step, mesh),
                   t_step_s=round(time.time() - t1, 3))
    return rec


def step_costs(cfg, shape, plan, step, mesh) -> dict:
    """Run `step` (`lower_cell`'s) for rank 0 on meta tensors under the
    fake group that `mesh` spans; the per-device counts (module
    docstring)."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs import input_specs
    from repro_torch.distributed import shardctx
    from repro_torch.launch import sharding as shr
    from repro_torch.models import Model
    from repro_torch.models.api import flatten_tree
    from repro_torch.models.cost import Counter

    cfg = cfg.replace(vocab_pad_to=256)
    model = shr.shard_params(Model(cfg, device="meta"), plan["params"],
                             mesh, 0)
    batch = shr.shard_batch(input_specs(cfg, shape), plan["batch"], mesh, 0)
    args = [batch]
    if shape.kind == "decode":
        cache = shr.shard_cache(
            model.cache_specs(shape.global_batch, shape.seq_len),
            plan["cache"], mesh, 0)
        args = [cache, batch["tokens"]]
    held = [t for a in args for _, t in flatten_tree(a)
            if isinstance(t, torch.Tensor)]
    shardctx.reset_collectives()
    mt = MemTracker()
    mt.track_external(model, *held)
    with mt, Counter() as count:
        step(model, *args)
    colls = {k: dict(v) for k, v in shardctx.COLLECTIVES.items()
             if v["count"]}
    peak = mt.get_tracker_snapshot("peak")
    return dict(
        flops_per_device=count.flops,
        hbm_bytes_per_device=count.hbm_bytes + sum(
            v.pop("hbm_bytes") for v in colls.values()),
        collectives=colls,
        collective_link_bytes_per_device=sum(v["link_bytes"]
                                             for v in colls.values()),
        peak_bytes_per_device=int(sum(d["Total"] for d in peak.values())))


def cell_path(arch: str, shape: str, multi_pod: bool,
              tag: str = "") -> pathlib.Path:
    suffix = f"__{tag}" if tag else ""
    return RUNS / f"{arch}__{shape}__{mesh_name(multi_pod)}{suffix}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    from repro_torch.configs import SHAPES, list_archs
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all, are required")
    RUNS.mkdir(parents=True, exist_ok=True)
    failures = 0
    for mp in meshes:
        todo = [(a, s) for a, s in cells
                if args.force or not cell_path(a, s, mp, args.tag).exists()]
        for a, s in cells:
            if (a, s) not in todo:
                print(f"cached  {cell_path(a, s, mp, args.tag).name}")
        if not todo:
            continue
        with fake_world(512 if mp else 256):
            for arch, shape in todo:
                out = cell_path(arch, shape, mp, args.tag)
                try:
                    res = run_cell(arch, shape, mp)
                except Exception:                   # recorded per cell
                    res = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(mp), "status": "error",
                           "traceback": traceback.format_exc()}
                out.write_text(json.dumps(res, indent=1))
                failures += res["status"] == "error"
                print(f"{res['status']:<8}{out.name}")
                if res["status"] == "error":
                    print(res["traceback"][-3000:])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
