"""Multi-pod dry run: every (arch x shape) cell planned on the production
meshes, and each cell's step run for rank 0 on the meta device.

Port of `repro.launch.dryrun`. For each cell it builds the production
mesh (16 x 16 ``("data", "model")``, or 2 x 16 x 16 with ``"pod"``)
over a fake process group of 256 or 512 ranks, runs
`launch.steps.lower_cell` on meta tensors and writes one JSON file per
cell under ``build/dryrun/``: the status (``ok``, ``skipped`` with the
reason, or ``error`` with the traceback), the reference's `meta`, the
chip count, and the bytes one device holds of the parameters, the
optimizer state (train), the batch and the decode cache, from the
plans' DTensor placements.

`step_costs` runs each cell's step (`lower_cell`'s) for rank 0 on meta
tensors: the model cut to rank 0's pieces (`shard_params`), its batch,
cache and ZeRO optimizer pieces likewise, the collectives recorded by
the fake group without communicating. A train step counts its forward,
the recomputation under remat, the backward and the optimizer's
collectives; its k microbatches are k passes alike, so one runs and is
counted k times, and the peak adds the k gradients' float32 sums. Per device it records what the reference reads
from the compiled HLO: `flops_per_device` (2 x output elements x K of
every matmul, attention's and K4's products included, `models.cost`),
`hbm_bytes_per_device` (each matmul, fused call and collective reads
its operands once and writes its result once), `collectives` (count,
payload and link bytes per kind, ring factors all-gather 1, all-reduce
2, reduce-scatter 1) and `peak_bytes_per_device` (the high-water mark
of live meta-tensor bytes, parameters, batch and cache included, by
`torch.distributed._tools.mem_tracker.MemTracker`).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --all --shape train_4k   # one shape
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape \
      decode_32k --overrides '{"vocab_pad_to": 1}' --tag ovr

`--overrides` (a JSON dict of `ModelConfig` fields) replaces fields of
every planned cell's config, as the reference's flag does; the cell's
file is named by `--tag`, as the reference's. `lower_cell` pads the
vocabulary to 256 rows whatever `vocab_pad_to` says, in both packages.
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


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides=None) -> dict:
    """One cell's record; needs a default group of the mesh's size
    (`fake_world(512 if multi_pod else 256)`). `overrides` ({field:
    value}) replace fields of the arch's config first, as the
    reference's `cfg.replace(**overrides)` (an unknown field raises
    TypeError)."""
    from repro_torch.configs import SHAPES, get_config, skip_reason
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell

    t0 = time.time()
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod)}
    reason = skip_reason(arch, shape_name)
    if reason:
        return dict(head, status="skipped", reason=reason)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if overrides:
        cfg = cfg.replace(**overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
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
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.cost import Counter
    from repro_torch.training.optimizer import AdamWConfig

    cfg = cfg.replace(vocab_pad_to=256)
    model = shr.shard_params(Model(cfg, device="meta"), plan["params"],
                             mesh, 0)
    batch = shr.shard_batch(input_specs(cfg, shape), plan["batch"], mesh, 0)
    args = [batch]
    k = 1
    if shape.kind == "train":
        # k microbatches are k passes alike: one runs, counted k times
        k = step.microbatches
        n = next(iter(batch.values())).shape[0] // k
        args = [shr.init_opt_pieces(plan["opt"], mesh, "meta"),
                {key: v[:n] for key, v in batch.items()}]
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
    more = {"flops": 0, "hbm_bytes": 0, "peak": 0}
    with mt, Counter() as count:
        if shape.kind != "train":
            step(model, *args)
        else:
            zs = make_train_step(model, AdamWConfig(), 1, plan=plan,
                                 mesh=mesh)
            value, grads = zs.grads(args[1])
            more = {"flops": (k - 1) * count.flops,
                    "hbm_bytes": (k - 1) * count.hbm_bytes,
                    # the k gradients' float32 sums
                    "peak": (k > 1) * 4 * sum(p.numel()
                                              for p in model.parameters())}
            once = {kind: dict(v) for kind, v in
                    shardctx.COLLECTIVES.items()}
            zs.apply(args[0], value, grads)
            for kind, v in once.items():
                for f, x in v.items():
                    shardctx.COLLECTIVES[kind][f] += (k - 1) * x
    colls = {kind: dict(v) for kind, v in shardctx.COLLECTIVES.items()
             if v["count"]}
    peak = mt.get_tracker_snapshot("peak")
    return dict(
        flops_per_device=count.flops + more["flops"],
        hbm_bytes_per_device=count.hbm_bytes + more["hbm_bytes"] + sum(
            v.pop("hbm_bytes") for v in colls.values()),
        collectives=colls,
        collective_link_bytes_per_device=sum(v["link_bytes"]
                                             for v in colls.values()),
        peak_bytes_per_device=int(sum(d["Total"] for d in peak.values()))
        + more["peak"])


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
    ap.add_argument("--overrides", default="",
                    help="JSON dict of ModelConfig overrides (perf iter)")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None
    from repro_torch.configs import SHAPES, list_archs
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:          # every cell, or every cell of --arch / --shape
        cells = [(a, s) for a in list_archs() for s in SHAPES
                 if args.arch in (None, a) and args.shape in (None, s)]
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
                    res = run_cell(arch, shape, mp, overrides)
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
