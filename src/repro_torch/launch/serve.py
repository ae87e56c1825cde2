"""Serving launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --preset uniform \\
        --lam 12
    PYTHONPATH=src python -m repro_torch.launch.serve --pool zoo \\
        --preset quality
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario multitenant \\
        --preset cost --lam-scale 2.0
    PYTHONPATH=src python -m repro_torch.launch.serve --policy bestroute-sq \\
        --deployment serial_published --lam 24
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario cluster \\
        --cells 2 --n 200 --device cpu

Port of `repro.launch.serve` (lines 1-161), every flag kept, plus
`--device` (the card unless ``cpu`` is asked for).

--scenario selects a named world from `repro_torch.serving.scenarios`
(roster, multi-tenant workload, failure/recovery schedule); it overrides
--pool/--arrivals/--lam.

--policy selects any scheduler of the `repro_torch.core.policies.
POLICIES` registry (RouteBalance and the router x dispatcher baseline
grid); --deployment picks the engine's serving arm (windowed,
concurrent, serial_published, microbatch).

--cells > 1 runs the hierarchy (`repro_torch.serving.hierarchy`,
routebalance only): the roster is partitioned into cells, each with its
own RouteBalance engine on the decision kernel, and a GlobalBalancer
places arrivals from telemetry digests exchanged every
--digest-interval seconds (usable for --digest-stale seconds;
--digest-mode picks the exact float32 or the int8 wire codec).
--cell-routing span instead shards the scan of ONE controller over the
cells (choices bitwise the single controller's); in the port that arm
runs on the staged torch backend, and the printed `decision_backend`
says so. Started by `torchrun` with one process per cell, the span runs
over `torch.distributed` (`core.decision.sharded_greedy_scan(mesh=)`):
rank 0 serves and prints the JSON line, the other ranks answer its
scans (`core.decision.cell_worker`) until it stops them. The backend is
named by --dist-backend (nccl: one card per rank; gloo: any number of
ranks on one card or on the CPU); a world size other than --cells is an
error. Started without `torchrun`, span runs the single-process
emulation.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --cells 2 \
        --cell-routing span --dist-backend gloo --device cpu --n 40
"""
from __future__ import annotations

import argparse
import datetime
import json
import os

# the zoo pool's world (a copy of `examples/zoo_serving.py`'s tables)
CAPS = {"gemma3-27b": 0.68, "mixtral-8x7b": 0.62, "phi3-mini-3.8b": 0.50,
        "granite-3-2b": 0.42, "mamba2-1.3b": 0.34, "qwen3-0.6b": 0.28}
VERB = {"gemma3-27b": 0.85, "mixtral-8x7b": 0.9, "phi3-mini-3.8b": 1.0,
        "granite-3-2b": 1.05, "mamba2-1.3b": 1.1, "qwen3-0.6b": 1.2}


def parse_args(argv=None):
    from ..core.engine import DEPLOYMENTS
    from ..core.policies import POLICIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", choices=("paper", "zoo"), default="paper")
    ap.add_argument("--scenario", default="",
                    help="named scenario from repro_torch.serving."
                         "scenarios (overrides --pool/--arrivals/--lam)")
    ap.add_argument("--policy", default="routebalance",
                    choices=sorted(POLICIES),
                    help="scheduling policy from the POLICIES registry")
    ap.add_argument("--deployment", default="windowed",
                    choices=DEPLOYMENTS, help="engine serving arm")
    ap.add_argument("--preset", default="uniform",
                    help="weight preset (routebalance policy only)")
    ap.add_argument("--weights", default="",
                    help="wq,wl,wc overriding --preset")
    ap.add_argument("--lam", type=float, default=12.0)
    ap.add_argument("--lam-scale", type=float, default=1.0,
                    help="scenario load multiplier (with --scenario)")
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--arrivals", default="poisson",
                    choices=("poisson", "gamma", "square", "flash"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", type=int, default=1,
                    help="partition the roster into N scheduling cells "
                         "(hierarchical path; routebalance only)")
    ap.add_argument("--cell-routing", default="balanced",
                    choices=("span", "balanced"),
                    help="balanced: per-cell engines + digest-routed "
                         "GlobalBalancer; span: one decision sharded "
                         "across cells (staged torch backend)")
    ap.add_argument("--digest-interval", type=float, default=0.25,
                    help="seconds between per-cell telemetry digests")
    ap.add_argument("--digest-stale", type=float, default=1.0,
                    help="digest staleness bound (a cell goes dark past "
                         "this age)")
    ap.add_argument("--digest-mode", default="exact",
                    choices=("exact", "int8"), help="digest wire codec")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the estimators and decisions "
                         "(default the card; 'cpu' to run without one)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend of the span arm under "
                         "torchrun (one process per cell)")
    return ap.parse_args(argv)


def serve(args):
    """Run the cell the parsed arguments describe. Returns (metrics,
    requests, scheduler)."""
    from ..core import (PRESETS, EngineConfig, EstimatorBundle, RBConfig,
                        ServingEngine, fit_policy, make_requests, run_cell)
    from ..core.device import resolve_device
    from ..serving.tiers import assigned_pool_tiers, paper_pool_tiers
    from ..serving.workload import make_arrivals
    from ..serving.world import World, build_dataset, paper_world

    dev = resolve_device(args.device)
    w = PRESETS[args.preset]
    if args.weights:
        w = tuple(float(x) for x in args.weights.split(","))
    rb = args.policy == "routebalance"
    # RouteBalance takes the weights; the BEST-Route scorer is the one
    # baseline router on a device
    policy_kw = (dict(weights=w) if rb else dict(device=dev)
                 if args.policy.startswith("bestroute-") else {})
    if args.cells > 1 and not rb:
        raise SystemExit("--cells > 1 requires the routebalance policy")
    backend = "torch" if args.cell_routing == "span" else "megakernel"

    def hier_sched(bundle, tiers):
        from ..serving.hierarchy import HierarchyConfig, build_scheduler
        return build_scheduler(
            RBConfig(weights=w, decision_backend=backend), bundle, tiers,
            HierarchyConfig(n_cells=args.cells,
                            routing=args.cell_routing,
                            digest_interval_s=args.digest_interval,
                            digest_stale_s=args.digest_stale,
                            digest_mode=args.digest_mode))

    def hier_cols(m, eng):
        m["cells"] = args.cells
        m["cell_routing"] = args.cell_routing
        m["decision_backend"] = backend
        bal = getattr(eng, "balancer", None)
        if bal is not None:
            m["intercell_imbalance"] = round(bal.imbalance(), 4)
            m["digests"] = bal.digests_sent
            m["digest_bytes"] = bal.bytes_sent

    if args.scenario:
        from ..serving.scenarios import get_scenario
        run = get_scenario(args.scenario).build(dataset_n=6000)
        run.bundle(device=dev)
        reqs = run.requests(args.n, lam_scale=args.lam_scale,
                            seed=args.seed)
        if args.cells > 1:
            eng = hier_sched(run.bundle(), run.tiers)
        else:
            eng = run.engine(run.policy(args.policy, **policy_kw),
                             deployment=args.deployment)
        m = run.run_cell(eng, reqs, seed=args.seed)
        if args.cells > 1:
            hier_cols(m, eng)
        m["scenario"] = args.scenario
        m["n_instances"] = run.n_instances
    else:
        if args.pool == "paper":
            world, names = paper_world(seed=args.seed)
            tiers = paper_pool_tiers()
        else:
            tiers = assigned_pool_tiers()
            names = [t.model for t in tiers]
            world = World([CAPS[m] for m in names],
                          [VERB[m] for m in names], seed=args.seed)
        ds = build_dataset(world, n=6000)
        bundle = EstimatorBundle.train(ds, tiers, names, device=dev)
        reqs = make_requests(
            ds, "test", make_arrivals(args.arrivals, args.lam, args.n,
                                      seed=args.seed))
        if args.cells > 1:
            eng = hier_sched(bundle, tiers)
        else:
            policy = fit_policy(args.policy, bundle, tiers, names, ds,
                                **policy_kw)
            eng = ServingEngine(policy, bundle, tiers,
                                EngineConfig(deployment=args.deployment))
        m = run_cell(eng, tiers, names, reqs, seed=args.seed)
        if args.cells > 1:
            hier_cols(m, eng)
    return m, reqs, eng


DIST_TIMEOUT_S = 600         # rendezvous and every collective of the span


def _print(m):
    print(json.dumps({k: v for k, v in m.items()
                      if not isinstance(v, tuple)}, indent=1,
                     default=str))


def serve_distributed(args, world: int, rank: int, local_rank: int):
    """The span arm with one process per cell, as `torchrun` starts it:
    rank 0 runs `serve` with the ``("cell",)`` mesh pinned and returns
    its metrics; the other ranks answer its scans and return None."""
    import torch
    import torch.distributed as dist

    from ..core.decision import (cell_worker, reset_counts,
                                 sharded_greedy_scan, stop_cell_workers)
    from ..distributed.shardctx import sharding_rules
    from .mesh import make_cell_mesh
    if world != args.cells:
        raise SystemExit(f"torchrun started {world} processes for --cells "
                         f"{args.cells}: the span arm runs one per cell")
    if args.cell_routing != "span" or args.dist_backend is None:
        raise SystemExit("under torchrun the launcher runs --cell-routing "
                         "span with --dist-backend nccl or gloo")
    if torch.device(args.device).type == "cuda":
        # NCCL: a card per rank; gloo may put every rank on one card
        n_dev = torch.cuda.device_count()
        if args.dist_backend == "nccl" and n_dev < world:
            raise SystemExit(f"nccl needs a card per rank: {n_dev} cards "
                             f"for {world} ranks")
        torch.cuda.set_device(local_rank % max(n_dev, 1))
    elif args.dist_backend == "nccl":
        raise SystemExit("nccl runs on the card, not on --device cpu")
    dist.init_process_group(args.dist_backend,
                            timeout=datetime.timedelta(
                                seconds=DIST_TIMEOUT_S))
    try:
        mesh = make_cell_mesh(args.cells)
        if rank:
            cell_worker(mesh, args.device)
            return None
        reset_counts()
        try:
            with sharding_rules(mesh):
                m, _, _ = serve(args)
        finally:
            stop_cell_workers(mesh, args.device)
        m["dist_backend"] = args.dist_backend
        m["span_all_reduces"] = sharded_greedy_scan.all_reduces
        m["span_broadcasts"] = sharded_greedy_scan.broadcasts
        m["span_broadcast_bytes"] = sharded_greedy_scan.broadcast_bytes
        return m
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world > 1 or args.cells > 1:
            m = serve_distributed(args, world, rank,
                                  int(os.environ.get("LOCAL_RANK", rank)))
            if m is not None:
                _print(m)
            return m
    elif args.dist_backend is not None:
        raise SystemExit("--dist-backend is for runs under torchrun; "
                         "without it span runs the single-process "
                         "emulation")
    m, _, _ = serve(args)
    _print(m)
    return m


if __name__ == "__main__":
    main()
