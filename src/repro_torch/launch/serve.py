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
says so.
"""
from __future__ import annotations

import argparse
import json

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


def main(argv=None):
    m, _, _ = serve(parse_args(argv))
    print(json.dumps({k: v for k, v in m.items()
                      if not isinstance(v, tuple)}, indent=1,
                     default=str))
    return m


if __name__ == "__main__":
    main()
