"""End-to-end serving run on the PyTorch port: policies on one engine
— a deployed RouteBalance stack sweeping its weight vector across the
frontier, vs an engineering-equalized BEST-Route baseline, all through
the SAME `ServingEngine` (only the `SchedulingPolicy` and the
`deployment=` knob differ) — the paper's headline experiment in
miniature. A final arm runs the hierarchical path end to end: the same
roster partitioned into --cells scheduling cells, per-cell RouteBalance
engines, and a GlobalBalancer routing arrivals from telemetry digests
exchanged every --digest-interval seconds.

The port's counterpart of `examples/serve_cluster.py`, at its sizes by
default. RouteBalance decides each batch in one call of the decision
kernel; the BEST-Route arms take their length estimates from the
bundle's KNN lookup through the lookup kernel. It runs on the card
unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_serve_cluster.py [--lam 12]
        [--n 600] [--cells 2] [--digest-interval 0.25]
    PYTHONPATH=src python examples/torch_serve_cluster.py --device cpu \\
        --dataset-n 400 --n 80
"""
import argparse

from repro_torch.core import (EngineConfig, EstimatorBundle, PRESETS,
                              RBConfig, ServingEngine, fit_policy,
                              make_requests, run_cell)
from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
from repro_torch.serving.tiers import paper_pool_tiers
from repro_torch.serving.workload import poisson_arrivals
from repro_torch.serving.world import build_dataset, paper_world


def main(argv=None):
    """Serve every arm and print the table. Returns [{"cell", "metrics",
    "requests", "engine"}]; the hierarchical arm's engine is its
    scheduler, with the balancer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--lam", type=float, default=12.0)
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--cells", type=int, default=2,
                    help="scheduling cells for the hierarchical arm")
    ap.add_argument("--digest-interval", type=float, default=0.25,
                    help="seconds between per-cell telemetry digests")
    ap.add_argument("--dataset-n", type=int, default=6000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    world, names = paper_world(seed=0)
    ds = build_dataset(world, n=args.dataset_n)
    tiers = paper_pool_tiers()
    bundle = EstimatorBundle.train(ds, tiers, names, backend="kernel",
                                   device=args.device)
    rows = []

    def cell(policy_name, deployment, **policy_kw):
        if policy_name.startswith("bestroute-"):
            # BEST-Route's own quality scorer sits beside the bundle
            policy_kw["device"] = bundle.device
        policy = fit_policy(policy_name, bundle, tiers, names, ds,
                            **policy_kw)
        eng = ServingEngine(policy, bundle, tiers,
                            EngineConfig(deployment=deployment))
        reqs = make_requests(ds, "test",
                             poisson_arrivals(args.lam, args.n, seed=1))
        return run_cell(eng, tiers, names, reqs), reqs, eng

    print(f"{'cell':32s} {'quality':>8s} {'E2E s':>7s} {'p99 s':>7s} "
          f"{'cost $':>9s} {'tput':>6s}")

    def show(name, m, reqs, eng):
        print(f"{name:32s} {m['quality']:8.3f} {m['mean_e2e']:7.2f} "
              f"{m['p99_e2e']:7.1f} {m['cost_per_req']:9.2e} "
              f"{m['throughput']:6.1f}")
        rows.append(dict(cell=name, metrics=m, requests=reqs, engine=eng))

    # one policy family, three weight vectors, windowed deployment
    for wname, w in (("cost", PRESETS["cost"]),
                     ("uniform", PRESETS["uniform"]),
                     ("quality", PRESETS["quality"])):
        show(f"routebalance/{wname} (windowed)",
             *cell("routebalance", "windowed", weights=w))
    # the equalized baseline on the SAME engine: concurrent scoring
    for t in (0.5, 0.7):
        show(f"bestroute-sq/t{t} (concurrent)",
             *cell("bestroute-sq", "concurrent", threshold=t))
    # the as-published deployment, one knob away: serial scoring
    show("bestroute-sq/t0.5 (serial)",
         *cell("bestroute-sq", "serial_published", threshold=0.5))
    # the hierarchical path end to end: same roster split into cells,
    # per-cell engines, digest-routed GlobalBalancer
    sched = build_scheduler(
        RBConfig(weights=PRESETS["uniform"]), bundle, tiers,
        HierarchyConfig(n_cells=args.cells,
                        digest_interval_s=args.digest_interval))
    reqs = make_requests(ds, "test",
                         poisson_arrivals(args.lam, args.n, seed=1))
    m = run_cell(sched, tiers, names, reqs)
    show(f"routebalance/uniform ({args.cells} cells)", m, reqs, sched)
    bal = sched.balancer
    print(f"{'':32s} digests={bal.digests_sent} "
          f"wire_bytes={bal.bytes_sent} "
          f"imbalance={bal.imbalance():.3f}")
    return rows


if __name__ == "__main__":
    main()
