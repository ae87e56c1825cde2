"""Budget-aware serving (§6.4) on the PyTorch port: per-request cost
budgets with the Eq. 2 admission filter, dispatch-time max_tokens clamp
and streaming early-stop — the filter converts budget exhaustion into
served quality. The port's counterpart of `examples/budget_serving.py`,
at its sizes by default; it runs on the card unless `--device cpu` is
given.

    PYTHONPATH=src python examples/torch_budget_serving.py
    PYTHONPATH=src python examples/torch_budget_serving.py --device cpu \\
        --dataset-n 400 --n 80
"""
import argparse

import numpy as np

from repro_torch.core import EstimatorBundle, RBConfig, RouteBalance, \
    make_requests, run_cell
from repro_torch.serving.tiers import paper_pool_tiers
from repro_torch.serving.workload import poisson_arrivals
from repro_torch.serving.world import build_dataset, paper_world


def main(argv=None):
    """Serve both arms and print their lines. Returns [{"cell",
    "metrics", "requests", "engine"}]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-n", type=int, default=4000)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--lam", type=float, default=16.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    world, names = paper_world(seed=0)
    ds = build_dataset(world, n=args.dataset_n)
    tiers = paper_pool_tiers()
    bundle = EstimatorBundle.train(ds, tiers, names, device=args.device)
    n = args.n
    rng = np.random.default_rng(0)
    budgets = np.full(n, np.nan)
    mask = rng.uniform(size=n) < 0.75          # the paper's tight mix
    budgets[mask] = 3.2e-5 * rng.uniform(0.4, 1.2, mask.sum())

    rows = []
    for label, filt in (("with Eq.2 admission filter", True),
                        ("runtime cap only", False)):
        reqs = make_requests(ds, "test",
                             poisson_arrivals(args.lam, n, seed=1),
                             budgets=budgets)
        rb = RouteBalance(RBConfig(budget_filter=filt), bundle, tiers)
        m = run_cell(rb, tiers, names, reqs)
        print(f"{label:28s} exhausted={m['exhausted_frac']:.3f} "
              f"served_quality={m['served_quality']:.3f} "
              f"cost=${m['cost_per_req']:.2e}")
        rows.append(dict(cell=label, metrics=m, requests=reqs, engine=rb))
    return rows


if __name__ == "__main__":
    main()
