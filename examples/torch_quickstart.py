"""Quickstart on the PyTorch port: one fused RouteBalance scheduling
decision, end to end.

Builds the synthetic prompt world + the paper's 13-instance tier pool,
trains the in-process predictor stack (MiniLM-analogue encoder -> KNN;
per-tier GBM TPOT heads), then walks a single batch through Eq. 1:
batched estimation -> budget filter -> LPT order -> greedy dispatch with
dead reckoning, each batch one call of the decision kernel. The port's
counterpart of `examples/quickstart.py`, at its sizes by default; it
runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --dataset-n 400 --n 80
"""
import argparse

from repro_torch.core import EstimatorBundle, PRESETS, RBConfig, \
    RouteBalance, make_requests, run_cell
from repro_torch.serving.tiers import paper_pool_tiers, tpot_table
from repro_torch.serving.workload import poisson_arrivals
from repro_torch.serving.world import build_dataset, paper_world


def main(argv=None):
    """Serve the cell and print its lines. Returns [{"cell", "metrics",
    "requests", "engine"}]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-n", type=int, default=3000)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--lam", type=float, default=12.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    world, names = paper_world(seed=0)
    ds = build_dataset(world, n=args.dataset_n)
    tiers = paper_pool_tiers()
    print("tier pool (TPOT ms at b=8, ctx=500):", tpot_table(tiers))

    print("training estimator bundle (encoder + KNN + TPOT heads)...")
    bundle = EstimatorBundle.train(ds, tiers, names, device=args.device)

    # one cell at lambda = 12 with the uniform preset
    reqs = make_requests(ds, "test",
                         poisson_arrivals(args.lam, args.n, seed=1))
    rb = RouteBalance(RBConfig(weights=PRESETS["uniform"]), bundle, tiers)
    m = run_cell(rb, tiers, names, reqs)
    print(f"\nuniform preset @ lambda={args.lam:g}: quality="
          f"{m['quality']:.3f} mean E2E={m['mean_e2e']:.2f}s "
          f"cost/req=${m['cost_per_req']:.2e}")
    print("tier mix:", {k: round(v, 2) for k, v in m["mix"].items()})
    print(f"decision compute: {m['measured_decide_ms_mean']:.1f} ms/batch "
          f"({m['measured_decide_ms_per_req']:.2f} ms/request amortized)")
    return [dict(cell="uniform", metrics=m, requests=reqs, engine=rb)]


if __name__ == "__main__":
    main()
