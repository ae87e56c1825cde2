"""RouteBalance over the ASSIGNED architecture zoo on the PyTorch port: a
heterogeneous pool of gemma3-27b / mixtral-8x7b / phi3-mini /
granite-3-2b / mamba2-1.3b / qwen3-0.6b tiers — the paper's technique is
model-agnostic, so the whole model zoo becomes one routed cluster. The
tiers are simulated; no model runs. The port's counterpart of
`examples/zoo_serving.py`, at its sizes by default; it runs on the card
unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_zoo_serving.py
    PYTHONPATH=src python examples/torch_zoo_serving.py --device cpu \\
        --dataset-n 400 --n 80
"""
import argparse

from repro_torch.core import EstimatorBundle, PRESETS, RBConfig, \
    RouteBalance, make_requests, run_cell
from repro_torch.serving.tiers import assigned_pool_tiers, tpot_table
from repro_torch.serving.workload import poisson_arrivals
from repro_torch.serving.world import World, build_dataset

# capacities/verbosities for the zoo pool (capability-ordered)
CAPS = {"gemma3-27b": 0.68, "mixtral-8x7b": 0.62, "phi3-mini-3.8b": 0.50,
        "granite-3-2b": 0.42, "mamba2-1.3b": 0.34, "qwen3-0.6b": 0.28}
VERB = {"gemma3-27b": 0.85, "mixtral-8x7b": 0.9, "phi3-mini-3.8b": 1.0,
        "granite-3-2b": 1.05, "mamba2-1.3b": 1.1, "qwen3-0.6b": 1.2}


def main(argv=None):
    """Serve one cell per preset and print their lines. Returns
    [{"cell", "metrics", "requests", "engine"}]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-n", type=int, default=4000)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--lam", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    tiers = assigned_pool_tiers()
    names = [t.model for t in tiers]
    world = World([CAPS[m] for m in names], [VERB[m] for m in names],
                  seed=3)
    ds = build_dataset(world, n=args.dataset_n)
    bundle = EstimatorBundle.train(ds, tiers, names, device=args.device)
    print("zoo pool TPOT ms (b=8, ctx=500):", tpot_table(tiers))
    rows = []
    for pname in ("cost", "uniform", "quality"):
        reqs = make_requests(ds, "test",
                             poisson_arrivals(args.lam, args.n, seed=1))
        rb = RouteBalance(RBConfig(weights=PRESETS[pname]), bundle, tiers)
        m = run_cell(rb, tiers, names, reqs)
        mix = {k.split("/")[0]: round(v, 2) for k, v in m["mix"].items()}
        print(f"{pname:8s} q={m['quality']:.3f} e2e={m['mean_e2e']:.2f}s "
              f"cost=${m['cost_per_req']:.2e} mix={mix}")
        rows.append(dict(cell=pname, metrics=m, requests=reqs, engine=rb))
    return rows


if __name__ == "__main__":
    main()
