"""The port's four serving examples (`examples/torch_{quickstart,
budget_serving, serve_cluster, zoo_serving}.py`) against the reference's
on the CPU, at a reduced size: dataset 400, 80 requests.

Each example's `main` runs with `--device cpu` and the reduced sizes;
the reference side is the reference example's own sequence of calls
through `repro` at the same sizes (its sizes are constants in the
file, so the sequence is spelled here, line for line, with its prints).
As in the other parity tests, the port's bundle is bridged from the
reference's trained weights, each request stream takes the reference
stream's ingest embeddings, and both sides run with `charge_compute=
False` (set through `RBConfig`, `EngineConfig` and the RouteBalance
policies of `fit_policy`), so no wall clock enters the simulation.
Every printed line must be equal, apart from the quickstart's measured
decide ms, and every `run_cell` metric apart from the measured decision
times.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from torch_scenario_parity import assert_metrics_equal, port_bundle

ROOT = Path(__file__).resolve().parents[1]
DATASET_N, N = 400, 80
SIZES = ["--device", "cpu", "--dataset-n", str(DATASET_N), "--n", str(N)]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _patch_port(monkeypatch, mod, ref_bundle, tiers, names, streams):
    """The port example trains the reference's weights (bridged), its
    streams take the reference streams' embeddings in order, and no
    engine charges wall-clock compute."""
    import repro_torch.core as P
    bridged = port_bundle(ref_bundle, tiers, names)

    class Bundle:
        @staticmethod
        def train(ds, tiers_, names_, backend="torch", device=None):
            assert device == "cpu"
            return bridged.with_knn_backend(backend)
    like = iter(streams)

    def make_requests(ds, which, arrivals, **kw):
        reqs = P.make_requests(ds, which, arrivals, **kw)
        reqs[0].cols.emb = next(like)[0].cols.emb
        return reqs
    monkeypatch.setattr(mod, "EstimatorBundle", Bundle)
    monkeypatch.setattr(mod, "make_requests", make_requests)
    for name in ("RBConfig", "EngineConfig"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(P, name), charge_compute=False))
    if hasattr(mod, "fit_policy"):
        monkeypatch.setattr(mod, "fit_policy", _no_charge(P.fit_policy))


def _no_charge(fit_policy):
    """`fit_policy` whose RouteBalance policies charge no compute (their
    factory takes `RBConfig` fields)."""
    def fit(name, *args, **kw):
        if name == "routebalance":
            kw["charge_compute"] = False
        return fit_policy(name, *args, **kw)
    return fit


def _lines(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith("decision compute:")]


def _compare(capsys, monkeypatch, name, ref_run, ctx):
    """Run the reference's sequence, then the port's example; equal
    printed lines and metrics, request for request the same instance."""
    ref_rows, streams = ref_run(ctx)
    ref_out = capsys.readouterr().out
    mod = _load(name)
    _patch_port(monkeypatch, mod, ctx["bundle"], ctx["tiers"],
                ctx["names"], streams)
    rows = mod.main(SIZES)
    port_out = capsys.readouterr().out
    assert _lines(port_out) == _lines(ref_out)
    assert len(rows) == len(ref_rows)
    for row, (rm, rreqs) in zip(rows, ref_rows):
        assert_metrics_equal(rm, row["metrics"])
        assert ([r.instance for r in row["requests"]]
                == [r.instance for r in rreqs])
    return rows


def _ref_cfgs():
    import repro.core as R
    return (functools.partial(R.RBConfig, charge_compute=False),
            functools.partial(R.EngineConfig, charge_compute=False))


# -- the reference examples' sequences at DATASET_N / N ------------------------

def _ref_quickstart(ctx):
    from repro.core import PRESETS, RouteBalance, make_requests, run_cell
    from repro.serving.tiers import tpot_table
    from repro.serving.workload import poisson_arrivals
    RBConfig, _ = _ref_cfgs()
    ds, tiers, names, bundle = (ctx[k] for k in ("ds", "tiers", "names",
                                                 "bundle"))
    print("tier pool (TPOT ms at b=8, ctx=500):", tpot_table(tiers))
    print("training estimator bundle (encoder + KNN + TPOT heads)...")
    reqs = make_requests(ds, "test", poisson_arrivals(12.0, N, seed=1))
    rb = RouteBalance(RBConfig(weights=PRESETS["uniform"]), bundle, tiers)
    m = run_cell(rb, tiers, names, reqs)
    print(f"\nuniform preset @ lambda=12: quality={m['quality']:.3f} "
          f"mean E2E={m['mean_e2e']:.2f}s cost/req=${m['cost_per_req']:.2e}")
    print("tier mix:", {k: round(v, 2) for k, v in m["mix"].items()})
    print(f"decision compute: {m['measured_decide_ms_mean']:.1f} ms/batch "
          f"({m['measured_decide_ms_per_req']:.2f} ms/request amortized)")
    return [(m, reqs)], [reqs]


def _ref_budget(ctx):
    from repro.core import RouteBalance, make_requests, run_cell
    from repro.serving.workload import poisson_arrivals
    RBConfig, _ = _ref_cfgs()
    ds, tiers, names, bundle = (ctx[k] for k in ("ds", "tiers", "names",
                                                 "bundle"))
    n = N
    rng = np.random.default_rng(0)
    budgets = np.full(n, np.nan)
    mask = rng.uniform(size=n) < 0.75          # the paper's tight mix
    budgets[mask] = 3.2e-5 * rng.uniform(0.4, 1.2, mask.sum())
    rows, streams = [], []
    for label, filt in (("with Eq.2 admission filter", True),
                        ("runtime cap only", False)):
        reqs = make_requests(ds, "test", poisson_arrivals(16.0, n, seed=1),
                             budgets=budgets)
        rb = RouteBalance(RBConfig(budget_filter=filt), bundle, tiers)
        m = run_cell(rb, tiers, names, reqs)
        print(f"{label:28s} exhausted={m['exhausted_frac']:.3f} "
              f"served_quality={m['served_quality']:.3f} "
              f"cost=${m['cost_per_req']:.2e}")
        rows.append((m, reqs))
        streams.append(reqs)
    return rows, streams


def _ref_serve_cluster(ctx):
    from repro.core import PRESETS, ServingEngine, make_requests, run_cell
    from repro.core import fit_policy as _fit
    from repro.serving.hierarchy import HierarchyConfig, build_scheduler
    from repro.serving.workload import poisson_arrivals
    RBConfig, EngineConfig = _ref_cfgs()
    fit_policy = _no_charge(_fit)
    ds, tiers, names, bundle = (ctx[k] for k in ("ds", "tiers", "names",
                                                 "bundle"))
    lam, n, cells, interval = 12.0, N, 2, 0.25
    rows, streams = [], []

    def cell(policy_name, deployment, **policy_kw):
        policy = fit_policy(policy_name, bundle, tiers, names, ds,
                            **policy_kw)
        eng = ServingEngine(policy, bundle, tiers,
                            EngineConfig(deployment=deployment))
        reqs = make_requests(ds, "test", poisson_arrivals(lam, n, seed=1))
        streams.append(reqs)
        m = run_cell(eng, tiers, names, reqs)
        rows.append((m, reqs))
        return m

    print(f"{'cell':32s} {'quality':>8s} {'E2E s':>7s} {'p99 s':>7s} "
          f"{'cost $':>9s} {'tput':>6s}")

    def show(name, m):
        print(f"{name:32s} {m['quality']:8.3f} {m['mean_e2e']:7.2f} "
              f"{m['p99_e2e']:7.1f} {m['cost_per_req']:9.2e} "
              f"{m['throughput']:6.1f}")

    for wname, w in (("cost", PRESETS["cost"]),
                     ("uniform", PRESETS["uniform"]),
                     ("quality", PRESETS["quality"])):
        m = cell("routebalance", "windowed", weights=w)
        show(f"routebalance/{wname} (windowed)", m)
    for t in (0.5, 0.7):
        m = cell("bestroute-sq", "concurrent", threshold=t)
        show(f"bestroute-sq/t{t} (concurrent)", m)
    m = cell("bestroute-sq", "serial_published", threshold=0.5)
    show("bestroute-sq/t0.5 (serial)", m)
    sched = build_scheduler(
        RBConfig(weights=PRESETS["uniform"]), bundle, tiers,
        HierarchyConfig(n_cells=cells, digest_interval_s=interval))
    reqs = make_requests(ds, "test", poisson_arrivals(lam, n, seed=1))
    streams.append(reqs)
    m = run_cell(sched, tiers, names, reqs)
    rows.append((m, reqs))
    show(f"routebalance/uniform ({cells} cells)", m)
    bal = sched.balancer
    print(f"{'':32s} digests={bal.digests_sent} "
          f"wire_bytes={bal.bytes_sent} "
          f"imbalance={bal.imbalance():.3f}")
    return rows, streams


def _ref_zoo(ctx):
    from repro.core import PRESETS, RouteBalance, make_requests, run_cell
    from repro.serving.tiers import tpot_table
    from repro.serving.workload import poisson_arrivals
    RBConfig, _ = _ref_cfgs()
    ds, tiers, names, bundle = (ctx[k] for k in ("ds", "tiers", "names",
                                                 "bundle"))
    print("zoo pool TPOT ms (b=8, ctx=500):", tpot_table(tiers))
    rows, streams = [], []
    for pname in ("cost", "uniform", "quality"):
        reqs = make_requests(ds, "test", poisson_arrivals(10.0, N, seed=1))
        rb = RouteBalance(RBConfig(weights=PRESETS[pname]), bundle, tiers)
        m = run_cell(rb, tiers, names, reqs)
        mix = {k.split("/")[0]: round(v, 2) for k, v in m["mix"].items()}
        print(f"{pname:8s} q={m['quality']:.3f} e2e={m['mean_e2e']:.2f}s "
              f"cost=${m['cost_per_req']:.2e} mix={mix}")
        rows.append((m, reqs))
        streams.append(reqs)
    return rows, streams


@pytest.fixture(scope="module")
def zoo_ctx():
    """The reference zoo example's world at DATASET_N."""
    from repro.core import EstimatorBundle
    from repro.serving.tiers import assigned_pool_tiers
    from repro.serving.world import World, build_dataset
    mod = _load("zoo_serving")
    tiers = assigned_pool_tiers()
    names = [t.model for t in tiers]
    world = World([mod.CAPS[m] for m in names],
                  [mod.VERB[m] for m in names], seed=3)
    ds = build_dataset(world, n=DATASET_N)
    return dict(ds=ds, tiers=tiers, names=names,
                bundle=EstimatorBundle.train(ds, tiers, names))


def test_quickstart_matches_reference(small_ctx, capsys, monkeypatch):
    _compare(capsys, monkeypatch, "quickstart", _ref_quickstart, small_ctx)


def test_budget_serving_matches_reference(small_ctx, capsys, monkeypatch):
    rows = _compare(capsys, monkeypatch, "budget_serving", _ref_budget,
                    small_ctx)
    assert rows[0]["metrics"]["exhausted_frac"] > 0


def test_serve_cluster_matches_reference(small_ctx, capsys, monkeypatch):
    """The baselines' lengths come through the lookup kernel's wrapper
    (its plain version on the CPU) and give the reference's; the
    hierarchical arm's digests and wire bytes are in the printed
    lines."""
    rows = _compare(capsys, monkeypatch, "serve_cluster",
                    _ref_serve_cluster, small_ctx)
    assert rows[3]["engine"].policy.bundle.knn.backend == "kernel"
    assert rows[-1]["engine"].balancer.digests_sent > 0


def test_zoo_serving_matches_reference(zoo_ctx, capsys, monkeypatch):
    _compare(capsys, monkeypatch, "zoo_serving", _ref_zoo, zoo_ctx)
