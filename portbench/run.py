"""Run one cell of the benchmark of `repro_torch` once, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--tracer <0|1>]

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name through BENCHMARK.json. Set-up (`setup_s`) builds
the cell and brings the fleet to steady occupancy; the window then
drives the program for `--seconds` of wall time; the decisions it made
are checked against the plain reference; the last line of standard
output is the result as one JSON object. With `--trace 0` the metrics
are the cell's end-to-end ones, with `--trace 1` its per-layer ones,
read under `torch.profiler` with the program's own tracer
(`repro_torch.tracing`) on for the window; the result's `info.spans`
then holds the tracer's summary (count, total and self seconds of each
span). `--tracer 0` keeps the tracer off in a traced run, so that the
per-layer metrics that do not read it show what the tracer costs them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load,
    compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    # the controller and the simulator are one Python thread: no pools
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)
    from portbench.bench import cell as cl
    try:
        bench, cell, cfg, mix = cl.find_cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        fail(str(e))
    if not torch.cuda.is_available():
        fail("CUDA is not available: this benchmark runs on the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell asks for {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    res = run_cell(bench, cell, cfg, mix, args.seed, args.seconds,
                   bool(args.trace), "cuda", tracer=bool(args.tracer))
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {bad}")
    for line in res.pop("check_lines"):
        print(line, file=sys.stderr)
    print(json.dumps(res), flush=True)


def run_cell(bench, cell, cfg, mix, seed: int, seconds: float, trace: bool,
             device: str, t_start: float = None, tracer: bool = True
             ) -> dict:
    """One run; returns the result object (with `check_lines`, the
    compared numbers beside their limits, for standard error). A traced
    run turns the program's tracer on for the window unless `tracer` is
    false."""
    import torch
    from portbench.bench import cell as cl
    from portbench.bench.trace import power_limit_w, read_profile
    from portbench.yard.reference import Reference
    from portbench.yard.training import encoder_params
    t_start = T_START if t_start is None else t_start
    cuda = device == "cuda"
    seed = seed % (2 ** 63)
    from repro_torch.kernels import decision_megakernel as k1mod
    marks = {"imports": time.perf_counter() - t_start}
    fleet = cl.Fleet.build(cfg, device)
    marks["fleet"] = time.perf_counter() - t_start
    annotate = torch.profiler.record_function if trace else None
    drive = cl.Drive(fleet, mix, seed, annotate=annotate)
    marks["stream"] = time.perf_counter() - t_start
    drive.warm()
    marks["warm"] = time.perf_counter() - t_start
    taps = []
    if trace:
        def tap(args, kw):
            emb, x, qual, gfeat = args[0], args[10], args[12], args[21]
            taps.append((tuple(emb.shape), x.shape[0], qual.shape[1],
                         args[5].shape[0], tuple(gfeat.shape),
                         kw["depth"], kw["use_gbm"], kw["w_aff"],
                         drive.probe.cur_rows, kw["k"]))
        k1mod.decision_megakernel.tap = tap
    if cuda:
        torch.cuda.synchronize()
    # the set-up's objects (world, stream, fleet, bundle) leave the
    # collector's generations, so that a full collection the simulator's
    # allocations trigger walks only what the window allocates
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    k1_before = (k1mod.decision_megakernel.launches,
                 k1mod.decision_megakernel.plain_calls)
    prof = tracing = None
    if trace:
        if tracer:
            from repro_torch import tracing
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        rf = torch.profiler.record_function("window")
        rf.__enter__()
    wall = drive.window(seconds, on_start=None if tracing is None
                        else tracing.enable)
    spans = None
    if tracing is not None:
        tracing.disable()
        spans = tracing.summary()
    if trace:
        rf.__exit__(None, None, None)
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        k1mod.decision_megakernel.tap = None
    k1_launches = (k1mod.decision_megakernel.launches - k1_before[0]
                   + k1mod.decision_megakernel.plain_calls - k1_before[1])
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    probe = drive.probe
    decided = drive.decided()
    per_req = probe.per_request_ms()
    ctrl_s = probe.controller_s()
    failed = sum(1 for rows, _ in probe.batches for r in rows
                 if drive.reqs[r].instance is None)
    view = dict(decided=decided, batches=len(probe.batches),
                controller_s=ctrl_s, place_s=probe.place_s,
                digest_s=probe.digest_s, hier=drive.hier, hot=drive.hot,
                per_request_ms=per_req, k1_calls=k1_launches,
                window_s=wall, trace=None, k1_bound_s=None, spans=spans,
                power_limit_w=power_limit_w() if cuda else float("nan"))
    if trace:
        tr = read_profile(prof, cl.K1_KERNEL) if cuda else None
        view["trace"] = tr
        view["k1_bound_s"] = _k1_bound_s(taps)
    metrics = {}
    # a reader that finds nothing to read in this cell returns None
    for m in bench["per_layer" if trace else "end_to_end"]:
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            continue
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = mod.read(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the check: the program's state goes first, then the reference runs
    gc.unfreeze()
    drive.release()
    fleet.bundle = None
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(cfg, fleet.world,
                    encoder_params(cfg["estimators"]["encoder"],
                                   cfg["estimators"]["encoder"]["seed"]),
                    fleet.pairs, device=device)
    read = cl.readings(drive, ref)
    correct, lines = cl.judge(read, cfg["check"]["limits"])
    lines = [f"decided {decided} requests in {len(probe.batches)} batches, "
             f"checked {read.get('rows_checked', 0)} rows of "
             f"{read.get('batches_checked', 0)} batches"
             + (f" and {read.get('placements_checked', 0)} placements"
                if drive.hier else ""),
             f"route_ms_p95 over {len(per_req)} requests"] + lines
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": decided, "failed": failed,
           "metrics": metrics, "device": device_rec}
    if trace and view["trace"] is not None:
        tr = view["trace"]
        device_rec["busy_s"] = tr["busy_s"]
        device_rec["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": idle_gaps(tr)}
    out["info"] = {"setup_marks_s": marks, "window_s": wall,
                   "window_sim_s": drive.window_sim,
                   "controller_s": ctrl_s, "batches": len(probe.batches),
                   "fires": probe.n_fires, "k1_calls": k1_launches,
                   "hot": drive.hot, "power_limit_w": view["power_limit_w"],
                   "reference_s": time.perf_counter() - t_ref,
                   "spans": spans and {k: [v["count"], v["total_s"],
                                           v["self_s"]]
                                       for k, v in spans.items()},
                   "readings": {k: v for k, v in read.items()
                                if not isinstance(v, dict)}}
    out["checks"] = {k: {"value": read[k],
                         "limit": cfg["check"]["limits"][k]}
                     for k in cfg["check"]["limits"] if k in read}
    out["check_lines"] = lines
    return out


def idle_gaps(tr) -> list:
    """The device's idle time by what the host was doing, at most ten
    entries: the idle inside the benchmark's `decide` and `digest` spans
    split by the innermost program span (`rb.*`) open over it, beside
    the ingest spans, the instances' `submit` and the simulator."""
    from portbench.bench.trace import IDLE_SPANS, NONE
    gaps = [g for g in tr["idle_gaps"] if g[0] not in IDLE_SPANS]
    gaps += [["decide/digest, no rb span" if n == NONE else n, v]
             for n, v in tr["idle_by_program_span"]]
    return sorted(gaps, key=lambda g: -g[1])[:10]


def _k1_bound_s(taps) -> float:
    """The least time the card could take for the window's K1 calls."""
    from portbench.yard.roofline import k1_counts
    tot = 0.0
    for (K, R, E), N, M, I, gshape, depth, use_gbm, w_aff, rows, k in taps:
        tot += k1_counts(K, R, E, N, M, I, use_gbm=use_gbm,
                         n_tiers=gshape[0], n_trees=gshape[1], depth=depth,
                         w_aff=w_aff,
                         n_neighbour_rows=min(rows * k, N))["bound_s"]
    return tot


if __name__ == "__main__":
    main()
