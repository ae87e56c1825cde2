"""Time the port's kernels, the SSM prefill and the quickstart on two
checkouts, in turns.

    python3 tools/turns.py OLD_DIR NEW_DIR [--phases k1,k2,k4,prefill,main]
                           [--out FILE]

OLD_DIR and NEW_DIR are checkouts of the repository (a `git archive` of
a commit unpacked into a git-ignored directory, say). Each phase runs
four times, OLD, NEW, NEW, OLD, each time in a fresh process that
imports only that checkout's `chip_smoke.py` and `repro_torch` (each
builds its own kernels). Phases:

  k1       chip_smoke phase 4: the decision kernel at R = 8, 64, 256
  k2       chip_smoke phase 4b: the KNN lookup at B = 1, 8, 64, 256
  k4       chip_smoke phase 4d: the SSD scan at the serving shape
  prefill  mamba2-1.3b (48 layers, seeded random bf16 weights),
           `Model.prefill` of 4 x 1,024 tokens: the first call, then
           the median of 3 more (host clock around a synchronize)
  main     chip_smoke phase 5: the quickstart at 12 and 30 req/s

Prints one summary line per phase: the device ms, call ms and
back-to-back ms (k1, k2, k4), the prefill ms, or the quickstart's
served requests, launches and decide ms per request, per turn; with
`--out`, also writes every JSON line a run emits, tagged with its tree
and turn, to FILE. Needs one NVIDIA GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys, time
sys.path.insert(0, {tree!r})
import numpy as np
import torch
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
phase = {phase!r}
if phase == "k1":
    from repro_torch.kernels import decision_megakernel as mk
    cs.phase_times(mk)
elif phase == "k2":
    from repro_torch.kernels import knn_topk as kt
    cs.phase_knn_times(kt)
elif phase == "k4":
    from repro_torch.kernels import ssd_scan as k4
    cs.phase_k4_times(k4)
elif phase == "main":
    from repro_torch.kernels import decision_megakernel as mk
    cs.phase_main_path(mk)
else:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (4, 1024)).astype(np.int32)).to("cuda")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill({{"tokens": tokens}}, pad_to=1024)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    cs.emit("prefill", model="mamba2-1.3b", batch=4, prompt=1024,
            first_ms=times[0], median_ms=float(np.median(times[1:])),
            ms=times)
'''


def device_ms(row):
    split = row.get("device_ms_by_function")
    return sum(split.values()) if isinstance(split, dict) else None


def summarize(phase, rows):
    """{turn label: the phase's headline numbers} from one run's rows."""
    if phase == "prefill":
        return {k: r[k] for r in rows if r.get("phase") == "prefill"
                for k in ("first_ms", "median_ms")}
    if phase == "main":
        return {f"rate={r['rate']}": {k: r[k] for k in (
            "served", "fired_batches", "launches",
            "measured_decide_ms_per_req", "per_call_ms")}
            for r in rows if r.get("phase") == "main_path"}
    key = {"k1": "R", "k2": "B", "k4": "S"}[phase]
    want = {"k1": "times", "k2": "knn_times", "k4": "k4_times"}[phase]
    return {f"{key}={r[key]}": dict(device_ms=device_ms(r), ms=r["ms"],
                                    b2b_ms=r["b2b_ms"])
            for r in rows if r.get("phase") == want}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--phases", default="k1,k2,k4,prefill,main")
    ap.add_argument("--out", help="file for every run's JSON lines")
    a = ap.parse_args()
    trees = {"old": str(Path(a.old).resolve()),
             "new": str(Path(a.new).resolve())}
    log = open(a.out, "w") if a.out else None
    failed = False
    for phase in a.phases.split(","):
        summary = []
        for turn, label in enumerate(("old", "new", "new", "old")):
            code = CHILD.format(tree=trees[label], phase=phase)
            proc = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  cwd=trees[label])
            rows = []
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    row = dict(json.loads(line), tree=label, turn=turn)
                    rows.append(row)
                    if log:
                        print(json.dumps(row), file=log, flush=True)
            if proc.returncode:
                failed = True
                print(f"{phase} {label} turn {turn} failed:\n"
                      f"{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
            summary.append(dict(tree=label, turn=turn,
                                numbers=summarize(phase, rows)))
        line = json.dumps({"phase": phase, "turns": summary})
        print(line, flush=True)
        if log:
            print(line, file=log, flush=True)
    if log:
        log.close()
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
