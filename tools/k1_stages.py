"""K1's time by stage at the main path's shapes, from its own stamps.

    python3 tools/k1_stages.py [--shapes 16x8,1024x16,16384x16] [--calls 20] \
        [--w-aff 0.35] [--clusters 8,16,global]

For each I x R (by default I = 16, 1,024 and 16,384, each at R = 8, 16
and 64): one K1 call (`decision_fused`) over a synthetic world of the
benchmark's sizes (a 14,886 x 128 index, 16 models, 16 tiers of 60 trees
of depth 3, k = 10, one window, every instance alive), run `--calls`
times back to back behind a spin with `timers` set. Prints one JSON line
a shape: the calls' CUDA event ms per call beside the stamps' (entry to
the end of the greedy loop), and the stamps' split: the per-instance
preamble (`trees_ms`: the entry to the end of the grid's last slice of
TPOT trees and, with the term on, affinity factors), the rest of stage 1
(the KNN lookup and label mixes, from there to the scan's start), the
LPT scan and, inside it, the steps' pass A (cost, latency with its
affinity factor, and admission), with the card's name and power limit.
With `--w-aff` > 0 the prefix-affinity term is on: each row carries 8
signature columns and each instance a plane of 64 sketch slots, a
quarter of the instances holding a row's leading columns. Each line
also gives the carry the scan ran on and its CTAs (the cluster's C on
the cluster carry, `kernels.decision_megakernel.carry_on`) and the
scan's microseconds a step. With `--clusters`, each shape past the
shared carry runs once per listed carry in turns (a, b, b, a for two):
a cluster of that many CTAs (the wrapper's constants set so that it
takes that C), or `global` for the global carry. Needs one NVIDIA GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

E, N, M, T, K_NN, TREES, DEPTH = 128, 14886, 16, 16, 10, 60, 3
SIG_W, SLOTS = 8, 64          # signature columns, sketch slots


def world(I: int, R: int, dev, seed: int = 0, aff: bool = False):
    """The positional arguments of one K1 call; with `aff`, rows'
    signatures and instances' sketch planes for the affinity term."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.normal(size=(N, E)).astype(f32)
    n_int, n_leaf = 2 ** DEPTH - 1, 2 ** DEPTH
    psig = np.zeros((1, 1, 1), np.int32)
    plane = np.zeros((1, 1), np.int32)
    if aff:
        psig = rng.integers(1, 2 ** 31, (1, R, SIG_W)).astype(np.int32)
        plane = rng.integers(1, 2 ** 31, (I, SLOTS)).astype(np.int32)
        for i in np.flatnonzero(rng.uniform(size=I) < 0.25):
            n = int(rng.integers(1, SIG_W + 1))
            plane[i, :n] = psig[0, rng.integers(R), :n]
    arrays = [
        rng.normal(size=(1, R, E)).astype(f32), np.ones((1, R), bool),
        np.full((1, R), np.nan, f32),
        rng.integers(8, 400, (1, R)).astype(f32),
        psig,
        rng.uniform(0, 300, I).astype(f32),
        rng.integers(1, 40, I).astype(f32),
        rng.integers(0, 8, I).astype(f32),
        rng.uniform(64, 900, I).astype(f32), np.ones(I, bool),
        x, (x * x).sum(1).astype(f32),
        rng.uniform(0, 1, (N, M)).astype(f32),
        rng.uniform(20, 400, (N, M)).astype(f32),
        rng.integers(0, M, I).astype(np.int32),
        (np.arange(I) % T).astype(np.int32), np.full(I, 48.0, f32),
        rng.uniform(1e-7, 1e-6, I).astype(f32),
        rng.uniform(1e-6, 1e-5, I).astype(f32),
        rng.uniform(0.01, 0.06, I).astype(f32), plane,
        rng.integers(0, 4, (T, TREES, n_int)).astype(np.int32),
        rng.uniform(0, 300, (T, TREES, n_int)).astype(f32),
        rng.uniform(-1e-3, 1e-3, (T, TREES, n_leaf)).astype(f32),
        np.full(T, 0.03, f32)]
    return [torch.as_tensor(a, device=dev) for a in arrays]


def measure(I: int, R: int, calls: int, dev, w_aff: float = 0.0) -> dict:
    from repro_torch.kernels import decision_megakernel as mk
    args = world(I, R, dev, aff=w_aff > 0.0)
    kw = dict(k=K_NN, eps=1e-6, weights=(1 / 3, 1 / 3, 1 / 3),
              latency_mode="full", lpt=True, budget_filter=True,
              w_aff=w_aff, use_gbm=True, depth=DEPTH, lr=0.15)
    timers = torch.zeros((calls, 5), dtype=torch.int64, device=dev)
    mk.decision_megakernel(*args, **kw, timers=timers[0])     # warm
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # the launches queue behind it
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for j in range(calls):
        mk.decision_megakernel(*args, **kw, timers=timers[j])
    stop.record()
    torch.cuda.synchronize()
    t = timers.cpu().numpy().astype(np.float64) * 1e-6        # ms
    kind, ctas = mk.carry_on(dev, 1, R, E, M, I)
    scan_ms = float((t[:, 3] - t[:, 2]).mean())
    return {"I": I, "R": R, "calls": calls, "w_aff": w_aff,
            "carry": kind, "ctas": ctas,
            "event_ms_per_call": start.elapsed_time(stop) / calls,
            "stamps_ms_per_call": float((t[:, 3] - t[:, 0]).mean()),
            "trees_ms": float((t[:, 1] - t[:, 0]).mean()),
            "stage1_ms": float((t[:, 2] - t[:, 1]).mean()),
            "scan_ms": scan_ms, "scan_us_per_step": 1e3 * scan_ms / R,
            "scan_a_ms": float(t[:, 4].mean())}


def forced(I: int, carry: str):
    """The wrapper's constants for `carry` at I: a cluster of int(carry)
    CTAs, or the global carry; restored by the caller."""
    if carry == "global":
        return {"MAX_CLUSTER": 1}
    C = int(carry)
    return {"MAX_CLUSTER": C, "CLUSTER_COLS": -(-I // C)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(
        f"{I}x{R}" for I in (16, 1024, 16384) for R in (8, 16, 64)))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--w-aff", type=float, default=0.0)
    ap.add_argument("--clusters", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_stages: needs an NVIDIA GPU")
    from repro_torch.kernels import decision_megakernel as mk
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    carries = [c for c in a.clusters.split(",") if c]
    for shape in a.shapes.split(","):
        I, R = (int(v) for v in shape.split("x"))
        turns = (carries + carries[::-1]
                 if carries and I > mk.MAX_SHARED_I else [None])
        for carry in turns:
            saved = {k: getattr(mk, k) for k in ("MAX_CLUSTER",
                                                 "CLUSTER_COLS")}
            try:
                for k, v in (forced(I, carry) if carry else {}).items():
                    setattr(mk, k, v)
                row = measure(I, R, a.calls, dev, a.w_aff)
            finally:
                for k, v in saved.items():
                    setattr(mk, k, v)
            print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
