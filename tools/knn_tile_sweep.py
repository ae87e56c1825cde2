"""Time the KNN lookup kernel (K2, `csrc/knn_topk.cu`) over its launch
layouts: for each batch B, every row tile RT in {1, ..., 32} and a
range of index splits, the device time per call and the rows' results
against the plain version. It is how `kernels.knn_topk.row_tile` and
`knn_splits` were chosen.

    PYTHONPATH=src python3 tools/knn_tile_sweep.py [--out FILE]

Needs one NVIDIA GPU. Writes one JSON object per (B, RT, splits) to
FILE with `--out`; prints the card, then every layout's time per B (ms
by "RTxS"), then the best layout per B beside the wrapper's own
choice. Times are CUDA events around 200
back-to-back launches, / 200, at the staged path's index (N = 14,886,
E = 128, k = 10).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

N, E, K_NN = 14886, 128, 10
BATCHES = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256)
TILES = (1, 2, 4, 8, 16, 32)
PER_SPLIT = (1, 2, 3, 4, 6, 8, 12, 16, 24)


def b2b_ms(fn, n=200, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from repro_torch.kernels import knn_topk as kt
    dev = torch.device("cuda")
    lib = kt._library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ct = -(-N // kt.COLS)
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(N, E, generator=g).to(dev)
    xsq = (x * x).sum(1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lines = []

    def emit(show=True, **row):
        lines.append(json.dumps(row))
        if show:
            print(lines[-1], flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(card=smi, torch=torch.__version__, N=N, E=E, k=K_NN, sms=sms)
    best, table = {}, {}
    for B in BATCHES:
        q = torch.randn(B, E, generator=g).to(dev)
        want_d, want_i = kt.knn_topk_plain(q, x, K_NN, xsq)
        for RT in TILES:
            tiles = -(-B // RT)
            if RT > 2 * B or RT < B // 16:
                continue
            for per in PER_SPLIT:
                S = -(-n_ct // per)
                if per > 1 and -(-n_ct // (per - 1)) == S:
                    continue                  # the same S as a smaller per
                cand_d, cand_i, tickets = kt._scratch_for(
                    dev, stream, B * S * K_NN, tiles)
                out_d = torch.empty((B, K_NN), device=dev)
                out_i = torch.empty((B, K_NN), dtype=torch.int32, device=dev)

                def call():
                    err = lib.rt_knn_topk(
                        q.data_ptr(), None, x.data_ptr(), xsq.data_ptr(), B,
                        N, E, K_NN, RT, S, per, cand_d.data_ptr(),
                        cand_i.data_ptr(), tickets.data_ptr(),
                        out_d.data_ptr(), out_i.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"cudaError {err}")
                call()
                agree = float((out_i == want_i).all(1).float().mean())
                ms = b2b_ms(call)
                emit(False, B=B, RT=RT, S=S, per=per, ctas=S * tiles,
                     b2b_ms=ms, idx_row_agreement=agree)
                table.setdefault(str(B), {})[f"{RT}x{S}"] = ms
                if agree >= 0.99 and (B not in best or ms < best[B]["b2b_ms"]):
                    best[B] = dict(RT=RT, S=S, per=per, b2b_ms=ms)
        S, per = kt.knn_splits(B, N)
        best.setdefault(B, {})["wrapper"] = dict(RT=kt.row_tile(B), S=S, per=per)
    emit(table=table)
    emit(best={str(B): v for B, v in best.items()})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
