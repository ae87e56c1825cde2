"""Where a CTA of the SSD scan kernel (K4) spends its time, by phase.

    python3 tools/k4_phases.py [--orders chunk-slowest,chunk-fastest]

Writes a copy of src/repro_torch/csrc/ssd_scan.cu into
build/k4_phases/ with a `%globaltimer` stamp by thread 0 of every CTA
at each phase boundary (the stamps follow the source's phase comments;
an edit that moves them fails here), builds it with the port's nvcc
flags, and runs it at the serving shape (B = 4, S = 1,024, nh = 64,
P = 64, N = 128, chunk 128, bf16 x), checked against the plain version.
`chunk-fastest` also rewrites the work-id order to walk the chunks of
one (row, head) first, for comparison. Prints one JSON line per order:
the mean us per phase of a CTA's life, the chain wait by chunk index,
the kernel's span. Needs one NVIDIA GPU.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ["id", "staging", "scores", "cum+M+y_intra", "load_B", "st",
          "wait", "publish", "y_inter"]
MARKS = [   # (text in the source, stamp index placed before it)
    ("  if (tid == 0) {\n    const int id = atomicAdd(counter, 1);", 0),
    ("  const int id = s_id, c = id", 1),
    ("  // scores C.B^T:", 2),
    ("  // x to float32 in place", 3),
    ("  // the chunk's state term st[n][p]", 4),
    ("  for (int t = tid; t < QT * NT; t += THREADS)\n    Bs[t]", 5),
    ("  // y_inter's first C stages load", 6),
    ("  const float dl = expf(cum[Q - 1]);", 7),
    ("  // y_inter = (C exp(cum)) S_in", 8),
    ("  if (p0 < P) {\n#pragma unroll\n    for (int i = 0; i < 8; ++i) {", 9),
]
STAMP = ("__device__ long long* g_stamps;\n"
         "#define STAMP(j) do { if (threadIdx.x == 0 && g_stamps) { "
         "long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); "
         "g_stamps[(size_t)blockIdx.x * 12 + (j)] = t; } } while (0)\n")
FASTEST = ("  const int id = s_id, c = id / (Bsz * nh), bh = id % (Bsz * nh);",
           "  const int id = s_id, c = id % nc, bh = id / nc;")


def stamped_source(order):
    src = (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    for text, j in MARKS:
        if text not in src:
            sys.exit(f"phase mark not found in ssd_scan.cu: {text!r}")
        src = src.replace(text, f"  STAMP({j});\n{text}", 1)
    src = src.replace("  STAMP(1);\n  const int id = s_id", (
        "  STAMP(1);\n  if (threadIdx.x == 0 && g_stamps) "
        "g_stamps[(size_t)blockIdx.x * 12 + 11] = s_id;\n  const int id = s_id"))
    if order == "chunk-fastest":
        if FASTEST[0] not in src:
            sys.exit("work-id order not found in ssd_scan.cu")
        src = src.replace(*FASTEST)
    src = src.replace('extern "C" {', 'extern "C" {\nint rt_set_stamps(long long* p) '
                      '{ return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }', 1)
    return STAMP + src


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--orders", default="chunk-slowest,chunk-fastest")
    orders = ap.parse_args().orders.split(",")
    import chip_smoke as cs
    cs.phase_device()
    from repro_torch.kernels import build, ssd_scan as k4
    out = ROOT / "build" / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for order in orders:
        cu = out / f"{order}.cu"
        cu.write_text(stamped_source(order))
        procs[order] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{order}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for order, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {order}:\n{log}")
    args, chunk = cs.k4_inputs(800, **cs.K4_SERVE)
    xh, Bm, Cm, dt, A = args
    Bsz, S, nh, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    grid = Bsz * nh * nc
    yp, sp = k4.ssd_scan_plain(*args, chunk=chunk)
    for order in orders:
        lib = ctypes.CDLL(str(out / f"{order}.so"))
        lib.rt_ssd_scan.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                    + [ctypes.c_void_p] * 6)
        lib.rt_set_stamps.argtypes = [ctypes.c_void_p]
        slots = torch.empty(Bsz * nh * P * N, device="cuda")
        flags = torch.zeros(Bsz * nh + 1, dtype=torch.int32, device="cuda")
        stamps = torch.zeros(grid * 12, dtype=torch.int64, device="cuda")

        def run(ptr):
            lib.rt_set_stamps(ptr)
            y = torch.empty_like(xh)
            state = torch.empty((Bsz, nh, P, N), device="cuda")
            err = lib.rt_ssd_scan(
                xh.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                A.data_ptr(), Bsz, S, nh, P, G, N, chunk, 1, y.data_ptr(),
                state.data_ptr(), slots.data_ptr(), flags.data_ptr(),
                flags.data_ptr() + 4 * (flags.numel() - 1),
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"launch failed: cudaError {err}")
            return y, state
        y, st = run(None)
        torch.cuda.synchronize()
        ok = (cs.close(y, yp, 2 ** -7, 1e-4)[0]
              and cs.close(st, sp, 0.0, 1e-4)[0])
        run(stamps.data_ptr())
        torch.cuda.synchronize()
        s = stamps.view(grid, 12).cpu().numpy().astype(np.float64)
        d = np.diff(s[:, :10], axis=1) / 1e3
        ids = s[:, 11].astype(int)
        chunk_of = ids % nc if order == "chunk-fastest" else ids // (Bsz * nh)
        print(json.dumps({
            "order": order, "matches_plain": bool(ok),
            "span_us": float((s[:, 9].max() - s[:, 0].min()) / 1e3),
            "cta_mean_us": float(d.sum(1).mean()),
            "mean_us": dict(zip(PHASES, d.mean(0).round(2).tolist())),
            "wait_by_chunk_us": [round(float(d[chunk_of == c, 6].mean()), 2)
                                 for c in range(nc)],
            "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
