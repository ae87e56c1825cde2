"""Drive the PyTorch/CUDA port of RouteBalance on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits nonzero
(phases 4b, 5b and 5c drive the KNN lookup kernel K2 and its paths):

  1. device — the card, `nvidia-smi`'s name and power limit, TF32 flags;
  2. build  — compile the CUDA sources of `src/repro_torch/csrc/`;
  3. check  — the decision kernel against its plain PyTorch version on
     the card, at the main path's shapes (N=14,886 x E=128 index, M=4,
     four 60-tree depth-3 TPOT heads, I=16 with 13 alive, R in
     {8, 64, 256}, and one request in the R=8 bucket) plus I=128 and
     I=4096, K=2 windows, the affinity term, the four latency modes,
     LPT and the budget filter on and off, the GBM off:
     on dyadic inputs (multiples of 1/8, so every distance is exact)
     choice/b1/f1 must be identical and est_T/l_chosen/d1 within rtol
     1e-5; on random normal inputs choice must agree on >= 99% of rows;
  4. times  — kernel and plain version, median of 50 CUDA-event-timed
     calls after warm-up, beside the least time the card could take, and
     the profiler's device time of the kernel's one function; back to
     back: CUDA events around 200 launches / 200, twice; fails if 20
     profiled calls run anything on the device but at most 20 launches
     of that function (as 4b, 4c and 4d do for K2, K3 and K4);
  3b. knn check — the KNN lookup kernel against its plain version on the
     main-path index (N=14,886 x E=128, k=10) at B in {1, 3, 8, 12, 40,
     64, 256, 300},
     plus N=1,000 with k=32 and bf16 input: on dyadic inputs idx and d2
     identical; on random normal inputs idx agreeing on >= 99% of rows
     and d2 within rtol 1e-5;
  4b. knn times — as phase 4 for B in {1, 8, 64, 256}, beside the time
     of the composite PyTorch expression (matmul + torch.topk) that the
     kernel is held to, back to back in turns (kernel, composite,
     composite, kernel); fails if the profiler sees no device time for
     the kernel's one function, or if 20 profiled calls run anything on
     the device but at most 20 launches of it;
  5. main path — the README quickstart on the port at the paper's sizes
     (18,608 prompts, the 13-instance pool, 300 requests at 12 req/s,
     then 600 at 30 req/s): every request served, none failed, one
     kernel launch per fired batch and no plain-version call;
  5b. staged — the same 300 requests through the staged numpy and torch
     decision backends, both fed by the KNN kernel, with
     `charge_compute=False` so that the two see the same batches: the
     per-request choices must be identical;
  5c. baselines — BEST-Route, Avengers-Pro and passthrough (sq / rr /
     sq dispatch) on the windowed engine, then BEST-Route under the
     serial_published, concurrent and microbatch deployments, the
     bundle's KNN on the kernel. For 5b and 5c: every request served,
     none failed, one KNN-kernel launch per scoring call, no plain
     call, no decision-kernel launch;
  3c. k3 check — the decode-attention kernel K3 against its plain version
     at the dense serving shape (B=8, H=16, K=2, d=128, C=1,024) with the
     cache full, partly empty and windowed, and at the smoke shape, plus
     clusters of 1, 3 and 8 pieces, a wrapped ring buffer, a window that
     empties whole tiles and pieces of two segments, in bf16 and
     float32: float32 within 1e-5 of the output's scale, bf16 within one
     unit in the last place (2^-7 relative) plus that;
  3d. k4 check — the SSD scan kernel K4 against its plain version at the
     SSM serving shape (B=4, S=1,024, nh=64, P=64, N=128, G=1, chunk 128),
     at S=2,048 (16 chunks a chain), at one chunk (S=128) and at the
     smoke shapes, in bf16 and float32: y and the final state within
     1e-4 of their scale (bf16 y within 2^-7 relative plus that);
  4c/4d. k3/k4 times — as phase 4 at the serving shapes, beside the bound
     and, for K3, `F.scaled_dot_product_attention` on pre-laid-out
     tensors (the port never calls it), back to back in turns (K3: kernel,
     SDPA, SDPA, kernel); K3 also with its caches cold, cycling over 36
     layers' caches (302 MB) as a decode step finds them; 4c fails if
     the profiler sees no device time for K3's one function, or if 20
     profiled calls, warm or cold, run anything on the device but at
     most 20 launches of it, and 4d the same for K4's one function;
  5d. dense serving — `qwen2.5-3b` at full width (36 layers, random
     seeded bf16 weights): 8 prompts of 512 tokens, `pad_to` 1,024, 64
     greedy decode steps; finite logits, K3 launches = 36 x 64, no plain
     call; then the card against the CPU (plain versions) at 2 layers in
     float32 on the same weights: identical greedy tokens over a
     64-token prompt and 8 steps, logits within 1e-3 (cuBLAS and the
     CPU's BLAS sum float32 in other orders); after the counted run, one
     prefill and one decode step under the profiler (device time, kernel
     launches, the device's busy share, the top kernels, K3's device
     time);
  5e. SSM serving — `mamba2-1.3b` at full width (48 layers): 4 prompts
     of 1,024 tokens, 32 decode steps; K4 launches = 48, no plain call;
     the same 2-layer card-against-CPU check;
  6. the kernels line, then the card's `nvidia-smi` line, then the last
     line `{"ok": true, "device": {...}}`.

It imports torch, numpy, the standard library and `repro_torch` (from
`src/` beside this file), never jax and nothing of the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (the bound uses them; see the printed name)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
N_INDEX, E, M, N_TIERS, N_TREES, DEPTH = 14886, 128, 4, 4, 60, 3
K_NN = 10
K1_FUNCTION = "decision_fused"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# -- synthetic decision inputs at the main path's shapes ----------------------

def make_case(seed, R, I, n_alive, K=1, dyadic=True, w_aff=0.0,
              use_gbm=True, mode="full", lpt=True, budget_filter=True,
              dev="cuda", valid=None):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if dyadic:
        emb = rng.integers(-8, 9, (K, R, E)) / 8
        x = rng.integers(-8, 9, (N_INDEX, E)) / 8
    else:
        emb = rng.normal(size=(K, R, E)) / np.sqrt(E)
        x = rng.normal(size=(N_INDEX, E)) / np.sqrt(E)
    emb, x = emb.astype(f32), x.astype(f32)
    rv = np.ones((K, R), bool)
    rv[:, R - max(1, R // 4) if valid is None else valid:] = False  # pad rows
    alive = np.arange(I) < n_alive
    args = dict(
        emb=emb, row_valid=rv,
        budgets=np.where(rng.uniform(size=(K, R)) < 0.5,
                         rng.uniform(1e-5, 3e-4, (K, R)), np.nan).astype(f32),
        len_in=rng.integers(8, 400, (K, R)).astype(f32),
        psig=np.zeros((1, 1, 1), np.int32),
        d=rng.uniform(0, 3000, I).astype(f32),
        b=rng.integers(0, 48, I).astype(f32),
        free=rng.integers(0, 4, I).astype(f32),
        ctx=rng.uniform(0, 900, I).astype(f32),
        alive=alive, x=x, xsq=(x * x).sum(1).astype(f32),
        qual=rng.uniform(0, 1, (N_INDEX, M)).astype(f32),
        leng=rng.uniform(20, 600, (N_INDEX, M)).astype(f32),
        m_of_i=rng.integers(0, M, I).astype(np.int32),
        tier_of_i=rng.integers(0, N_TIERS, I).astype(np.int32),
        maxb=np.full(I, 48.0, f32),
        price_in=rng.uniform(0.05, 0.4, I).astype(f32),
        price_out=rng.uniform(0.05, 0.4, I).astype(f32),
        nominal=rng.uniform(0.005, 0.05, I).astype(f32),
        sig_plane=np.zeros((1, 1), np.int32))
    if w_aff > 0:
        pool = rng.integers(1, 2 ** 31 - 1, 64).astype(np.int32)
        args["psig"] = pool[rng.integers(0, 64, (K, R, 8))]
        plane = pool[rng.integers(0, 64, (I, 64))]
        plane[rng.uniform(size=(I, 64)) < 0.5] = 0
        args["sig_plane"] = plane
    n_int, n_leaf = 2 ** DEPTH - 1, 2 ** DEPTH
    if use_gbm:     # random packed trees at the heads' real shapes
        scale = np.array([48.0, 3000.0, 900.0, 48.0 * 900.0], f32)
        feat = rng.integers(0, 4, (N_TIERS, N_TREES, n_int)).astype(np.int32)
        gbm = [feat, (rng.uniform(0, 1, feat.shape) * scale[feat]).astype(f32),
               rng.normal(0, 2e-3, (N_TIERS, N_TREES, n_leaf)).astype(f32),
               rng.uniform(0.01, 0.05, N_TIERS).astype(f32)]
    else:
        gbm = [np.zeros((1, 1, 1), np.int32), np.zeros((1, 1, 1), f32),
               np.zeros((1, 1, 1), f32), np.zeros(1, f32)]
    tensors = [torch.as_tensor(a, device=dev)
               for a in list(args.values()) + gbm]
    statics = dict(k=10, eps=1e-6, weights=(1 / 3, 1 / 3, 1 / 3),
                   latency_mode=mode, lpt=lpt, budget_filter=budget_filter,
                   w_aff=w_aff, use_gbm=use_gbm,
                   depth=DEPTH if use_gbm else 1, lr=0.15)
    return tensors, statics


def plain_reference(mk, tensors, statics):
    out = mk.decision_megakernel_plain(*tensors, **statics)
    return [o.cpu().numpy() for o in out]


def kernel_out(mk, tensors, statics):
    out = mk.decision_megakernel(*tensors, **statics)
    torch.cuda.synchronize()
    return [o.cpu().numpy() for o in out]


def bound_ms(tensors, statics, n_neighbour_rows):
    """Least time for the function: bytes it must move (inputs read once,
    outputs written once; of the label planes only the neighbours' rows,
    of the trees only the nodes walked) over the memory rate, or float32
    operations over the CUDA-core peak, whichever is larger."""
    emb, rv, bud, lin = tensors[:4]
    K, R, _ = emb.shape
    I = tensors[5].shape[0]
    per_row = 4 * E + 1 + 4 + 4
    per_inst = 4 * 8 + 1 + 4 * 2
    nbytes = (K * R * per_row + N_INDEX * E * 4 + N_INDEX * 4
              + n_neighbour_rows * M * 4 * 2 + I * per_inst
              + K * R * 12 + K * I * 12)
    if statics["use_gbm"]:
        nbytes += I * N_TREES * (DEPTH * 8 + 4)
    if statics["w_aff"] > 0:
        nbytes += K * R * 8 * 4 + I * 64 * 4
    flops = 2 * K * R * N_INDEX * E + 3 * K * R * N_INDEX
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def neighbour_rows(tensors, k=10):
    emb, x, xsq = tensors[0], tensors[10], tensors[11]
    q = emb.reshape(-1, E)
    d2 = xsq[None, :] - 2.0 * (q @ x.T) + (q * q).sum(-1, keepdim=True)
    return int(torch.sort(d2, dim=1, stable=True)[1][:, :k].unique().numel())


def device_split_ms(fn, names, n=20):
    """Device time per call of each named __global__ function, from the
    profiler's CUDA activity over n calls, averaged over the launches it
    recorded (it can drop some); empty when it sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in names:
            if name in ev.key:
                us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
                out[name] = us / max(ev.count, 1) / 1e3
    return out


def b2b_ms(fn, n=200, warm=5):
    """Back-to-back time per call: CUDA events around n launches, / n."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def b2b_turns(kernel, yardstick=None, n=200):
    """Back-to-back times in turns, kernel, yardstick, yardstick, kernel
    (kernel, kernel without a yardstick): ([kernel ms] * 2, [yardstick
    ms] * 2 or None)."""
    if yardstick is None:
        return [b2b_ms(kernel, n), b2b_ms(kernel, n)], None
    k1, y1 = b2b_ms(kernel, n), b2b_ms(yardstick, n)
    y2, k2 = b2b_ms(yardstick, n), b2b_ms(kernel, n)
    return [k1, k2], [y1, y2]


def required_split(fn, names, label, n=20):
    """device_split_ms for a kernel whose functions the profiler must
    see: fails when it returns nothing for one of `names`."""
    split = device_split_ms(fn, names=names, n=n)
    if not all(name in split for name in names):    # once more
        split = device_split_ms(fn, names=names, n=n)
    if not all(name in split for name in names):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        fail(f"{label}: the profiler saw no device time for {names}; it "
             f"saw {[ev.key[:120] for ev in prof.key_averages()]}")
    return split


def functions_per_call(fn, name, label, n=20, tries=3):
    """What one call of `fn` runs on the device, measured: the profiler's
    device activities (kernels, copies, fills) over n calls, as
    `device_split_ms` records them. Fails unless every activity seen is
    a launch of the __global__ function `name` and there are at most n
    (the profiler can drop some; a profile that saw none is taken
    again). Returns (distinct functions seen, activities seen / n)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if str(ev.device_type).endswith("CUDA"):
                seen[ev.key[:120]] = seen.get(ev.key[:120], 0) + ev.count
        if seen:
            break
    count = sum(seen.values())
    check(seen and count <= n and all(name in key for key in seen),
          f"{label}: {n} calls ran {seen} on the device, want at most "
          f"{n} launches of {name} and nothing else")
    return len(seen), count / n


def time_ms(fn, n=50, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# -- phases -------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.device import resolve_device
    resolve_device(None)                  # TF32 off, card required
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi.stdout.strip(),
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {name: [ln for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, out in build.build_info.get("ptxas", {}).items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_check(mk):
    cases = [
        dict(R=8, I=16, n_alive=13), dict(R=64, I=16, n_alive=13),
        dict(R=256, I=16, n_alive=13),
        dict(R=64, I=16, n_alive=13, mode="off_reactive"),
        dict(R=64, I=16, n_alive=13, mode="off_predictive"),
        dict(R=64, I=16, n_alive=13, mode="static_prior", use_gbm=False),
        dict(R=64, I=16, n_alive=13, lpt=False),
        dict(R=64, I=16, n_alive=13, budget_filter=False),
        dict(R=64, I=16, n_alive=13, use_gbm=False),
        dict(R=64, I=128, n_alive=100),
        dict(R=64, I=16, n_alive=13, K=2),
        dict(R=64, I=16, n_alive=13, w_aff=0.5),
        # one request in the R = 8 bucket; the carry's largest roster
        dict(R=8, I=16, n_alive=13, valid=1),
        dict(R=64, I=4096, n_alive=4000),
    ]
    max_abs = 0.0
    for seed, case in enumerate(cases):
        tensors, statics = make_case(seed, **case)
        got = kernel_out(mk, tensors, statics)
        want = plain_reference(mk, tensors, statics)
        for j, name in ((0, "choice"), (4, "b1"), (5, "f1")):
            check(np.array_equal(got[j], want[j]),
                  f"{case}: {name} differs from the plain version")
        for j, name in ((1, "est_T"), (2, "l_chosen"), (3, "d1")):
            check(np.allclose(got[j], want[j], rtol=1e-5, atol=0),
                  f"{case}: {name} outside rtol 1e-5")
            max_abs = max(max_abs, float(np.abs(got[j] - want[j]).max()))
        emit("check", inputs="dyadic", **case, exact=True)
    agreements = []
    for R in (8, 64, 256):
        tensors, statics = make_case(100 + R, R=R, I=16, n_alive=13,
                                     dyadic=False)
        got = kernel_out(mk, tensors, statics)
        want = plain_reference(mk, tensors, statics)
        rv = tensors[1].cpu().numpy()
        agree = (got[0] == want[0]) & rv
        frac = float(agree.sum() / rv.sum())
        rel = np.abs(got[1] - want[1]) / np.maximum(np.abs(want[1]), 1e-30)
        rel_max = float(rel[agree].max()) if agree.any() else None
        agreements.append(frac)
        emit("check", inputs="normal", R=R, I=16, choice_agreement=frac,
             est_T_max_rel_err_on_agreeing_rows=rel_max)
        check(frac >= 0.99, f"R={R}: choice agreement {frac} < 0.99")
    return max_abs, min(agreements)


def phase_times(mk):
    rows = {}
    for R in (8, 64, 256):
        tensors, statics = make_case(200 + R, R=R, I=16, n_alive=13,
                                     dyadic=False)
        def kernel():
            return mk.decision_megakernel(*tensors, **statics)
        k_ms = time_ms(kernel)
        p_ms = time_ms(
            lambda: mk.decision_megakernel_plain(*tensors, **statics))
        b_ms, by, nbytes, flops = bound_ms(tensors, statics,
                                          neighbour_rows(tensors))
        rows[R] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       bytes=nbytes, flops=flops, library_ms=None,
                       b2b_ms=b2b_turns(kernel)[0],
                       device_ms_by_function=required_split(
                           kernel, (K1_FUNCTION,), f"K1 R={R}"),
                       layout=dict(zip(("row_tile", "splits"),
                                       mk.layout(R, N_INDEX)[:2])))
        (rows[R]["global_functions_per_call"],
         rows[R]["device_activities_per_call"]) = functions_per_call(
            kernel, K1_FUNCTION, f"K1 R={R}")
        emit("times", R=R, I=16, K=1, **rows[R], calls_timed=50)
    return rows


def knn_inputs(seed, B, N, dyadic, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    if dyadic:
        q, x = rng.integers(-8, 9, (B, E)) / 8, rng.integers(-8, 9, (N, E)) / 8
    else:
        q, x = rng.normal(size=(B, E)), rng.normal(size=(N, E))
    return (torch.tensor(q, dtype=dtype, device="cuda"),
            torch.tensor(x, dtype=dtype, device="cuda"))


def phase_knn_check(kt):
    cases = [dict(B=B, N=N_INDEX, k=K_NN)
             for B in (1, 3, 8, 12, 40, 64, 256, 300)]
    cases += [dict(B=8, N=1000, k=32), dict(B=8, N=N_INDEX, k=K_NN,
                                            dtype=torch.bfloat16)]
    max_abs, agreements = 0.0, []
    for seed, case in enumerate(cases):
        dtype = case.get("dtype", torch.float32)
        for dyadic in (True, False):
            q, x = knn_inputs(300 + seed, case["B"], case["N"], dyadic, dtype)
            d, i = kt.knn_topk(q, x, case["k"])
            torch.cuda.synchronize()
            pd, pi = kt.knn_topk_plain(q, x, case["k"])
            check(int(i.max()) < case["N"] and int(i.min()) >= 0,
                  f"{case}: index out of range")
            row = dict(B=case["B"], N=case["N"], k=case["k"],
                       dtype=str(dtype).split(".")[-1])
            if dyadic:
                check(torch.equal(i, pi) and torch.equal(d, pd),
                      f"{case}: dyadic idx/d2 differ from the plain version")
                emit("knn_check", inputs="dyadic", **row, exact=True)
                continue
            agree = float((i == pi).all(1).float().mean())
            rel = float(((d - pd).abs() / pd.abs().clamp_min(1e-30)).max())
            max_abs = max(max_abs, float((d - pd).abs().max()))
            agreements.append(agree)
            emit("knn_check", inputs="normal", **row, idx_row_agreement=agree,
                 d2_max_rel_err=rel)
            check(agree >= 0.99, f"{case}: idx agreement {agree} < 0.99")
            check(rel <= 1e-5, f"{case}: d2 relative error {rel} > 1e-5")
    return max_abs, min(agreements)


def knn_bound_ms(B, N, k):
    """Least time: q, x and |x|^2 read once, d2 and idx written once, over
    the memory rate; or 2*B*N*E + 3*B*N float32 operations over the
    CUDA-core peak; whichever is larger."""
    nbytes = B * E * 4 + N * E * 4 + N * 4 + B * k * 8
    flops = 2 * B * N * E + 3 * B * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_knn_times(kt):
    rows = {}
    for B in (1, 8, 64, 256):
        q, x = knn_inputs(400 + B, B, N_INDEX, dyadic=False)
        xsq = (x * x).sum(1)            # the estimator passes |x|^2 in
        def kernel():
            return kt.knn_topk(q, x, K_NN, xsq=xsq)
        def composite():
            d2 = xsq[None] - 2 * (q @ x.T) + (q * q).sum(1, keepdim=True)
            return torch.topk(d2, K_NN, largest=False)
        b_ms, by, nbytes, flops = knn_bound_ms(B, N_INDEX, K_NN)
        b2b, comp_b2b = b2b_turns(kernel, composite)
        rows[B] = dict(
            ms=time_ms(kernel),
            plain_ms=time_ms(lambda: kt.knn_topk_plain(q, x, K_NN, xsq)),
            composite_ms=time_ms(composite), bound_ms=b_ms, bound_by=by,
            bytes=nbytes, flops=flops, library_ms=None, b2b_ms=b2b,
            composite_b2b_ms=comp_b2b,
            device_ms_by_function=required_split(
                kernel, ("knn_topk_fused",), f"K2 B={B}"),
            row_tile=kt.row_tile(B), splits=kt.knn_splits(B, N_INDEX)[0])
        (rows[B]["global_functions_per_call"],
         rows[B]["device_activities_per_call"]) = functions_per_call(
            kernel, "knn_topk_fused", f"K2 B={B}")
        emit("knn_times", B=B, N=N_INDEX, E=E, k=K_NN, **rows[B],
             calls_timed=50, tf32=torch.backends.cuda.matmul.allow_tf32)
    return rows


def phase_main_path(mk):
    from repro_torch.core import (EstimatorBundle, RBConfig, RouteBalance,
                                  make_requests, run_cell)
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.workload import poisson_arrivals
    from repro_torch.serving.world import build_dataset, paper_world
    t0 = time.perf_counter()
    world, names = paper_world(seed=0)
    ds = build_dataset(world)
    tiers = paper_pool_tiers()
    bundle = EstimatorBundle.train(ds, tiers, names)
    check(bundle.device.type == "cuda", "bundle is not on the card")
    emit("main_setup", prompts=len(ds.prompts), index_rows=len(ds.train_idx),
         seconds=time.perf_counter() - t0)
    launches = {}
    for lam, n in ((12.0, 300), (30.0, 600)):
        reqs = make_requests(ds, "test", poisson_arrivals(lam, n, seed=0))
        rb = RouteBalance(RBConfig(), bundle, tiers)
        mk.reset_counts()
        t1 = time.perf_counter()
        m = run_cell(rb, tiers, names, reqs)
        wall = time.perf_counter() - t1
        fired = len(rb.compute_log)
        got = (mk.decision_megakernel.launches,
               mk.decision_megakernel.plain_calls)
        launches[lam] = got[0]
        stats = rb._fused.stats
        calls = max(stats["calls"], 1)
        emit("main_path", rate=lam, requests=n, served=m["n"],
             failed=m["failed"], fired_batches=fired, launches=got[0],
             plain_calls=got[1], quality=m["quality"],
             mean_e2e=m["mean_e2e"], p99_e2e=m["p99_e2e"],
             cost_per_req=m["cost_per_req"],
             measured_decide_ms_mean=m["measured_decide_ms_mean"],
             measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
             mean_batch_size=m["mean_batch_size"],
             per_call_ms={k: stats[k] / calls * 1e3 for k in
                          ("stage_s", "dispatch_s", "device_s", "sync_s")},
             sync_counts={k: stats[k] for k in
                          ("full_reseed", "delta_sync", "carry")},
             shape_variants=rb._fused.shape_variants(), wall_s=wall)
        check(m["n"] == n and m["failed"] == 0,
              f"{lam} req/s: served {m['n']} of {n}, failed {m['failed']}")
        check(got[0] == fired and fired > 0,
              f"{lam} req/s: {got[0]} launches for {fired} batches")
        check(got[1] == 0, f"{lam} req/s: {got[1]} plain-version calls")
        check(np.isfinite(m["mean_e2e"]) and 0.0 < m["quality"] < 1.0,
              f"{lam} req/s: implausible metrics {m}")
        check(all(r.instance is not None for r in reqs),
              f"{lam} req/s: a request was never dispatched")
    return launches, dict(ds=ds, tiers=tiers, names=names, bundle=bundle)


def served_through_knn(label, eng, m, n, counts, kt, mk, **extra):
    """Check one staged/baseline run and emit its row; returns the KNN
    kernel's launches in it."""
    launches = kt.knn_topk.launches
    calls = len(eng.compute_log)
    emit("staged", run=label, requests=n, served=m["n"], failed=m["failed"],
         scoring_calls=calls, knn_launches=launches,
         knn_plain_calls=kt.knn_topk.plain_calls,
         decision_kernel_launches=mk.decision_megakernel.launches,
         quality=m["quality"], mean_e2e=m["mean_e2e"],
         p99_e2e=m["p99_e2e"], cost_per_req=m["cost_per_req"],
         measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
         mean_batch_size=m["mean_batch_size"],
         deployment=m.get("deployment"), **extra)
    check(m["n"] == n and m["failed"] == 0,
          f"{label}: served {m['n']} of {n}, failed {m['failed']}")
    check(launches == calls > 0,
          f"{label}: {launches} KNN launches for {calls} scoring calls")
    check(kt.knn_topk.plain_calls == 0, f"{label}: plain KNN calls")
    check(mk.decision_megakernel.launches == 0,
          f"{label}: the decision kernel ran")
    check(np.isfinite(m["mean_e2e"]) and 0.0 < m["quality"] < 1.0,
          f"{label}: implausible metrics {m}")
    counts[label] = launches
    return launches


def phase_staged(ctx, kt, mk):
    """The staged decision backends and the baselines, the KNN on the
    kernel, at the quickstart's sizes (12 req/s, 300 requests)."""
    from repro_torch.core import (EngineConfig, RBConfig, RouteBalance,
                                  ServingEngine, fit_policy, make_requests,
                                  run_cell)
    from repro_torch.serving.workload import poisson_arrivals
    ds, tiers, names = ctx["ds"], ctx["tiers"], ctx["names"]
    bundle = ctx["bundle"].with_knn_backend("kernel")
    n = 300

    def stream():
        return make_requests(ds, "test", poisson_arrivals(12.0, n, seed=0))

    def reset():
        kt.reset_counts()
        mk.reset_counts()

    counts, choices = {}, {}
    for backend in ("numpy", "torch"):
        reqs = stream()
        rb = RouteBalance(RBConfig(decision_backend=backend,
                                   knn_backend="kernel",
                                   charge_compute=False),
                          ctx["bundle"], tiers)
        reset()
        m = run_cell(rb, tiers, names, reqs)
        served_through_knn(f"routebalance-{backend}", rb, m, n, counts, kt,
                           mk, charge_compute=False)
        choices[backend] = [r.instance for r in reqs]
    same = choices["numpy"] == choices["torch"]
    emit("staged_parity", runs=["routebalance-numpy", "routebalance-torch"],
         identical_choices=same,
         differing=sum(a != b for a, b in zip(choices["numpy"],
                                               choices["torch"])))
    check(same, "staged numpy and torch backends chose differently")
    runs = [(name, "windowed") for name in ("bestroute-sq", "avengers-rr",
                                            "passthrough-sq")]
    runs += [("bestroute-sq", dep) for dep in ("serial_published",
                                               "concurrent", "microbatch")]
    for name, dep in runs:
        reqs = stream()
        # BEST-Route's own quality scorer sits beside the bundle
        kw = ({"device": bundle.device} if name.startswith("bestroute")
              else {})
        eng = ServingEngine(fit_policy(name, bundle, tiers, names, ds, **kw),
                            bundle, tiers, EngineConfig(deployment=dep))
        reset()
        m = run_cell(eng, tiers, names, reqs)
        served_through_knn(f"{name}/{dep}", eng, m, n, counts, kt, mk)
    return counts


# -- model-zoo kernels: K3 decode attention, K4 SSD scan ----------------------

DEV = "cuda"
K3_SERVE = dict(B=8, K=2, g=8, d=128, C=1024)
K4_SERVE = dict(B=4, S=1024, nh=64, P=64, N=128, G=1, chunk=128)


def k3_inputs(seed, B, K, g, d, C, valid, window=0, dtype=torch.bfloat16):
    """q (B, H, d), caches (B, C, K, d), pos = valid - 1: the cache of a
    decode step at position `valid - 1`, positions 0..valid-1 then -1,
    or, with valid > C, a ring buffer that has wrapped (slot j holds the
    latest position congruent to j mod C)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    H = K * g
    q, kc, vc = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
                 for shape in ((B, H, d), (B, C, K, d), (B, C, K, d)))
    pos = valid - 1
    cpos = torch.arange(C, dtype=torch.int32, device=DEV)
    if valid > C:
        cpos = pos - (pos - cpos) % C
    cpos[valid:] = -1
    return (q, kc, vc, cpos), pos, window


def close(got, want, rtol, atol_rel):
    """|got - want| <= rtol |want| + atol_rel * max(1, max |want|);
    returns (ok, max abs error)."""
    got, want = got.float(), want.float()
    atol = atol_rel * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    return bool((err <= rtol * want.abs() + atol).all()), float(err.max())


def phase_k3_check(k3):
    S = K3_SERVE
    cases = [dict(S, valid=1024), dict(S, valid=540),
             dict(S, valid=1024, window=256), dict(S, valid=700, window=100),
             dict(B=2, K=2, g=2, d=16, C=40, valid=36),
             dict(B=2, K=2, g=2, d=16, C=16, valid=16, window=16)]
    # clusters of 1, 3 and 8 pieces; a wrapped ring buffer; a window
    # that empties tiles 0-9; pieces of two segments (32 heads)
    cases += [dict(B=1, K=1, g=8, d=128, C=64 * n, valid=64 * n - 3)
              for n in (1, 3, 8)]
    cases += [dict(S, valid=1500, window=900), dict(S, valid=800, window=150),
              dict(B=1, K=1, g=32, d=8, C=2560, valid=2500)]
    max_abs = 0.0
    for seed, case in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            args, pos, window = k3_inputs(500 + seed, dtype=dtype, **case)
            got = k3.decode_attention(*args, pos, window)
            torch.cuda.synchronize()
            want = k3.decode_attention_plain(*args, pos, window)
            rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
            ok, err = close(got, want, rtol, 1e-5)
            max_abs = max(max_abs, err)
            emit("k3_check", **case, dtype=str(dtype).split(".")[-1],
                 max_abs_err=err, tolerance=f"rtol {rtol}, atol 1e-5 x scale")
            check(ok, f"K3 {case} {dtype}: error {err} outside tolerance")
    return max_abs


def k4_inputs(seed, B, S, nh, P, N, G, chunk, dtype=torch.bfloat16):
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    xh = rnd(B, S, nh, P).to(dtype)
    Bm, Cm = rnd(B, S, G, N) * 0.5, rnd(B, S, G, N) * 0.5
    dt = torch.nn.functional.softplus(rnd(B, S, nh))
    A = -torch.exp(rnd(nh) * 0.3)
    return (xh, Bm, Cm, dt, A), chunk


def phase_k4_check(k4):
    cases = [K4_SERVE, dict(B=2, S=32, nh=16, P=8, N=16, G=1, chunk=16),
             dict(B=2, S=64, nh=4, P=16, N=16, G=2, chunk=16),
             # 16 chunks a chain (longer than a cluster could hold); one chunk
             dict(K4_SERVE, B=2, S=2048, nh=16), dict(K4_SERVE, S=128)]
    max_abs = 0.0
    for seed, case in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            args, chunk = k4_inputs(600 + seed, dtype=dtype, **case)
            y, st = k4.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            yp, sp = k4.ssd_scan_plain(*args, chunk=chunk)
            rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
            ok_y, err_y = close(y, yp, rtol, 1e-4)
            ok_s, err_s = close(st, sp, 0.0, 1e-4)
            max_abs = max(max_abs, err_y, err_s)
            emit("k4_check", **case, dtype=str(dtype).split(".")[-1],
                 y_max_abs_err=err_y, state_max_abs_err=err_s,
                 tolerance=f"y: rtol {rtol}, atol 1e-4 x scale; "
                           f"state: atol 1e-4 x scale")
            check(ok_y and ok_s, f"K4 {case} {dtype}: error y {err_y}, "
                                 f"state {err_s} outside tolerance")
    return max_abs


def k3_bound_ms(B, K, g, d, C, valid, itemsize):
    """Least time: q, the valid K and V rows, the positions and the output
    moved once over the memory rate; or 4 B H C_valid d operations (the
    two dots) over the float32 CUDA-core peak the kernel computes at
    (the bf16 tensor-core peak would only lower this side)."""
    H = K * g
    nbytes = (2 * B * H * d * itemsize + 2 * B * valid * K * d * itemsize
              + C * 4)
    flops = 4 * B * H * valid * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_k3_times(k3):
    import torch.nn.functional as F
    S = K3_SERVE
    valid = 544                      # mid-way through the 64 decode steps
    args, pos, window = k3_inputs(700, valid=valid, **S)
    q, kc, vc, cpos = args

    def kernel():
        return k3.decode_attention(q, kc, vc, cpos, pos)
    # the library call on tensors laid out for it beforehand: (B, H, 1, d)
    # query, (B, K, C, d) cache, a (1, 1, 1, C) mask broadcast over heads
    ql = q[:, :, None, :]
    kl, vl = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = ((cpos >= 0) & (cpos <= pos))[None, None, None, :]

    def library():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    torch.testing.assert_close(library()[:, :, 0].float(), kernel().float(),
                               rtol=2 ** -7, atol=2e-2)
    # cold: 36 layers' caches (302 MB, six times the L2), cycled as the
    # layers of a decode step find them
    layers = [k3_inputs(701 + i, valid=valid, **S)[0] for i in range(36)]
    turn = iter(range(10 ** 9))

    def cold():
        return k3.decode_attention(*layers[next(turn) % 36], pos)
    names = ("decode_attention_cluster",)
    b_ms, by, nbytes, flops = k3_bound_ms(valid=valid, itemsize=2, **S)
    b2b, lib_b2b = b2b_turns(kernel, library)
    row = dict(ms=time_ms(kernel),
               plain_ms=time_ms(lambda: k3.decode_attention_plain(
                   q, kc, vc, cpos, pos)),
               library_ms=time_ms(library), b2b_ms=b2b,
               library_b2b_ms=lib_b2b, cold_ms=time_ms(cold, n=72),
               cold_b2b_ms=b2b_ms(cold, n=216), bound_ms=b_ms, bound_by=by,
               peak_used="3.35 TB/s HBM; 67 TFLOP/s float32",
               bytes=nbytes, flops=flops,
               device_ms_by_function=required_split(kernel, names, "K3"),
               cold_device_ms_by_function=required_split(cold, names,
                                                         "K3 cold", n=72),
               layout_from_shape=dict(zip(
                   ("S", "tiles_per_piece", "tiles_per_segment"),
                   k3.pieces(S["B"], S["K"], S["C"], S["g"]))))
    (row["global_functions_per_call"],
     row["device_activities_per_call"]) = functions_per_call(
        kernel, names[0], "K3")
    (row["cold_global_functions_per_call"],
     row["cold_device_activities_per_call"]) = functions_per_call(
        cold, names[0], "K3 cold")
    del layers
    emit("k3_times", **S, valid=valid, dtype="bfloat16", **row,
         calls_timed=50)
    return row


def k4_bound_ms(B, S, nh, P, N, G, chunk, itemsize):
    """Least time: x and y in their dtype, B/C/dt/A and the final state in
    float32, moved once; or, per (row, head, chunk), the lower triangle
    of C.B^T (Q(Q+1)/2 x N), its product with x (Q(Q+1)/2 x P), the
    state read-out (Q x P x N) and update (P x N x Q), two operations a
    term, over the float32 CUDA-core peak (the precision the scan keeps)."""
    Q = chunk
    T = Q * (Q + 1) // 2
    nbytes = (2 * B * S * nh * P * itemsize + 2 * B * S * G * N * 4
              + B * S * nh * 4 + nh * 4 + B * nh * P * N * 4)
    flops = 2 * B * nh * (S // Q) * (T * N + T * P + 2 * Q * P * N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_k4_times(k4):
    args, chunk = k4_inputs(800, **K4_SERVE)

    def kernel():
        return k4.ssd_scan(*args, chunk=chunk)
    b_ms, by, nbytes, flops = k4_bound_ms(itemsize=2, **K4_SERVE)
    name = "ssd_scan_chunks"
    row = dict(ms=time_ms(kernel, n=20),
               plain_ms=time_ms(lambda: k4.ssd_scan_plain(*args, chunk=chunk),
                                n=20),
               library_ms=None, b2b_ms=b2b_turns(kernel)[0],
               bound_ms=b_ms, bound_by=by,
               peak_used="3.35 TB/s HBM; 67 TFLOP/s float32",
               bytes=nbytes, flops=flops,
               device_ms_by_function=required_split(kernel, (name,), "K4"))
    (row["global_functions_per_call"],
     row["device_activities_per_call"]) = functions_per_call(kernel, name,
                                                             "K4")
    emit("k4_times", **K4_SERVE, dtype="bfloat16", **row, calls_timed=20)
    return row


def serve(model, tokens, pad_to, steps):
    """`Model.prefill`, then `steps` greedy `Model.decode` steps; returns
    (prefill ms, decode ms per step, every step's logits finite, the last
    logits and cache)."""
    from repro_torch.models import greedy_sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens}, pad_to=pad_to)
    finite = torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode(cache, greedy_sample(logits)[:, None])
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps, bool(finite), logits,
            cache)


def device_profile(fn, wall_ms):
    """One call of `fn` under torch.profiler: its device time, its kernel
    launches, the device's busy share of `wall_ms` (the same work timed
    without the profiler), the six kernels with the most device time and
    K3's device time (`decode_attention_cluster`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():          # device rows: kernels, copies
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            rows.append((us / 1e3, ev.key[:90], ev.count))
    rows.sort(reverse=True)
    launches = sum(r[2] for r in rows)
    device_ms = sum(r[0] for r in rows)
    return dict(device_ms=device_ms, kernel_launches=launches,
                device_busy_share=device_ms / wall_ms if wall_ms else None,
                k3_device_ms=sum(r[0] for r in rows
                                 if "decode_attention_cluster" in r[1]),
                top=[dict(ms=ms, name=name, count=n)
                     for ms, name, n in rows[:6]])


def card_against_cpu(cfg, prompt_len, steps, tol=1e-3):
    """The same 2-layer float32 model on the card (kernels) and on the CPU
    (plain versions): identical greedy tokens, logits within `tol`."""
    from repro_torch.models import Model, greedy_sample
    cfg2 = cfg.replace(n_layers=2, dtype=torch.float32)
    cpu = Model(cfg2, device="cpu", seed=1)
    gpu = Model(cfg2)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, prompt_len)).astype(np.int32))
    gl, gc = gpu.prefill({"tokens": toks}, pad_to=prompt_len + steps)
    cl, cc = cpu.prefill({"tokens": toks}, pad_to=prompt_len + steps)
    worst, same = 0.0, True
    for step in range(steps + 1):
        worst = max(worst, float((gl.cpu() - cl).abs().max()))
        gt, ct = greedy_sample(gl)[:, None], greedy_sample(cl)[:, None]
        same &= torch.equal(gt.cpu(), ct)
        if step == steps or not same:
            break
        gl, gc = gpu.decode(gc, gt)
        cl, cc = cpu.decode(cc, ct)
    del gpu, cpu
    torch.cuda.empty_cache()
    return same, worst, tol


def phase_zoo_serving(label, name, batch, prompt_len, pad_to, steps, k3, k4,
                      want_k3, want_k4):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = Model(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(DEV)
    k3.reset_counts()
    k4.reset_counts()
    pre_ms, dec_ms, finite, logits, cache = serve(model, tokens, pad_to,
                                                  steps)
    counts = dict(k3_launches=k3.decode_attention.launches,
                  k3_plain_calls=k3.decode_attention.plain_calls,
                  k4_launches=k4.ssd_scan.launches,
                  k4_plain_calls=k4.ssd_scan.plain_calls)
    # where a step's time goes, after the counted run
    from repro_torch.models import greedy_sample
    decode_profile = device_profile(
        lambda: model.decode(cache, greedy_sample(logits)[:, None]), dec_ms)
    del cache
    prefill_profile = device_profile(
        lambda: model.prefill({"tokens": tokens}, pad_to=pad_to), pre_ms)
    params = sum(p.numel() for p in model.parameters())
    del model, logits
    torch.cuda.empty_cache()
    same, worst, tol = card_against_cpu(cfg, 64, 8)
    emit(label, model=name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=params, dtype=str(cfg.dtype).split(".")[-1], batch=batch,
         prompt=prompt_len, pad_to=pad_to, decode_steps=steps, init_s=init_s,
         prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
         logits_finite=finite, **counts,
         prefill_profile=prefill_profile, decode_step_profile=decode_profile,
         cpu_check=dict(layers=2, dtype="float32", prompt=64, steps=8,
                        identical_tokens=same, logits_max_abs_err=worst,
                        tolerance=tol))
    check(finite, f"{name}: non-finite logits")
    check(counts["k3_launches"] == want_k3
          and counts["k4_launches"] == want_k4,
          f"{name}: launches {counts}, want K3 {want_k3}, K4 {want_k4}")
    check(counts["k3_plain_calls"] == counts["k4_plain_calls"] == 0,
          f"{name}: plain-version calls {counts}")
    check(same and worst <= tol,
          f"{name}: card vs CPU tokens identical={same}, logits error {worst}")
    return counts


def main():
    smi_line = phase_device()
    phase_build()
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.kernels import knn_topk as kt
    max_abs, min_agree = phase_check(mk)
    knn_abs, knn_agree = phase_knn_check(kt)
    times = phase_times(mk)
    knn_times = phase_knn_times(kt)
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ssd_scan as k4
    k3_abs = phase_k3_check(k3)
    k4_abs = phase_k4_check(k4)
    k3_times = phase_k3_times(k3)
    k4_times = phase_k4_times(k4)
    launches, ctx = phase_main_path(mk)
    knn_counts = phase_staged(ctx, kt, mk)
    del ctx
    dense = phase_zoo_serving("dense_serving", "qwen2.5-3b", 8, 512, 1024,
                              64, k3, k4, want_k3=36 * 64, want_k4=0)
    ssm = phase_zoo_serving("ssm_serving", "mamba2-1.3b", 4, 1024, 1024, 32,
                            k3, k4, want_k3=0, want_k4=48)
    main8, knn1 = times[8], knn_times[1]
    print(json.dumps({"kernels": [{
        "name": "decision_megakernel", "route": "cuda",
        "source": "src/repro_torch/csrc/decision_megakernel.cu",
        "replaces": "src/repro/kernels/decision_megakernel.py:283",
        "function": "decision_call",
        "launches": launches[12.0], "launches_30rps": launches[30.0],
        "checked_against_plain": True, "max_abs_err": max_abs,
        "min_choice_agreement_normal": min_agree,
        "ms": main8["ms"], "plain_ms": main8["plain_ms"],
        "bound_ms": main8["bound_ms"], "bound_by": main8["bound_by"],
        "library_ms": None, "b2b_ms": main8["b2b_ms"],
        "device_ms_by_function": main8["device_ms_by_function"],
        "global_functions_per_call": main8["global_functions_per_call"],
        "device_activities_per_call": main8["device_activities_per_call"],
        "shape": {"K": 1, "R": 8, "I": 16, "N": N_INDEX,
                                      "E": E, "M": M},
        "by_R": {str(R): v for R, v in times.items()}}, {
        "name": "knn_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/knn_topk.cu",
        "replaces": "src/repro/kernels/knn_topk.py:83",
        "function": "knn_topk",
        "launches": sum(knn_counts.values()), "launches_by_run": knn_counts,
        "checked_against_plain": True, "max_abs_err": knn_abs,
        "min_idx_row_agreement_normal": knn_agree,
        "ms": knn1["ms"], "plain_ms": knn1["plain_ms"],
        "bound_ms": knn1["bound_ms"], "bound_by": knn1["bound_by"],
        "library_ms": None, "composite_ms": knn1["composite_ms"],
        "b2b_ms": knn1["b2b_ms"], "composite_b2b_ms": knn1["composite_b2b_ms"],
        "device_ms_by_function": knn1["device_ms_by_function"],
        "global_functions_per_call": knn1["global_functions_per_call"],
        "device_activities_per_call": knn1["device_activities_per_call"],
        "shape": {"B": 1, "N": N_INDEX, "E": E, "k": K_NN},
        "by_B": {str(B): v for B, v in knn_times.items()}}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:87",
        "function": "decode_attention",
        "launches": dense["k3_launches"], "checked_against_plain": True,
        "max_abs_err": k3_abs, "ms": k3_times["ms"],
        "plain_ms": k3_times["plain_ms"], "bound_ms": k3_times["bound_ms"],
        "bound_by": k3_times["bound_by"],
        "library_ms": k3_times["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "b2b_ms": k3_times["b2b_ms"],
        "library_b2b_ms": k3_times["library_b2b_ms"],
        "cold_ms": k3_times["cold_ms"], "cold_b2b_ms": k3_times["cold_b2b_ms"],
        "device_ms_by_function": k3_times["device_ms_by_function"],
        "cold_device_ms_by_function":
            k3_times["cold_device_ms_by_function"],
        "global_functions_per_call": k3_times["global_functions_per_call"],
        "device_activities_per_call": k3_times["device_activities_per_call"],
        "cold_global_functions_per_call":
            k3_times["cold_global_functions_per_call"],
        "layout_from_shape": k3_times["layout_from_shape"],
        "shape": dict(K3_SERVE, valid=544, dtype="bfloat16")}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:87",
        "function": "ssd_scan",
        "launches": ssm["k4_launches"], "checked_against_plain": True,
        "max_abs_err": k4_abs, "ms": k4_times["ms"],
        "plain_ms": k4_times["plain_ms"], "bound_ms": k4_times["bound_ms"],
        "bound_by": k4_times["bound_by"], "library_ms": None,
        "b2b_ms": k4_times["b2b_ms"],
        "device_ms_by_function": k4_times["device_ms_by_function"],
        "global_functions_per_call": k4_times["global_functions_per_call"],
        "device_activities_per_call": k4_times["device_activities_per_call"],
        "shape": dict(K4_SERVE, dtype="bfloat16")}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
