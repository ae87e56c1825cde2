"""Drive the PyTorch/CUDA port of RouteBalance on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits nonzero
(phases 4b, 5b and 5c drive the KNN lookup kernel K2 and its paths):

  1. device — the card, `nvidia-smi`'s name and power limit, TF32 flags;
  2. build  — compile the CUDA sources of `src/repro_torch/csrc/`;
  3. check  — the decision kernel against its plain PyTorch version on
     the card, at the main path's shapes (N=14,886 x E=128 index, M=4,
     four 60-tree depth-3 TPOT heads, I=16 with 13 alive, R in
     {8, 64, 256}) plus I=128, K=2 windows, the affinity term, the four
     latency modes, LPT and the budget filter on and off, the GBM off:
     on dyadic inputs (multiples of 1/8, so every distance is exact)
     choice/b1/f1 must be identical and est_T/l_chosen/d1 within rtol
     1e-5; on random normal inputs choice must agree on >= 99% of rows;
  4. times  — kernel and plain version, median of 50 CUDA-event-timed
     calls after warm-up, beside the least time the card could take, and
     the profiler's device time of each of the kernel's two functions;
  3b. knn check — the KNN lookup kernel against its plain version on the
     main-path index (N=14,886 x E=128, k=10) at B in {1, 8, 64, 256},
     plus N=1,000 with k=32 and bf16 input: on dyadic inputs idx and d2
     identical; on random normal inputs idx agreeing on >= 99% of rows
     and d2 within rtol 1e-5;
  4b. knn times — as phase 4 for B in {1, 8, 64, 256}, beside the time
     of the composite PyTorch expression (matmul + torch.topk) that a
     later kernel is held to;
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
N_INDEX, E, M, N_TIERS, N_TREES, DEPTH = 14886, 128, 4, 4, 60, 3
K_NN = 10


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# -- synthetic decision inputs at the main path's shapes -----------------------

def make_case(seed, R, I, n_alive, K=1, dyadic=True, w_aff=0.0,
              use_gbm=True, mode="full", lpt=True, budget_filter=True,
              dev="cuda"):
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
    rv[:, R - max(1, R // 4):] = False           # pad rows
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


def device_split_ms(fn, names=("knn_partial_topk", "decision_scan"), n=20):
    """Device time per call of each named __global__ function, from the
    profiler's CUDA activity (empty when the profiler sees no device
    time)."""
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
                out[name] = us / n / 1e3
    return out


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


# -- phases -----------------------------------------------------------------------

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
        split = device_split_ms(kernel)
        b_ms, by, nbytes, flops = bound_ms(tensors, statics,
                                          neighbour_rows(tensors))
        rows[R] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       bytes=nbytes, flops=flops, library_ms=None,
                       device_ms_by_function=split or "not measured")
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
    cases = [dict(B=B, N=N_INDEX, k=K_NN) for B in (1, 8, 64, 256)]
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
        rows[B] = dict(
            ms=time_ms(kernel),
            plain_ms=time_ms(lambda: kt.knn_topk_plain(q, x, K_NN, xsq)),
            composite_ms=time_ms(composite), bound_ms=b_ms, bound_by=by,
            bytes=nbytes, flops=flops, library_ms=None,
            device_ms_by_function=device_split_ms(
                kernel, names=("knn_topk_partial", "knn_topk_merge"))
            or "not measured", splits=kt.n_splits(B, N_INDEX, q.device))
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


def main():
    smi_line = phase_device()
    phase_build()
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.kernels import knn_topk as kt
    max_abs, min_agree = phase_check(mk)
    knn_abs, knn_agree = phase_knn_check(kt)
    times = phase_times(mk)
    knn_times = phase_knn_times(kt)
    launches, ctx = phase_main_path(mk)
    knn_counts = phase_staged(ctx, kt, mk)
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
        "library_ms": None, "shape": {"K": 1, "R": 8, "I": 16, "N": N_INDEX,
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
        "shape": {"B": 1, "N": N_INDEX, "E": E, "k": K_NN},
        "by_B": {str(B): v for B, v in knn_times.items()}}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
