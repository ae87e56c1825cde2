"""Drive the PyTorch/CUDA port of RouteBalance on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits nonzero
(phases 4b, 5b and 5c drive the KNN lookup kernel K2 and its paths):

  1. device — the card, `nvidia-smi`'s name and power limit, TF32 flags;
  2. build  — compile the CUDA sources of `src/repro_torch/csrc/`;
  3. check  — the decision kernel against its plain PyTorch version on
     the card, at the main path's shapes (N=14,886 x E=128 index, M=4,
     four 60-tree depth-3 TPOT heads, I=16 with 13 alive, R in
     {8, 64, 256}, and one request in the R=8 bucket) plus I=128,
     I=4096 (the shared carry's largest), I=4097 and I=16,384 (the
     global carry), K=2 windows, the affinity term, the four latency modes,
     LPT and the budget filter on and off, the GBM off:
     on dyadic inputs (multiples of 1/8, so every distance is exact)
     choice/b1/f1 must be identical and est_T/l_chosen/d1 within rtol
     1e-5; on random normal inputs (I=16 and 16,384) choice must agree
     on >= 99% of rows;
  4. times  — kernel and plain version, median of 50 CUDA-event-timed
     calls after warm-up, beside the least time the card could take, and
     the profiler's device time of the kernel's one function; back to
     back: CUDA events around 200 launches / 200, twice; fails if 20
     profiled calls run anything on the device but at most 20 launches
     of that function (as 4b, 4c and 4d do for K2, K3 and K4); then K1
     at I=16,384 (R=8, 16) with its device time without the TPOT heads,
     and K1's device time with each carry about the boundary between
     them (I = 1,024 to 8,192), the two carries' outputs bitwise equal;
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
     empties whole tiles and pieces of two segments, then the decode
     shapes of phase 5h's families (`K3_ZOO`: recurrentgemma's g = 10,
     d = 256 ring wrapped at 2,048, phi-3-vision's d = 96, granite-moe's
     g = 3, whisper's 1,500-frame cross-attention and 448-slot ring,
     mixtral's g = 4), of phase 5i's trained granite-3-2b (g = 4,
     d = 64, 528 slots) and of phase 5l's and 5m's ranks (granite-moe
     B = 4, 12 / 4 heads; granite-3-2b B = 4, 16 / 4 heads; qwen2.5-3b
     under its cut KV heads, 128 of 512 slots all, 8 and none valid,
     its (max, exp-sum) held too; of phase 5n's ranks: recurrentgemma
     B = 2, g = 10, d = 256 over 1,024 of 2,048 ring slots with the
     stats, whisper's 3 heads of 64 over 448 self slots and 1,500 cross
     frames), with their shared memory against the opt-in
     limit, in bf16 and float32: float32 within 1e-5 of the output's
     scale, bf16 within one unit in the last place (2^-7 relative) plus
     that;
  3d. k4 check — the SSD scan kernel K4 against its plain version at the
     SSM serving shape (B=4, S=1,024, nh=64, P=64, N=128, G=1, chunk 128),
     at S=2,048 (16 chunks a chain), at one chunk (S=128), at phase 5i's
     B=2, at phase 5m's rank (B=2, nh=32) and at the smoke shapes, in bf16 and float32: y and the final state within
     1e-4 of their scale (bf16 y within 2^-7 relative plus that);
  4c/4d. k3/k4 times — as phase 4 at the serving shapes, beside the bound
     and, for K3, `F.scaled_dot_product_attention` on pre-laid-out
     tensors (the port never calls it), back to back in turns (K3: kernel,
     SDPA, SDPA, kernel); K3 also with its caches cold, cycling over 36
     layers' caches (302 MB) as a decode step finds them; 4c fails if
     the profiler sees no device time for K3's one function, or if 20
     profiled calls, warm or cold, run anything on the device but at
     most 20 launches of it, and 4d the same for K4's one function; K3
     once more, warm, at recurrentgemma's shape (bf16, ring full);
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
  3e. multi-window — K in {2, 3, 4, 5, 8} windows of unequal R (3 and 5
     pad to 4 and 8 windows of invalid rows) in one decision-kernel call
     at the main path's shapes, held against the plain version (every
     output identical on dyadic inputs; on random normal ones choices
     agreeing on >= 99% of the valid rows, est_T/l_chosen within rtol
     1e-5 on those, d1 within rtol 1e-5 and b1/f1 identical on windows
     whose choices all agree) and against the kernel's call on each
     window alone (choices identical, est_T/l_chosen/d1 exact on dyadic
     inputs and within rtol 1e-5 on random normal ones); then
     through the hot path (`FusedHotPath.decide_cols_multi` against
     `decide_cols` per window, the quickstart's bundle and pool with
     mid-run telemetry): identical choices, l_chosen within rtol 1e-5;
     one `__global__` function per K-window call; one K-window call
     timed against K single calls at R = 8 (wrapper call, device, and
     hot path with its fetch), for K in {2, 4, 8};
  5f. scenarios — the fault-tolerant, elastic serving path on the
     megakernel backend, `charge_compute=False`, each world's bundle
     trained on the card at `Scenario.build()`'s dataset size (1,200):
     `chaos_world` under a crash storm, a correlated failure, a hedged
     straggler storm, telemetry blackouts of half and all the fleet (and
     all of it for 6 s under 3x the load on the latency preset, where
     the watchdog declares the mirror dark) and a crash storm with
     recovery off; `elastic_chaos`
     under a crash storm; `diurnal_elastic`, `flashcrowd_elastic`;
     `failover`, `cluster` (48 instances), `multitenant`,
     `session_chat` at affinity 0.5; `hyperscale` (16 tiers x 128).
     Each: every request terminal once; none failed where recovery is
     armed; the counters each cell exists for above zero (retries,
     hedges, quarantines, degraded decisions, scale-ups, sheds); K1
     launches = fired batches less degraded ones (the recovery
     manager's `degraded_batches`), no plain call. Each cell then runs
     again with the kernel's wrapper tapped (`decision_megakernel.tap`):
     the same completions and calls; one argument shape per (K, R)
     bucket, as many as the hot path's shape variants (no variant from
     roster churn); the recorded first call, calls after roster events
     (up to 6), every 16th call and the last call held against the plain
     version on the same tensors as 3e holds random normal inputs. Then a
     controller crash at t = 5.3 resumed from a `CheckpointManager` on
     disk: completions identical to the uncrashed run's. Then
     `hyperfleet_10k`: 500 of its requests on the staged torch backend
     with one K2 launch per scoring call, then as one controller
     through K1 (10,000 instances, bucket 16,384: the global carry;
     launches = fired batches less degraded ones, no plain call, shape
     variants = R buckets, completions identical to the staged run; at
     most 8 recorded calls held against the plain version as above);
     every 16th lookup of the staged run and the last,
     recorded through `knn_topk.tap`, held against the plain version
     (idx rows identical on >= 99%, d2 within rtol 1e-5 plus 1e-6 of
     its scale);
  5g. hierarchy — `repro_torch.serving.hierarchy` on the card,
     `charge_compute=False`: `cluster` (48 instances, 400 requests) at
     one balanced cell against the single controller (identical
     per-request trajectories) and at two cells with `RecoveryConfig()`
     (every request terminal once, none failed, retries > 0 and the cell
     managers' retries summing to the router's); `hyperfleet_10k` on
     500 requests in balanced cells at 16 (K1 at I = 1,024) and 32
     (I = 512) cells with exact digests and at 16 with int8 digests
     (terminal once, K1 launches = the cells' fired batches less degraded
     ones, no plain call, no K2 launch, each cell's shape variants equal
     to its R buckets, digests on the wire), the exact runs once more
     with `decision_megakernel.tap` (the same completions; the first
     call, every 16th and the last held against the plain version as 5f
     holds its calls), each beside 5f's staged and flat K1 decide ms a
     request; span at 16 cells on the staged torch backend with
     K2 (completions identical to 5f's unsharded staged run, one K2
     launch per scoring call, no K1 launch), and span on `cluster` at 2
     cells (100 requests; each decision's choice and est_T kept for 5k,
     as for the 16-cell run); K1 alone at I = 512 and
     1,024 (R = 8, 64): exact against the plain version on dyadic inputs,
     then call ms, device ms and bound, and at R = 8 the device ms
     without the TPOT heads; the cells' hot-path clocks per call; and
     `python -m repro_torch.launch.serve --scenario cluster --cells 2
     --n 200` as a subprocess (2 cells, digests on the wire, every
     request terminal once: the scenario's kill at t = 6 s fails what
     runs there, recovery being off);
  5h. zoo families — at full width, random seeded bf16 weights drawn on
     the card, through `Model.prefill` / `Model.decode`:
     `recurrentgemma-2b` (26 layers, 4 x 2,048, ring wrapped, 8 steps),
     `granite-moe-3b-a800m` (32, 8 x 512, pad_to 1,024, 8 steps),
     `phi-3-vision-4.2b` (32, 4 x 576 image embeddings + 64 tokens, pad_to
     1,024, 8 steps), `whisper-tiny` (4 + 4, 8 x 1,500 frames, 4
     decoder tokens, 8 steps) and `mixtral-8x7b` (8 of 32 layers, cut
     to fit the card; 4 x 512, pad_to 1,024, 8 steps): finite logits, K3
     launches = attention calls x steps, no K4 launch, no plain call,
     MoE pairs dropped at prefill capacity and none at decode, prefill
     and decode ms with the profiler's device time, busy share and K3's
     device time; then each in float32 over a whole layer pattern
     (recurrentgemma 3 layers, whisper 2 + 2, the others 2), weights
     drawn on the card, run there and then moved to the CPU: identical
     greedy tokens, logits within 1e-3;
  5i. training — the zoo's training path (`Model.value_and_grad`,
     `launch.steps.make_train_step`, AdamW, `training.train_loop.train`,
     `python -m repro_torch.launch.train`) on the card: one float32 train
     step of each family's smoke variant (dense GQA, Mamba-2, RG-LRU, MoE,
     vision, encoder-decoder) and of granite-3-2b cut to one layer at
     full width (1 x 1,024 tokens), card against CPU (`TRAIN_TOL`: loss,
     ce, aux, grad_norm within 1e-5 relative; each gradient leaf within
     1e-4 of its scale; each parameter after the AdamW step, at its peak
     lr of 1e-3, within 1e-4 of its scale plus the most the measured
     gradient difference can move AdamW's step there, and every leaf's
     update larger than that limit, so that a missing one would show);
     `granite-3-2b` at full width (40 layers, bf16,
     remat, 4 x 4,096 tokens in 2 microbatches: 1 warm-up and 1 timed
     step) and `mamba2-1.3b` (48 layers, 2 x 4,096: 1 + 1): finite loss,
     grad_norm, lr, ms, tokens/s and peak memory each step, one step under
     the profiler (device ms, busy share, six leading operations), the
     model FLOPs beside their time at the bf16 peak and the float32
     attention products run beside theirs at the float32 peak, no K3/K4
     call while training; then the trained weights serve: granite-3-2b
     4 x 512 and 16 greedy steps (K3 launches = 40 x 16), mamba2-1.3b one
     2 x 1,024 prefill (K4 launches = 48), no plain call, and in float32
     on the card and then on the CPU, as in 5h (2 x 64, 8 steps:
     identical greedy tokens, logits within 1e-3); then
     `examples/torch_train_small.py --preset tiny` (the loss falls by
     more than 0.3 over 40 steps) and with `--compress-grads`, a run cut
     at step 15 (checkpoints every 10) resumed to 25 (losses within 1e-6
     of the uncut run's, bitwise reported), and `python -m
     repro_torch.launch.train --smoke --steps 5` as a subprocess;
  5k. span over torch.distributed — this process rank 0 of a gloo group,
     the other ranks (every group's, spawned at the phase's start) on
     the same card in `cell_worker`, the
     ``("cell",)`` mesh pinned with `sharding_rules`: `cluster` (100
     requests) over 2 and over 4 ranks, `hyperfleet_10k` (5f's 500
     requests, 4,096 padded columns a rank) over 4: completions, every
     decision's choice and est_T identical to 5g's emulation, one K2
     launch on rank 0 per scoring call, 4 all-reduces a scanned row plus
     1 a scan and 3 broadcasts a scan, every worker joined as many
     collectives as rank 0 (plus the stop header) and exited 0; NCCL
     with one rank per card when the machine has 4 cards, else a line
     saying it was not run and why; then `python -m
     repro_torch.launch.serve --scenario cluster --cells 2 --cell-routing
     span --dist-backend gloo` in two processes started as torchrun
     starts them (its JSON names the backend and counts the
     collectives; every request terminal once);
  5l. model distribution — (a) `python -m repro_torch.launch.dryrun
     --all` and `--all --multi-pod`, one subprocess a shape, all at once
     (CPU work): 0 errors, exactly the reference's skips (long_500k for the 7
     full-attention archs on both meshes), the per-device GB of
     mixtral-8x7b and gemma3-27b `train_4k`, and (5m(c)) FLOPs, HBM
     bytes, collectives and peak bytes per device on all 66 ok cells
     (train cells included since 5n); (b)
     `granite-moe-3b-a800m` at full width (D = 1,536, 24 / 8 heads, 40
     experts, d_ff 512, top-8, 32 layers) in float32, served as 5m
     serves (below): 8 x 512 prompts (pad_to 1,024), 4 rows a data
     shard, prefill and 8 greedy steps, each rank with 12 query / 4 KV
     heads and half of every expert's d_ff; K3 = 32 x 8 a rank; (c)
     `shardmap_allreduce` of each rank's 64 MB float32 gradient on the
     same ranks over ("data",) and ("data", "model"): bitwise the
     one-process arithmetic, its ms; NCCL (a card a rank) is written,
     not run (one card);
  5m. the placement plans run — `granite-3-2b` (a: 40 layers, D =
     2,048, 32 / 8 heads, d_ff 8,192, vocabulary 49,155 padded to
     49,408) and `mamba2-1.3b` (b: 48 layers, 64 SSD heads) at full
     width and depth in float32 on 4 gloo ranks on the one card (one
     spawn with 5l(b, c)), mesh (data 2, model 2), weights drawn on the
     card from one seed and cut to each rank's pieces by the plan
     (`lower_cell`, `shard_params`): (a) 8 x 512 prompts (pad_to
     1,024), 4 rows a data shard, prefill and 8 greedy steps (cut from
     16: the script's time) through
     `lower_cell`'s steps, each rank's K3 on its 16 query / 4 KV heads;
     (b) 4 x 1,024, prefill and 8 steps, K4 on 32 heads a rank; each
     shard's tokens identical to one process on its rows, logits (the
     "model" ranks' vocabulary shares put together) within 1e-3, every
     "model" rank with the same tokens, the collectives per forward as
     predicted (`tp_want`), K3 = 40 x 8 and K4 = 48 launches a rank, no
     plain call; prefill ms, decode ms a step and peak memory a rank
     beside one process; (c) is 5l(a); (d) `qwen2.5-3b` at full width,
     4 of its 36 layers, on (data 1, model 4): its 2 KV heads of 128
     cut to a quarter head a rank, the cache on its slots, K3 over the
     rank's slots with every head returning its (max, exp-sum), the
     ranks' outputs merged over "model"; 4 x 256 (pad_to 512), 8 steps,
     tokens identical to one process, logits within 1e-3, the
     collectives as predicted, K3 = 4 x 8 a rank;
  5n. the hybrid, the encoder-decoder and the train step under the
     plans — in 5l/5m's spawn of 4 gloo ranks, mesh (data 2, model 2),
     float32, weights drawn on the card from one seed and cut by
     `lower_cell` / `shard_params`: (a) `recurrentgemma-2b` at full width
     and depth (26 layers, 8 of them local attention; W = 2,560;
     vocabulary 256,000), 2 rows a data shard x 2,048 tokens, prefill
     and 8 greedy steps (the 2,048-slot ring wraps): the RG-LRU on 1,280
     channels a rank, u gathered for the gates, the one KV head cut and
     K3 over the rank's 1,024 slots with the stats, K3 = 8 x 8 a rank;
     (b) `whisper-tiny` at full width (4 + 4 layers, 3 of 6 heads of 64
     a rank), 4 rows a shard x 1,500 frames, 4 prompt tokens, 16 steps,
     K3 = 2 x 4 x 16 a rank; each as 5m holds its archs (tokens
     identical to one process, logits within 1e-3, every "model" rank
     the same tokens, the collectives `tp_want`'s, no plain call); (c)
     `granite-3-2b` at full width, 20 of its 40 layers (4 ranks' float32
     weights, gradients and ZeRO moments share the card), remat, a
     4 x 1,024 global batch: the train step under the plan
     (`make_train_step(..., plan=, mesh=)`), its first step held against
     one process on the same batch, weights and moments (m = 0, v =
     1e-4): loss, ce and grad_norm within 1e-5 relative, 512 sampled
     elements of every moment's and parameter's piece within 1e-4 of
     the piece's scale; then 1 more step (the loss finite and falling)
     and one of 2 microbatches; step ms, peak GB a rank beside one
     process's, the collectives a step by kind;
  5o. overrides and the soak — (a) the reference's randomized soak
     worlds through K1: `random_scenario` seeds 0-3 at up to 16 tiers x
     128 instances (bundles trained on the card), 200 requests each on
     the world's own failure schedule, affinity weights 0 and 0.5:
     K1 launches = fired batches less degraded ones, no plain call; the
     same run with K1's wrapper tapped, the same completions, every
     recorded call held against the plain version as 5f holds its
     calls; the staged torch backend on the card, the same completions
     and no K1 launch; I, calls and decide ms a request per world; (b)
     in 5l-5n's spawn, `granite-3-2b` with `{"vocab_pad_to": 1}`
     planned as configured (49,155 rows do not divide over "model", so
     the embedding and the logits are split over d_model: the rank's
     columns all-gathered, its partial logits summed) at full width and
     depth, float32, 8 x 512, 8 steps on (data 2, model 2), held as 5m
     holds its archs (tokens identical to one process, logits within
     1e-3, the collectives `tp_want`'s, K3 40 x 8 a rank, no plain
     call);
  5j. examples — `examples/torch_{quickstart, budget_serving,
     serve_cluster, zoo_serving}.py` at the reference's sizes as a user
     runs them (their printed lines kept): every request terminal once,
     K1 launches = the RouteBalance arms' fired batches, K2 launches =
     the BEST-Route arms' scoring calls (serve_cluster), no plain call,
     and the recorded K1 calls (the first, every 16th, the last) held
     against the plain version;
  6. the kernels line (launches of every driven path: K1 the main path,
     5f and 5g's hierarchy, 5j's examples and 5o(a)'s soak, K2 5b, 5c,
     5f's hyperfleet, 5g's span, 5k's span over ranks and 5j's
     serve_cluster, K3 5d, 5h by model, 5i's trained granite, 5l's,
     5m's, 5n's and 5o(b)'s ranks by part and model, K4 5e,
     5i's trained mamba2 and 5m's ranks),
     then the card's `nvidia-smi` line, then the last line
     `{"ok": true, "device": {...}}`.

It imports torch, numpy, the standard library and `repro_torch` (from
`src/` beside this file), never jax and nothing of the JAX package.
"""
import json
import os
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


T_START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line: the phase, the script's seconds so far, the rest."""
    print(json.dumps({"phase": phase,
                      "t_s": time.perf_counter() - T_START, **kw}),
          flush=True)


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
    of the trees each node once: the nodes walked, or where the walks
    cover more, the trees of the tiers in the roster) over the memory
    rate, or float32 operations over the CUDA-core peak, whichever is
    larger."""
    emb, rv, bud, lin = tensors[:4]
    K, R, _ = emb.shape
    I = tensors[5].shape[0]
    per_row = 4 * E + 1 + 4 + 4
    per_inst = 4 * 8 + 1 + 4 * 2
    nbytes = (K * R * per_row + N_INDEX * E * 4 + N_INDEX * 4
              + n_neighbour_rows * M * 4 * 2 + I * per_inst
              + K * R * 12 + K * I * 12)
    if statics["use_gbm"]:
        n_tiers = int(torch.unique(tensors[15]).numel())
        per_tier = N_TREES * ((2 ** DEPTH - 1) * 8 + 2 ** DEPTH * 4) + 4
        nbytes += min(I * N_TREES * (DEPTH * 8 + 4), n_tiers * per_tier)
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
        # one request in the R = 8 bucket; the shared carry's largest
        # roster; the global carry one past it and at hyperfleet_10k's
        # bucket (one window, and two with the affinity term)
        dict(R=8, I=16, n_alive=13, valid=1),
        dict(R=64, I=4096, n_alive=4000),
        dict(R=64, I=4097, n_alive=4097),
        dict(R=16, I=16384, n_alive=10000),
        dict(R=16, I=16384, n_alive=10000, K=2, w_aff=0.5),
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
    # the global carry on random normal inputs: choices on >= 99% of the
    # rows, est_T and l_chosen within rtol 1e-5 where they agree
    tensors, statics = make_case(116, R=16, I=16384, n_alive=10000,
                                 dyadic=False)
    rows, agree, rel = hold_k1(kernel_out(mk, tensors, statics),
                               plain_reference(mk, tensors, statics),
                               tensors[1].cpu().numpy(), False,
                               "K1 I=16384 normal")
    agreements.append(agree / rows)
    emit("check", inputs="normal", R=16, I=16384, choice_agreement=agree / rows,
         est_T_l_chosen_max_rel_err_on_agreeing_rows=rel)
    check(agree >= 0.99 * rows, f"I=16384: choice agreement {agree}/{rows}")
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


def phase_times_wide(mk):
    """K1 at hyperfleet_10k's roster bucket (I = 16,384 with 10,000
    alive: the global carry) for R = 8 and 16, timed as phase 4 times
    it (call, device, plain, bound), with the device time once more
    without the TPOT heads' trees (their share: a warp an instance)."""
    rows = {}
    for I, R, n_alive in ((16384, 8, 10000), (16384, 16, 10000)):
        tensors, statics = make_case(900 + R, R=R, I=I, n_alive=n_alive,
                                     dyadic=False)

        def kernel():
            return mk.decision_megakernel(*tensors, **statics)
        b_ms, by, nbytes, flops = bound_ms(tensors, statics,
                                           neighbour_rows(tensors))
        off, st_off = make_case(900 + R, R=R, I=I, n_alive=n_alive,
                                dyadic=False, use_gbm=False)
        row = dict(I=I, R=R, K=1, alive=n_alive, ms=time_ms(kernel, n=20),
                   plain_ms=time_ms(lambda: mk.decision_megakernel_plain(
                       *tensors, **statics), n=10),
                   bound_ms=b_ms, bound_by=by, bytes=nbytes, flops=flops,
                   device_ms=required_split(
                       kernel, (K1_FUNCTION,), f"K1 I={I} R={R}",
                       n=10)[K1_FUNCTION],
                   device_ms_gbm_off=required_split(
                       lambda: mk.decision_megakernel(*off, **st_off),
                       (K1_FUNCTION,), f"K1 I={I} R={R} GBM off",
                       n=10)[K1_FUNCTION])
        (row["global_functions_per_call"],
         row["device_activities_per_call"]) = functions_per_call(
            kernel, K1_FUNCTION, f"K1 I={I} R={R}", n=10)
        rows[f"I={I},R={R}"] = row
        emit("times_wide", **row)
    return rows


def phase_carry_boundary(mk):
    """Where the scan's carry moves from shared to global memory: K1 on
    the same random-normal inputs with each carry, at rosters about
    `MAX_SHARED_I` (the hierarchy's cell bucket 1,024, 4,096, and 8,192,
    where the shared carry still fits up to R = 16). The wrapper picks
    the carry by `MAX_SHARED_I`, which is set around each timing: 0 for
    the global carry, past any roster for the shared one. The two
    carries' outputs must be bitwise equal; device ms (profiler, 20
    calls) are taken in turns shared, global, global, shared."""
    rows = {}
    saved = mk.MAX_SHARED_I
    for I, R in ((1024, 8), (1024, 64), (4096, 8), (4096, 16), (4096, 64),
                 (8192, 8), (8192, 16)):
        tensors, statics = make_case(950 + I + R, R=R, I=I,
                                     n_alive=I * 5 // 8, dyadic=False)

        def kernel():
            return mk.decision_megakernel(*tensors, **statics)
        times, outs = {"shared": [], "global": []}, {}
        try:
            for carry in ("shared", "global", "global", "shared"):
                mk.MAX_SHARED_I = 0 if carry == "global" else 1 << 30
                outs.setdefault(carry, [o.cpu() for o in kernel()])
                times[carry].append(required_split(
                    kernel, (K1_FUNCTION,), f"K1 I={I} R={R} {carry}")
                    [K1_FUNCTION])
        finally:
            mk.MAX_SHARED_I = saved
        check(all(torch.equal(a, b)
                  for a, b in zip(outs["shared"], outs["global"])),
              f"K1 I={I} R={R}: the global carry differs from the shared")
        row = dict(I=I, R=R, device_ms_shared=times["shared"],
                   device_ms_global=times["global"],
                   global_over_shared=sum(times["global"])
                   / sum(times["shared"]),
                   runs=("shared" if I <= saved else "global"))
        rows[f"I={I},R={R}"] = row
        emit("carry_boundary", bitwise_equal=True, **row)
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


# -- multi-window dispatch on K1 (phase 3e) ------------------------------------

MW_SIZES = (8, 5, 3, 7, 1, 6, 2, 4)     # rows of the K windows, R bucket 8
MW_KS = (2, 3, 4, 5, 8)                 # 3 and 5 pad to 4 and 8 windows


def k1_counts(mk):
    """(calls that went to the decision kernel, calls that went to its
    plain version); on the CPU (a rehearsal, DEV = "cpu") the plain
    version's calls stand in for launches."""
    f = mk.decision_megakernel
    return ((f.launches, f.plain_calls) if DEV == "cuda"
            else (f.plain_calls, 0))


def k2_counts(kt):
    """(calls that went to the KNN kernel, calls to its plain version);
    on the CPU (DEV = "cpu") the plain calls stand in for launches."""
    f = kt.knn_topk
    return ((f.launches, f.plain_calls) if DEV == "cuda"
            else (f.plain_calls, 0))


def window_slice(tensors, w):
    """The arguments of one window of a K-window call, as a K = 1 call."""
    return [t[w:w + 1].contiguous() if j < 4 else t
            for j, t in enumerate(tensors)]


def multiwindow_case(seed, K, dyadic):
    """make_case at the main path's shapes with K windows of unequal R
    (MW_SIZES) in the R = 8 bucket; windows pad to a power of two with
    windows of invalid rows."""
    from repro_torch.core.decision import bucket_pow2
    Kb = bucket_pow2(K, lo=1)
    tensors, statics = make_case(seed, R=8, I=16, n_alive=13, K=Kb,
                                 dyadic=dyadic, dev=DEV)
    rv = tensors[1]
    rv[:] = False
    for w in range(K):
        rv[w, :MW_SIZES[w]] = True
    return tensors, statics


def hold_k1(got, want, rv, exact, label):
    """Hold a decision-kernel call's outputs against the plain version's
    on the same inputs. Exact (dyadic inputs): every output identical.
    Otherwise: choices agree on >= 99% of the valid rows, est_T and
    l_chosen within rtol 1e-5 on the agreeing rows, and on each window
    whose valid choices all agree d1 within rtol 1e-5 and b1/f1
    identical. Returns (valid rows, agreeing rows, max relative error)."""
    if exact:
        for j, name in enumerate(("choice", "est_T", "l_chosen", "d1", "b1",
                                  "f1")):
            check(np.array_equal(got[j], want[j]),
                  f"{label}: {name} differs from the plain version")
        return int(rv.sum()), int(rv.sum()), 0.0
    agree = (got[0] == want[0]) & rv
    worst = 0.0
    for j, name in ((1, "est_T"), (2, "l_chosen")):
        a, b = got[j][agree], want[j][agree]
        if a.size:
            worst = max(worst, float((np.abs(a - b) / np.maximum(
                np.abs(b), 1e-30)).max()))
        check(np.allclose(a, b, rtol=1e-5, atol=0),
              f"{label}: {name} outside rtol 1e-5 of the plain version")
    for w in range(rv.shape[0]):
        if (agree[w] == rv[w]).all():
            check(np.allclose(got[3][w], want[3][w], rtol=1e-5, atol=0)
                  and np.array_equal(got[4][w], want[4][w])
                  and np.array_equal(got[5][w], want[5][w]),
                  f"{label} window {w}: d1/b1/f1 differ from the plain "
                  "version")
    return int(rv.sum()), int(agree.sum()), worst


def phase_multiwindow(mk, ctx):
    """K windows in one decision-kernel call against its plain version
    and against one kernel call per window: at the wrapper (dyadic and
    random normal inputs, and one __global__ function per K-window call)
    and through the hot path (`FusedHotPath.decide_cols_multi` against
    `decide_cols` on the same telemetry); then one K-window call timed
    against K single calls."""
    from repro_torch.core import RBConfig, make_requests
    from repro_torch.core.hotpath import FusedHotPath
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import randomize_telemetry
    out = {}
    for K in MW_KS:
        row = {}
        for dyadic in (True, False):
            tensors, statics = multiwindow_case(500 + K, K, dyadic)
            multi = kernel_out(mk, tensors, statics)
            want = plain_reference(mk, tensors, statics)
            n_rows, n_agree, rel_plain = hold_k1(
                multi, want, tensors[1].cpu().numpy(), dyadic, f"K={K}")
            check(n_agree >= 0.99 * n_rows, f"K={K}: choice agreement "
                  f"{n_agree}/{n_rows} with the plain version < 0.99")
            worst = 0.0
            for w in range(K):
                one = kernel_out(mk, window_slice(tensors, w), statics)
                valid = tensors[1][w].cpu().numpy()
                check(np.array_equal(multi[0][w][valid], one[0][0][valid]),
                      f"K={K} window {w}: choice differs from its own call")
                for j, name in ((1, "est_T"), (2, "l_chosen")):
                    a, b = multi[j][w][valid], one[j][0][valid]
                    if dyadic:
                        check(np.array_equal(a, b), f"K={K} window {w}: "
                              f"{name} not exact on dyadic inputs")
                    else:
                        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                        worst = max(worst, float(rel.max()))
                        check(np.allclose(a, b, rtol=1e-5, atol=0),
                              f"K={K} window {w}: {name} outside rtol 1e-5")
                for j, name in ((3, "d1"), (4, "b1"), (5, "f1")):
                    check(np.array_equal(multi[j][w], one[j][0])
                          if dyadic else
                          np.allclose(multi[j][w], one[j][0], rtol=1e-5),
                          f"K={K} window {w}: {name} differs")
            row["dyadic" if dyadic else "normal"] = dict(
                exact=dyadic, max_rel_err_vs_own_call=worst,
                choice_agreement_vs_plain=n_agree / n_rows,
                max_rel_err_vs_plain=rel_plain)
        out[K] = row
        emit("multiwindow_check", K=K, windows_padded_to=int(
            tensors[0].shape[0]), rows=list(MW_SIZES[:K]), **row)
    # the hot path: the main path's bundle and pool, mid-run telemetry
    bundle, tiers, names = ctx["bundle"], ctx["tiers"], ctx["names"]
    sim = randomize_telemetry(ClusterSim(tiers, names), seed=9)
    hp = FusedHotPath(bundle, sim.instances, RBConfig())
    reqs = make_requests(ctx["ds"], "test", np.zeros(sum(MW_SIZES)),
                         encoder=bundle.encoder)
    cols = reqs[0].cols
    cuts = np.cumsum((0,) + MW_SIZES)
    rows = [np.arange(cuts[w], cuts[w + 1]) for w in range(len(MW_SIZES))]
    for K in MW_KS:
        batches = [(cols, r) for r in rows[:K]]
        multi = [lz.fetch() for lz in hp.decide_cols_multi(batches, sim.tel)]
        worst = 0.0
        for (cm, lm), (c, r) in zip(multi, batches):
            cs, ls = hp.decide_cols(c, r, sim.tel).fetch()
            check(np.array_equal(cm, cs),
                  f"hot path K={K}: a window's choice differs")
            check(np.allclose(lm, ls, rtol=1e-5, atol=0),
                  f"hot path K={K}: l_chosen outside rtol 1e-5")
            worst = max(worst, float((np.abs(lm - ls)
                                      / np.maximum(np.abs(ls), 1e-30)).max()))
        out[K]["hot_path"] = dict(identical_choices=True,
                                  l_chosen_max_rel_err=worst)
        emit("multiwindow_hot_path", K=K, **out[K]["hot_path"])
    if DEV != "cuda":
        return out
    # one K-window call against K single calls, R = 8 (no claim)
    for K in (2, 4, 8):
        tensors, statics = multiwindow_case(600 + K, K, dyadic=False)
        singles = [window_slice(tensors, w) for w in range(K)]

        def multi_call():
            return mk.decision_megakernel(*tensors, **statics)

        def single_calls():
            for s in singles:
                mk.decision_megakernel(*s, **statics)
        n_fn, per_call = functions_per_call(multi_call, K1_FUNCTION,
                                            f"K1 K={K} windows")
        check(n_fn == 1, f"K={K}: {n_fn} functions per K-window call")
        dev_multi = required_split(multi_call, (K1_FUNCTION,),
                                   f"K1 K={K}")[K1_FUNCTION]
        dev_one = required_split(lambda: mk.decision_megakernel(
            *singles[0], **statics), (K1_FUNCTION,), "K1 K=1")[K1_FUNCTION]
        batches = [(cols, r) for r in rows[:K]]
        hot_multi = host_ms(lambda: [lz.fetch() for lz in
                                     hp.decide_cols_multi(batches, sim.tel)])
        hot_single = host_ms(lambda: [hp.decide_cols(c, r, sim.tel).fetch()
                                      for c, r in batches])
        t = dict(K=K, R=8, wrapper_call_ms=time_ms(multi_call),
                 wrapper_k_single_calls_ms=time_ms(single_calls),
                 device_ms=dev_multi, device_ms_k_single_calls=K * dev_one,
                 hot_path_call_ms=hot_multi,
                 hot_path_k_single_calls_ms=hot_single,
                 global_functions_per_call=n_fn,
                 device_activities_per_call=per_call)
        out[K]["times"] = t
        emit("multiwindow_times", **t)
    return out


def host_ms(fn, n=50, warm=5):
    """Median host-clock time of fn (which ends in a fetch, so in a
    synchronize), over n calls after warm-up."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# -- the fault-tolerant, elastic serving path (phase 5f) -----------------------

SCEN_DATASET_N = 1200        # `Scenario.build()`'s default


def scenario_cells():
    """(label, scenario key, schedule builder over tiers or None for the
    scenario's own, recovery: "scenario" | None | RecoveryConfig kwargs,
    requests, lam_scale, RBConfig kwargs, counters that must be > 0)."""
    from repro_torch.serving import faults as F
    hedged = dict(hedge_factor=2.5, hedge_slack_s=1.0)
    return [
        ("chaos/crash_storm", "chaos", F.crash_storm, "scenario", 420, 1.0,
         {}, ("retries",)),
        ("chaos/correlated_failure", "chaos", F.correlated_failure,
         "scenario", 420, 1.0, {}, ("retries",)),
        ("chaos/straggler_storm_hedged", "chaos",
         lambda t: F.straggler_storm(t, frac=0.7, factor=8.0, duration=10.0),
         hedged, 420, 1.0, {}, ("hedges", "duplicate_tokens")),
        ("chaos/blackout_half", "chaos",
         lambda t: F.telemetry_blackout(t, frac=0.5), "scenario", 420, 1.0,
         {}, ("quarantines",)),
        ("chaos/blackout_full", "chaos",
         lambda t: F.telemetry_blackout(t, frac=1.0), "scenario", 420, 1.0,
         {}, ("quarantines",)),
        # under 3x the load on the latency preset every instance holds
        # work when the mirror goes dark, so the watchdog declares it dark
        ("chaos/blackout_full_loaded", "chaos",
         lambda t: F.telemetry_blackout(t, frac=1.0, duration=6.0),
         "scenario", 420, 3.0, {"weights": (0.1, 0.8, 0.1)},
         ("degraded_decisions",)),
        ("chaos/crash_storm_no_recovery", "chaos", F.crash_storm, None, 420,
         1.0, {}, ()),
        ("elastic_chaos/crash_storm", "elastic_chaos", F.crash_storm,
         "scenario", 600, 4.0, {}, ("retries", "scale_ups")),
        ("diurnal_elastic", "diurnal_elastic", None, "scenario", 1200, 4.0,
         {}, ("scale_ups", "shed")),
        ("flashcrowd_elastic", "flashcrowd_elastic", None, "scenario", 600,
         4.0, {}, ("scale_ups", "shed")),
        ("failover", "failover", None, "scenario", 400, 1.0, {}, ()),
        ("cluster", "cluster", None, "scenario", 400, 1.0, {}, ()),
        ("multitenant", "multitenant", None, "scenario", 400, 1.0, {}, ()),
        ("session_chat/affinity_0.5", "session_chat", None, "scenario", 400,
         1.0, {"affinity_weight": 0.5}, ()),
        ("hyperscale", "hyperscale", None, "scenario", 600, 1.0, {}, ()),
    ]


def completion_tuples(reqs):
    return [(r.rid, r.finish_time, r.tokens_out, r.model_idx, r.instance,
             bool(r.failed), r.attempt, r.hedges, bool(r.shed))
            for r in reqs]


class K1Recorder:
    """A tap for the decision kernel's wrapper (`decision_megakernel.tap`):
    clones the arguments of the first call, of each call whose alive
    mask differs from the call before it (a roster event: a kill, a
    revive, a quarantine, an autoscale), up to `events` of them, of
    every `every`-th call, and of the last call; and notes every call's
    argument shapes."""

    def __init__(self, events=6, every=16):
        self.events, self.every, self.n_events, self.n = events, every, 0, 0
        self.kept, self.last, self.prev_alive = [], None, None
        self.signatures, self.windows = set(), set()

    def __call__(self, args, kw):
        self.signatures.add(tuple(tuple(t.shape) for t in args))
        self.windows.add(tuple(args[0].shape[:2]))      # (K, R) buckets
        snap = (self.n, [t.clone() for t in args], dict(kw))
        alive = snap[1][9]
        if self.n == 0:
            self.kept.append(("first",) + snap)
        elif (self.n_events < self.events
              and not torch.equal(alive, self.prev_alive)):
            self.n_events += 1
            self.kept.append(("roster_event",) + snap)
        elif self.n % self.every == 0:
            self.kept.append(("sampled",) + snap)
        self.prev_alive, self.last = alive, snap
        self.n += 1

    def calls(self):
        if self.last is not None and self.last[0] != self.kept[-1][1]:
            return self.kept + [("last",) + self.last]
        return self.kept


def hold_recorded_k1(mk, rec, label):
    """Each recorded call once more through the kernel and through its
    plain version on the same tensors (`hold_k1` on random inputs);
    fails below 99% choice agreement over the recorded rows."""
    n_rows = n_agree = 0
    worst = 0.0
    for kind, i, args, kw in rec.calls():
        got = kernel_out(mk, args, kw)
        want = plain_reference(mk, args, kw)
        r, a, rel = hold_k1(got, want, args[1].cpu().numpy(), False,
                            f"{label} call {i} ({kind})")
        n_rows, n_agree, worst = n_rows + r, n_agree + a, max(worst, rel)
    check(n_rows > 0 and n_agree >= 0.99 * n_rows,
          f"{label}: choice agreement {n_agree}/{n_rows} with the plain "
          "version < 0.99 on the recorded calls")
    return dict(calls=[(kind, i) for kind, i, _, _ in rec.calls()],
                rows=n_rows, choice_agreement=n_agree / n_rows,
                est_T_l_chosen_max_rel_err=worst)


def phase_scenarios(mk, kt):
    """The scenario worlds on the card (the megakernel backend,
    `charge_compute=False`, bundles trained by the port on the card), a
    controller crash restored through `CheckpointManager`, and
    `hyperfleet_10k` on the staged torch backend fed by the KNN kernel.
    Each cell runs twice: counted (launches, times), then with the
    kernel's wrapper tapped (`K1Recorder`), which must give the same
    completions; the recorded calls are then held against the plain
    version."""
    import dataclasses
    from repro_torch.core import RBConfig, RouteBalance
    from repro_torch.serving import faults
    from repro_torch.serving.metrics import check_terminal_states
    from repro_torch.serving.recovery import RecoveryConfig
    from repro_torch.serving.scenarios import get_scenario
    worlds, setup = {}, {}

    def world(key):
        if key not in worlds:
            t0 = time.perf_counter()
            sc = {"chaos": faults.chaos_world,
                  "elastic_chaos": faults.elastic_chaos_world}.get(
                key, lambda: get_scenario(key))()
            run = sc.build(dataset_n=SCEN_DATASET_N)
            run.bundle(device=DEV)
            check(run.bundle().device.type == DEV, f"{key}: bundle device")
            worlds[key] = (run, sc)
            setup[key] = time.perf_counter() - t0
        return worlds[key]

    rows, k1_total = {}, 0
    for (label, key, sched, rec, n, scale, rb_kw,
         nonzero) in scenario_cells():
        run, sc = world(key)
        run.scenario = (sc if sched is None else
                        dataclasses.replace(sc, schedule=sched(run.tiers)))
        run.recovery = (sc.recovery if rec == "scenario" else
                        None if rec is None else RecoveryConfig(**rec))

        def one(tap):
            reqs = run.requests(n, lam_scale=scale, seed=0)
            from repro_torch.core.hotpath import FusedHotPath
            FusedHotPath.clear_cache(run.bundle())  # fresh hot path
            rb = RouteBalance(RBConfig(charge_compute=False, **rb_kw),
                              run.bundle(), run.tiers)
            mk.reset_counts()
            mk.decision_megakernel.tap = tap
            try:
                t0 = time.perf_counter()
                m = run.run_cell(rb, reqs, seed=0)
                wall = time.perf_counter() - t0
            finally:
                mk.decision_megakernel.tap = None
            return reqs, rb, m, wall

        reqs, rb, m, wall = one(None)
        launches, plain = k1_counts(mk)
        k1_total += launches
        check_terminal_states(reqs)
        fired = len(rb.compute_log)
        mgr = getattr(rb.sim, "recovery", None)
        degraded = mgr.degraded_batches if mgr is not None else 0
        hp = rb._fused
        variants = hp.shape_variants() if hp is not None else 0
        recorder = K1Recorder()
        reqs2, rb2, _, _ = one(recorder)
        same = completion_tuples(reqs2) == completion_tuples(reqs)
        held = hold_recorded_k1(mk, recorder, label)
        counters = {k: m[k] for k in (
            "retries", "gave_up", "hedges", "duplicate_tokens",
            "quarantines", "degraded_decisions", "scale_ups", "scale_downs",
            "peak_alive") if k in m}
        row = dict(cell=label, instances=run.n_instances, requests=len(reqs),
                   served=m["n"], failed=m["failed"], shed=m["shed"],
                   fired_batches=fired, degraded_batches=degraded,
                   k1_launches=launches, k1_plain_calls=plain,
                   shape_variants=variants,
                   window_buckets=len(recorder.windows),
                   argument_shapes=len(recorder.signatures),
                   roster_reseeds=hp.stats["roster_reseed"] if hp else 0,
                   quality=m["quality"], mean_e2e=m["mean_e2e"],
                   p99_e2e=m["p99_e2e"], cost_per_req=m["cost_per_req"],
                   measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
                   mean_batch_size=m["mean_batch_size"], wall_s=wall,
                   tapped_run_identical=same, recorded_vs_plain=held,
                   **counters)
        rows[label] = row
        emit("scenario", **row)
        check(m["n"] + m["failed"] + m["shed"] == len(reqs),
              f"{label}: {len(reqs)} requests, not all terminal once")
        if run.recovery is not None:
            check(m["failed"] == 0, f"{label}: {m['failed']} failed with "
                  "recovery armed")
        for k in nonzero:
            check(m.get(k, 0) > 0, f"{label}: {k} is 0")
        check(launches == fired - degraded > 0,
              f"{label}: {launches} K1 launches for {fired} batches, "
              f"{degraded} degraded")
        check(plain == 0, f"{label}: {plain} plain-version calls")
        check(recorder.n == launches,
              f"{label}: the tapped run made {recorder.n} calls, the "
              f"counted run {launches}")
        check(same, f"{label}: the tapped run's completions differ")
        # roster churn adds no shape: one argument-shape set per (K, R)
        # bucket, and the hot path counts exactly those
        check(variants == len(recorder.windows) == len(recorder.signatures)
              and rb2._fused.shape_variants() == variants,
              f"{label}: {variants} shape variants, {len(recorder.windows)} "
              f"(K, R) buckets, {len(recorder.signatures)} argument shapes")
        check(np.isfinite(m["mean_e2e"]) and 0.0 < m["quality"] < 1.0,
              f"{label}: implausible metrics")
    crash = phase_crash_restore(world("chaos")[0], faults)
    fleet, fleet_run, fleet_done = phase_hyperfleet(mk, kt)
    emit("scenario_setup", seconds_by_world=setup)
    return dict(cells=rows, k1_launches=k1_total, crash=crash,
                hyperfleet=fleet, worlds=worlds, fleet_run=fleet_run,
                fleet_completions=fleet_done)


def phase_crash_restore(run, faults):
    """The chaos world under a crash storm, uncrashed and with the
    controller crashed at t = 5.3 and resumed by a fresh engine from a
    `CheckpointManager` on disk: identical completion tuples."""
    import tempfile
    from repro_torch.core import RBConfig, RouteBalance, ServingEngine
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.metrics import check_terminal_states
    from repro_torch.serving.recovery import (RecoveryConfig, arm_recovery,
                                              simulate_controller_crash)
    from repro_torch.serving.scenarios import apply_schedule
    sched = faults.crash_storm(run.tiers)

    def one(crash_at, ckpt_dir):
        reqs = run.requests(420, seed=0)
        sim = ClusterSim(run.tiers, run.names, seed=0)
        arm_recovery(sim, RecoveryConfig())
        eng = RouteBalance(RBConfig(charge_compute=False), run.bundle(),
                           run.tiers)
        eng.expected = len(reqs)
        eng.attach(sim)
        holder = {"eng": eng, "dropped": 0}
        for r in reqs:
            sim.push(r.arrival, lambda t, rr=r: holder["eng"].enqueue(rr, t))
        apply_schedule(sim, sched, seed=1)
        if crash_at is not None:
            ckpt = CheckpointManager(ckpt_dir)

            def crash(t):
                holder["eng"].save_checkpoint(ckpt, step=1)
                holder["dropped"] = simulate_controller_crash(sim,
                                                              holder["eng"])
                tree, _ = ckpt.restore(ServingEngine._checkpoint_template())
                arm_recovery(sim, RecoveryConfig())
                fresh = RouteBalance(RBConfig(charge_compute=False),
                                     run.bundle(), run.tiers)
                fresh.resume(sim, tree, reqs)
                holder["eng"] = fresh
            sim.push(crash_at, crash)
        sim.run()
        check_terminal_states(reqs)
        return completion_tuples(reqs), holder["dropped"]

    scratch_dir = Path(__file__).resolve().parent / "build"
    scratch_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_dir) as d:
        ref, _ = one(None, None)
        got, dropped = one(5.3, d)
    same = got == ref
    emit("crash_restore", t=5.3, requests=len(ref), dropped_events=dropped,
         identical_completions=same,
         differing=sum(a != b for a, b in zip(got, ref)))
    check(dropped > 0, "the controller crash dropped nothing")
    check(same, "the restored run's completions differ from the uncrashed")
    return dict(identical=same, dropped_events=dropped)


# -- the reference's randomized soak through K1 (phase 5o(a)) -----------------

SOAK_SEEDS = (0, 1, 2, 3)
SOAK_SIZE = dict(max_tiers=16, max_instances=128)
SOAK_N = 200
SOAK_DATASET_N = 220         # the soak's world size (tests/test_torch_soak.py)
SOAK_AFFINITY = (0.0, 0.5)


def phase_soak(mk):
    """`random_scenario` worlds (seeds SOAK_SEEDS, up to 16 tiers x 128
    instances, bundles trained on the card), SOAK_N requests each on
    the world's own failure schedule, affinity weights 0 and 0.5: a run
    through K1, counted (launches = fired batches less degraded ones, no
    plain call); the same run with K1's wrapper tapped (`K1Recorder`):
    the same completions, every recorded call held against the plain
    version at 5f's bar (`hold_recorded_k1`); the same run on the staged
    torch backend on the card: the same completions, no K1 launch."""
    from repro_torch.core import RBConfig, RouteBalance
    from repro_torch.serving.metrics import check_terminal_states
    from repro_torch.serving.scenarios import random_scenario
    rows, total = {}, 0
    for seed in SOAK_SEEDS:
        t0 = time.perf_counter()
        run = random_scenario(seed, **SOAK_SIZE).build(
            dataset_n=SOAK_DATASET_N)
        run.bundle(device=DEV)
        setup = time.perf_counter() - t0
        check(run.n_instances <= mk.MAX_SHARED_I,
              f"soak world {seed}: {run.n_instances} instances, past the "
              "shared carry the soak exercises")
        for w in SOAK_AFFINITY:
            label = f"soak/{seed}/affinity_{w}"

            def one(tap, backend="megakernel"):
                reqs = run.requests(SOAK_N, seed=seed)
                from repro_torch.core.hotpath import FusedHotPath
                FusedHotPath.clear_cache(run.bundle())
                rb = RouteBalance(RBConfig(decision_backend=backend,
                                           affinity_weight=w,
                                           charge_compute=False),
                                  run.bundle(), run.tiers)
                mk.reset_counts()
                mk.decision_megakernel.tap = tap
                try:
                    t1 = time.perf_counter()
                    m = run.run_cell(rb, reqs, seed=0)
                    wall = time.perf_counter() - t1
                finally:
                    mk.decision_megakernel.tap = None
                return reqs, rb, m, wall

            reqs, rb, m, wall = one(None)
            launches, plain = k1_counts(mk)
            total += launches
            check_terminal_states(reqs)
            fired = len(rb.compute_log)
            mgr = getattr(rb.sim, "recovery", None)
            degraded = mgr.degraded_batches if mgr is not None else 0
            recorder = K1Recorder()
            reqs2, _, _, _ = one(recorder)
            same = completion_tuples(reqs2) == completion_tuples(reqs)
            held = hold_recorded_k1(mk, recorder, label)
            sreqs, _, sm, swall = one(None, "torch")
            staged_k1 = sum(k1_counts(mk))
            staged_same = completion_tuples(sreqs) == completion_tuples(reqs)
            row = dict(cell=label, seed=seed, tiers=len(run.tiers),
                       instances=run.n_instances, requests=len(reqs),
                       affinity_weight=w, schedule_events=len(
                           run.scenario.schedule),
                       served=m["n"], failed=m["failed"], shed=m["shed"],
                       fired_batches=fired, degraded_batches=degraded,
                       k1_launches=launches, k1_plain_calls=plain,
                       decide_ms_per_req=m["measured_decide_ms_per_req"],
                       staged_decide_ms_per_req=sm[
                           "measured_decide_ms_per_req"],
                       mean_batch_size=m["mean_batch_size"],
                       quality=m["quality"], mean_e2e=m["mean_e2e"],
                       wall_s=wall, staged_wall_s=swall, setup_s=setup,
                       tapped_run_identical=same, recorded_vs_plain=held,
                       staged_torch_identical=staged_same,
                       staged_k1_launches=staged_k1)
            rows[label] = row
            emit("soak", **row)
            check(m["n"] + m["failed"] + m["shed"] == len(reqs),
                  f"{label}: {len(reqs)} requests, not all terminal once")
            check(launches == fired - degraded > 0 and plain == 0,
                  f"{label}: {launches} K1 launches for {fired} batches, "
                  f"{degraded} degraded, {plain} plain calls")
            check(recorder.n == launches and same,
                  f"{label}: the tapped run made {recorder.n} calls "
                  f"(counted {launches}), completions identical={same}")
            check(staged_same and staged_k1 == 0,
                  f"{label}: the staged torch backend's completions "
                  f"identical={staged_same}, K1 calls {staged_k1}")
            check(np.isfinite(m["mean_e2e"]) and 0.0 < m["quality"] < 1.0,
                  f"{label}: implausible metrics")
    emit("soak_done", k1_launches=total,
         script_s=time.perf_counter() - T_START)
    return dict(cells=rows, k1_launches=total)


class K2Recorder:
    """A tap for the KNN kernel's wrapper (`knn_topk.tap`): keeps every
    `every`-th call's query (cloned) and the last call's, beside the index
    it was looked up in (the bundle's, which a run does not change)."""

    def __init__(self, every=16):
        self.every, self.n, self.kept, self.last = every, 0, [], None

    def __call__(self, q, x, k, xsq):
        snap = (self.n, q.clone(), x, k, xsq)
        if self.n % self.every == 0:
            self.kept.append(snap)
        self.last = snap
        self.n += 1

    def calls(self):
        if self.last is not None and self.last[0] != self.kept[-1][0]:
            return self.kept + [self.last]
        return self.kept


def hold_recorded_k2(kt, rec):
    """Each recorded lookup once more through the kernel and its plain
    version: idx rows identical on >= 99% of the rows, d2 within rtol
    1e-5 plus 1e-6 of its scale (a query next to an index row has a d2
    near 0 that cancellation leaves few exact digits)."""
    n_rows = n_agree = 0
    worst = 0.0
    for i, q, x, k, xsq in rec.calls():
        d, idx = kt.knn_topk(q, x, k, xsq=xsq)
        pd, pidx = kt.knn_topk_plain(q, x, k, xsq)
        ok, err = close(d, pd, 1e-5, 1e-6)
        check(ok, f"hyperfleet_10k call {i}: d2 error {err} outside "
              "tolerance of the plain version")
        n_rows += q.shape[0]
        n_agree += int((idx == pidx).all(1).sum())
        worst = max(worst, err)
    check(n_rows > 0 and n_agree >= 0.99 * n_rows,
          f"hyperfleet_10k: idx agreement {n_agree}/{n_rows} < 0.99")
    return dict(calls=[c[0] for c in rec.calls()], rows=n_rows,
                idx_row_agreement=n_agree / n_rows, d2_max_abs_err=worst)


HYPERFLEET_N = 500       # 5f, 5g and 5k (cut from 2,000, then 1,000: time)


def phase_hyperfleet(mk, kt):
    """`hyperfleet_10k`: HYPERFLEET_N of its requests on the staged torch
    backend with the KNN kernel (one K2 launch per scoring call, the
    recorded lookups held against the plain version), then the same
    requests as one controller through K1 (`RBConfig()`, I bucket
    16,384: the global carry), counted (launches = fired batches less
    degraded ones, no plain call, shape variants = R buckets, completions
    identical to the staged run) and once more tapped (at most 8
    recorded calls held against the plain version). Returns (row, the
    built run, the staged run's completion tuples)."""
    from repro_torch.core import RBConfig, RouteBalance
    from repro_torch.core.decision import bucket_pow2
    from repro_torch.serving.metrics import check_terminal_states
    from repro_torch.serving.scenarios import get_scenario
    t0 = time.perf_counter()
    run = get_scenario("hyperfleet_10k").build(dataset_n=SCEN_DATASET_N)
    run.bundle(device=DEV)
    setup = time.perf_counter() - t0
    reqs = run.requests(HYPERFLEET_N, seed=0)
    rb = RouteBalance(RBConfig(decision_backend="torch", knn_backend="kernel",
                               charge_compute=False), run.bundle(), run.tiers)
    mk.reset_counts()
    kt.reset_counts()
    recorder = K2Recorder()
    kt.knn_topk.tap = recorder
    try:
        t1 = time.perf_counter()
        m = run.run_cell(rb, reqs, seed=0)
        wall = time.perf_counter() - t1
    finally:
        kt.knn_topk.tap = None
    launches, plain = k2_counts(kt)
    staged_k1 = sum(k1_counts(mk))
    calls = len(rb.compute_log)
    held = hold_recorded_k2(kt, recorder)
    staged = completion_tuples(reqs)
    row = dict(instances=run.n_instances, requests=len(reqs), served=m["n"],
               failed=m["failed"], scoring_calls=calls, knn_launches=launches,
               knn_plain_calls=plain, quality=m["quality"],
               mean_e2e=m["mean_e2e"], p99_e2e=m["p99_e2e"],
               measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
               mean_batch_size=m["mean_batch_size"], setup_s=setup,
               wall_s=wall, recorded_vs_plain=held)
    check(m["n"] + m["failed"] + m["shed"] == len(reqs) and m["n"] > 0,
          "hyperfleet_10k: requests not all terminal")
    check(launches == calls > 0,
          f"hyperfleet_10k: {launches} K2 launches for {calls} scoring calls")
    check(plain == 0, "hyperfleet_10k: plain KNN calls")
    check(recorder.n == launches,
          f"hyperfleet_10k: the tap saw {recorder.n} of {launches} calls")
    check(staged_k1 == 0, "K1 ran on the staged backend")

    # one controller through K1
    def flat(tap):
        reqs = run.requests(HYPERFLEET_N, seed=0)
        from repro_torch.core.hotpath import FusedHotPath
        FusedHotPath.clear_cache(run.bundle())   # fresh hot path
        rb = RouteBalance(RBConfig(charge_compute=False), run.bundle(),
                          run.tiers)
        mk.reset_counts()
        kt.reset_counts()
        mk.decision_megakernel.tap = tap
        try:
            t1 = time.perf_counter()
            m = run.run_cell(rb, reqs, seed=0)
            wall = time.perf_counter() - t1
        finally:
            mk.decision_megakernel.tap = None
        return reqs, rb, m, wall, k1_counts(mk), sum(k2_counts(kt))

    freqs, frb, fm, fwall, (k1, k1_plain), k2 = flat(None)
    check_terminal_states(freqs)
    fired = len(frb.compute_log)
    mgr = getattr(frb.sim, "recovery", None)
    degraded = mgr.degraded_batches if mgr is not None else 0
    buckets = len({bucket_pow2(n) for n, _ in frb.compute_log})
    variants = frb._fused.shape_variants()
    same = completion_tuples(freqs) == staged
    # at most 8 recorded calls (the plain version is slow at this width):
    # the first, 2 after roster events, at most 3 sampled, the last
    rec = K1Recorder(events=2, every=max(16, -(-k1 // 4)))
    treqs, _, _, _, (t_k1, _), _ = flat(rec)
    tapped_same = completion_tuples(treqs) == completion_tuples(freqs)
    check(len(rec.calls()) <= 8, f"hyperfleet_10k flat: {len(rec.calls())} "
          "recorded calls")
    check(all(args[5].shape[0] == 16384 for _, _, args, _ in rec.calls()),
          "hyperfleet_10k flat: a recorded call is not at I = 16,384")
    row["flat"] = dict(
        i_bucket=frb._fused._Itot, requests=len(freqs), served=fm["n"],
        failed=fm["failed"], shed=fm["shed"], fired_batches=fired,
        degraded_batches=degraded, k1_launches=k1, k1_plain_calls=k1_plain,
        k2_launches=k2, shape_variants=variants, r_buckets=buckets,
        identical_to_staged=same, tapped_run_identical=tapped_same,
        measured_decide_ms_per_req=fm["measured_decide_ms_per_req"],
        staged_torch_decide_ms_per_req=m["measured_decide_ms_per_req"],
        mean_batch_size=fm["mean_batch_size"], quality=fm["quality"],
        mean_e2e=fm["mean_e2e"], p99_e2e=fm["p99_e2e"], wall_s=fwall,
        recorded_vs_plain=hold_recorded_k1(mk, rec, "hyperfleet_10k flat"),
        **hot_path_split([frb]))
    emit("hyperfleet", **row)
    f = row["flat"]
    check(fm["n"] + fm["failed"] + fm["shed"] == len(freqs) and fm["n"] > 0,
          "hyperfleet_10k flat: requests not all terminal once")
    check(f["i_bucket"] == 16384, f"hyperfleet_10k flat: I bucket "
          f"{f['i_bucket']}")
    check(k1 == fired - degraded > 0 and k1_plain == 0 and k2 == 0,
          f"hyperfleet_10k flat: {k1} K1 launches ({k1_plain} plain) for "
          f"{fired} batches, {degraded} degraded; K2 {k2}")
    check(variants == buckets if not degraded else variants <= buckets,
          f"hyperfleet_10k flat: {variants} shape variants for {buckets} "
          "R buckets")
    check(same, "hyperfleet_10k flat: completions differ from the staged "
          "torch run")
    check(t_k1 == k1 and rec.n == k1 and tapped_same,
          f"hyperfleet_10k flat: the tapped run made {rec.n} calls "
          f"(counted {k1}), completions identical={tapped_same}")
    return row, run, staged


# -- the hierarchy (phase 5g) -----------------------------------------------

HIER_N = 400                      # cluster cells: 5f's request count
HIER_FLEET = ((16, "exact", 1024), (32, "exact", 512), (16, "int8", 1024))
SPAN_CLUSTER_N = 100    # 5g's span on `cluster` and 5k's (cut from 200)
LAUNCHER_N = 100        # each launcher run (cut from 200: time)


def hier_run(mk, kt, run, make, reqs, tap=None):
    """One counted cell: a fresh scheduler from `make()` (hot-path cache
    dropped, so each cell engine's shape count is this run's), the K1 and
    K2 counts set to 0 just before and read just after. Returns
    (scheduler, metrics, wall s, (K1 launches, K1 plain), (K2 launches,
    K2 plain))."""
    from repro_torch.core.hotpath import FusedHotPath
    FusedHotPath.clear_cache(run.bundle())
    sched = make()
    mk.reset_counts()
    kt.reset_counts()
    mk.decision_megakernel.tap = tap
    try:
        t0 = time.perf_counter()
        m = run.run_cell(sched, reqs, seed=0)
        wall = time.perf_counter() - t0
    finally:
        mk.decision_megakernel.tap = None
    return sched, m, wall, k1_counts(mk), k2_counts(kt)


def check_cells(label, sched, m, reqs, k1, k2):
    """The balanced hierarchy's invariants: every request terminal once,
    K1 launches = the cells' fired batches less their degraded ones, no
    plain call, no K2 launch (K1 has the lookup built in), and each cell
    engine's shape variants equal to its R buckets (roster churn adds
    none). Returns (fired, degraded)."""
    from repro_torch.core.decision import bucket_pow2
    from repro_torch.serving.metrics import check_terminal_states
    check_terminal_states(reqs)
    check(m["n"] + m["failed"] + m["shed"] == len(reqs),
          f"{label}: {len(reqs)} requests, not all terminal once")
    fired = sum(len(e.compute_log) for e in sched.engines)
    degraded = sum(cs.recovery.degraded_batches for cs in sched.cell_sims
                   if cs.recovery is not None)
    check(k1[0] == fired - degraded > 0,
          f"{label}: {k1[0]} K1 launches for {fired} batches, {degraded} "
          "degraded")
    check(k1[1] == 0, f"{label}: {k1[1]} K1 plain-version calls")
    check(sum(k2) == 0, f"{label}: K2 ran {k2} on the balanced path")
    for ci, e in enumerate(sched.engines):
        if e._fused is None:
            continue
        want = len({bucket_pow2(s) for s, _ in e.compute_log})
        check(e._fused.shape_variants() == want,
              f"{label} cell {ci}: {e._fused.shape_variants()} shape "
              f"variants for {want} R buckets")
    return fired, degraded


def hot_path_split(engines):
    """The cells' hot-path host clocks summed over their K1 calls, per
    call (ms): staging, mirror sync, the launch, the wait for the answer
    and its copy out, beside each decided batch's whole decide time, and
    the mirror's reseed / delta / carry counts."""
    keys = ("stage_s", "host_s", "dispatch_s", "device_s", "sync_s",
            "full_reseed", "roster_reseed", "delta_sync", "delta_rows",
            "carry")
    tot = {k: sum(e._fused.stats[k] for e in engines if e._fused)
           for k in keys}
    calls = max(sum(e._fused.stats["calls"] for e in engines if e._fused), 1)
    decide = sum(dt for e in engines for _, dt in e.compute_log)
    return dict(per_call_ms={
        "stage": tot["stage_s"] / calls * 1e3,
        "mirror_sync": (tot["host_s"] - tot["stage_s"]) / calls * 1e3,
        "launch": tot["dispatch_s"] / calls * 1e3,
        "device_wait": tot["device_s"] / calls * 1e3,
        "copy_out": tot["sync_s"] / calls * 1e3,
        "decide_whole": decide / calls * 1e3},
        sync_counts={k: tot[k] for k in keys[5:]})


def phase_hierarchy(mk, kt, scen):
    """Phase 5g: the hierarchy on the card, `charge_compute=False`.
    `cluster` at one cell against the single controller and at two cells
    with recovery armed; `hyperfleet_10k` in balanced cells at 16 and 32
    cells (K1 at I = 1,024 and 512), 16 once more with int8 digests, the
    exact runs once more tapped and their recorded K1 calls held against
    the plain version; span at 16 cells on the staged torch backend
    with K2 against 5f's unsharded staged run; K1 alone at I = 512 and
    1,024; and the launcher as a subprocess."""
    from repro_torch.core import RBConfig, RouteBalance
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    from repro_torch.serving.recovery import RecoveryConfig
    t_phase = time.perf_counter()
    out, k1_total = {}, 0
    cfg = RBConfig(charge_compute=False)

    # one cell against one controller, then two cells with recovery
    run, sc = scen["worlds"]["cluster"]
    run.scenario, run.recovery = sc, sc.recovery
    reqs_a = run.requests(HIER_N, seed=0)
    single, _, _, k1_single, _ = hier_run(
        mk, kt, run, lambda: RouteBalance(cfg, run.bundle(), run.tiers),
        reqs_a)
    reqs_b = run.requests(HIER_N, seed=0)
    one, m1, _, k1, k2 = hier_run(
        mk, kt, run, lambda: build_scheduler(
            cfg, run.bundle(), run.tiers, HierarchyConfig(n_cells=1)),
        reqs_b)
    check_cells("cluster/1 cell", one, m1, reqs_b, k1, k2)
    k1_total += k1[0]
    same = completion_tuples(reqs_a) == completion_tuples(reqs_b)
    out["one_cell"] = dict(requests=HIER_N, identical_to_single=same,
                           k1_launches=k1[0],
                           single_controller_k1_launches=k1_single[0],
                           fired_batches=len(single.compute_log))
    emit("hierarchy_one_cell", **out["one_cell"])
    check(same, "cluster: the 1-cell hierarchy's trajectories differ from "
          "the single controller's")
    run.recovery = RecoveryConfig()
    try:
        reqs = run.requests(HIER_N, seed=0)
        two, m2, wall, k1, k2 = hier_run(
            mk, kt, run, lambda: build_scheduler(
                cfg, run.bundle(), run.tiers, HierarchyConfig(n_cells=2)),
            reqs)
    finally:
        run.recovery = sc.recovery
    fired, degraded = check_cells("cluster/2 cells, recovery", two, m2,
                                  reqs, k1, k2)
    k1_total += k1[0]
    per_cell = [cs.recovery.retries for cs in two.cell_sims]
    out["two_cells_recovery"] = dict(
        requests=HIER_N, served=m2["n"], failed=m2["failed"],
        retries=m2["retries"], retries_by_cell=per_cell,
        hedges=m2["hedges"], quarantines=m2["quarantines"],
        fired_batches=fired, degraded_batches=degraded, k1_launches=k1[0],
        digests=two.balancer.digests_sent,
        imbalance=two.balancer.imbalance(), wall_s=wall)
    emit("hierarchy_two_cells", **out["two_cells_recovery"])
    check(m2["failed"] == 0, f"cluster/2 cells: {m2['failed']} failed "
          "with recovery armed")
    check(m2["retries"] > 0 and sum(per_cell) == m2["retries"],
          f"cluster/2 cells: retries {m2['retries']}, by cell {per_cell}")

    # hyperfleet_10k in balanced cells, then once more tapped
    fleet = scen["fleet_run"]
    staged_ms = scen["hyperfleet"]["measured_decide_ms_per_req"]
    flat_ms = scen["hyperfleet"]["flat"]["measured_decide_ms_per_req"]
    out["fleet"] = {}
    for n_cells, mode, bucket in HIER_FLEET:
        label = f"hyperfleet_10k/{n_cells} cells/{mode}"
        hcfg = HierarchyConfig(n_cells=n_cells, digest_mode=mode)

        def make():
            return build_scheduler(cfg, fleet.bundle(), fleet.tiers, hcfg)
        reqs = fleet.requests(HYPERFLEET_N, seed=0)
        sched, m, wall, k1, k2 = hier_run(mk, kt, fleet, make, reqs)
        fired, degraded = check_cells(label, sched, m, reqs, k1, k2)
        k1_total += k1[0]
        buckets = sorted({e._fused._Itot for e in sched.engines
                          if e._fused is not None})
        check(buckets == [bucket], f"{label}: I buckets {buckets}")
        bal = sched.balancer
        check(bal.digests_sent > 0 and bal.bytes_sent > 0,
              f"{label}: no digest crossed the wire")
        row = dict(cells=n_cells, digest_mode=mode, i_bucket=bucket,
                   requests=len(reqs), served=m["n"], failed=m["failed"],
                   shed=m["shed"], fired_batches=fired,
                   degraded_batches=degraded, k1_launches=k1[0],
                   k1_plain_calls=k1[1],
                   measured_decide_ms_per_req=m[
                       "measured_decide_ms_per_req"],
                   staged_torch_decide_ms_per_req_5f=staged_ms,
                   flat_k1_decide_ms_per_req_5f=flat_ms,
                   mean_batch_size=m["mean_batch_size"],
                   imbalance=bal.imbalance(), digests=bal.digests_sent,
                   digest_bytes=bal.bytes_sent,
                   digest_bytes_per_s=bal.bytes_sent / max(sched.sim.now,
                                                           1e-9),
                   quality=m["quality"], mean_e2e=m["mean_e2e"],
                   p99_e2e=m["p99_e2e"], wall_s=wall,
                   **hot_path_split(sched.engines))
        if mode == "exact":
            rec = K1Recorder(events=0)            # first, every 16th, last
            reqs2 = fleet.requests(HYPERFLEET_N, seed=0)
            hier_run(mk, kt, fleet, make, reqs2, tap=rec)
            row["tapped_run_identical"] = (completion_tuples(reqs2)
                                           == completion_tuples(reqs))
            check(row["tapped_run_identical"],
                  f"{label}: the tapped run's completions differ")
            check(rec.n == k1[0], f"{label}: the tapped run made {rec.n} "
                  f"calls, the counted run {k1[0]}")
            check(all(args[5].shape[0] == bucket
                      for _, _, args, _ in rec.calls()),
                  f"{label}: a recorded call is not at I = {bucket}")
            row["recorded_vs_plain"] = hold_recorded_k1(mk, rec, label)
        out["fleet"][label] = row
        emit("hierarchy_fleet", **row)
        check(np.isfinite(m["mean_e2e"]) and 0.0 < m["quality"] < 1.0,
              f"{label}: implausible metrics")

    # span: one logical decision sharded over 16 cells, staged torch + K2
    reqs = fleet.requests(HYPERFLEET_N, seed=0)
    with DecideRecorder() as rec:
        span, m, wall, k1, k2 = hier_run(
            mk, kt, fleet, lambda: build_scheduler(
                _span_cfg(), fleet.bundle(), fleet.tiers,
                HierarchyConfig(n_cells=16, routing="span")), reqs)
    out["span_emulated"] = {("hyperfleet_10k", 16): dict(
        completions=completion_tuples(reqs), decisions=rec.calls,
        measured_decide_ms_per_req=m["measured_decide_ms_per_req"])}
    calls = len(span.compute_log)
    same = completion_tuples(reqs) == scen["fleet_completions"]
    out["span"] = dict(cells=16, requests=len(reqs), served=m["n"],
                       scoring_calls=calls, knn_launches=k2[0],
                       knn_plain_calls=k2[1], k1_calls=sum(k1),
                       identical_to_staged_5f=same,
                       measured_decide_ms_per_req=m[
                           "measured_decide_ms_per_req"],
                       staged_torch_decide_ms_per_req_5f=staged_ms,
                       quality=m["quality"], mean_e2e=m["mean_e2e"],
                       p99_e2e=m["p99_e2e"], wall_s=wall)
    emit("hierarchy_span", **out["span"])
    check(span.cfg.shard_cells == 16, "span: not sharded")
    check(same, "span: completions differ from 5f's unsharded staged run")
    check(k2[0] == calls > 0 and k2[1] == 0,
          f"span: {k2} K2 launches for {calls} scoring calls")
    check(sum(k1) == 0, "span: K1 ran on the staged backend")
    span_k2 = k2[0]

    # span on `cluster`: the emulation 5k is held to
    for n_cells in SPAN_CLUSTER_CELLS:
        reqs = run.requests(SPAN_CLUSTER_N, seed=0)
        with DecideRecorder() as rec:
            sched, m, wall, k1, k2 = hier_run(
                mk, kt, run, lambda: build_scheduler(
                    _span_cfg(), run.bundle(), run.tiers,
                    HierarchyConfig(n_cells=n_cells, routing="span")), reqs)
        label = f"cluster/span {n_cells} cells"
        check_span_run(label, sched, m, reqs, k1, k2)
        span_k2 += k2[0]
        out["span_emulated"][("cluster", n_cells)] = dict(
            completions=completion_tuples(reqs), decisions=rec.calls,
            measured_decide_ms_per_req=m["measured_decide_ms_per_req"])
        emit("hierarchy_span_cluster", cells=n_cells, requests=len(reqs),
             served=m["n"], failed=m["failed"],
             scoring_calls=len(sched.compute_log), knn_launches=k2[0],
             measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
             quality=m["quality"], mean_e2e=m["mean_e2e"], wall_s=wall)

    out["k1_times"] = phase_k1_cells(mk)
    out["launcher"] = phase_launcher()
    out["k1_launches"] = k1_total
    out["k2_launches_span"] = span_k2
    emit("hierarchy_done", seconds=time.perf_counter() - t_phase,
         k1_launches=k1_total, k2_launches_span=span_k2)
    return out


def phase_k1_cells(mk):
    """K1 alone at the cells' rosters (I = 512 and 1,024, a cell's alive
    share of hyperfleet_10k) on the main path's index: held against the
    plain version on dyadic inputs (every output), then timed as phase 4
    times it (call, device, bound) at R = 8 and 64, and at R = 8 once
    more without the TPOT heads (device ms)."""
    rows = {}
    for I, n_alive in ((512, 313), (1024, 625)):
        for R in (8, 64):
            tensors, statics = make_case(700 + I + R, R=R, I=I,
                                         n_alive=n_alive, dev=DEV)
            hold_k1(kernel_out(mk, tensors, statics),
                    plain_reference(mk, tensors, statics),
                    tensors[1].cpu().numpy(), True, f"K1 I={I} R={R}")
            if DEV != "cuda":
                continue
            tensors, statics = make_case(800 + I + R, R=R, I=I,
                                         n_alive=n_alive, dyadic=False)

            def kernel():
                return mk.decision_megakernel(*tensors, **statics)
            b_ms, by, nbytes, flops = bound_ms(tensors, statics,
                                               neighbour_rows(tensors))
            row = dict(I=I, R=R, alive=n_alive, ms=time_ms(kernel),
                       plain_ms=time_ms(lambda: mk.decision_megakernel_plain(
                           *tensors, **statics), n=10),
                       bound_ms=b_ms, bound_by=by, bytes=nbytes, flops=flops,
                       device_ms=required_split(
                           kernel, (K1_FUNCTION,),
                           f"K1 I={I} R={R}")[K1_FUNCTION])
            if R == 8:
                # the same call without the TPOT heads: their share of
                # the device time, which the scan CTA pays per instance
                off, st_off = make_case(800 + I + R, R=R, I=I,
                                        n_alive=n_alive, dyadic=False,
                                        use_gbm=False)
                row["device_ms_gbm_off"] = required_split(
                    lambda: mk.decision_megakernel(*off, **st_off),
                    (K1_FUNCTION,), f"K1 I={I} R={R} GBM off")[K1_FUNCTION]
            rows[f"I={I},R={R}"] = row
            emit("hierarchy_k1_times", exact_vs_plain_dyadic=True, **row)
    return rows


def phase_launcher():
    """`python -m repro_torch.launch.serve --scenario cluster --cells 2`
    as a user runs it, on the card: its JSON names 2 cells, digests
    crossed the wire and every request is terminal once. The scenario
    kills 15% of its instances at t = 6 s with recovery off, so requests
    in flight there fail, as in the reference's launcher."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--scenario",
           "cluster", "--cells", "2", "--n", str(LAUNCHER_N)]
    if DEV != "cuda":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root / "src")},
                         timeout=300)
    wall = time.perf_counter() - t0
    check(res.returncode == 0,
          f"launcher exited {res.returncode}: {res.stderr[-2000:]}")
    m = json.loads(res.stdout)
    row = dict(command=" ".join(cmd[1:]), wall_s=wall, **{
        k: m.get(k) for k in ("cells", "cell_routing", "decision_backend",
                              "n", "failed", "shed", "digests",
                              "digest_bytes", "intercell_imbalance",
                              "quality", "mean_e2e",
                              "measured_decide_ms_per_req")})
    emit("hierarchy_launcher", **row)
    check(m["cells"] == 2 and m["digests"] > 0 and m["digest_bytes"] > 0,
          f"launcher: {row}")
    check(m["n"] + m["failed"] + m["shed"] == LAUNCHER_N,
          f"launcher: {LAUNCHER_N} requests, not all terminal once")
    return row


# -- the span arm over torch.distributed (phase 5k) -----------------------------

SPAN_CFG_KW = dict(decision_backend="torch", knn_backend="kernel",
                   charge_compute=False)
SPAN_CLUSTER_CELLS = (2,)
# (ranks, ((world, 5g's emulation it is held to), ...)); the padded
# column axis is the same at every cell count here (cluster's 48
# instances pad to 64 at 2 and 4 cells, hyperfleet_10k's 10,000 to
# 16,384 at 4 and 16), so 5g's emulation is the same scan
SPAN_DIST = ((2, (("cluster", 2),)),
             (4, (("cluster", 2), ("hyperfleet_10k", 16))))
SPAN_TIMEOUT_S = 120          # rendezvous and every collective of a group


def _span_cfg():
    from repro_torch.core import RBConfig
    return RBConfig(**SPAN_CFG_KW)


class DecideRecorder:
    """While active, keeps each staged decision's (choice, est_T) as
    `repro_torch.core.decision.decide` returns them (the scheduler looks
    the function up at every call)."""

    def __enter__(self):
        from repro_torch.core import decision
        self.mod, self.orig, self.calls = decision, decision.decide, []

        def decide(*args, **kw):
            choice, est_T = self.orig(*args, **kw)
            self.calls.append((choice.copy(), est_T.copy()))
            return choice, est_T
        decision.decide = decide
        return self

    def __exit__(self, *exc):
        self.mod.decide = self.orig


def check_span_run(label, sched, m, reqs, k1, k2):
    """A span run's invariants: every request terminal once, one K2
    launch per scoring call, no plain call, no K1 launch."""
    from repro_torch.serving.metrics import check_terminal_states
    check_terminal_states(reqs)
    check(m["n"] + m["failed"] + m["shed"] == len(reqs),
          f"{label}: {len(reqs)} requests, not all terminal once")
    calls = len(sched.compute_log)
    check(k2[0] == calls > 0 and k2[1] == 0,
          f"{label}: {k2} K2 launches for {calls} scoring calls")
    check(sum(k1) == 0, f"{label}: K1 ran on the staged backend")


def span_rank(init_method, rank, world, backend, device, queue):
    """Rank `rank` (> 0) of a 5k group, in a process of its own: join,
    answer rank 0's scans in `cell_worker` until it stops them, and put
    this rank's collective counts on `queue`."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import decision
    from repro_torch.launch.mesh import make_cell_mesh
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SPAN_TIMEOUT_S))
    try:
        scans = decision.cell_worker(make_cell_mesh(world), device)
        f = decision.sharded_greedy_scan
        queue.put(dict(rank=rank, scans=scans, all_reduces=f.all_reduces,
                       broadcasts=f.broadcasts,
                       broadcast_bytes=f.broadcast_bytes))
    finally:
        dist.destroy_process_group()


def span_dist_run(mk, kt, mesh, name, run, n_req, world, emu):
    """One span run with this process as rank 0 of `mesh`'s group: the
    completions and every decision's choice and est_T identical to 5g's
    emulation, K2 once per scoring call, and the collectives the scan
    spells (4 all-reduces a row and 1 a scan in the full latency mode,
    3 broadcasts a scan)."""
    from repro_torch.core import decision
    from repro_torch.core.decision import bucket_pow2
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    label = f"{name}/span over {world} ranks"
    reqs = run.requests(n_req, seed=0)
    decision.reset_counts()
    with DecideRecorder() as rec:
        sched, m, wall, k1, k2 = hier_run(
            mk, kt, run, lambda: build_scheduler(
                _span_cfg(), run.bundle(), run.tiers,
                HierarchyConfig(n_cells=world, routing="span")), reqs)
    f = decision.sharded_greedy_scan
    ar, bc, nbytes = f.all_reduces, f.broadcasts, f.broadcast_bytes
    check_span_run(label, sched, m, reqs, k1, k2)
    calls = len(sched.compute_log)
    rows = sum(bucket_pow2(len(c)) for c, _ in rec.calls)
    same = completion_tuples(reqs) == emu["completions"]
    same_dec = len(rec.calls) == len(emu["decisions"]) and all(
        np.array_equal(c, ce) and e.tobytes() == ee.tobytes()
        for (c, e), (ce, ee) in zip(rec.calls, emu["decisions"]))
    row = dict(
        world=name, ranks=world, requests=len(reqs), served=m["n"],
        failed=m["failed"], scoring_calls=calls, rows_scanned=rows,
        knn_launches_rank0=k2[0], knn_plain_calls=k2[1],
        all_reduces_per_rank=ar, all_reduces_per_request=ar / len(reqs),
        all_reduces_per_row=(ar - calls) / max(rows, 1), broadcasts=bc,
        broadcast_bytes=nbytes, identical_completions=same,
        identical_choices_est_T=same_dec,
        measured_decide_ms_per_req=m["measured_decide_ms_per_req"],
        emulated_decide_ms_per_req_5g=emu["measured_decide_ms_per_req"],
        quality=m["quality"], mean_e2e=m["mean_e2e"], wall_s=wall)
    # what the ranks add to a request's decision, per all-reduce made
    row["added_ms_per_all_reduce"] = (
        (row["measured_decide_ms_per_req"]
         - row["emulated_decide_ms_per_req_5g"])
        / max(row["all_reduces_per_request"], 1e-9))
    emit("span_dist", **row)
    check(sched.policy._cell_mesh is mesh,
          f"{label}: the scheduler did not take the pinned mesh")
    check(same, f"{label}: completions differ from 5g's emulation")
    check(same_dec, f"{label}: choices or est_T differ from 5g's emulation")
    check(ar == 4 * rows + calls and bc == 3 * calls,
          f"{label}: {ar} all-reduces, {bc} broadcasts for {calls} scans "
          f"of {rows} rows")
    return row


def spawn_span_ranks(backend, world):
    """Start ranks 1..world-1 of a 5k group (`span_rank`, spawned) on a
    fresh `FileStore` under `build/`; they wait for rank 0 at the
    rendezvous. Returns (init method, processes, their queue)."""
    import multiprocessing
    store = Path(__file__).resolve().parent / "build" / (
        f"span_store_{backend}_{world}")
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    init = f"file://{store}"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=span_rank,
                         args=(init, r, world, backend, DEV, queue))
             for r in range(1, world)]
    for p in procs:
        p.start()
    return init, procs, queue


def span_group(mk, kt, backend, world, runs, worlds, emulated, spawned):
    """Join the spawned ranks as rank 0 over `backend`, drive `runs` with
    the mesh pinned, stop the workers and hold their counts to rank
    0's."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import decision
    from repro_torch.distributed.shardctx import sharding_rules
    from repro_torch.launch.mesh import make_cell_mesh
    init, procs, queue = spawned
    t0 = time.perf_counter()
    out = dict(backend=backend, ranks=world, runs={})
    dist.init_process_group(
        backend, init_method=init, rank=0, world_size=world,
        timeout=datetime.timedelta(seconds=SPAN_TIMEOUT_S))
    out["rendezvous_wait_s"] = time.perf_counter() - t0
    try:
        mesh = make_cell_mesh(world)
        check(mesh is not None and mesh.size() == world,
              f"{backend}/{world}: no cell mesh")
        sums = [0, 0]
        try:
            with sharding_rules(mesh):
                for name, emu_cells in runs:
                    run, n_req = worlds[name]
                    row = span_dist_run(mk, kt, mesh, name, run, n_req,
                                        world, emulated[(name, emu_cells)])
                    out["runs"][name] = row
                    sums[0] += row["all_reduces_per_rank"]
                    sums[1] += row["broadcasts"]
        finally:
            decision.stop_cell_workers(mesh, DEV)
        ranks = [queue.get(timeout=SPAN_TIMEOUT_S) for _ in procs]
    finally:
        if dist.is_initialized():     # a scan left part way tore it down
            dist.destroy_process_group()
    for p in procs:
        p.join(SPAN_TIMEOUT_S)
    codes = [p.exitcode for p in procs]
    out.update(worker_ranks=ranks, exit_codes=codes,
               seconds=time.perf_counter() - t0)
    emit("span_dist_group", **out)
    check(codes == [0] * len(procs), f"{backend}/{world}: exit codes {codes}")
    for r in ranks:
        check(r["all_reduces"] == sums[0] and r["broadcasts"] == sums[1] + 1,
              f"{backend}/{world}: rank {r['rank']} joined {r} collectives,"
              f" rank 0 {sums} (+ the stop header)")
    return out


def phase_span_launcher():
    """`python -m repro_torch.launch.serve --scenario cluster --cells 2
    --cell-routing span --dist-backend gloo` in two processes on the
    card, started as `torchrun` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT in the environment, env://
    rendezvous on the loopback): rank 0 prints the JSON line, its
    collectives counted, every request terminal once; rank 1 prints
    nothing. (torchrun itself is left out: on some Python versions its
    argument parser takes the launcher's `--n` for an ambiguous
    abbreviation of its own options.)"""
    import signal
    import socket
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--scenario",
           "cluster", "--cells", "2", "--cell-routing", "span",
           "--dist-backend", "gloo", "--n", str(LAUNCHER_N)]
    if DEV != "cuda":
        cmd += ["--device", "cpu"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env={**os.environ, "PYTHONPATH": str(root / "src"),
             "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(300 - (time.perf_counter() - t0), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(10)
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    check(codes == [0, 0], f"span launcher ranks exited {codes}: "
          f"{outs[0][1][-1500:]} {outs[-1][1][-1500:]}")
    check(not outs[1][0].strip(), "span launcher: rank 1 printed "
          f"{outs[1][0][:200]}")
    m = json.loads(outs[0][0])
    row = dict(command=" ".join(cmd[1:]), ranks=2, wall_s=wall, **{
        k: m.get(k) for k in ("cells", "cell_routing", "decision_backend",
                              "dist_backend", "n", "failed", "shed",
                              "span_all_reduces", "span_broadcasts",
                              "span_broadcast_bytes", "quality", "mean_e2e",
                              "measured_decide_ms_per_req")})
    emit("span_dist_launcher", **row)
    check(m["cells"] == 2 and m["dist_backend"] == "gloo"
          and m["span_all_reduces"] > 0 and m["span_broadcasts"] > 0,
          f"span launcher: {row}")
    check(m["n"] + m["failed"] + m["shed"] == LAUNCHER_N,
          f"span launcher: {LAUNCHER_N} requests, not all terminal once")
    return row


def phase_span_dist(mk, kt, scen, emulated):
    """Phase 5k: the span arm with one cell per rank over
    `torch.distributed`, this process rank 0 and the others spawned:
    gloo at 2 and 4 ranks on the one card (`SPAN_DIST`), held to 5g's
    emulation; NCCL with one rank per card when the machine has 4
    cards; then the launcher under torchrun."""
    t_phase = time.perf_counter()
    worlds = {"cluster": (scen["worlds"]["cluster"][0], SPAN_CLUSTER_N),
              "hyperfleet_10k": (scen["fleet_run"], HYPERFLEET_N)}
    groups = [("gloo", w, runs) for w, runs in SPAN_DIST]
    n_cards = torch.cuda.device_count() if DEV == "cuda" else 0
    if n_cards >= 4:
        groups.append(("nccl", 4, SPAN_DIST[1][1]))
        nccl = "run"
    else:
        nccl = (f"not run: {n_cards} card(s); NCCL takes one card per "
                "rank, so its 4-rank layout needs 4 cards (written, not "
                "verified on this machine)")
    emit("span_dist_nccl", status=nccl)
    # every group's workers start now: a later group's reach the card
    # while an earlier group runs
    spawned = [spawn_span_ranks(b, w) for b, w, _ in groups]
    try:
        out = {f"{b}/{w}": span_group(mk, kt, b, w, runs, worlds, emulated,
                                      sp)
               for (b, w, runs), sp in zip(groups, spawned)}
    finally:
        for _, procs, _ in spawned:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    out["nccl"] = nccl
    out["launcher"] = phase_span_launcher()
    out["k2_launches"] = sum(r["knn_launches_rank0"] for g in out.values()
                             if isinstance(g, dict) and "runs" in g
                             for r in g["runs"].values())
    emit("span_dist_done", seconds=time.perf_counter() - t_phase,
         k2_launches=out["k2_launches"])
    return out


# -- phase 5l: the model-distribution layer ----------------------------------

MESH_ARCH = "granite-moe-3b-a800m"
# 8 x 512 prompts (pad_to 1,024), 8 greedy steps, 4 rows a data shard
MESH_SERVE = dict(batch=8, prompt=512, pad_to=1024, steps=8)
MESH_AR_NUMEL = 16 * 2 ** 20         # 64 MB of float32 a rank (5l(c))
MESH_AR_AXES = (("data",), ("data", "model"))
MESH_TIMEOUT_S = 120                 # rendezvous and every collective


def phase_dryrun():
    """5l(a) and 5m(c): `python -m repro_torch.launch.dryrun --all` and
    `--all --multi-pod`, one subprocess a shape, all at once (CPU work): 0
    errors, the reference's skips (long_500k for the 7 full-attention
    archs, on both meshes), the per-device GB of mixtral-8x7b and
    gemma3-27b `train_4k`, and FLOPs, HBM bytes, collectives and peak
    bytes per device on all 66 ok cells, train cells included (none
    left as a plan)."""
    from repro_torch.configs import LONG_CONTEXT_OK, SHAPES, list_archs
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    # one process a (mesh, shape): 8 at once on the host's cores
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--force", "--shape", sh] + flag, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
        for flag in ([], ["--multi-pod"]) for sh in SHAPES]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for out, err, rc in outs:
        check(rc == 0, f"dry run exited {rc}: {out[-1500:]} {err[-1500:]}")
    runs = root / "build" / "dryrun"
    recs = {}
    for a in list_archs():
        for sh in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                recs[(a, sh, mesh)] = json.loads(
                    (runs / f"{a}__{sh}__{mesh}.json").read_text())
    status = {k: v["status"] for k, v in recs.items()}
    skipped = {k for k, v in status.items() if v == "skipped"}
    want = {(a, "long_500k", m) for a in list_archs()
            if a not in LONG_CONTEXT_OK for m in ("16x16", "2x16x16")}
    gb = {f"{a}/{m}": {k: v / 1e9 for k, v in
                       recs[(a, "train_4k", m)]["bytes_per_device"].items()}
          for a in ("mixtral-8x7b", "gemma3-27b")
          for m in ("16x16", "2x16x16")}
    counted = {k for k, v in recs.items() if "flops_per_device" in v}
    want_counted = {k for k, v in recs.items() if v["status"] == "ok"}
    keys = ("flops_per_device", "hbm_bytes_per_device",
            "collective_link_bytes_per_device", "peak_bytes_per_device",
            "collectives")
    sample = {f"{a}/{sh}": {k: recs[(a, sh, "16x16")][k] for k in keys}
              for a, sh in (("granite-3-2b", "decode_32k"),
                            ("granite-3-2b", "prefill_32k"),
                            ("granite-3-2b", "train_4k"),
                            ("recurrentgemma-2b", "decode_32k"),
                            ("whisper-tiny", "decode_32k"),
                            ("mamba2-1.3b", "prefill_32k"),
                            ("mixtral-8x7b", "decode_32k"))}
    row = dict(cells=len(recs), ok=sum(v == "ok" for v in status.values()),
               skipped=len(skipped),
               errors=sum(v == "error" for v in status.values()),
               counted=len(counted),
               plan_only=sum(1 for v in recs.values() if "plan_only" in v),
               train_4k_gb_per_device=gb, counts_16x16=sample,
               seconds=wall)
    emit("mesh_dryrun", **row)
    check(row["errors"] == 0 and skipped == want and row["ok"] == 66,
          f"dry run: {row['ok']} ok, {row['errors']} errors, skipped "
          f"{sorted(skipped ^ want)} differ from the reference's")
    check(counted == want_counted and len(counted) == 66
          and row["plan_only"] == 0,
          f"dry run: counts on {sorted(counted ^ want_counted)} differ "
          f"from the 66 ok cells")
    return row


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def mesh_groups(axes):
    """The rank groups of `axes` on the (data 2, model 2) mesh (rank r
    at data r // 2, model r % 2)."""
    return [[0, 2], [1, 3]] if axes == ("data",) else [[0, 1, 2, 3]]


def mesh_ar_inputs(device, numel):
    """Every rank's 5l(c) gradient, drawn from the rank's own seed."""
    out = []
    for r in range(4):
        gen = torch.Generator(device=device).manual_seed(900 + r)
        out.append(torch.randn(numel, generator=gen, device=device)
                   * (10.0 ** -(r + 1)))
    return out


def allreduce_one_process(xs, group):
    """`shardmap_allreduce`'s arithmetic over `group`'s inputs in one
    process: each scale, their MAX, the int8 levels summed as int32,
    the mean, in float32."""
    scale = torch.stack([torch.clamp(xs[r].abs().max() / 127.0, min=1e-12)
                         for r in group]).max()
    s = sum(torch.clamp(torch.round(xs[r] / scale), -127, 127)
            .to(torch.int8).to(torch.int32) for r in group)
    return s.float() * scale / len(group)


# -- tensor-parallel serving under the placement plans (phase 5m) -------------

# (label, arch, serve, (data, model) mesh, layers or 0 for all): 5l(b)
# granite-moe, 5m(a) granite-3-2b and 5m(b) mamba2-1.3b at full width
# and depth; 5m(d) qwen2.5-3b at full width, 4 layers, whose 2 KV heads
# the 4 "model" ranks cut (the head-cut path)
# (label, arch, serve, (data, model), layers: 0 for all); 5m(a) runs 8
# steps (cut from 16: the script's time); `extra` is whisper's frames
TP_SERVE = (("5l(b)", MESH_ARCH, MESH_SERVE, (2, 2), 0),
            ("5m(a)", "granite-3-2b", dict(batch=8, prompt=512, pad_to=1024,
                                           steps=8), (2, 2), 0),
            ("5m(b)", "mamba2-1.3b", dict(batch=4, prompt=1024, pad_to=1024,
                                          steps=8), (2, 2), 0),
            ("5m(d)", "qwen2.5-3b", dict(batch=4, prompt=256, pad_to=512,
                                         steps=8), (1, 4), 4),
            ("5n(a)", "recurrentgemma-2b", dict(batch=4, prompt=2048,
                                                pad_to=2048, steps=8),
             (2, 2), 0),
            ("5n(b)", "whisper-tiny", dict(batch=8, prompt=4, pad_to=1500,
                                           steps=16, extra=1500), (2, 2), 0),
            # 5o(b): `{"vocab_pad_to": 1}` planned as configured: 49,155
            # rows do not divide over "model", so the embedding and the
            # logits go to d_model
            ("5o(b)", "granite-3-2b", dict(batch=8, prompt=512, pad_to=1024,
                                           steps=8, overrides={
                                               "vocab_pad_to": 1}),
             (2, 2), 0))
# 5n(c): granite-3-2b at full width, 20 of its 40 layers (four ranks'
# float32 weights, gradients and ZeRO moments share the one card), remat,
# a 4 x 1,024 global batch on (data 2, model 2): one step held against
# one process on the same batch, 2 more, then one of 2 microbatches. The
# moments start at m = 0, v = TRAIN_TP_V0 on both sides, so that AdamW's
# first step is m / (sqrt(v) + eps) of a gradient known to about 1e-6,
# not the sign of a gradient element near eps
TRAIN_TP = dict(arch="granite-3-2b", layers=20, batch=4, seq=1024,
                mesh=(2, 2), steps=2)
TRAIN_TP_V0 = 1e-4
TRAIN_TP_SAMPLES = 512               # elements a leaf's piece is held by
TP_SEED = 6
TP_LIMIT_S = 600                     # the ranks are killed past this


def tp_cfg(name, layers=0, overrides=None):
    """The arch at full width in float32 (`layers` deep, all of them for
    0), its vocabulary padded to 256 as the dry run plans it, then the
    config `overrides`."""
    from repro_torch.configs import get_config
    cfg = get_config(name).replace(dtype=torch.float32, **{
        "vocab_pad_to": 256, **(overrides or {})})
    return cfg.replace(n_layers=layers) if layers else cfg


def tp_whole_logits(group, vocab):
    """A data shard's logits at one step from its "model" ranks: their
    vocabulary shares put together, or, where the plan splits the
    embedding over d_model, the whole logits every rank holds (alike)."""
    if group[0].shape[-1] == vocab:
        check(all(np.array_equal(g, group[0]) for g in group),
              "the model ranks' whole logits differ")
        return group[0]
    return np.concatenate(group, -1)


def tp_cut(cfg, m):
    """Whether the plan cuts the attention's KV heads over m "model"
    ranks."""
    return (any(b.mixer == "attn" for b in cfg.layer_types)
            and cfg.n_kv_heads % m != 0)


def tp_want(cfg, d, m, decode):
    """The collectives one forward makes under the plan over d "data"
    and m "model" ranks, as PERF.md predicts them: one all-reduce over
    "model" each for the embedding, every `wo`, dense `down` and MoE
    `out`, and the SSD's gated norm and `out_proj`, one over "data" for
    each MoE layer's aux; one all-gather for the greedy token, at decode
    one for each SSD layer's conv_B / conv_C channels, and where the
    plan cuts the KV heads one for each attention layer's projections
    and, at decode, one more for K3's outputs and (max, exp-sum) over
    the slots."""
    if cfg.is_encdec:             # whole heads (whisper-tiny on 2 ranks)
        per_dec = 3                   # self and cross `wo`, the MLP
        return {"all_reduce": 1 + cfg.n_layers * per_dec
                + (0 if decode else 2 * cfg.n_enc_layers),
                "all_gather": 1 + (0 if decode else 1),
                "reduce_scatter": 0}
    n_attn = sum(b.mixer == "attn" for b in cfg.layer_types)
    n_ssd = sum(b.mixer == "ssd" for b in cfg.layer_types)
    n_lru = sum(b.mixer == "rglru" for b in cfg.layer_types)
    n_dense = sum(b.mlp == "dense" for b in cfg.layer_types)
    n_moe = sum(b.mlp == "moe" for b in cfg.layer_types)
    cut = n_attn * (2 if decode else 1) if tp_cut(cfg, m) else 0
    return {"all_reduce": 1 + n_attn + n_dense + 2 * n_ssd + n_lru
            + n_moe * (1 + (d > 1)),
            "all_gather": 1 + (n_ssd if decode else 0) + cut + n_lru,
            "reduce_scatter": 0}


def spawn_mesh_ranks(target, args, limit_s, label):
    """Run `target(init_method, rank, 4, *args, queue)` in 4 spawned
    processes (a FileStore under build/), drain what each puts on the
    queue, kill any left past `limit_s`; fails unless all 4 exit 0 and
    report. Returns (the reports by rank, seconds)."""
    import multiprocessing
    import queue as stdqueue
    import signal
    store = Path(__file__).resolve().parent / "build" / f"{label}_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target,
                         args=(f"file://{store}", r, 4) + tuple(args)
                         + (queue,)) for r in range(4)]
    for p in procs:
        p.start()
    ranks = []
    try:      # drain the queue first: a rank exits once its put is read
        deadline = t0 + limit_s
        while len(ranks) < 4:
            if not any(p.is_alive() for p in procs) and queue.empty():
                break
            try:
                ranks.append(queue.get(timeout=max(
                    min(deadline - time.perf_counter(), 5.0), 0.1)))
            except stdqueue.Empty:
                if time.perf_counter() > deadline:
                    break
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * 4 and len(ranks) == 4,
          f"{label} ranks exit codes {codes}, {len(ranks)} reported "
          f"(limit {limit_s} s)")
    return sorted(ranks, key=lambda r: r["rank"]), time.perf_counter() - t0


def _peak_bytes(device):
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _reset_peak(device):
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _allocated(device):
    return torch.cuda.memory_allocated() if device == "cuda" else 0


TRAIN_TP_SEED = 12                   # the batch's


def train_tp_cfg():
    from repro_torch.models.config import ShapeSpec
    t = TRAIN_TP
    cfg = tp_cfg(t["arch"], t["layers"]).replace(remat=True)
    return cfg, ShapeSpec("tp_train", t["seq"], t["batch"], "train")


def train_tp_batch(cfg, shape):
    from repro_torch.training.data import batch_for
    return {k: torch.from_numpy(v).to(DEV) for k, v in batch_for(
        cfg, shape.seq_len, shape.global_batch, seed=TRAIN_TP_SEED).items()}


def train_tp_state(state):
    """AdamW's moments at m = 0, v = TRAIN_TP_V0 (see TRAIN_TP)."""
    for v in state["v"].values():
        v.fill_(TRAIN_TP_V0)
    return state


def leaf_sample(t):
    """(TRAIN_TP_SAMPLES elements of `t` at an even stride, its largest
    magnitude), on the host."""
    f = t.detach().reshape(-1)
    stride = max(1, f.numel() // TRAIN_TP_SAMPLES)
    return (f[::stride][:TRAIN_TP_SAMPLES].float().cpu().numpy().copy(),
            float(f.abs().max()))


def tp_train_rank(rank, mesh, device, cfg, shape):
    """5n(c) on one rank: granite-3-2b (TRAIN_TP) drawn on the card from
    TP_SEED and cut to this rank's pieces under `lower_cell`'s train
    plan; its rows of the batch; its ZeRO moments' pieces; then
    TRAIN_TP["steps"] steps of `make_train_step(..., plan=, mesh=)` and
    one of 2 microbatches: per step ms, peak memory, the metrics and the
    collectives by kind; after the first, samples of every moment's and
    parameter's piece (`leaf_sample`)."""
    from repro_torch.distributed import shardctx
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import init_opt_state, lower_cell, \
        make_train_step
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamWConfig
    _reset_peak(device)
    model = Model(cfg, device=None if device == "cuda" else device,
                  seed=TP_SEED)
    plan, meta, _ = lower_cell(cfg, shape, mesh)
    shr.shard_params(model, plan["params"], mesh, rank)
    if device == "cuda":
        torch.cuda.empty_cache()
    whole = train_tp_batch(cfg, shape)
    batch = shr.shard_batch(whole, shr.batch_pspecs(whole, mesh), mesh,
                            rank)
    del whole
    state = train_tp_state(init_opt_state(model, plan=plan, mesh=mesh))
    ocfg = AdamWConfig(**TRAIN_CHECK_OPT)
    out = dict(steps=[], meta=meta)
    for k, n in ((1, TRAIN_TP["steps"]), (2, 1)):
        step = make_train_step(model, ocfg, k, plan=plan, mesh=mesh)
        for i in range(n):
            shardctx.reset_collectives()
            _reset_peak(device)
            t0 = time.perf_counter()
            state, mets = step(state, batch)
            _sync(device)
            out["steps"].append(dict(
                microbatches=k, ms=(time.perf_counter() - t0) * 1e3,
                peak_bytes=_peak_bytes(device),
                **{m: float(v) for m, v in mets.items()},
                collectives={c: v["count"] for c, v in
                             shardctx.COLLECTIVES.items()},
                collective_bytes={c: v["bytes"] for c, v in
                                  shardctx.COLLECTIVES.items()}))
            if not out["steps"][1:]:
                out["m"] = {p: leaf_sample(t) for p, t in state["m"].items()}
                out["params"] = {n_: leaf_sample(p) for n_, p in
                                 model.named_parameters()}
    del model, state, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def train_tp_one_process(device, cfg, shape):
    """5n(c)'s first step by one process on the whole batch, the same
    weights and moments: (metrics, ms, peak bytes, the model, the
    state)."""
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamWConfig
    _reset_peak(device)
    model = Model(cfg, device=None if device == "cuda" else device,
                  seed=TP_SEED)
    batch = train_tp_batch(cfg, shape)
    state = train_tp_state(init_opt_state(model))
    step = make_train_step(model, AdamWConfig(**TRAIN_CHECK_OPT))
    t0 = time.perf_counter()
    state, mets = step(state, batch)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return ({k: float(v) for k, v in mets.items()}, ms,
            _peak_bytes(device), model, state)


def tp_train_compare(ranks, cfg, shape):
    """5n(c): each rank's first step against one process's: loss, ce and
    grad_norm within TRAIN_TOL["loss"] relative, every moment's and
    parameter's sampled piece within TRAIN_TOL["grad"] / ["param"] of
    the piece's scale; the losses finite and falling; every rank with
    the same collectives."""
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import lower_cell
    d, m = TRAIN_TP["mesh"]
    sizes = {"data": d, "model": m}
    plan, _, _ = lower_cell(cfg, shape, sizes)
    mets, ms, peak, model, state = train_tp_one_process(DEV, cfg, shape)
    params = dict(model.named_parameters())
    groups = shr.stacked_groups(cfg, params)
    m_err = p_err = 0.0
    with torch.no_grad():
        for r, rank in enumerate(ranks):
            got = rank["train"]
            for path, (names, st) in groups.items():
                piece = shr.local_piece(
                    shr.stack_group(state["m"], names, st),
                    plan["opt"]["m"][path].spec, sizes, r)
                want, scale = leaf_sample(piece)
                m_err = max(m_err, float(np.abs(
                    got["m"][path][0] - want).max()) / max(scale, 1e-30))
            for name, p in params.items():
                piece = shr.local_piece(p, shr._layer_spec(
                    cfg, name, plan["params"]), sizes, r)
                want, scale = leaf_sample(piece)
                p_err = max(p_err, float(np.abs(
                    got["params"][name][0] - want).max()) / max(scale, 1e-30))
    del model, state, params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    first = [rk["train"]["steps"][0] for rk in ranks]
    rel = {k: max(abs(f[k] - mets[k]) / max(abs(mets[k]), 1e-30)
                  for f in first) for k in ("loss", "ce", "grad_norm")}
    losses = [s["loss"] for s in ranks[0]["train"]["steps"]]
    n = TRAIN_TP["steps"]
    row = dict(
        part="5n(c)", model=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, dtype="float32", remat=True,
        mesh=sizes, backend="gloo", ranks=4,
        global_batch=shape.global_batch, seq=shape.seq_len,
        microbatches_planned=ranks[0]["train"]["meta"]["microbatches"],
        optimizer=dict(TRAIN_CHECK_OPT, v0=TRAIN_TP_V0),
        one_process=dict(mets, ms=ms, peak_gb=peak / 1e9),
        sharded_first=dict(first[0], ms_per_rank=[f["ms"] for f in first],
                           peak_gb_per_rank=[f["peak_bytes"] / 1e9
                                             for f in first]),
        rel_err=rel, m_sample_max_rel_err=m_err,
        param_sample_max_rel_err=p_err, samples_per_leaf=TRAIN_TP_SAMPLES,
        tolerance=TRAIN_TOL, losses=losses,
        steps=[{k: s[k] for k in ("microbatches", "ms", "loss", "grad_norm",
                                  "collectives", "collective_bytes")}
               | {"peak_gb": s["peak_bytes"] / 1e9}
               for s in ranks[0]["train"]["steps"]],
        ms_per_step_per_rank=[[s["ms"] for s in rk["train"]["steps"]]
                              for rk in ranks])
    emit("tp_train", **row)
    check(max(rel.values()) <= TRAIN_TOL["loss"]
          and m_err <= TRAIN_TOL["grad"] and p_err <= TRAIN_TOL["param"],
          f"5n(c): the sharded step against one process: {rel}, moments "
          f"{m_err}, parameters {p_err}")
    check(all(np.isfinite(losses)) and losses[n - 1] < losses[0],
          f"5n(c): losses {losses} not finite and falling")
    check(all(rk["train"]["steps"][i]["collectives"]
              == ranks[0]["train"]["steps"][i]["collectives"]
              for rk in ranks for i in range(n + 1)),
          "5n(c): the ranks' collectives differ")
    return row


def tp_rank(init_method, rank, world, device, serves, ar_numel, train,
            queue):
    """One rank of phases 5l(b, c) and 5m: join the gloo group and for
    each (config, serve, mesh shape): build the (data, model) mesh, draw
    the float32 model on the card from TP_SEED, cut it to this rank's
    pieces under the plan (`lower_cell`, `shard_params`), serve its data
    shard's rows through `lower_cell`'s prefill and decode steps (K3 /
    K4 and the collectives counted from 0 per forward; a MoE model's
    experts of every call recorded, `route_recorder`); then 5l(c):
    `shardmap_allreduce` of this rank's `ar_numel` float32 gradient over
    each MESH_AR_AXES on the (data 2, model 2) mesh, held bitwise
    against the one-process arithmetic; then 5n(c), the train step
    (`tp_train_rank`). Puts this rank's logits shares, tokens, times,
    peak memory, the all-reduces and the train steps on `queue`."""
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed import shardctx
    from repro_torch.distributed.compression import shardmap_allreduce
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models import Model, moe
    from repro_torch.models.config import ShapeSpec
    globals()["DEV"] = device
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = dict(rank=rank, rendezvous_s=time.perf_counter() - t0, runs={})
    try:
        meshes = {}
        for i, (cfg, serve, shape) in enumerate(serves):
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            before = _allocated(device)
            t1 = time.perf_counter()
            model = Model(cfg, device=None if device == "cuda" else device,
                          seed=TP_SEED)
            B, S = serve["batch"], serve["pad_to"]
            plan, _, step = lower_cell(
                cfg, ShapeSpec("tp_prefill", S, B, "prefill"), mesh)
            _, _, dstep = lower_cell(
                cfg, ShapeSpec("tp_decode", S, B, "decode"), mesh)
            if "overrides" in serve:     # planned as configured (5o(b))
                plan = dict(plan, params=shr.param_pspecs(
                    Model(cfg, device="meta"), mesh))
            shr.shard_params(model, plan["params"], mesh, rank)
            if device == "cuda":
                torch.cuda.empty_cache()
            _sync(device)
            run = dict(init_s=time.perf_counter() - t1,
                       embed_spec=plan["params"]["['embed']"].spec,
                       params_kept=sum(p.numel()
                                       for p in model.parameters()))
            batch = shr.shard_batch(
                zoo_batch(cfg, B, serve["prompt"], serve.get("extra", 0)),
                plan["batch"], mesh, rank)
            logits, tokens, colls = [], [], []

            def record(tok, lg):
                logits.append(lg.cpu().numpy())
                tokens.append(tok.reshape(-1).cpu().numpy())
                colls.append({k: v["count"]
                              for k, v in shardctx.COLLECTIVES.items()})
                shardctx.reset_collectives()
            experts = []
            if cfg.n_experts:
                moe.moe_layer.route = route_recorder(experts)
            k3.reset_counts()
            k4.reset_counts()
            shardctx.reset_collectives()
            _reset_peak(device)
            run["allocated_before_draw"] = before
            run["allocated_at_serve"] = _allocated(device)
            t1 = time.perf_counter()
            tok, cache = step(model, batch)
            _sync(device)
            t2 = time.perf_counter()
            record(tok, step.last["logits"])
            tok = tok[:, None]
            dec_s = 0.0
            for _ in range(serve["steps"]):
                _sync(device)
                t3 = time.perf_counter()
                tok, cache = dstep(model, cache, tok)
                _sync(device)
                dec_s += time.perf_counter() - t3
                record(tok, dstep.last["logits"])
            moe.moe_layer.route = None
            run.update(zoo_counts(k3, k4), prefill_ms=(t2 - t1) * 1e3,
                       decode_ms_per_step=dec_s * 1e3 / serve["steps"],
                       peak_bytes=_peak_bytes(device), logits=logits,
                       tokens=tokens, collectives=colls, experts=experts,
                       cache_bytes=sum(t.numel() * t.element_size()
                                       for layer in cache["layers"]
                                       for t in layer.values()
                                       if isinstance(t, torch.Tensor)))
            out["runs"][i] = run
            del model, cache, step, dstep
            if device == "cuda":
                torch.cuda.empty_cache()
        mesh = meshes[(2, 2)]
        xs = mesh_ar_inputs(device, ar_numel)
        ar = {}
        for axes in MESH_AR_AXES:
            group = next(g for g in mesh_groups(axes) if rank in g)
            got = shardmap_allreduce(xs[rank], mesh, axes)
            want = allreduce_one_process(xs, group)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            times = []
            for _ in range(3):
                _sync(device)
                t1 = time.perf_counter()
                shardmap_allreduce(xs[rank], mesh, axes)
                _sync(device)
                times.append((time.perf_counter() - t1) * 1e3)
            ar["+".join(axes)] = dict(bitwise=same, ms=sorted(times)[1],
                                      ranks=len(group))
        out["allreduce"] = ar
        del xs
        if device == "cuda":
            torch.cuda.empty_cache()
        out["train"] = tp_train_rank(rank, meshes[TRAIN_TP["mesh"]], device,
                                     *train)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    queue.put(out)


# the probability gap between the k-th and (k+1)-th expert that the
# ranks' rounding can close: their MoE inputs differ from one process's
# by about 1e-5 of 5 (the row-split `wo` and d_ff sums), which moves a
# router probability near 1 / 40 by a few 1e-7
ROUTE_TIE = 1e-6


def route_recorder(store):
    """A `moe_layer.route` that keeps each call's experts (int16 on the
    host) and changes nothing."""
    def route(idx, probs):
        store.append(idx.to(torch.int16).cpu().numpy())
        return idx
    return route


def route_replayer(calls, gaps):
    """A `moe_layer.route` that hands back the recorded calls' experts in
    order; for each token whose own top-k set differs it appends the gap
    between its own k-th and (k+1)-th probabilities to `gaps`."""
    it = iter(calls)

    def route(idx, probs):
        rec = torch.from_numpy(next(it)).to(idx.device, torch.long)
        k = idx.shape[1]
        diff = (rec.sort(-1).values != idx.sort(-1).values).any(-1)
        if bool(diff.any()):
            top = probs.topk(k + 1, -1).values
            gaps.extend((top[:, k - 1] - top[:, k])[diff].tolist())
        return rec
    return route


def one_process(cfg, serve, device, seed, shards=2, routes=None):
    """Each of `shards` data shards' rows served by one process with the
    whole model drawn from `seed` (no mesh; 5l and 5m): every step's
    logits and tokens, prefill ms, decode ms a step and peak memory. With
    `routes` (a shard's recorded experts of every MoE call, from its
    ranks) the MoE layers replay them (`route_replayer`), and each
    shard's `route_gaps` lists the tokens whose own choice differed."""
    from repro_torch.models import Model, greedy_sample, moe
    model = Model(cfg, device=None if device == "cuda" else device,
                  seed=seed)
    rows = serve["batch"] // shards
    whole = zoo_batch(cfg, serve["batch"], serve["prompt"],
                      serve.get("extra", 0))
    out = []
    for j in range(shards):
        gaps = []
        if routes is not None:
            moe.moe_layer.route = route_replayer(routes[j], gaps)
        _reset_peak(device)
        t1 = time.perf_counter()
        lg, cache = model.prefill({k: v[j * rows:(j + 1) * rows]
                                   for k, v in whole.items()},
                                  pad_to=serve["pad_to"])
        _sync(device)
        t2 = time.perf_counter()
        logits, toks = [lg.cpu().numpy()], [greedy_sample(lg).cpu().numpy()]
        dec_s = 0.0
        for _ in range(serve["steps"]):
            t3 = time.perf_counter()
            lg, cache = model.decode(cache, greedy_sample(lg)[:, None])
            _sync(device)
            dec_s += time.perf_counter() - t3
            logits.append(lg.cpu().numpy())
            toks.append(greedy_sample(lg).cpu().numpy())
        moe.moe_layer.route = None
        out.append(dict(logits=logits, tokens=toks,
                        prefill_ms=(t2 - t1) * 1e3,
                        decode_ms_per_step=dec_s * 1e3 / serve["steps"],
                        peak_bytes=_peak_bytes(device), route_gaps=gaps))
        del cache, lg
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_tp():
    """Phases 5l, 5m and 5n: (5l(a), also 5m(c)) the dry run, then the
    placement plans run on 4 gloo ranks on the one card, one spawn, each
    rank serving its data shard's rows through `lower_cell`'s steps on
    its pieces, in float32: (5l(b)) granite-moe, (5m(a)) granite-3-2b
    and (5m(b)) mamba2-1.3b at full width and depth on (data 2, model
    2); (5m(d)) qwen2.5-3b at full width, 4 layers, on (data 1, model
    4), whose 2 KV heads the plan cuts; (5n(a)) recurrentgemma-2b and
    (5n(b)) whisper-tiny at full width on (data 2, model 2). Each shard's tokens identical to
    one process, logits (its "model" ranks' vocabulary shares put
    together) within 1e-3 (granite-moe's one process replays the ranks'
    expert choices, and every token whose own top-8 differed must sit
    at a near-tie, its 8th and 9th probabilities within ROUTE_TIE; the
    "model" ranks of a shard route alike), every "model" rank with the same tokens, the
    collectives per forward `tp_want`'s, K3 launches = attention layers
    x steps a rank (b: 32 x 8, a: 40 x 8, d: 4 x 8, K3 over the rank's
    slots with its (max, exp-sum); 5n(a): 8 x 8 over 1,024 of 2,048
    slots; 5n(b): 2 x 4 x 16, self and cross), K4 = SSD layers a rank
    (b: 48), no plain call; prefill ms, decode ms a step and peak memory
    a rank beside one process. (5l(c)) `shardmap_allreduce` on the same
    ranks, bitwise the one-process arithmetic. (5n(c)) the train step
    under the plan on the same ranks (`tp_train_rank`,
    `tp_train_compare`). NCCL (a card a rank) is written, not run: one
    card here."""
    t_phase = time.perf_counter()
    dry = phase_dryrun()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    serves = tuple((tp_cfg(name, layers, serve.get("overrides")), serve,
                    shape) for _, name, serve, shape, layers in TP_SERVE)
    train = train_tp_cfg()
    ranks, ranks_s = spawn_mesh_ranks(
        tp_rank, (DEV, serves, MESH_AR_NUMEL, train), TP_LIMIT_S, "tp")
    rows = {}
    for i, ((label, *_), (cfg, serve, (d, m))) in enumerate(zip(TP_SERVE,
                                                                serves)):
        name = cfg.name
        runs = [r["runs"][i] for r in ranks]
        routes = [runs[j * m]["experts"] for j in range(d)] \
            if cfg.n_experts else None
        one = one_process(cfg, serve, DEV, TP_SEED, shards=d, routes=routes)
        gaps = [g for o in one for g in o["route_gaps"]]
        worst, same, agree = 0.0, True, True
        for j in range(d):
            group = runs[j * m:(j + 1) * m]
            for t in range(serve["steps"] + 1):
                want = one[j]["logits"][t]
                full = tp_whole_logits([g["logits"][t] for g in group],
                                       want.shape[-1])
                worst = max(worst, float(np.abs(full - want).max()))
                same &= bool(np.array_equal(group[0]["tokens"][t],
                                            one[j]["tokens"][t]))
                agree &= all(np.array_equal(g["tokens"][t],
                                            group[0]["tokens"][t])
                             for g in group)
            agree &= all(len(g["experts"]) == len(group[0]["experts"])
                         and all(np.array_equal(a, b) for a, b in zip(
                             g["experts"], group[0]["experts"]))
                         for g in group)
        want_c = [tp_want(cfg, d, m, False)] + \
            [tp_want(cfg, d, m, True)] * serve["steps"]
        n_attn = sum(b.mixer == "attn" for b in cfg.layer_types)
        n_ssd = sum(b.mixer == "ssd" for b in cfg.layer_types)
        # whisper: self- and cross-attention, two K3 calls a layer a step
        want_k3 = (2 if cfg.is_encdec else 1) * n_attn * serve["steps"]
        row = dict(
            part=label, model=name, layers=cfg.n_layers,
            embed_spec=runs[0]["embed_spec"],
            d_model=cfg.d_model, heads=(cfg.n_heads, cfg.n_kv_heads),
            head_cut=tp_cut(cfg, m), experts=cfg.n_experts, d_ff=cfg.d_ff,
            vocab=cfg.vocab, padded_vocab=cfg.padded_vocab, dtype="float32",
            mesh={"data": d, "model": m}, backend="gloo", ranks=4, **serve,
            rows_per_rank=serve["batch"] // d,
            params_kept_per_rank=[r["params_kept"] for r in runs],
            k3_launches_per_rank=[r["k3_launches"] for r in runs],
            k4_launches_per_rank=[r["k4_launches"] for r in runs],
            plain_calls=sum(r["k3_plain_calls"] + r["k4_plain_calls"]
                            for r in runs),
            collectives_per_forward=runs[0]["collectives"][:2],
            collectives_as_predicted=all(r["collectives"] == want_c
                                         for r in runs),
            sharded_prefill_ms=[r["prefill_ms"] for r in runs],
            sharded_decode_ms_per_step=[r["decode_ms_per_step"]
                                        for r in runs],
            sharded_peak_gb=[r["peak_bytes"] / 1e9 for r in runs],
            sharded_allocated_gb_before_draw=[
                r["allocated_before_draw"] / 1e9 for r in runs],
            sharded_allocated_gb_at_serve=[r["allocated_at_serve"] / 1e9
                                           for r in runs],
            sharded_cache_gb=[r["cache_bytes"] / 1e9 for r in runs],
            one_process_prefill_ms=[o["prefill_ms"] for o in one],
            one_process_decode_ms_per_step=[o["decode_ms_per_step"]
                                            for o in one],
            one_process_peak_gb=[o["peak_bytes"] / 1e9 for o in one],
            identical_tokens=same, logits_max_abs_err=worst, tolerance=1e-3,
            moe_calls_replayed=sum(len(r) for r in routes or ()),
            routing_flips=len(gaps), max_flip_gap=max(gaps, default=None),
            flip_gap_limit=ROUTE_TIE,
            model_ranks_agree=agree, init_s=[r["init_s"] for r in runs])
        emit("tp_serving", **row)
        check(all(g <= ROUTE_TIE for g in gaps),
              f"{label} {name}: the ranks routed {len(gaps)} tokens "
              f"otherwise than one process, gaps up to {max(gaps, default=0.0)} (above "
              f"{ROUTE_TIE}: not a near-tie)")
        check(same and worst <= 1e-3, f"{label} {name}: tokens identical="
              f"{same}, logits error {worst} (one process)")
        check(agree, f"{label} {name}: the model ranks of a shard disagree")
        check(row["collectives_as_predicted"],
              f"{label} {name}: collectives {runs[0]['collectives'][:2]}, "
              f"want {want_c[:2]}")
        check(row["k3_launches_per_rank"] == [want_k3] * 4
              and row["k4_launches_per_rank"] == [n_ssd] * 4
              and row["plain_calls"] == 0,
              f"{label} {name}: K3 {row['k3_launches_per_rank']} (want "
              f"{want_k3}), K4 {row['k4_launches_per_rank']} (want "
              f"{n_ssd}), plain {row['plain_calls']}")
        if "overrides" in serve:
            check(runs[0]["embed_spec"] == ((), ("model",)),
                  f"{label} {name}: the embedding's plan is "
                  f"{runs[0]['embed_spec']}, not d_model over \"model\"")
        rows[f"{label} {name}"] = row
    ar = {k: dict(v, numel=MESH_AR_NUMEL, mb=MESH_AR_NUMEL * 4 / 2 ** 20,
                  ms_per_rank=[r["allreduce"][k]["ms"] for r in ranks],
                  bitwise_every_rank=all(r["allreduce"][k]["bitwise"]
                                         for r in ranks))
          for k, v in ranks[0]["allreduce"].items()}
    emit("mesh_allreduce", **ar)
    emit("mesh_nccl", status="not run: one card; NCCL takes one card per "
         "rank (written, not verified on this machine)")
    check(all(v["bitwise_every_rank"] for v in ar.values()),
          f"5l(c): shardmap_allreduce not bitwise {ar}")
    train = tp_train_compare(ranks, *train)
    seconds = time.perf_counter() - t_phase
    emit("tp_done", seconds=seconds, dryrun_s=dry["seconds"],
         ranks_s=ranks_s, rendezvous_s=[r["rendezvous_s"] for r in ranks],
         dryrun_counted_cells=dry["counted"],
         script_s=time.perf_counter() - T_START)
    return dict(dryrun=dry, serving=rows, allreduce=ar, train=train,
                seconds=seconds,
                k3_launches={n: sum(r["k3_launches_per_rank"])
                             for n, r in rows.items()},
                k4_launches={n: sum(r["k4_launches_per_rank"])
                             for n, r in rows.items()
                             if r["k4_launches_per_rank"][0]})


# -- the four serving examples (phase 5j) -------------------------------------

EXAMPLES = ("quickstart", "budget_serving", "serve_cluster", "zoo_serving")
EXAMPLE_ARGV = ()     # the reference's sizes (a rehearsal may shrink them)


def example_launches(rows):
    """(K1, K2) launches the example's arms must make: one K1 launch per
    fired batch of a RouteBalance engine (the hierarchy's cell engines
    too), one K2 launch per scoring call of a baseline."""
    k1 = k2 = 0
    for row in rows:
        eng = row["engine"]
        for e in getattr(eng, "engines", None) or [eng]:
            if e.policy.name == "routebalance":
                k1 += len(e.compute_log)
            else:
                k2 += len(e.compute_log)
    return k1, k2


def phase_examples(mk, kt):
    """Phase 5j: `examples/torch_{quickstart, budget_serving,
    serve_cluster, zoo_serving}.py` on the card at the reference's sizes,
    each run as a user runs it (`main([])`), its printed lines kept:
    every request terminal once, K1 and K2 launches as its arms need
    (`example_launches`) with no plain call, and the recorded K1 calls
    (the first, every 16th, the last) held against the plain version."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.serving.metrics import check_terminal_states
    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", root / "examples" / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rec = K1Recorder(events=0)
        mk.reset_counts()
        kt.reset_counts()
        mk.decision_megakernel.tap = rec
        printed = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rows = mod.main(list(EXAMPLE_ARGV) + (
                    [] if DEV == "cuda" else ["--device", "cpu"]))
            wall = time.perf_counter() - t0
        finally:
            mk.decision_megakernel.tap = None
        k1, k2 = k1_counts(mk), k2_counts(kt)
        want = example_launches(rows)
        cells = {}
        for row in rows:
            reqs, m = row["requests"], row["metrics"]
            check_terminal_states(reqs)
            check(m["n"] + m["failed"] + m["shed"] == len(reqs),
                  f"{name}/{row['cell']}: requests not all terminal once")
            cells[row["cell"]] = {k: m.get(k) for k in (
                "n", "failed", "shed", "quality", "mean_e2e", "p99_e2e",
                "cost_per_req", "mix", "exhausted_frac", "served_quality",
                "throughput", "measured_decide_ms_mean",
                "measured_decide_ms_per_req", "mean_batch_size")}
            bal = getattr(row["engine"], "balancer", None)
            if bal is not None:
                cells[row["cell"]].update(
                    digests=bal.digests_sent, wire_bytes=bal.bytes_sent,
                    imbalance=bal.imbalance())
        held = hold_recorded_k1(mk, rec, f"example {name}")
        out[name] = dict(k1_launches=k1[0], k1_plain_calls=k1[1],
                         k2_launches=k2[0], k2_plain_calls=k2[1],
                         wall_s=wall, cells=cells,
                         printed=printed.getvalue().splitlines(),
                         recorded_vs_plain=held)
        emit("example", name=name, **out[name])
        check((k1[0], k2[0]) == want and k1[0] > 0,
              f"example {name}: (K1, K2) launches {(k1[0], k2[0])}, its "
              f"arms need {want}")
        check(k1[1] == 0 and k2[1] == 0,
              f"example {name}: plain calls K1 {k1[1]}, K2 {k2[1]}")
        check(rec.n == k1[0], f"example {name}: the tap saw {rec.n} of "
              f"{k1[0]} K1 calls")
    check(out["serve_cluster"]["k2_launches"] > 0,
          "serve_cluster: the BEST-Route arms made no K2 launch")
    emit("examples_done", seconds=time.perf_counter() - t_phase)
    return out


# -- model-zoo kernels: K3 decode attention, K4 SSD scan ----------------------

DEV = "cuda"
K3_SERVE = dict(B=8, K=2, g=8, d=128, C=1024)
# the decode shapes of phase 5h's families, held in phase 3c: the
# recurrentgemma ring wrapped at 2,048 (g = 10 over head groups of 4, a
# partial group; g d / 8 = 320 pairs > 256 threads; d = 256, the
# kernel's largest), phi-3-vision's d = 96, granite-moe's g = 3, whisper's
# cross-attention over 1,500 frames (all valid, pos past them) and its
# 448-slot self-attention ring, mixtral's windowed g = 4; phase 5i's
# trained granite-3-2b, 4 x 512 then 16 steps in a 528-slot cache;
# phase 5l's granite-moe rank, 4 rows of 512 then 8 steps, 12 q / 4 kv
# heads (the plan's "model" half); phase 5m's
# granite-3-2b rank (4 rows, 16 q / 4 kv heads, 512 + 16 of 1,024 slots)
# and its qwen2.5-3b ranks, whose KV heads the plan cuts: K3 over a
# rank's 128 of 512 slots with every head, its (max, exp-sum) too
# (`stats`), on a share all valid, 8 valid and none valid; phase 5n's
# ranks: recurrentgemma's 2 rows over 1,024 of its 2,048 ring slots
# (its one KV head cut in half, g = 10, d = 256, the window masking the
# share's oldest 8 positions) with the stats, and whisper's 3 heads of
# 64 a rank over its 448 self slots and 1,500 cross frames
K3_ZOO = {
    "recurrentgemma-2b": dict(B=4, K=1, g=10, d=256, C=2048, valid=2112,
                              window=2048),
    "phi-3-vision-4.2b": dict(B=4, K=32, g=1, d=96, C=1024, valid=700),
    "granite-moe-3b-a800m": dict(B=8, K=8, g=3, d=64, C=1024, valid=600),
    "granite-moe-3b-a800m/mesh": dict(B=4, K=4, g=3, d=64, C=1024,
                                      valid=520),
    "whisper-tiny/cross": dict(B=8, K=6, g=1, d=64, C=1500, valid=1500,
                               pos=1500),
    "whisper-tiny/self": dict(B=8, K=6, g=1, d=64, C=448, valid=68),
    "mixtral-8x7b": dict(B=4, K=8, g=4, d=128, C=1024, valid=540,
                         window=4096),
    "granite-3-2b": dict(B=4, K=8, g=4, d=64, C=528, valid=528),
    "granite-3-2b/tp": dict(B=4, K=4, g=4, d=64, C=1024, valid=528),
    "qwen2.5-3b/cut": dict(B=4, K=2, g=8, d=128, C=128, valid=128, pos=263,
                           stats=True),
    "qwen2.5-3b/cut-tail": dict(B=4, K=2, g=8, d=128, C=128, valid=8,
                                pos=263, stats=True),
    "qwen2.5-3b/cut-empty": dict(B=4, K=2, g=8, d=128, C=128, valid=0,
                                 pos=263, stats=True),
    "recurrentgemma-2b/tp": dict(B=2, K=1, g=10, d=256, C=1024,
                                 valid=1024, pos=2055, window=2048,
                                 stats=True),
    "whisper-tiny/tp-self": dict(B=4, K=3, g=1, d=64, C=448, valid=20),
    "whisper-tiny/tp-cross": dict(B=4, K=3, g=1, d=64, C=1500, valid=1500,
                                  pos=1500)}
K4_SERVE = dict(B=4, S=1024, nh=64, P=64, N=128, G=1, chunk=128)


def k3_inputs(seed, B, K, g, d, C, valid, window=0, pos=None,
              dtype=torch.bfloat16):
    """q (B, H, d), caches (B, C, K, d), pos = valid - 1 unless given: the
    cache of a decode step at position `valid - 1`, positions
    0..valid-1 then -1, or, with valid > C, a ring buffer that has wrapped
    (slot j holds the latest position congruent to j mod C). A `pos`
    past every position is a cross-attention cache (every slot valid)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    H = K * g
    q, kc, vc = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
                 for shape in ((B, H, d), (B, C, K, d), (B, C, K, d)))
    last = valid - 1
    cpos = torch.arange(C, dtype=torch.int32, device=DEV)
    if valid > C:
        cpos = last - (last - cpos) % C
    cpos[valid:] = -1
    return (q, kc, vc, cpos), last if pos is None else pos, window


def close(got, want, rtol, atol_rel):
    """|got - want| <= rtol |want| + atol_rel * max(1, max |want|);
    returns (ok, max abs error)."""
    got, want = got.float(), want.float()
    atol = atol_rel * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    return bool((err <= rtol * want.abs() + atol).all()), float(err.max())


def stats_close(got, want):
    """K3's (max, exp-sum) pairs (B, H, 2): where no slot is valid both
    exactly (-1e30, 0), elsewhere the max within rtol 1e-6 and the sum
    within rtol 1e-5; returns (ok, max abs error)."""
    empty = want[..., 0] <= -1e29
    ok = bool(torch.equal(got[empty], want[empty]))
    err = 0.0
    for j, rtol in ((0, 1e-6), (1, 1e-5)):
        g, w = got[..., j][~empty], want[..., j][~empty]
        if w.numel():
            e = (g - w).abs()
            ok &= bool((e <= rtol * w.abs() + 1e-30).all())
            err = max(err, float(e.max()))
    return ok, err


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
    cases = [(None, c) for c in cases] + list(K3_ZOO.items())
    max_abs = 0.0
    for seed, (model, case) in enumerate(cases):
        stats = case.get("stats", False)
        shape = {k: v for k, v in case.items() if k != "stats"}
        for dtype in (torch.bfloat16, torch.float32):
            args, pos, window = k3_inputs(500 + seed, dtype=dtype, **shape)
            got = k3.decode_attention(*args, pos, window, stats)
            torch.cuda.synchronize()
            want = k3.decode_attention_plain(*args, pos, window, stats)
            rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
            extra = {}
            if stats:
                (got, got_ml), (want, want_ml) = got, want
                ok_ml, err_ml = stats_close(got_ml, want_ml)
                extra = dict(stats_max_abs_err=err_ml,
                             stats_tolerance="max: rtol 1e-6; exp-sum: "
                             "rtol 1e-5; -1e30 and 0 exactly where no "
                             "slot is valid")
                check(ok_ml, f"K3 {case} {dtype}: stats error {err_ml}")
            ok, err = close(got, want, rtol, 1e-5)
            max_abs = max(max_abs, err)
            if model is not None:
                layout = k3.pieces(case["B"], case["K"], case["C"],
                                   case["g"])
                extra = dict(extra, model=model, layout_from_shape=layout,
                             smem_bytes=k3._library().rt_decode_attention_smem(
                                 case["g"], case["d"], layout[2],
                                 k3.DTYPES[dtype]),
                             smem_limit=k3.smem_limit(args[0].device))
            emit("k3_check", **shape, **extra,
                 dtype=str(dtype).split(".")[-1], max_abs_err=err,
                 tolerance=f"rtol {rtol}, atol 1e-5 x scale")
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
             # 16 chunks a chain (longer than a cluster could hold); one
             # chunk; phase 5i's trained mamba2-1.3b, a 2 x 1,024 prefill
             dict(K4_SERVE, B=2, S=2048, nh=16), dict(K4_SERVE, S=128),
             dict(K4_SERVE, B=2),
             # phase 5m's mamba2-1.3b rank: 2 rows, 32 of 64 heads
             dict(K4_SERVE, B=2, nh=32)]
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


def phase_k3_times(k3, S=K3_SERVE, valid=544, window=0, cold_layers=36,
                   label="k3_times", seed=700):
    """K3 timed at shape S, `valid` - 1 the decode position (the default:
    qwen2.5-3b's serving shape mid-way through its 64 decode steps), with
    its caches warm and, over `cold_layers` layers' caches, cold."""
    import torch.nn.functional as F
    args, pos, window = k3_inputs(seed, valid=valid, window=window, **S)
    q, kc, vc, cpos = args

    def kernel():
        return k3.decode_attention(q, kc, vc, cpos, pos, window)
    # the library call on tensors laid out for it beforehand: (B, H, 1, d)
    # query, (B, K, C, d) cache, a (1, 1, 1, C) mask broadcast over heads
    ql = q[:, :, None, :]
    kl, vl = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    slots = k3._valid(cpos, pos, window)
    mask = slots[None, None, None, :]

    def library():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    torch.testing.assert_close(library()[:, :, 0].float(), kernel().float(),
                               rtol=2 ** -7, atol=2e-2)
    names = ("decode_attention_cluster",)
    b_ms, by, nbytes, flops = k3_bound_ms(valid=int(slots.sum()),
                                          itemsize=2, **S)
    b2b, lib_b2b = b2b_turns(kernel, library)
    row = dict(ms=time_ms(kernel),
               plain_ms=time_ms(lambda: k3.decode_attention_plain(
                   q, kc, vc, cpos, pos, window)),
               library_ms=time_ms(library), b2b_ms=b2b,
               library_b2b_ms=lib_b2b, bound_ms=b_ms, bound_by=by,
               peak_used="3.35 TB/s HBM; 67 TFLOP/s float32",
               bytes=nbytes, flops=flops,
               device_ms_by_function=required_split(kernel, names, label),
               layout_from_shape=dict(zip(
                   ("S", "tiles_per_piece", "tiles_per_segment"),
                   k3.pieces(S["B"], S["K"], S["C"], S["g"]))))
    (row["global_functions_per_call"],
     row["device_activities_per_call"]) = functions_per_call(
        kernel, names[0], label)
    if cold_layers:
        # cold: 36 layers' caches (302 MB, six times the L2), cycled as
        # the layers of a decode step find them
        layers = [k3_inputs(seed + 1 + i, valid=valid, window=window,
                            **S)[0] for i in range(cold_layers)]
        turn = iter(range(10 ** 9))

        def cold():
            return k3.decode_attention(*layers[next(turn) % cold_layers],
                                       pos, window)
        row.update(cold_ms=time_ms(cold, n=2 * cold_layers),
                   cold_b2b_ms=b2b_ms(cold, n=6 * cold_layers),
                   cold_device_ms_by_function=required_split(
                       cold, names, f"{label} cold", n=2 * cold_layers))
        (row["cold_global_functions_per_call"],
         row["cold_device_activities_per_call"]) = functions_per_call(
            cold, names[0], f"{label} cold")
        del layers
    emit(label, **S, valid=valid, window=window, dtype="bfloat16", **row,
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


def serve(model, batch, pad_to, steps):
    """`Model.prefill`, then `steps` greedy `Model.decode` steps; returns
    (prefill ms, decode ms per step, every step's logits finite, the last
    logits and cache)."""
    from repro_torch.models import greedy_sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, pad_to=pad_to)
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
    without the profiler), its device time by kind (float32 FFMA GEMMs,
    tensor-core GEMMs, the rest), the six kernels with the most device
    time and K3's device time (`decode_attention_cluster`). It records
    the device's activity alone: host-side operator events, which no
    number here reads, take minutes to gather for a training step's
    hundreds of thousands of operations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    f32_gemm = sum(ms for ms, name, _ in rows
                   if "gemm" in name and "f32f32_f32f32" in name)
    tc_gemm = sum(ms for ms, name, _ in rows
                  if ("gemm" in name or "nvjet" in name)
                  and "f32f32_f32f32" not in name)
    return dict(device_ms=device_ms, kernel_launches=launches,
                by_kind_ms=dict(float32_ffma_gemm=f32_gemm,
                                tensor_core_gemm=tc_gemm,
                                other=device_ms - f32_gemm - tc_gemm),
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


def zoo_batch(cfg, batch, prompt_len, extra, seed=7):
    """Prompt tokens (batch, prompt_len) from a seeded generator, plus
    `extra` image embeddings (`frontend_embeds`) or audio frames
    (`frames`) of width `frontend_dim` for the vision model or the
    encoder-decoder, on the card."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(DEV)}
    if extra:
        key = "frames" if cfg.is_encdec else "frontend_embeds"
        out[key] = torch.from_numpy(rng.standard_normal(
            (batch, extra, cfg.frontend_dim), dtype=np.float32)).to(DEV)
    return out


def greedy_run(model, batch, pad_to, steps):
    """Prefill then `steps` greedy decode steps: every step's logits, on
    the CPU."""
    from repro_torch.models import greedy_sample
    logits, cache = model.prefill(batch, pad_to=pad_to)
    out = [logits.cpu()]
    for _ in range(steps):
        logits, cache = model.decode(cache, greedy_sample(logits)[:, None])
        out.append(logits.cpu())
    return out


def card_then_cpu(cfg, prompt_len, extra, steps=8, tol=1e-3, weights=None):
    """The same float32 model (weights drawn on the card, seed 1, or the
    state dict `weights` cast to float32) run on the card (kernels), then
    moved to the CPU (plain versions) and run again on the same inputs:
    identical greedy tokens, logits within `tol`, up to the first step
    whose tokens differ."""
    from repro_torch.models import Model, greedy_sample
    model = Model(cfg, seed=1)
    if weights is not None:
        model.load_state_dict(weights)
    batch = zoo_batch(cfg, 2, prompt_len, extra, seed=9)
    pad_to = prompt_len + (0 if cfg.is_encdec else extra) + steps
    card = greedy_run(model, batch, pad_to, steps)
    model.to("cpu")
    cpu = greedy_run(model, {k: v.cpu() for k, v in batch.items()}, pad_to,
                     steps)
    del model
    torch.cuda.empty_cache()
    worst, same = 0.0, True
    for gl, cl in zip(card, cpu):
        worst = max(worst, float((gl - cl).abs().max()))
        same &= torch.equal(greedy_sample(gl), greedy_sample(cl))
        if not same:
            break
    return same, worst, tol


def zoo_counts(k3, k4):
    """K3 and K4 launches and plain calls since their last reset; in a
    CPU rehearsal (DEV "cpu") the plain calls stand for the launches."""
    a, b = k3.decode_attention, k4.ssd_scan
    if DEV == "cuda":
        return dict(k3_launches=a.launches, k3_plain_calls=a.plain_calls,
                    k4_launches=b.launches, k4_plain_calls=b.plain_calls)
    return dict(k3_launches=a.plain_calls, k3_plain_calls=0,
                k4_launches=b.plain_calls, k4_plain_calls=0)


def phase_zoo_serving(label, name, batch, prompt_len, pad_to, steps, k3, k4,
                      want_k3, want_k4, layers=None, extra=0, family=None):
    """One zoo model at full width (depth cut to `layers` where given):
    prefill and greedy decode counted, then profiled, then the card
    against the CPU in float32: `card_against_cpu` at 2 layers, or for
    phase 5h (`family` = (check layers, check extra inputs))
    `card_then_cpu` at that depth, the encoder cut alike. A MoE model's
    prefill must drop pairs and its decode none."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    t_phase = time.perf_counter()
    cfg = get_config(name)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    model = Model(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inputs = zoo_batch(cfg, batch, prompt_len, extra)
    k3.reset_counts()
    k4.reset_counts()
    n_moe = sum(b.mlp == "moe" for b in cfg.layer_types)
    drops = []
    if n_moe:
        moe.moe_layer.tap = lambda capacity, kept: drops.append(
            (capacity, kept.numel(), (~kept).sum()))
    try:
        pre_ms, dec_ms, finite, logits, cache = serve(model, inputs, pad_to,
                                                      steps)
    finally:
        moe.moe_layer.tap = None
    counts = zoo_counts(k3, k4)
    moe_row = {}
    if n_moe:
        dropped = [int(d) for _, _, d in drops]
        moe_row = dict(moe_calls=len(drops),
                       prefill_capacity=drops[0][0],
                       prefill_pairs_per_layer=drops[0][1],
                       prefill_dropped_pairs=sum(dropped[:n_moe]),
                       prefill_pairs=n_moe * drops[0][1],
                       decode_dropped_pairs=sum(dropped[n_moe:]))
    # where a step's time goes, after the counted run
    from repro_torch.models import greedy_sample
    decode_profile = device_profile(
        lambda: model.decode(cache, greedy_sample(logits)[:, None]), dec_ms)
    del cache
    prefill_profile = device_profile(
        lambda: model.prefill(inputs, pad_to=pad_to), pre_ms)
    params = sum(p.numel() for p in model.parameters())
    del model, logits
    torch.cuda.empty_cache()
    check_layers, check_extra = family or (2, 0)
    if family:
        cut = dict(n_layers=check_layers, dtype=torch.float32)
        if cfg.is_encdec:
            cut["n_enc_layers"] = check_layers
        same, worst, tol = card_then_cpu(
            get_config(name).replace(**cut),
            4 if cfg.is_encdec else 64, check_extra)
    else:
        same, worst, tol = card_against_cpu(cfg, 64, 8)
    cpu_check = dict(layers=check_layers, dtype="float32",
                     prompt=4 if cfg.is_encdec else 64, steps=8,
                     identical_tokens=same, logits_max_abs_err=worst,
                     tolerance=tol)
    if check_extra:
        cpu_check["frames" if cfg.is_encdec else "image_embeds"] = \
            check_extra
    if cfg.is_encdec:
        cpu_check["encoder_layers"] = check_layers
    reduced = {} if not layers else dict(
        reduced=f"depth {layers} of {get_config(name).n_layers} layers")
    emit(label, model=name, layers=cfg.n_layers, **reduced,
         d_model=cfg.d_model, params=params,
         dtype=str(cfg.dtype).split(".")[-1], batch=batch,
         prompt=prompt_len, **({"extra_inputs": extra} if extra else {}),
         pad_to=pad_to, decode_steps=steps, init_s=init_s,
         prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
         logits_finite=finite, **counts, **moe_row,
         prefill_profile=prefill_profile, decode_step_profile=decode_profile,
         cpu_check=cpu_check, seconds=time.perf_counter() - t_phase)
    check(finite, f"{name}: non-finite logits")
    check(counts["k3_launches"] == want_k3
          and counts["k4_launches"] == want_k4,
          f"{name}: launches {counts}, want K3 {want_k3}, K4 {want_k4}")
    check(counts["k3_plain_calls"] == counts["k4_plain_calls"] == 0,
          f"{name}: plain-version calls {counts}")
    if n_moe:
        check(moe_row["moe_calls"] == n_moe * (steps + 1)
              and moe_row["prefill_dropped_pairs"] > 0
              and moe_row["decode_dropped_pairs"] == 0,
              f"{name}: MoE drops {moe_row}: want pairs dropped at prefill "
              f"capacity and none at decode")
    check(same and worst <= tol,
          f"{name}: card vs CPU tokens identical={same}, logits error {worst}")
    return counts


# phase 5h at full width: (arch, batch, prompt tokens, pad_to, decode
# steps, K3 launches, image embeddings or audio frames, depth, the card
# against CPU check's (layers, extra inputs): a whole layer pattern, at
# least 2 layers as in 5d). mixtral's 32 layers (about 93 GB of bf16) do
# not fit one 80 GB card, so its depth is cut to 8.
# 16 decode steps each (cut from 32: the script's time)
ZOO_FAMILIES = (
    ("recurrentgemma-2b", 4, 2048, 2048, 8, 8 * 8, 0, None, (3, 0)),
    ("granite-moe-3b-a800m", 8, 512, 1024, 8, 32 * 8, 0, None, (2, 0)),
    ("phi-3-vision-4.2b", 4, 64, 1024, 8, 32 * 8, 576, None, (2, 32)),
    ("whisper-tiny", 8, 4, 0, 8, 2 * 4 * 8, 1500, None, (2, 1500)),
    ("mixtral-8x7b", 4, 512, 1024, 8, 8 * 8, 0, 8, (2, 0)),
)


def phase_zoo_families(k3, k4):
    """Phase 5h: each family served at full width through K3, then held
    card against CPU over a whole layer pattern."""
    t0 = time.perf_counter()
    out = {}
    for (name, batch, prompt, pad_to, steps, want_k3, extra, layers,
         family) in ZOO_FAMILIES:
        out[name] = phase_zoo_serving(
            "zoo_family", name, batch, prompt, pad_to, steps, k3, k4,
            want_k3=want_k3, want_k4=0, layers=layers, extra=extra,
            family=family)
    emit("zoo_families", seconds=time.perf_counter() - t0,
         k3_launches={k: v["k3_launches"] for k, v in out.items()})
    return out


# -- phase 5i: the zoo's training path on the card ----------------------------

TRAIN_FAMILIES = ("granite-3-2b", "mamba2-1.3b", "recurrentgemma-2b",
                  "granite-moe-3b-a800m", "phi-3-vision-4.2b", "whisper-tiny")
# card against CPU: loss, ce, aux and grad_norm within 1e-5 relative; each
# gradient leaf within 1e-4 of its largest magnitude; each parameter after
# one AdamW step within 1e-4 of its scale (max(|p|, lr)) plus what the
# measured gradient difference moves the step: AdamW's first step is
# lr g / (|g| + eps'), eps' = eps / clip scale, which moves by at most
# 2 lr |dg| / (|g| - |dg| + eps') (at most 2 lr, where the signs may differ)
TRAIN_TOL = dict(loss=1e-5, grad=1e-4, param=1e-4)
# the step at its peak rate (no warm-up), so that an update of about lr =
# 1e-3 an element stands well above the parameters' limit; a leaf is
# "seen" when leaving its update out would break that limit
TRAIN_CHECK_OPT = dict(lr=1e-3, warmup_steps=0)
# full width: (arch, batch, sequence, microbatches, warm-up, timed steps,
# serving check: (batch, prompt, decode steps, K3 launches, K4 launches))
TRAIN_WIDE = (("granite-3-2b", 4, 4096, 2, 1, 1, (4, 512, 16, 40 * 16, 0)),
              ("mamba2-1.3b", 2, 4096, 1, 1, 1, (2, 1024, 0, 0, 48)))
TRAIN_LOOP_STEPS = 40
# the trained weights' card-against-CPU check: 2 x this prompt, 8 steps
TRAINED_CPU_PROMPT = 64


def train_once(model, batch, ocfg):
    """One AdamW step by hand (value_and_grad, then update from a fresh
    state): the numbers and tensors the card-against-CPU check reads, on
    the CPU."""
    from repro_torch.training import optimizer as opt
    (loss, mets), grads = model.value_and_grad(batch)
    params = dict(model.named_parameters())
    before = {k: p.detach().to("cpu", torch.float32, copy=True)
              for k, p in params.items()}
    _, om = opt.update(ocfg, grads, opt.init(params), params)
    after = {k: p.detach().float().cpu() for k, p in params.items()}
    return dict(loss=float(loss), ce=float(mets["ce"]),
                aux=float(mets["aux"]), grad_norm=float(om["grad_norm"]),
                lr=float(om["lr"]),
                grads={k: g.float().cpu() for k, g in grads.items()},
                params=after,
                updates={k: after[k] - before[k] for k in after})


def train_card_against_cpu(name, cfg, B, S):
    """The same float32 model (weights drawn on the card, seed 1, then
    copied to the CPU) takes one train step on each: `TRAIN_TOL`."""
    import copy
    from repro_torch.models import Model
    from repro_torch.training.data import batch_for
    from repro_torch.training.optimizer import AdamWConfig
    card = Model(cfg, device=DEV, seed=1)
    cpu = copy.deepcopy(card).to("cpu")
    batch = batch_for(cfg, S, B, seed=11)
    ocfg = AdamWConfig(**TRAIN_CHECK_OPT)
    got = train_once(card, batch, ocfg)
    del card
    torch.cuda.empty_cache()
    want = train_once(cpu, batch, ocfg)
    del cpu
    lr = want["lr"]
    row = dict(model=name, layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab, batch=B, seq=S, dtype="float32", lr=lr,
               loss=(got["loss"], want["loss"]))
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
           for k in ("loss", "ce", "grad_norm")}
    rel["aux"] = abs(got["aux"] - want["aux"]) / max(abs(want["aux"]), 1.0)
    eps = ocfg.eps / min(1.0, ocfg.clip_norm / want["grad_norm"])
    grad_err = param_err = 0.0
    flips = n = 0
    unseen, margin = [], (float("inf"), None, 0.0, 0.0)
    for k, gc in want["grads"].items():
        gd = (got["grads"][k] - gc).abs()
        grad_err = max(grad_err, float(gd.max()) /
                       max(float(gc.abs().max()), 1e-30))
        pc = want["params"][k]
        pd = (got["params"][k] - pc).abs()
        scale = max(float(pc.abs().max()), lr)
        moved = lr * torch.clamp(
            2 * gd / ((gc.abs() - gd).clamp_min(0) + eps), max=2.0)
        param_err = max(param_err,
                        float((pd - moved).max()) / scale)
        # the error a missing update would give, against the limit
        limit = TRAIN_TOL["param"] * scale
        upd = want["updates"][k].abs()
        ratio = float((upd - moved).max()) / limit
        if ratio <= 1.0:
            unseen.append(k)
        if ratio < margin[0]:
            margin = (ratio, k, float(upd.max()), limit)
        flips += int((gc.abs() < gd).sum())
        n += pc.numel()
    row.update(rel_err=rel, grad_max_rel_err=grad_err,
               param_max_err_beyond_step_sensitivity=param_err,
               grad_elements_sign_uncertain=flips, params=n,
               leaves=len(want["params"]),
               leaves_seen=len(want["params"]) - len(unseen),
               leaves_unseen=unseen,
               least_margin=dict(leaf=margin[1], largest_update=margin[2],
                               limit=margin[3],
                               update_beyond_sensitivity_over_limit=margin[0]),
               tolerance=TRAIN_TOL, optimizer=TRAIN_CHECK_OPT)
    check(max(rel.values()) <= TRAIN_TOL["loss"]
          and grad_err <= TRAIN_TOL["grad"]
          and param_err <= TRAIN_TOL["param"],
          f"{name}: card vs CPU train step {row}")
    check(not unseen, f"{name}: the step check cannot see an update of "
          f"{unseen}")
    return row


def phase_train_checks():
    """5i.1: each assigned family's smoke variant and granite-3-2b cut to
    one layer at full width, one float32 train step, card against CPU."""
    from repro_torch.configs import get_config, smoke_variant
    t0 = time.perf_counter()
    rows = {}
    for name in TRAIN_FAMILIES:
        cfg = smoke_variant(get_config(name)).replace(dtype=torch.float32)
        rows[name] = train_card_against_cpu(name, cfg, 2, 24)
    wide = get_config("granite-3-2b").replace(n_layers=1,
                                              dtype=torch.float32)
    rows["granite-3-2b/1-layer"] = train_card_against_cpu(
        "granite-3-2b/1-layer", wide, 1, 1024)
    emit("train_card_vs_cpu", seconds=time.perf_counter() - t0, runs=rows)
    return rows


def attention_train_flops(cfg, B, S):
    """(the attention products of a training step by the usual count:
    forward QK and PV over the causal half, backward twice that; the
    float32 products this port runs: the live blocks of `flash_attention`
    (`attention._blocks`), forward twice under remat and 5 products in
    the backward)."""
    from repro_torch.models.attention import _blocks
    n_attn = sum(b.mixer == "attn" for b in cfg.layer_types)
    usual = 6.0 * S * S * cfg.hd * cfg.n_heads * B * n_attn
    bq = min(cfg.attn_chunk, S)
    n_live = len(_blocks(S // bq, S // bq, bq, bq, S, True, 0, "cpu"))
    passes = (4 if cfg.remat else 2) + 5
    run = passes * 2.0 * bq * bq * cfg.hd * cfg.n_heads * B * n_attn * n_live
    return usual, run


def phase_train_wide(name, B, S, k, warm, timed, serving, k3, k4):
    """5i.2-4: `arch` at full width in bf16 (remat as configured): warm-up
    and timed steps of `make_train_step`, each with its loss, grad_norm,
    lr, ms, tokens/s and peak memory; one step under the profiler; then
    the trained weights serve through K3 / K4, counted."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models import Model
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import AdamWConfig
    t_phase = time.perf_counter()
    cfg = get_config(name)
    model = Model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    state = init_opt_state(model)
    step = make_train_step(model, AdamWConfig(), microbatches=k)
    stream = TokenStream(cfg.vocab, S, B, seed=0).batches()
    k3.reset_counts()
    k4.reset_counts()
    steps = []
    for i in range(warm + timed):
        batch = next(stream)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(step=i, warmup=i < warm, loss=float(mets["loss"]),
                          grad_norm=float(mets["grad_norm"]),
                          lr=float(mets["lr"]), ms=ms,
                          tokens_per_s=B * S / ms * 1e3,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    kernel_calls = zoo_counts(k3, k4)
    step_ms = float(np.median([r["ms"] for r in steps[warm:]]))
    batch = next(stream)
    t0 = time.perf_counter()
    prof = device_profile(lambda: step(state, batch), step_ms)
    prof["profiled_step_s"] = time.perf_counter() - t0
    prof.pop("k3_device_ms")
    del state, step, batch
    torch.cuda.empty_cache()
    tokens = B * S
    flops = 6.0 * n_params * tokens
    attn_usual, attn_run = attention_train_flops(cfg, B, S)
    row = dict(model=name, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params, dtype=str(cfg.dtype).split(".")[-1],
               remat=cfg.remat, batch=B, seq=S, microbatches=k,
               tokens_per_step=tokens, steps=steps, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3,
               peak_gb=max(r["peak_gb"] for r in steps),
               train_kernel_calls=kernel_calls, step_profile=prof,
               model_flops=flops + attn_usual, flops_6nt=flops,
               attention_flops=attn_usual,
               model_flops_ms_at_bf16_peak=(flops + attn_usual)
               / BF16_FLOPS * 1e3,
               attention_float32_flops_run=attn_run,
               attention_float32_ms_at_fp32_peak=attn_run / FP32_FLOPS * 1e3)
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in steps), f"{name}: non-finite training step {steps}")
    check(kernel_calls["k3_plain_calls"] == kernel_calls["k4_plain_calls"]
          == 0, f"{name}: plain-version calls in training {kernel_calls}")
    # serve the trained weights
    sb, prompt, dsteps, want_k3, want_k4 = serving
    inputs = zoo_batch(cfg, sb, prompt, 0)
    k3.reset_counts()
    k4.reset_counts()
    if dsteps:
        pre_ms, dec_ms, finite, _, _ = serve(model, inputs, prompt + dsteps,
                                             dsteps)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(inputs, pad_to=prompt)
        finite = bool(torch.isfinite(logits).all())
        pre_ms, dec_ms = (time.perf_counter() - t0) * 1e3, None
    served = dict(batch=sb, prompt=prompt, decode_steps=dsteps,
                  prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
                  logits_finite=finite, **zoo_counts(k3, k4))
    # the trained weights in float32, card against CPU, as in 5h
    weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    same, worst, tol = card_then_cpu(cfg.replace(dtype=torch.float32),
                                     TRAINED_CPU_PROMPT, 0, weights=weights)
    del weights
    served["cpu_check"] = dict(dtype="float32", batch=2,
                               prompt=TRAINED_CPU_PROMPT, steps=8,
                               identical_tokens=same,
                               logits_max_abs_err=worst, tolerance=tol)
    emit("train_wide", **row, serve_trained=served,
         seconds=time.perf_counter() - t_phase)
    check(finite, f"{name}: trained weights give non-finite logits")
    check(served["k3_launches"] == want_k3 and served["k4_launches"]
          == want_k4, f"{name}: serving launches {served}, want K3 "
          f"{want_k3}, K4 {want_k4}")
    check(served["k3_plain_calls"] == served["k4_plain_calls"] == 0,
          f"{name}: plain-version calls serving {served}")
    check(same and worst <= tol, f"{name}: trained weights, card vs CPU "
          f"tokens identical={same}, logits error {worst}")
    return row, served


def phase_train_loop():
    """5i.5: `examples/torch_train_small.py --preset tiny` (the loss
    falls over `TRAIN_LOOP_STEPS` steps) and with `--compress-grads`; a
    run cut at step 15 (checkpoints every 10) resumed to step 25 against
    the uncut run; `python -m repro_torch.launch.train --smoke --steps 5`
    in a subprocess."""
    import importlib.util
    import shutil
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import Model
    from repro_torch.training.data import TokenStream
    from repro_torch.training.train_loop import TrainConfig, train
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke_train"
    shutil.rmtree(out, ignore_errors=True)
    spec = importlib.util.spec_from_file_location(
        "torch_train_small", root / "examples" / "torch_train_small.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dev = [] if DEV == "cuda" else ["--device", "cpu"]
    tiny = example.main(["--preset", "tiny", "--steps",
                         str(TRAIN_LOOP_STEPS), "--ckpt",
                         str(out / "tiny")] + dev)
    comp = example.main(["--preset", "tiny", "--steps", "25",
                         "--compress-grads", "--ckpt", str(out / "comp")]
                        + dev)

    def run(n_steps, ckpt, skip=0):
        data = TokenStream(256, 32, 8, seed=0)
        for _ in range(skip):
            next(data.batches(1))
        model = Model(smoke_variant(ARCHS["granite-3-2b"]).replace(
            vocab=256), device=DEV)
        return train(model, data, TrainConfig(
            n_steps=n_steps, ckpt_every=10, ckpt_dir=str(ckpt)),
            log=lambda s: None)
    full = run(25, out / "full")
    run(15, out / "cut")
    resumed = run(25, out / "cut", skip=10)
    loss_diff = float(np.abs(resumed["losses"] - full["losses"][10:]).max())
    params_equal = all(torch.equal(resumed["params"][k], p)
                       for k, p in full["params"].items())
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--steps", "5"] + dev
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root / "src")},
                         timeout=300)
    launcher = dict(command=" ".join(cmd[1:]), returncode=res.returncode,
                    wall_s=time.perf_counter() - t0,
                    last_line=(res.stdout.strip().splitlines() or [""])[-1])
    row = dict(tiny=dict(steps=TRAIN_LOOP_STEPS,
                         first_loss=tiny["first_loss"],
                         final_loss=tiny["final_loss"]),
               compressed=dict(steps=25, first_loss=comp["first_loss"],
                               final_loss=comp["final_loss"]),
               resume=dict(cut_at=15, checkpoint_every=10, resumed_to=25,
                           losses_bitwise=loss_diff == 0.0,
                           loss_max_abs_diff=loss_diff,
                           params_bitwise=params_equal, tolerance=1e-6),
               launcher=launcher, seconds=time.perf_counter() - t_phase)
    emit("train_loop", **row)
    shutil.rmtree(out, ignore_errors=True)
    check(tiny["final_loss"] < tiny["first_loss"] - 0.3,
          f"tiny preset: loss did not fall {row['tiny']}")
    check(np.isfinite(comp["final_loss"])
          and comp["final_loss"] < comp["first_loss"],
          f"--compress-grads: {row['compressed']}")
    check(loss_diff <= 1e-6, f"resume: losses differ by {loss_diff}")
    check(res.returncode == 0 and "->" in launcher["last_line"],
          f"launcher: {launcher} {res.stderr[-2000:]}")
    return row


def phase_training(k3, k4):
    """Phase 5i: training on the card."""
    t0 = time.perf_counter()
    checks = phase_train_checks()
    wide = {name: phase_train_wide(name, B, S, k, warm, timed, serving, k3,
                                   k4)
            for name, B, S, k, warm, timed, serving in TRAIN_WIDE}
    loop = phase_train_loop()
    emit("training", seconds=time.perf_counter() - t0)
    return checks, wide, loop


def main():
    smi_line = phase_device()
    phase_build()
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.kernels import knn_topk as kt
    max_abs, min_agree = phase_check(mk)
    knn_abs, knn_agree = phase_knn_check(kt)
    times = phase_times(mk)
    times_wide = phase_times_wide(mk)
    carry_split = phase_carry_boundary(mk)
    knn_times = phase_knn_times(kt)
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.kernels import ssd_scan as k4
    k3_abs = phase_k3_check(k3)
    k4_abs = phase_k4_check(k4)
    k3_times = phase_k3_times(k3)
    rg = dict(K3_ZOO["recurrentgemma-2b"])
    rg_valid, rg_window = rg.pop("valid"), rg.pop("window")
    k3_rg_times = phase_k3_times(k3, S=rg, valid=rg_valid, window=rg_window,
                                 cold_layers=0, label="k3_times_zoo",
                                 seed=740)
    k4_times = phase_k4_times(k4)
    launches, ctx = phase_main_path(mk)
    knn_counts = phase_staged(ctx, kt, mk)
    multiwindow = phase_multiwindow(mk, ctx)
    del ctx
    scen = phase_scenarios(mk, kt)
    knn_counts["hyperfleet_10k/torch"] = scen["hyperfleet"]["knn_launches"]
    hier = phase_hierarchy(mk, kt, scen)
    knn_counts["span"] = hier["k2_launches_span"]
    span_dist = phase_span_dist(mk, kt, scen, hier.pop("span_emulated"))
    knn_counts["span_dist"] = span_dist["k2_launches"]
    tp = phase_tp()
    scen_k1 = dict(total=scen["k1_launches"],
                   by_cell={k: v["k1_launches"]
                            for k, v in scen["cells"].items()},
                   flat=scen["hyperfleet"]["flat"]["k1_launches"])
    del scen
    examples = phase_examples(mk, kt)
    for name, ex in examples.items():
        if ex["k2_launches"]:
            knn_counts[f"examples/{name}"] = ex["k2_launches"]
    examples_k1 = {name: ex["k1_launches"] for name, ex in examples.items()}
    soak = phase_soak(mk)
    dense = phase_zoo_serving("dense_serving", "qwen2.5-3b", 8, 512, 1024,
                              64, k3, k4, want_k3=36 * 64, want_k4=0)
    ssm = phase_zoo_serving("ssm_serving", "mamba2-1.3b", 4, 1024, 1024, 32,
                            k3, k4, want_k3=0, want_k4=48)
    zoo = phase_zoo_families(k3, k4)
    _, trained, _ = phase_training(k3, k4)
    k3_by_path = {"dense_serving/qwen2.5-3b": dense["k3_launches"],
                  **{f"zoo_families/{k}": v["k3_launches"]
                     for k, v in zoo.items()},
                  "train_serve/granite-3-2b":
                      trained["granite-3-2b"][1]["k3_launches"],
                  **{f"tp_serving/{k}": v
                     for k, v in tp["k3_launches"].items() if v}}
    k4_by_path = {"ssm_serving/mamba2-1.3b": ssm["k4_launches"],
                  **{f"tp_serving/{k}": v
                     for k, v in tp["k4_launches"].items()},
                  "train_serve/mamba2-1.3b":
                      trained["mamba2-1.3b"][1]["k4_launches"]}
    main8, knn1 = times[8], knn_times[1]
    print(json.dumps({"kernels": [{
        "name": "decision_megakernel", "route": "cuda",
        "source": "src/repro_torch/csrc/decision_megakernel.cu",
        "replaces": "src/repro/kernels/decision_megakernel.py:283",
        "function": "decision_call",
        "launches": (launches[12.0] + launches[30.0] + scen_k1["total"]
                     + scen_k1["flat"] + hier["k1_launches"]
                     + sum(examples_k1.values()) + soak["k1_launches"]),
        "launches_by_path": {"main_12rps": launches[12.0],
                             "main_30rps": launches[30.0],
                             "scenarios": scen_k1["total"],
                             "hyperfleet_10k_flat": scen_k1["flat"],
                             "hierarchy": hier["k1_launches"],
                             "soak": soak["k1_launches"],
                             **{f"examples/{k}": v
                                for k, v in examples_k1.items()}},
        "launches_by_scenario": scen_k1["by_cell"],
        "hierarchy": {"by_run": {k: v["k1_launches"]
                                 for k, v in hier["fleet"].items()},
                      "times_at_cells": hier["k1_times"]},
        "multiwindow": {str(K): v.get("times") for K, v in
                        multiwindow.items()},
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
        "by_R": {str(R): v for R, v in times.items()},
        "global_carry": times_wide, "carry_boundary": carry_split}, {
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
        "launches": sum(k3_by_path.values()),
        "launches_by_path": k3_by_path, "checked_against_plain": True,
        "checked_zoo_shapes": list(K3_ZOO),
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
        "shape": dict(K3_SERVE, valid=544, dtype="bfloat16"),
        "at_recurrentgemma": dict(
            {k: k3_rg_times[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "b2b_ms", "library_b2b_ms", "device_ms_by_function",
                "global_functions_per_call", "layout_from_shape")},
            shape=dict(rg, valid=rg_valid, window=rg_window,
                       dtype="bfloat16"))}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:87",
        "function": "ssd_scan",
        "launches": sum(k4_by_path.values()),
        "launches_by_path": k4_by_path, "checked_against_plain": True,
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
