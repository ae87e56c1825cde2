"""Rank programs of the span tests (not a test module): each runs in a
process of its own, spawned by `run_ranks` with one gloo rank per
process on the CPU and a `FileStore` under the test's temporary
directory. Nothing here imports jax or the reference, so a rank starts
in a few seconds; the test module holds the results against them."""
import contextlib
import datetime
import multiprocessing
import os
import pickle
import time

import numpy as np

from repro_torch.core.decision import LATENCY_MODES

RANK_TIMEOUT_S = 90          # rendezvous and every collective
R, I, PAD_COLS, PAD_ROWS = 16, 32, 5, 4


def _rank_main(target, err_path, rank, world, init, *args):
    """A spawned rank: its standard error (file descriptor 2, so what the
    C++ runtime prints at exit too) goes to `err_path`, then `target`
    runs."""
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    os.close(fd)
    target(rank, world, init, *args)


def _err_tail(path, n=2000):
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:].strip()
    except OSError:
        return ""


def run_ranks(target, world, tmp_path, *args, timeout=120.0):
    """Run `target(rank, world, init_method, *args)` in `world` spawned
    processes and wait at most `timeout` seconds for them all; on expiry
    kill every one and raise TimeoutError, and raise RuntimeError if one
    exits nonzero, naming each failing rank's exit code and the tail of
    its standard error (kept in ``rank{r}.err`` under `tmp_path`). A hang
    fails the calling test, never the suite."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    errs = [str(tmp_path / f"rank{r}.err") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(target, errs[r], r, world, init) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if any(codes):
        lines = [f"rank exit codes {codes}"]
        for r, code in enumerate(codes):
            if code:
                tail = _err_tail(errs[r])
                lines.append(f"rank {r} exited {code}"
                             + (f"; its stderr ends:\n{tail}" if tail else
                                "; no stderr"))
        raise RuntimeError("\n".join(lines))


@contextlib.contextmanager
def rank_group(rank, world, init_method):
    """`join_group`, then on the way out a barrier and
    `destroy_process_group()`, so no rank exits with the gloo group
    alive while another still talks to it."""
    import torch.distributed as dist
    join_group(rank, world, init_method)
    try:
        yield
    finally:
        if dist.is_initialized():
            try:
                dist.barrier()
            finally:
                dist.destroy_process_group()


def join_group(rank, world, init_method):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def scan_case(seed, dyadic, aff):
    """Numpy inputs of one scan (R rows, I columns): the last PAD_COLS
    columns never allowed (the padding `decide` appends), the last
    PAD_ROWS rows invalid (pad rows), the LPT order over the valid rows.
    `dyadic` rounds every value to a few binary digits, so that every
    product and sum is exact."""
    rng = np.random.default_rng((seed, dyadic, aff))

    def u(lo, hi, shape, grid):
        x = rng.uniform(lo, hi, shape)
        return (np.round(x * grid) / grid if dyadic else x).astype(np.float32)
    alive = np.arange(I) < I - PAD_COLS
    allowed = (rng.uniform(size=(R, I)) < 0.7) & alive
    allowed[np.arange(R), rng.integers(0, I - PAD_COLS, R)] = True
    b = rng.integers(1, 40, I).astype(np.float32)
    maxb = np.full(I, 48.0, np.float32)
    maxb[:3] = b[:3] + 1                     # batches that saturate
    l_inst = u(20, 600, (R, I), 1)
    rv = np.arange(R) < R - PAD_ROWS
    key = np.where(rv, l_inst.max(1), -1e30)
    return dict(
        order=np.argsort(-key, kind="stable").astype(np.int64),
        q=u(0, 1, (R, I), 8), c=u(1e-6, 1e-3, (R, I), 2 ** 20),
        l_inst=l_inst, tpot=u(0.005, 0.05, I, 1024),
        nominal=u(0.005, 0.05, I, 1024), d=u(0, 3000, I, 1), b=b,
        free=rng.integers(0, 4, I).astype(np.float32), maxb=maxb,
        allowed=allowed, rv=rv,
        affinity=(u(0, 0.6, (R, I), 16) * alive).astype(np.float32)
        if aff else None,
        weights=(0.5, 0.25, 0.25) if dyadic else (0.4, 0.35, 0.25))


def scan_args(a):
    """(positional, keyword) arguments of `greedy_scan` from a case."""
    import torch

    def t(x):
        return torch.from_numpy(np.array(x))
    args = (t(a["order"]), t(a["q"]), t(a["c"]), t(a["l_inst"]),
            t(a["tpot"]), t(a["nominal"]), t(a["d"]), t(a["b"]),
            t(a["free"]), t(a["maxb"]), a["weights"], t(a["allowed"]))
    kw = dict(row_valid=t(a["rv"]),
              affinity=None if a["affinity"] is None else t(a["affinity"]))
    return args, kw


CASES = [(seed, dyadic, aff, mode) for seed, dyadic in ((0, False),
                                                        (1, True))
         for aff in (False, True) for mode in LATENCY_MODES]


def scan_grid(rank, world, init_method, out_path):
    """Every case of CASES through `sharded_greedy_scan(mesh=...)`: rank 0
    leads and writes (choice, est_T, d, b, free) per case, the mesh
    checks and the collective counts to `out_path`; the other ranks
    answer in `cell_worker`."""
    import torch.distributed as dist

    from repro_torch.core import decision
    from repro_torch.launch.mesh import make_cell_mesh
    join_group(rank, world, init_method)
    try:
        mesh = make_cell_mesh(world)
        if rank:
            decision.cell_worker(mesh, device="cpu")
            return
        out = dict(mismatch_mesh=make_cell_mesh(world * 2),
                   names=mesh.mesh_dim_names, size=mesh.size(),
                   worker_refusal=None, scans={})
        try:
            decision.cell_worker(mesh, device="cpu")
        except RuntimeError as e:
            out["worker_refusal"] = str(e)
        try:
            for case in CASES:
                seed, dyadic, aff, mode = case
                args, kw = scan_args(scan_case(seed, dyadic, aff))
                decision.reset_counts()
                ch, est, (d, b, f) = decision.sharded_greedy_scan(
                    *args, mode, **kw, n_cells=world, mesh=mesh)
                counts = (decision.sharded_greedy_scan.all_reduces,
                          decision.sharded_greedy_scan.broadcasts)
                out["scans"][case] = ([x.numpy() for x in (ch, est, d, b, f)],
                                      counts)
        finally:
            decision.stop_cell_workers(mesh, device="cpu")
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def completions(reqs):
    return [(r.rid, r.finish_time, r.tokens_out, r.model_idx, r.instance,
             bool(r.failed), r.attempt, r.hedges, bool(r.shed))
            for r in reqs]


def cluster_span(rank, world, init_method, out_path, n_req):
    """The `cluster` scenario with span routing at `world` cells: rank 0
    runs it once in one process (the emulation, before the group
    exists), then as the leader of the group with the other ranks in
    `cell_worker`, the mesh pinned with `sharding_rules`; it writes both
    runs' completions and the second run's mesh and counts."""
    import torch.distributed as dist

    from repro_torch.core import RBConfig, decision
    from repro_torch.distributed.shardctx import sharding_rules
    from repro_torch.launch.mesh import make_cell_mesh
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    from repro_torch.serving.scenarios import get_scenario
    if rank == 0:
        run = get_scenario("cluster").build(dataset_n=240)
        run.bundle(device="cpu")
        cfg = RBConfig(decision_backend="torch", charge_compute=False)
        hcfg = HierarchyConfig(n_cells=world, routing="span")
        reqs = run.requests(n_req, seed=0)
        one = build_scheduler(cfg, run.bundle(), run.tiers, hcfg)
        run.run_cell(one, reqs, seed=0)
        out = dict(emulated=completions(reqs),
                   emulated_mesh=one.policy._cell_mesh)
    join_group(rank, world, init_method)
    try:
        mesh = make_cell_mesh(world)
        if rank:
            decision.cell_worker(mesh, device="cpu")
            return
        reqs = run.requests(n_req, seed=0)
        decision.reset_counts()
        try:
            with sharding_rules(mesh):
                span = build_scheduler(cfg, run.bundle(), run.tiers, hcfg)
                run.run_cell(span, reqs, seed=0)
        finally:
            decision.stop_cell_workers(mesh, device="cpu")
        out.update(distributed=completions(reqs),
                   pinned=span.policy._cell_mesh is mesh,
                   scoring_calls=len(span.compute_log),
                   all_reduces=decision.sharded_greedy_scan.all_reduces,
                   broadcasts=decision.sharded_greedy_scan.broadcasts)
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def leader_fails_mid_scan(rank, world, init_method, out_dir):
    """Rank 0 raises inside a scan, after its third all-reduce, while the
    workers wait in the fourth; its `finally` calls `stop_cell_workers`
    as the launcher's does. Every rank writes what ended it, and after
    how many seconds, to `out_dir/rank{rank}.pkl`."""
    import torch.distributed as dist

    from repro_torch.core import decision
    from repro_torch.launch.mesh import make_cell_mesh
    join_group(rank, world, init_method)
    t0 = time.monotonic()
    try:
        mesh = make_cell_mesh(world)
        if rank:
            decision.cell_worker(mesh, device="cpu")
            ended = "stopped"
        else:
            reducer, calls = decision._reducer, [0]

            def failing(op, group):
                combine = reducer(op, group)

                def f(x):
                    calls[0] += 1
                    if calls[0] == 3:
                        raise ValueError("leader fault mid-scan")
                    return combine(x)
                return f
            decision._reducer = failing
            args, kw = scan_args(scan_case(0, False, False))
            try:
                try:
                    decision.sharded_greedy_scan(*args, "full", **kw,
                                                 n_cells=world, mesh=mesh)
                finally:
                    decision.stop_cell_workers(mesh, device="cpu")
            except ValueError as e:
                ended = f"leader: {e}; in flight after: " + str(
                    decision.sharded_greedy_scan.in_flight)
    except Exception as e:        # a worker's collective fails
        ended = f"{type(e).__name__}: {e}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as fh:
        pickle.dump((ended, time.monotonic() - t0), fh)
