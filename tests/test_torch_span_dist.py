"""The span arm with one cell per rank over `torch.distributed`, on the
CPU: 2 and 4 gloo ranks, each a spawned process (`torch_span_ranks`).

  * `make_cell_mesh` gives None without a process group and with a
    world size other than the cell count, and a ``("cell",)`` mesh
    otherwise;
  * `sharded_greedy_scan(mesh=...)` led by rank 0, the other ranks in
    `cell_worker`, on seeded random and on dyadic inputs, in the four
    latency modes, with and without the affinity term, with padded
    never-allowed columns and invalid rows: choice, est_T and the final
    d, b, free are bitwise the port's emulation (`mesh=None`), its
    `greedy_scan` and the reference's `sharded_greedy_scan(mesh=None)`;
    each row costs 4 all-reduces (5 in the blind modes) plus one for
    the state, and each scan 3 broadcasts;
  * the `cluster` scenario with span routing at 2 cells through the
    leader and a worker gives the per-request completions of the
    port's single-process span run, which `test_torch_hierarchy.py`
    holds against the reference;
  * a leader that raises in the middle of a scan ends every rank at
    once: its exception comes through, the workers' pending collective
    fails, and nobody waits for the collective timeout.

Each spawn is bounded: the group's rendezvous and collectives time out
after `RANK_TIMEOUT_S`, and `run_ranks` kills the ranks after its own
limit, failing the test.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from torch_span_ranks import (CASES, PAD_COLS, RANK_TIMEOUT_S, I, R,
                              cluster_span, leader_fails_mid_scan,
                              run_ranks, scan_args, scan_case, scan_grid)

_GRIDS = {}


def _grid(world, tmp_path_factory):
    """The whole scan grid through `world` ranks, spawned once."""
    if world not in _GRIDS:
        tmp = tmp_path_factory.mktemp(f"span{world}")
        run_ranks(scan_grid, world, tmp, str(tmp / "out.pkl"))
        with open(tmp / "out.pkl", "rb") as fh:
            _GRIDS[world] = pickle.load(fh)
    return _GRIDS[world]


def bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def test_make_cell_mesh_without_a_group():
    from repro_torch.launch.mesh import make_cell_mesh
    assert make_cell_mesh(2) is None
    assert make_cell_mesh(1) is None


@pytest.mark.parametrize("world", [2, 4])
def test_cell_specs_is_the_scan_layout(world):
    """`cell_specs`' placements split the (R, C, Ic) planes, the (C, Ic)
    state and the (R,) vectors as the scan reads them: rank r takes the
    r-th contiguous block of Ic columns."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.sharding import cell_specs
    plane, state, vec = cell_specs()
    assert (plane, state, vec) == (Shard(1), Shard(0), Replicate())
    Ic = I // world
    cols = torch.arange(R * I).reshape(R, I)
    for rank in range(world):
        block = cols[:, rank * Ic:(rank + 1) * Ic]
        assert torch.equal(cols.reshape(R, world, Ic).chunk(
            world, plane.dim)[rank].reshape(R, Ic), block)
        assert torch.equal(cols[0].reshape(world, Ic).chunk(
            world, state.dim)[rank].reshape(Ic), block[0])


def test_sharding_rules_pins_the_mesh():
    from repro_torch.distributed.shardctx import current, sharding_rules
    assert current() is None
    with sharding_rules("outer"):
        with sharding_rules("inner"):
            assert current() == "inner"
        assert current() == "outer"
    assert current() is None


@pytest.mark.parametrize("world", [2, 4])
def test_make_cell_mesh_in_a_group(world, tmp_path_factory):
    out = _grid(world, tmp_path_factory)
    assert out["names"] == ("cell",) and out["size"] == world
    assert out["mismatch_mesh"] is None
    assert "cell_worker" in out["worker_refusal"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[
    f"{'dyadic' if dy else 'random'}-{'aff' if aff else 'noaff'}-{mode}"
    for _, dy, aff, mode in CASES])
def test_distributed_scan_is_bitwise(world, case, tmp_path_factory):
    from repro.core import decision_jax as ref
    from repro_torch.core.decision import greedy_scan, sharded_greedy_scan
    seed, dyadic, aff, mode = case
    got, (all_reduces, broadcasts) = _grid(world, tmp_path_factory)[
        "scans"][case]
    a = scan_case(seed, dyadic, aff)
    args, kw = scan_args(a)
    emulated = sharded_greedy_scan(*args, mode, **kw, n_cells=world)
    plain = greedy_scan(*args, mode, **kw)
    r = ref.sharded_greedy_scan(
        *(jnp.asarray(a[k]) for k in ("order", "q", "c", "l_inst", "tpot",
                                      "nominal", "d", "b", "free", "maxb")),
        a["weights"], jnp.asarray(a["allowed"]), mode,
        row_valid=jnp.asarray(a["rv"]),
        affinity=None if a["affinity"] is None
        else jnp.asarray(a["affinity"]), n_cells=world)
    for want in (emulated, plain, r):
        flat = [want[0], want[1], *want[2]]
        for g, w in zip(got, flat):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_array_equal(
                bits(g), bits(w.astype(g.dtype, copy=False)))
    assert (np.asarray(got[0]) < a["allowed"].shape[1] - PAD_COLS).all()
    per_row = 5 if mode in ("off_reactive", "off_predictive") else 4
    assert all_reduces == R * per_row + 1 and broadcasts == 3


def test_cluster_span_leader_and_worker(tmp_path):
    """`cluster`, span at 2 cells, 48 requests: the leader and one
    worker give the single-process run's completions."""
    run_ranks(cluster_span, 2, tmp_path, str(tmp_path / "out.pkl"), 48,
              timeout=150.0)
    with open(tmp_path / "out.pkl", "rb") as fh:
        out = pickle.load(fh)
    assert out["emulated_mesh"] is None and out["pinned"]
    assert out["distributed"] == out["emulated"]
    assert all(c[2] > 0 or c[5] or c[8] for c in out["distributed"])
    assert out["all_reduces"] > 4 * out["scoring_calls"] > 0
    # three a scan, and the stop header
    assert out["broadcasts"] == 3 * out["scoring_calls"] + 1


@pytest.mark.parametrize("world", [2, 4])
def test_leader_fault_mid_scan_ends_every_rank(world, tmp_path):
    """Rank 0 raises between two all-reduces of a scan and calls
    `stop_cell_workers` on its way out: no stop header goes out (the
    workers wait in an all-reduce it would not match), the group is torn
    down instead, and every rank exits well inside the collectives'
    timeout (`run_ranks`' limit is half of it)."""
    run_ranks(leader_fails_mid_scan, world, tmp_path, str(tmp_path),
              timeout=RANK_TIMEOUT_S / 2)
    ended = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            ended.append(pickle.load(fh))
    assert ended[0][0] == ("leader: leader fault mid-scan; in flight "
                           "after: False")
    for what, seconds in ended[1:]:
        assert what.startswith("RuntimeError") and "stopped" not in what
        assert seconds < RANK_TIMEOUT_S / 3


@pytest.mark.parametrize("env,argv,match", [
    ({"WORLD_SIZE": "3", "RANK": "0"},
     ["--cell-routing", "span", "--dist-backend", "gloo"],
     "3 processes for --cells 2"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, ["--cell-routing", "span"],
     "--dist-backend"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, ["--dist-backend", "gloo"],
     "--cell-routing span"),
    ({}, ["--cell-routing", "span", "--dist-backend", "gloo"], "torchrun")],
    ids=["world-size", "no-backend", "balanced", "no-torchrun"])
def test_launcher_refuses(monkeypatch, env, argv, match):
    """Under torchrun the launcher needs one process per cell, span
    routing and a named backend; without torchrun a backend is an error,
    not a silent emulation. Each refusal comes before any rendezvous."""
    from repro_torch.launch import serve
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        serve.main(["--cells", "2", "--device", "cpu"] + argv)


@pytest.mark.slow
def test_launcher_in_two_ranks(tmp_path):
    """`python -m repro_torch.launch.serve --cells 2 --cell-routing span
    --dist-backend gloo --device cpu` in two processes started as
    `torchrun --nproc-per-node 2` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): rank 0 prints the one JSON
    line, its collectives counted; rank 1 prints nothing (about 12 s)."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--cells", "2",
           "--cell-routing", "span", "--dist-backend", "gloo", "--device",
           "cpu", "--n", "40"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        cmd, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env={**os.environ, "PYTHONPATH": str(root / "src"), "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(10)
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    assert not outs[1][0].strip()
    m = json.loads(outs[0][0])
    assert m["n"] + m["failed"] + m["shed"] == 40
    assert m["dist_backend"] == "gloo" and m["cells"] == 2
    assert m["span_all_reduces"] > 0 and m["span_broadcasts"] > 0
