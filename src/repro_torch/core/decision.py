"""The LPT greedy scan with dead reckoning: the per-step arithmetic of
the RouteBalance decision (§4).

Port of `repro.core.decision_jax` (lines 46-241 and 286-471):
`LATENCY_MODES`, `bucket_pow2`, `greedy_step` and the scan, the
cell-sharded scan of the hierarchy's span routing (`cell_greedy_step`,
`cell_greedy_scan`, `sharded_greedy_scan`), and the staged tensor core
that `RBConfig(decision_backend="torch")` runs (the reference's
`decision_backend="jax"`): `greedy_core` (the scan over a precomputed
order and admission mask), `lpt_admission` (the LPT order and Eq. 2
admission), `decide_batch` (the two in turn) and `decide`, its numpy-in
/ numpy-out wrapper. The reference runs the scan as a `lax.scan` under
`jit`; here it is a Python loop over the R rows on torch tensors, one
loop (`_scan`) for the flat and the cell-sharded step. `lpt_admission`
and the scan are also the last stages of the decision kernel's plain
version (`repro_torch.kernels.decision_megakernel.
decision_megakernel_plain`), and the scan never reads a value back to
the host, so on a CUDA tensor the loop only enqueues work.

The sharded scan splits the instance axis into `n_cells` contiguous
blocks. Every step still needs the global cost and latency maxima, the
global best score and its first attaining column, so the blocks are
combined per step with exact max / min / sum reductions over the cell
axis; a max, a min, or a sum of one value and zeros is exact in any
order, so the result is bitwise `greedy_scan`'s. Two arms share the
step: the single-program emulation (`mesh=None`: the cell axis is dim 0
of one tensor, the combines reductions over it), and one cell per rank
over `torch.distributed` (a ``("cell",)`` mesh from
`launch.mesh.make_cell_mesh`: the combines are all-reduces, rank 0
leads and the other ranks run `cell_worker`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .budget import admission_math, cost_matrix
from .scoring import affinity_discount, masked_score, quantize_scores

LATENCY_MODES = ("full", "off_reactive", "off_predictive", "static_prior")


def bucket_pow2(n: int, lo: int = 8) -> int:
    """Round a dynamic size up to the next power of two (floor `lo`), so
    batch and roster shapes fall into O(log) variants."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def greedy_step(d, b, free, *, q, c, l, tpot, nominal_tpot, b0,
                max_batch, weights, allowed, latency_mode, valid,
                affinity):
    """One greedy-scan step for one request: Eq. 1 over the live
    dead-reckoned state (d, b, free), the pick, and the state update.

    q/c/l/allowed/affinity are the request's (I,) rows, `valid` a 0-dim
    bool (pad rows pick but do not update). Returns (d, b, free,
    i (1,) int64 pick, est (1,) float32 latency); the state is updated
    in place."""
    wq, wl, wc = weights
    wait = torch.where(free > 0, 0.0, d / torch.clamp_min(b, 1.0))
    tpot_eff = tpot * torch.clamp_min(b / b0, 1.0)
    if latency_mode == "static_prior":
        T = nominal_tpot * l
    else:
        T = tpot_eff * (wait + l)
    if affinity is not None:
        T = affinity_discount(T, affinity)
    if latency_mode in ("off_reactive", "off_predictive"):
        # the model score is instance-blind: least normalized tie metric
        # among the score-tied candidates, over ALL columns (dead and pad
        # included: only the where() masks them)
        s = masked_score(q, c, T, (wq, 0.0, wc), allowed)
        tie = (d + b) if latency_mode == "off_reactive" else T
        tn = tie / torch.clamp_min(tie.amax(), 1e-9)
        i = torch.argmin(torch.where(s >= s.amax(), tn, float("inf")))
    else:
        s = masked_score(q, c, T, (wq, wl, wc), allowed)
        i = torch.argmax(s)
    i = i.view(1)
    est = T.gather(0, i)
    # dead reckoning: the chosen instance's pending work grows by L̂
    d.index_add_(0, i, torch.where(valid, l.gather(0, i), 0.0))
    has_free = (free.gather(0, i) > 0) & valid
    free.index_add_(0, i, -torch.where(has_free, 1.0, 0.0))
    b_i = b.gather(0, i)
    b.index_copy_(0, i, torch.where(
        has_free, torch.minimum(b_i + 1.0, max_batch.gather(0, i)), b_i))
    return d, b, free, i, est


def _scan(step, order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
          free, max_batch, weights, allowed, latency_mode, row_valid,
          affinity, **step_kw):
    """The R-step loop both scans run: gather the request planes into
    scan order, take one `step` (`greedy_step` or `cell_greedy_step`,
    with its extra keywords `step_kw`) per row, and scatter the picks
    and latencies back to request order. d/b/free are copied, not
    modified. Returns (choice (R,) int64, est_T (R,) float32,
    (d, b, free) post-scan)."""
    R = q_inst.shape[0]
    b0 = torch.clamp_min(b, 1.0)          # snapshot batch (TPOT reference)
    d, b, free = d.clone(), b.clone(), free.clone()
    if row_valid is None:
        row_valid = torch.ones(R, dtype=torch.bool, device=q_inst.device)
    # gather the rows into scan order once, so each step indexes by a
    # Python int and never syncs with the device
    q_o, c_o, l_o = q_inst[order], c_hat[order], l_inst[order]
    a_o, v_o = allowed[order], row_valid[order]
    aff_o = None if affinity is None else affinity[order]
    picks, ests = [], []
    for t in range(R):
        d, b, free, i, est = step(
            d, b, free, q=q_o[t], c=c_o[t], l=l_o[t], tpot=tpot,
            nominal_tpot=nominal_tpot, b0=b0, max_batch=max_batch,
            weights=weights, allowed=a_o[t], latency_mode=latency_mode,
            valid=v_o[t], affinity=None if aff_o is None else aff_o[t],
            **step_kw)
        picks.append(i)
        ests.append(est)
    # the scan emits in scan order; scatter back to request order
    choice = torch.empty(R, dtype=torch.int64, device=q_inst.device)
    est_T = torch.empty(R, dtype=torch.float32, device=q_inst.device)
    if R:
        choice.index_copy_(0, order, torch.cat(picks))
        est_T.index_copy_(0, order, torch.cat(ests))
    return choice, est_T, (d, b, free)


def greedy_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
                free, max_batch, weights, allowed, latency_mode: str,
                row_valid=None, affinity=None):
    """The R-step scan in `order` (LPT or arrival). (R, I) planes, (I,)
    state; d/b/free are copied, not modified. Returns (choice (R,)
    int64, est_T (R,) float32, (d, b, free) post-scan)."""
    return _scan(greedy_step, order, q_inst, c_hat, l_inst, tpot,
                 nominal_tpot, d, b, free, max_batch, weights, allowed,
                 latency_mode, row_valid, affinity)


def cell_greedy_step(d, b, free, *, q, c, l, tpot, nominal_tpot, b0,
                     max_batch, weights, allowed, latency_mode, valid,
                     affinity, offs, gmax, gmin, gsum):
    """`greedy_step` over cell-sharded state (reference lines 286-367).

    Per-instance tensors carry a leading cell axis: (C, Ic) state and
    request rows. `offs` (C, 1) int64 holds each block's first global
    column; gmax/gmin/gsum reduce (C, k) per-cell values over all the
    cells to (1, k). Returns (d, b, free, i (1,) int64 GLOBAL pick,
    est (1,) float32); the state is updated in place, and only in the
    winner's cell: other cells take identities (+ -0.0, or their own
    value written back), so they stay bit for bit as they were."""
    wq, wl, wc = weights
    C, Ic = d.shape
    wait = torch.where(free > 0, 0.0, d / torch.clamp_min(b, 1.0))
    tpot_eff = tpot * torch.clamp_min(b / b0, 1.0)
    if latency_mode == "static_prior":
        T = nominal_tpot * l
    else:
        T = tpot_eff * (wait + l)
    if affinity is not None:
        T = affinity_discount(T, affinity)
    neg = float("-inf")

    def local_max(x):
        return x.amax(dim=-1, keepdim=True)
    blind = latency_mode in ("off_reactive", "off_predictive")
    # masked_score with GLOBAL normalizers: per-cell maxima of the masked
    # planes (and of the blind arms' tie metric, which no score feeds),
    # the max over cells in one combine (a max is exact elementwise, so
    # combining them together changes no bit), then the same clamps
    loc = [local_max(torch.where(allowed, c, neg)),
           local_max(torch.where(allowed, T, neg))]
    if blind:
        tie = (d + b) if latency_mode == "off_reactive" else T
        loc.append(local_max(tie))
    g = gmax(torch.cat(loc, dim=-1))
    cmax = torch.clamp_min(g[:, 0:1], 1e-12)
    tmax = torch.clamp_min(g[:, 1:2], 1e-12)
    sw_l = 0.0 if blind else wl
    s = wq * q + wc * (1.0 - c / cmax) + sw_l * (1.0 - T / tmax)
    s = torch.where(allowed, quantize_scores(s), neg)
    big = torch.iinfo(torch.int64).max
    if blind:
        # least normalized tie metric among the score-tied candidates,
        # over every column (see greedy_step)
        tn = tie / torch.clamp_min(g[:, 2:3], 1e-9)
        smax = gmax(local_max(s))
        v = torch.where(s >= smax, tn, float("inf"))
        vloc, aloc = v.min(dim=-1, keepdim=True)
        cand = torch.where(vloc == gmin(vloc), offs + aloc, big)
    else:
        sloc, aloc = s.max(dim=-1, keepdim=True)
        cand = torch.where(sloc == gmax(sloc), offs + aloc, big)
    i = gmin(cand).view(1)                    # first attaining column
    li = torch.clamp(i - offs, 0, Ic - 1)     # (C, 1) winner's local column
    in_cell = (i >= offs) & (i < offs + Ic)   # (C, 1), one True
    # est = T at the winner: one cell contributes, the others add 0.0
    est = gsum(torch.where(in_cell, T.gather(1, li), 0.0)).view(1)
    # dead reckoning in the winner's cell, as greedy_step does it there
    add_d = torch.where(valid, l.gather(1, li), 0.0)
    d.scatter_add_(1, li, torch.where(in_cell, add_d, -0.0))
    has_free = (free.gather(1, li) > 0) & valid & in_cell
    free.scatter_add_(1, li, -torch.where(has_free, 1.0, 0.0))
    b_i = b.gather(1, li)
    b.scatter_(1, li, torch.where(
        has_free, torch.minimum(b_i + 1.0, max_batch.gather(1, li)), b_i))
    return d, b, free, i, est


def cell_greedy_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d,
                     b, free, max_batch, weights, allowed,
                     latency_mode: str, row_valid=None, affinity=None, *,
                     offs, gmax, gmin, gsum):
    """`greedy_scan` over cell-sharded tensors (reference lines
    370-394): (R, C, Ic) request planes, (C, Ic) state. Returns (choice
    (R,) int64 GLOBAL columns, est_T (R,) float32, (d, b, free) still
    cell-sharded); d/b/free are copied, not modified."""
    return _scan(cell_greedy_step, order, q_inst, c_hat, l_inst, tpot,
                 nominal_tpot, d, b, free, max_batch, weights, allowed,
                 latency_mode, row_valid, affinity, offs=offs, gmax=gmax,
                 gmin=gmin, gsum=gsum)


def sharded_greedy_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot,
                        d, b, free, max_batch, weights, allowed,
                        latency_mode: str, row_valid=None, affinity=None,
                        *, n_cells: int, mesh=None):
    """Drop-in cell-sharded `greedy_scan` (reference lines 397-471): the
    same flat tensors in and out, bitwise the same results. The
    instance axis must split evenly into `n_cells` contiguous blocks.

    `mesh=None` runs the single-program emulation. A ``("cell",)`` mesh
    of `n_cells` ranks (`launch.mesh.make_cell_mesh`) runs one block per
    rank: this call is the leader's (rank 0), which broadcasts the
    inputs to the ranks in `cell_worker`; every rank scans its block,
    and the results come back to rank 0."""
    C = int(n_cells)
    if C <= 1:
        return greedy_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot,
                           d, b, free, max_batch, weights, allowed,
                           latency_mode, row_valid=row_valid,
                           affinity=affinity)
    I = q_inst.shape[-1]
    if I % C:
        raise ValueError(f"{I} instance columns do not split into {C} "
                         "cells")
    if mesh is not None:
        return _leader_scan(order, q_inst, c_hat, l_inst, tpot,
                            nominal_tpot, d, b, free, max_batch, weights,
                            allowed, latency_mode, row_valid, affinity,
                            mesh=mesh, n_cells=C)
    Ic = I // C

    def r2(x):                                    # (R, I) -> (R, C, Ic)
        return x.reshape(x.shape[0], C, Ic)

    def r1(x):                                    # (I,) -> (C, Ic)
        return x.reshape(C, Ic)
    offs = (torch.arange(C, device=q_inst.device) * Ic)[:, None]
    choice, est_T, (d2, b2, f2) = cell_greedy_scan(
        order, r2(q_inst), r2(c_hat), r2(l_inst), r1(tpot),
        r1(nominal_tpot), r1(d), r1(b), r1(free), r1(max_batch), weights,
        r2(allowed), latency_mode, row_valid=row_valid,
        affinity=None if affinity is None else r2(affinity), offs=offs,
        gmax=lambda x: x.amax(dim=0, keepdim=True),
        gmin=lambda x: x.amin(dim=0, keepdim=True),
        gsum=lambda x: x.sum(dim=0, keepdim=True))
    return choice, est_T, (d2.reshape(I), b2.reshape(I), f2.reshape(I))


# -- the span scan over torch.distributed: one cell per rank ------------------
#
# Rank 0 (the leader) owns the engine; ranks 1..C-1 answer scans in
# `cell_worker`. Each scan is a header broadcast (a stop, or the shapes,
# the latency mode, the affinity flag and the weights), two payload
# broadcasts (every float32 input; the admission mask and row validity
# as bytes), then per request row one MAX (the cost, latency and tie
# maxima), one MAX of the scores (one MIN of the tie metric in the
# blind modes besides), one MIN of the candidate columns and one SUM of
# est, and at the end one SUM that brings the state blocks home: each
# rank fills the columns outside its block with -0.0, and x + -0.0 is x
# for every x. Only broadcast and all_reduce are used, the two
# collectives gloo runs on CUDA tensors. The counts of collectives
# made in this process are `sharded_greedy_scan.all_reduces`,
# `.broadcasts` and `.broadcast_bytes`, reset by `reset_counts()`.
# `sharded_greedy_scan.in_flight` is True on the leader from a scan's
# header to its last collective: a leader that leaves a scan part way
# (an exception) cannot stop the workers with a header, which no
# collective of theirs would match, so `stop_cell_workers` then tears
# the group down and the workers' pending collective fails at once.

_STOP, _SCAN = 0.0, 1.0
_HEADER = 8        # command, R, I, latency mode, affinity flag, wq, wl, wc
_STATE_ROWS = 6    # tpot, nominal_tpot, d, b, free, max_batch

sharded_greedy_scan.all_reduces = 0
sharded_greedy_scan.broadcasts = 0
sharded_greedy_scan.broadcast_bytes = 0
sharded_greedy_scan.in_flight = False


def reset_counts():
    sharded_greedy_scan.all_reduces = 0
    sharded_greedy_scan.broadcasts = 0
    sharded_greedy_scan.broadcast_bytes = 0


def _cell_group(mesh):
    """(process group, this rank's cell, cell count) of a mesh with a
    "cell" dimension."""
    if "cell" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"{mesh} has no 'cell' dimension")
    dim = mesh.mesh_dim_names.index("cell")
    return (mesh.get_group("cell"), mesh.get_local_rank("cell"),
            mesh.size(dim))


def _broadcast(x, group):
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    sharded_greedy_scan.broadcasts += 1
    sharded_greedy_scan.broadcast_bytes += x.numel() * x.element_size()
    return x


def _reducer(op, group):
    def combine(x):
        x = x.clone()          # all_reduce writes in place; callers reuse x
        dist.all_reduce(x, op=op, group=group)
        sharded_greedy_scan.all_reduces += 1
        return x
    return combine


def _leader_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
                 free, max_batch, weights, allowed, latency_mode, row_valid,
                 affinity, *, mesh, n_cells):
    group, rank, C = _cell_group(mesh)
    if C != n_cells:
        raise ValueError(f"the mesh has {C} cells, the scan {n_cells}")
    if rank != 0:
        raise RuntimeError(f"rank {rank} is a worker: it runs "
                           "cell_worker(mesh); rank 0 leads the scan")
    R, I = q_inst.shape
    if R >= 1 << 24:
        raise ValueError(f"{R} rows: the scan order travels as float32")
    dev = q_inst.device
    if row_valid is None:
        row_valid = torch.ones(R, dtype=torch.bool, device=dev)
    planes = [q_inst, c_hat, l_inst] + ([] if affinity is None
                                        else [affinity])
    f32 = torch.float32
    sharded_greedy_scan.in_flight = True
    _broadcast(torch.tensor(
        [_SCAN, R, I, LATENCY_MODES.index(latency_mode),
         affinity is not None, *weights], dtype=torch.float64, device=dev),
        group)
    flat = _broadcast(torch.cat(
        [torch.stack(planes).to(f32).reshape(-1),
         torch.stack([tpot, nominal_tpot, d, b, free, max_batch]
                     ).to(f32).reshape(-1),
         order.to(f32)]), group)
    masks = _broadcast(torch.cat([allowed.reshape(-1), row_valid]
                                 ).to(torch.uint8), group)
    out = _block_scan(flat, masks, R, I, latency_mode,
                      tuple(float(w) for w in weights),
                      affinity is not None, group, rank, C)
    sharded_greedy_scan.in_flight = False
    return out


def _block_scan(flat, masks, R, I, latency_mode, weights, has_aff, group,
                rank, C):
    """One rank's part of a scan, on the broadcast payloads: its block
    in the layout `launch.sharding.cell_specs` documents (the cell axis
    of the (R, C, Ic) planes and of the (C, Ic) state), `cell_greedy_scan`
    on it with the combines as collectives, then the state home. Returns
    (choice, est_T, (d, b, free)) over the whole instance axis."""
    Ic = I // C
    P = 4 if has_aff else 3
    n_pl, n_st = P * R * I, _STATE_ROWS * I
    planes = flat[:n_pl].reshape(P, R, C, Ic).narrow(
        2, rank, 1)                                   # (P, R, 1, Ic)
    st = flat[n_pl:n_pl + n_st].reshape(_STATE_ROWS, C, Ic).narrow(
        1, rank, 1)                                   # (6, 1, Ic)
    order = flat[n_pl + n_st:].to(torch.int64)
    allowed = masks[:R * I].reshape(R, C, Ic).narrow(1, rank, 1).bool()
    row_valid = masks[R * I:].bool()
    offs = torch.full((1, 1), rank * Ic, dtype=torch.int64,
                      device=flat.device)
    choice, est_T, blocks = cell_greedy_scan(
        order, planes[0], planes[1], planes[2], st[0], st[1], st[2], st[3],
        st[4], st[5], weights, allowed, latency_mode, row_valid=row_valid,
        affinity=planes[3] if has_aff else None, offs=offs,
        gmax=_reducer(dist.ReduceOp.MAX, group),
        gmin=_reducer(dist.ReduceOp.MIN, group),
        gsum=_reducer(dist.ReduceOp.SUM, group))
    home = torch.full((3, I), -0.0, dtype=flat.dtype, device=flat.device)
    home[:, rank * Ic:(rank + 1) * Ic] = torch.cat(blocks)
    home = _reducer(dist.ReduceOp.SUM, group)(home)
    return choice, est_T, (home[0], home[1], home[2])


def cell_worker(mesh, device=None) -> int:
    """The loop of ranks 1..C-1 of a span mesh: answer the leader's
    scans (`sharded_greedy_scan(mesh=...)` on rank 0) until it sends
    the stop header (`stop_cell_workers`). `device=None` means the card;
    it must be where the leader's tensors are when the backend is
    NCCL. Returns the number of scans answered."""
    from .device import resolve_device
    dev = resolve_device(device)
    group, rank, C = _cell_group(mesh)
    if rank == 0:
        raise RuntimeError("rank 0 leads the span scan; ranks 1.."
                           f"{C - 1} run cell_worker")
    scans = 0
    while True:
        hdr = _broadcast(torch.empty(_HEADER, dtype=torch.float64,
                                     device=dev), group).tolist()
        if hdr[0] == _STOP:
            return scans
        R, I, mode, has_aff = (int(v) for v in hdr[1:5])
        P = 4 if has_aff else 3
        flat = _broadcast(torch.empty(
            P * R * I + _STATE_ROWS * I + R, dtype=torch.float32,
            device=dev), group)
        masks = _broadcast(torch.empty(R * I + R, dtype=torch.uint8,
                                       device=dev), group)
        _block_scan(flat, masks, R, I, LATENCY_MODES[mode], tuple(hdr[5:]),
                    bool(has_aff), group, rank, C)
        scans += 1


def stop_cell_workers(mesh, device=None):
    """Rank 0: send the stop header, so every `cell_worker` returns.
    `device` as the workers' (None means the card). If a scan was left
    part way, the workers wait in one of its collectives instead: the
    default process group is then destroyed, so that their collective
    fails and they exit, and no header is sent."""
    from .device import resolve_device
    group, rank, _ = _cell_group(mesh)
    if rank != 0:
        raise RuntimeError("only rank 0 stops the cell workers")
    if sharded_greedy_scan.in_flight:
        sharded_greedy_scan.in_flight = False
        dist.destroy_process_group()
        return
    _broadcast(torch.full((_HEADER,), _STOP, dtype=torch.float64,
                          device=resolve_device(device)), group)


def greedy_core(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
                free, max_batch, weights, allowed,
                latency_mode: str = "full", affinity=None,
                n_cells: int = 0, mesh=None):
    """The greedy pass over a precomputed order + admission mask, on
    float32 tensors of one device; `n_cells > 1` runs the cell-sharded
    scan (bitwise the same), over the ranks of `mesh` when one is given.
    Returns (choice (R,) int64, est_T (R,) float32)."""
    choice, est_T, _ = sharded_greedy_scan(
        order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b, free,
        max_batch, weights, allowed, latency_mode, affinity=affinity,
        n_cells=n_cells, mesh=mesh)
    return choice, est_T


def lpt_admission(pred_len_max, l_inst, budgets, len_in, price_in,
                  price_out, lpt: bool = True, budget_filter: bool = True,
                  valid=None):
    """The stages ahead of the scan, on float32 tensors of one device:
    the scan order (descending `pred_len_max`, stable, with `lpt`;
    arrival order without) and Eq. 2 admission with the cost matrix
    (without `budget_filter`, every column `valid` admits; `valid`
    None admits every column). Returns (order (R,) int64, allowed
    (R, I) bool, c_hat (R, I))."""
    if lpt:
        order = torch.argsort(-pred_len_max, stable=True)
    else:
        order = torch.arange(l_inst.shape[0], device=l_inst.device)
    if budget_filter:
        allowed, c_hat = admission_math(budgets, len_in, l_inst, price_in,
                                        price_out, valid=valid)
    else:
        c_hat = cost_matrix(len_in, l_inst, price_in, price_out)
        allowed = torch.ones(c_hat.shape, dtype=torch.bool,
                             device=c_hat.device)
        if valid is not None:
            allowed = allowed & valid[None, :]
    return order, allowed, c_hat


def decide_batch(q_inst, l_inst, pred_len_max, tpot, nominal_tpot, d, b,
                 free, max_batch, budgets, len_in, price_in, price_out,
                 weights, latency_mode: str = "full", lpt: bool = True,
                 budget_filter: bool = True, affinity=None, valid=None,
                 n_cells: int = 0, mesh=None):
    """The whole per-batch decision on float32 tensors of one device.

    q_inst/l_inst: (R, I) per-instance quality / predicted length;
    pred_len_max: (R,) max predicted length over *models* (LPT key);
    tpot/nominal_tpot/d/b/free/max_batch: (I,) instance state;
    budgets (R,) with nan = unconstrained; len_in (R,);
    price_in/price_out (I,); affinity optionally (R, I) prefix-reuse
    discount; valid optionally (I,) bool, the columns that may be
    chosen (pad columns never admit, never win the cheapest fallback);
    n_cells > 1 runs the cell-sharded scan, over the ranks of `mesh`
    when one is given. Returns (choice (R,), est_T (R,), c_hat (R, I),
    allowed (R, I))."""
    order, allowed, c_hat = lpt_admission(
        pred_len_max, l_inst, budgets, len_in, price_in, price_out, lpt,
        budget_filter, valid)
    choice, est_T = greedy_core(order, q_inst, c_hat, l_inst, tpot,
                                nominal_tpot, d, b, free, max_batch,
                                weights, allowed, latency_mode, affinity,
                                n_cells=n_cells, mesh=mesh)
    return choice, est_T, c_hat, allowed


def decide(q_inst: np.ndarray, l_inst: np.ndarray,
           pred_len_max: np.ndarray, tpot: np.ndarray,
           nominal_tpot: np.ndarray, d: np.ndarray, b: np.ndarray,
           free: np.ndarray, max_batch: np.ndarray,
           budgets: np.ndarray, len_in: np.ndarray,
           price_in: np.ndarray, price_out: np.ndarray, weights,
           latency_mode: str = "full", lpt: bool = True,
           budget_filter: bool = True,
           affinity: Optional[np.ndarray] = None,
           device=None, n_cells: int = 0,
           mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """numpy-in / numpy-out wrapper for the scheduler's staged path: every
    input cast to float32 on `device` (None means the card), the batch
    padded to the next power of two (>= 8), as the reference pads it
    for its jit cache. Pad rows carry a -1e30 LPT key, so they scan
    strictly after every real request, a NaN budget and zero `len_in`;
    their choices are dropped. With `n_cells > 1` (the hierarchy's span
    routing) the instance axis is also padded, to a power of two that
    `n_cells` divides, with columns that are never allowed, and the scan
    runs cell-sharded, over the ranks of `mesh` when one is given (this
    process is then rank 0); the real columns keep their order, so the
    first attaining column and every choice are the unpadded call's.
    Returns (choice (R,) int64, est_T (R,) float64)."""
    from .device import resolve_device
    dev = resolve_device(device)
    R, I = q_inst.shape
    valid = None
    if n_cells > 1:
        Ip = max(bucket_pow2(I), bucket_pow2(n_cells, lo=1))
        padc = Ip - I

        def col(a, fill=0.0):
            return np.concatenate([np.asarray(a, float),
                                   np.full(padc, fill)])
        q_inst = np.pad(np.asarray(q_inst, float), ((0, 0), (0, padc)))
        l_inst = np.pad(np.asarray(l_inst, float), ((0, 0), (0, padc)))
        tpot, nominal_tpot, d, b, free, price_in, price_out = (
            col(a) for a in (tpot, nominal_tpot, d, b, free, price_in,
                             price_out))
        max_batch = col(max_batch, 1.0)
        if affinity is not None:
            affinity = np.pad(np.asarray(affinity, np.float32),
                              ((0, 0), (0, padc)))
        valid = torch.arange(Ip, device=dev) < I
    Rp = bucket_pow2(R)
    if Rp != R:
        pad = Rp - R
        q_inst = np.pad(np.asarray(q_inst, float), ((0, pad), (0, 0)))
        l_inst = np.pad(np.asarray(l_inst, float), ((0, pad), (0, 0)))
        pred_len_max = np.concatenate(
            [np.asarray(pred_len_max, float), np.full(pad, -1e30)])
        budgets = np.concatenate(
            [np.asarray(budgets, float), np.full(pad, np.nan)])
        len_in = np.concatenate(
            [np.asarray(len_in, float), np.zeros(pad)])
        if affinity is not None:
            affinity = np.pad(np.asarray(affinity, np.float32),
                              ((0, pad), (0, 0)))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    choice, est_T, _, _ = decide_batch(
        f32(q_inst), f32(l_inst), f32(pred_len_max), f32(tpot),
        f32(nominal_tpot), f32(d), f32(b), f32(free), f32(max_batch),
        f32(budgets), f32(len_in), f32(price_in), f32(price_out),
        tuple(float(w) for w in weights), latency_mode=latency_mode,
        lpt=lpt, budget_filter=budget_filter,
        affinity=None if affinity is None else f32(affinity), valid=valid,
        n_cells=n_cells, mesh=mesh)
    return (choice[:R].cpu().numpy().astype(np.int64),
            est_T[:R].cpu().numpy().astype(np.float64))
