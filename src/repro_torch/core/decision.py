"""The LPT greedy scan with dead reckoning: the per-step arithmetic of
the RouteBalance decision (§4).

Port of `repro.core.decision_jax` (lines 46-142): `LATENCY_MODES`,
`bucket_pow2`, `greedy_step` and the scan. The reference runs the scan
as a `lax.scan`; here it is a Python loop over the R rows on torch
tensors. It is the stage-4 body of the decision kernel's plain version
(`repro_torch.kernels.decision_megakernel.decision_megakernel_plain`),
and it never reads a value back to the host, so on a CUDA tensor the
loop only enqueues work.
"""
from __future__ import annotations

import torch

from .scoring import affinity_discount, masked_score

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


def greedy_scan(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
                free, max_batch, weights, allowed, latency_mode: str,
                row_valid=None, affinity=None):
    """The R-step scan in `order` (LPT or arrival). (R, I) planes, (I,)
    state; d/b/free are copied, not modified. Returns (choice (R,)
    int64, est_T (R,) float32, (d, b, free) post-scan)."""
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
        d, b, free, i, est = greedy_step(
            d, b, free, q=q_o[t], c=c_o[t], l=l_o[t], tpot=tpot,
            nominal_tpot=nominal_tpot, b0=b0, max_batch=max_batch,
            weights=weights, allowed=a_o[t], latency_mode=latency_mode,
            valid=v_o[t], affinity=None if aff_o is None else aff_o[t])
        picks.append(i)
        ests.append(est)
    # the scan emits in scan order; scatter back to request order
    choice = torch.empty(R, dtype=torch.int64, device=q_inst.device)
    est_T = torch.empty(R, dtype=torch.float32, device=q_inst.device)
    if R:
        choice.index_copy_(0, order, torch.cat(picks))
        est_T.index_copy_(0, order, torch.cat(ests))
    return choice, est_T, (d, b, free)
