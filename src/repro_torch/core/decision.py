"""The LPT greedy scan with dead reckoning: the per-step arithmetic of
the RouteBalance decision (§4).

Port of `repro.core.decision_jax` (lines 46-241): `LATENCY_MODES`,
`bucket_pow2`, `greedy_step` and the scan, and the staged tensor core
that `RBConfig(decision_backend="torch")` runs (the reference's
`decision_backend="jax"`): `greedy_core` (the scan over a precomputed
order and admission mask), `decide_batch` (LPT order + Eq. 2 admission
+ scan) and `decide`, its numpy-in / numpy-out wrapper. The reference
runs the scan as a `lax.scan` under `jit`; here it is a Python loop over
the R rows on torch tensors. It is also the stage-4 body of the decision
kernel's plain version
(`repro_torch.kernels.decision_megakernel.decision_megakernel_plain`),
and it never reads a value back to the host, so on a CUDA tensor the
loop only enqueues work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .budget import admission_math, cost_matrix
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


def greedy_core(order, q_inst, c_hat, l_inst, tpot, nominal_tpot, d, b,
                free, max_batch, weights, allowed,
                latency_mode: str = "full", affinity=None):
    """The greedy pass over a precomputed order + admission mask, on
    float32 tensors of one device. Returns (choice (R,) int64, est_T
    (R,) float32)."""
    choice, est_T, _ = greedy_scan(order, q_inst, c_hat, l_inst, tpot,
                                   nominal_tpot, d, b, free, max_batch,
                                   weights, allowed, latency_mode,
                                   affinity=affinity)
    return choice, est_T


def decide_batch(q_inst, l_inst, pred_len_max, tpot, nominal_tpot, d, b,
                 free, max_batch, budgets, len_in, price_in, price_out,
                 weights, latency_mode: str = "full", lpt: bool = True,
                 budget_filter: bool = True, affinity=None):
    """The whole per-batch decision on float32 tensors of one device.

    q_inst/l_inst: (R, I) per-instance quality / predicted length;
    pred_len_max: (R,) max predicted length over *models* (LPT key);
    tpot/nominal_tpot/d/b/free/max_batch: (I,) instance state;
    budgets (R,) with nan = unconstrained; len_in (R,);
    price_in/price_out (I,); affinity optionally (R, I) prefix-reuse
    discount. Returns (choice (R,), est_T (R,), c_hat (R, I),
    allowed (R, I))."""
    R = q_inst.shape[0]
    if lpt:
        order = torch.argsort(-pred_len_max, stable=True)
    else:
        order = torch.arange(R, device=q_inst.device)
    if budget_filter:
        allowed, c_hat = admission_math(budgets, len_in, l_inst, price_in,
                                        price_out)
    else:
        c_hat = cost_matrix(len_in, l_inst, price_in, price_out)
        allowed = torch.ones(c_hat.shape, dtype=torch.bool,
                             device=c_hat.device)
    choice, est_T = greedy_core(order, q_inst, c_hat, l_inst, tpot,
                                nominal_tpot, d, b, free, max_batch,
                                weights, allowed, latency_mode, affinity)
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
           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """numpy-in / numpy-out wrapper for the scheduler's staged path: every
    input cast to float32 on `device` (None means the card), the batch
    padded to the next power of two (>= 8), as the reference pads it
    for its jit cache. Pad rows carry a -1e30 LPT key, so they scan
    strictly after every real request, a NaN budget and zero `len_in`;
    their choices are dropped. Returns (choice (R,) int64, est_T (R,)
    float64)."""
    from .device import resolve_device
    dev = resolve_device(device)
    R = q_inst.shape[0]
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
        affinity=None if affinity is None else f32(affinity))
    return (choice[:R].cpu().numpy().astype(np.int64),
            est_T[:R].cpu().numpy().astype(np.float64))
