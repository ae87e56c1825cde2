"""LPT-ordered greedy assignment with dead reckoning (Algorithm 1), its
tensor twin, and a Hungarian reference for the greedy-gap replay (§4.1).

Port of `repro.core.assignment` (lines 14-186). `lpt_order`,
`greedy_assign` (the numpy loop: float32 when its inputs are, which is
how the scheduler calls it) and `hungarian` are copies;
`greedy_assign_torch` is the counterpart of `greedy_assign_jax`, the
greedy pass on torch tensors through `core.decision.greedy_core`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .scoring import _affinity_discount_np, score_row


def lpt_order(pred_len_max: np.ndarray, enable: bool = True) -> np.ndarray:
    """Longest-predicted-output-first (Graham's LPT rule; §4.1).
    Sort key is max over models since the model is not yet chosen."""
    if not enable:
        return np.arange(len(pred_len_max))
    return np.argsort(-pred_len_max, kind="stable")


def greedy_assign(order: np.ndarray, q_hat_inst: np.ndarray,
                  c_hat: np.ndarray, len_inst: np.ndarray,
                  tpot: np.ndarray, d: np.ndarray, b: np.ndarray,
                  free: np.ndarray, max_batch: np.ndarray, weights,
                  allowed: Optional[np.ndarray] = None,
                  latency_mode: str = "full",
                  nominal_tpot: Optional[np.ndarray] = None,
                  affinity: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, Dict]:
    """Sequential greedy over the batch in LPT order.

    q_hat_inst/len_inst/c_hat: (R, I) per-instance expansions; tpot: (I,)
    predicted per-iteration time; d/b/free: (I,) dead-reckoned instance
    state (pending decode tokens, decode batch, free slots). Each dispatch
    updates the LOCAL copy of the chosen instance's state so later
    requests see the consequences of earlier ones — no herding (§4.2).

    latency_mode: full | off_reactive | off_predictive | static_prior
    (the four isolation arms of §6.3).

    affinity: optional (R, I) float32 prefix-reuse discount
    (affinity_weight x matched-prefix fraction, `serving.affinity`):
    the predicted latency T is scaled by (1 - affinity) BEFORE scoring,
    tie-breaks and est_latency — a warm prefix cache shortens this
    request's effective prefill on that instance.
    """
    R, I = q_hat_inst.shape
    choice = np.full(R, -1, np.int64)
    # the loop follows the input dtype: the scheduler's staged numpy
    # path passes float32 so all three backends share one arithmetic
    # contract (the T/score chains are then bitwise the jitted cores');
    # direct callers with float64 inputs keep the legacy double loop
    dt = np.float32 if q_hat_inst.dtype == np.float32 else np.float64
    q_hat_inst = np.asarray(q_hat_inst, dt)
    c_hat = np.asarray(c_hat, dt)
    len_inst = np.asarray(len_inst, dt)
    tpot = np.asarray(tpot, dt)
    if nominal_tpot is not None:
        nominal_tpot = np.asarray(nominal_tpot, dt)
    max_batch = np.asarray(max_batch, dt)
    d = d.astype(dt).copy()
    b = b.astype(dt).copy()
    b0 = np.maximum(b.copy(), dt(1.0))  # snapshot batch (TPOT reference)
    free = free.astype(dt).copy()
    est_T = np.zeros(R)
    for r in order:
        wait = np.where(free > 0, 0.0, d / np.maximum(b, 1.0))
        # in-batch dispatches grow the decode batch beyond the snapshot the
        # TPOT head saw; scale conservatively (compute-bound regime is
        # ~linear in batch) so idle-but-identical instances don't herd.
        tpot_eff = tpot * np.maximum(b / b0, 1.0)
        if latency_mode == "static_prior":
            T = (nominal_tpot if nominal_tpot is not None else tpot) \
                * len_inst[r]
        else:
            T = tpot_eff * (wait + len_inst[r])
        if affinity is not None:
            T = _affinity_discount_np(T, affinity[r]).astype(dt)
        if latency_mode in ("off_reactive", "off_predictive"):
            w = (weights[0], 0.0, weights[2])
            s = score_row(q_hat_inst[r], c_hat[r], T, w,
                          None if allowed is None else allowed[r])
            # model score is instance-blind: tie-break within winner
            # model. Scores come back epsilon-quantized (exact multiples
            # of SCORE_QUANTUM), so the 1e-9 nudge — far below the
            # quantum, far above float64 eps — orders candidates inside
            # a quantized tie group without ever crossing groups. The
            # nudge runs in float64 even when the loop is float32 (it
            # would underflow an O(1) float32 score).
            tie = (d + b) if latency_mode == "off_reactive" else T
            tn = (tie / max(tie.max(), 1e-9)).astype(np.float64)
            s = s.astype(np.float64) - 1e-9 * tn
        else:
            s = score_row(q_hat_inst[r], c_hat[r], T, weights,
                          None if allowed is None else allowed[r])
        i = int(np.argmax(s))
        choice[r] = i
        est_T[r] = T[i]
        # dead reckoning: the chosen instance's pending work grows by L̂
        d[i] += len_inst[r, i]
        if free[i] > 0:
            free[i] -= 1
            b[i] = min(b[i] + 1, max_batch[i])
    return choice, {"est_latency": est_T}


# ---------------------------------------------------------------------------
# Tensor variant: the greedy pass of `core.decision.greedy_core`, the
# Eq. 1 / dead-reckoning math of the loop above on torch tensors.

def greedy_assign_torch(order, q_hat_inst, c_hat, len_inst, tpot, d, b,
                        free, max_batch, weights,
                        allowed: Optional[np.ndarray] = None,
                        latency_mode: str = "full",
                        nominal_tpot: Optional[np.ndarray] = None,
                        device=None) -> np.ndarray:
    """numpy in, (R,) int64 choice out; the scan runs in float32 on
    `device` (None means the card)."""
    from .decision import greedy_core
    from .device import resolve_device
    dev = resolve_device(device)
    if allowed is None:
        allowed = np.ones(np.shape(q_hat_inst), bool)
    if nominal_tpot is None:
        nominal_tpot = tpot

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    choice, _ = greedy_core(
        torch.as_tensor(np.asarray(order, np.int64), device=dev),
        f32(q_hat_inst), f32(c_hat), f32(len_inst), f32(tpot),
        f32(nominal_tpot), f32(d), f32(b), f32(free), f32(max_batch),
        tuple(float(w) for w in weights),
        torch.as_tensor(np.asarray(allowed, bool), device=dev),
        latency_mode=latency_mode)
    return choice.cpu().numpy()


# ---------------------------------------------------------------------------
# Hungarian (Jonker-free O(n^3) reference) for the offline replay: a
# batch-level matching differs from greedy only through within-batch state
# updates; the paper measures 15.6% assignment divergence with -0.002
# realized quality (§4.1).

def hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimal-cost assignment; cost (n, m), n <= m. Returns col of each
    row. Classic potentials implementation."""
    n, m = cost.shape
    if n > m:
        raise ValueError(f"hungarian needs rows <= columns, got {cost.shape}")
    INF = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)      # p[j] = row matched to col j (1-idx)
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    ans = np.zeros(n, np.int64)
    for j in range(1, m + 1):
        if p[j] > 0:
            ans[p[j] - 1] = j - 1
    return ans
