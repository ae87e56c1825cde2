"""Equation 2 budget control: average-case admission filter at scoring
time, worst-case enforcement at dispatch (max_tokens clamp) (§4.1, §6.4).

Port of `repro.core.budget` (lines 17-76): `cost_matrix` and
`admission_math` in torch with the reference's operation order (the
former is operators only, so it takes numpy arrays as well),
`admission_mask` a numpy copy for the host greedy loop, and
`max_tokens_clamp` unchanged (host-side, per dispatch).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def cost_matrix(len_in, pred_len, price_in, price_out):
    """Ĉ(r,i) = (ℓ_in c_in + L̂ c_out) · 1e-6 over (R, I). The per-token
    scale is a reciprocal multiply, as in the reference."""
    return (len_in[:, None] * price_in[None, :]
            + pred_len * price_out[None, :]) * 1e-6


def admission_math(budgets, len_in, pred_len, price_in, price_out,
                   valid=None):
    """Eq. 2: (allowed (R, I) bool, c_hat (R, I)). A request may use the
    candidates whose predicted cost fits its budget (nan = no budget);
    when none fits it keeps its single cheapest candidate (first index
    on ties). `valid` (I,) bool restricts the candidate set: masked
    columns never admit and never win the cheapest fallback."""
    I = pred_len.shape[1]
    c_hat = cost_matrix(len_in, pred_len, price_in, price_out)
    has_budget = ~torch.isnan(budgets)
    constrained = torch.where(has_budget[:, None],
                              c_hat <= budgets[:, None], True)
    c_sel = c_hat
    if valid is not None:
        constrained = constrained & valid[None, :]
        c_sel = torch.where(valid[None, :], c_hat, float("inf"))
    none_fit = ~constrained.any(dim=1)
    cheapest = (torch.arange(I, device=c_hat.device)[None, :]
                == c_sel.argmin(dim=1)[:, None])     # one-hot fallback
    allowed = torch.where(none_fit[:, None], cheapest, constrained)
    return allowed, c_hat


def admission_mask(budgets: np.ndarray, len_in: np.ndarray,
                   pred_len: np.ndarray, price_in: np.ndarray,
                   price_out: np.ndarray):
    """Eq. 2 in numpy: (R,) budgets (nan = none), (R,) len_in, (R, I)
    pred_len per instance's model, (I,) prices -> (allowed (R, I) bool,
    c_hat (R, I)). Requests whose budget excludes every candidate keep
    their single cheapest candidate (first index on ties)."""
    I = pred_len.shape[1]
    c_hat = cost_matrix(len_in, pred_len, price_in, price_out)
    has_budget = ~np.isnan(budgets)
    constrained = np.where(has_budget[:, None],
                           c_hat <= budgets[:, None], True)
    none_fit = ~constrained.any(axis=1)
    cheapest = (np.arange(I)[None, :]
                == c_hat.argmin(axis=1)[:, None])    # one-hot fallback
    allowed = np.where(none_fit[:, None], cheapest, constrained)
    return allowed, c_hat


def max_tokens_clamp(budget: Optional[float], len_in: int,
                     price_in: float, price_out: float) -> Optional[int]:
    """Worst-case enforcement at dispatch: the response may not exceed the
    remaining budget at the chosen model's output price."""
    if budget is None or np.isnan(budget):
        return None
    rem = budget - len_in * price_in / 1e6
    return max(int(rem / (price_out / 1e6 + 1e-30)), 1)
