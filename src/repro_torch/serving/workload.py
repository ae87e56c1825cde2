"""Arrival processes: Poisson (the paper's default), gamma-bursty and
square-wave (§6.9 non-stationary robustness), plus the flash-crowd
piecewise-Poisson trace used by the scenario subsystem
(`repro_torch.serving.scenarios`), and the per-request budget mix.

Port of `repro.serving.workload` (numpy, unchanged): the same seeds give
the same arrays."""
from __future__ import annotations

import numpy as np


def poisson_arrivals(lam: float, n: int, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / lam, n)
    return start + np.cumsum(gaps)


def gamma_bursty_arrivals(lam: float, n: int, cv: float = 3.0,
                          seed: int = 0) -> np.ndarray:
    """Gamma-distributed gaps with mean 1/lam and coefficient of
    variation cv (cv > 1 = bursty)."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / cv ** 2
    scale = 1.0 / (lam * shape)
    return np.cumsum(rng.gamma(shape, scale, n))


def square_wave_arrivals(lam: float, n: int, period: float = 60.0,
                         high_frac: float = 1.5, seed: int = 0
                         ) -> np.ndarray:
    """Alternates between high_frac*lam and (2-high_frac)*lam every
    period/2 seconds; matched mean lam."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    lo = (2.0 - high_frac) * lam
    hi = high_frac * lam
    for _ in range(n):
        phase_hi = (t % period) < period / 2
        rate = hi if phase_hi else lo
        t += rng.exponential(1.0 / max(rate, 1e-9))
        out.append(t)
    return np.asarray(out)


def flash_crowd_arrivals(lam: float, n: int, burst_start: float = 20.0,
                         burst_dur: float = 10.0, burst_mult: float = 5.0,
                         seed: int = 0) -> np.ndarray:
    """Baseline-Poisson trace with one flash crowd: the rate jumps to
    burst_mult*lam inside [burst_start, burst_start+burst_dur). Unlike
    the square wave this is NOT mean-matched — a flash crowd adds load,
    which is the point (high-load separation, §6.5)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        in_burst = burst_start <= t < burst_start + burst_dur
        rate = lam * (burst_mult if in_burst else 1.0)
        t += rng.exponential(1.0 / max(rate, 1e-9))
        out.append(t)
    return np.asarray(out)


def sample_budgets(n: int, frac: float, lo: float = 2e-5, hi: float = 4e-4,
                   seed=0, rng: np.random.Generator = None) -> np.ndarray:
    """Vectorized per-request budget mix: each request independently
    carries a log-uniform USD budget in [lo, hi] with probability
    `frac`, nan otherwise (nan = unconstrained, the column convention of
    `repro_torch.serving.request.RequestColumns`). One draw per stream at
    workload-generation time — budgets are ingest data, not per-request
    hot-path work."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    has = rng.uniform(size=n) < frac
    vals = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return np.where(has, vals, np.nan)


ARRIVAL_KINDS = ("poisson", "gamma", "square", "flash")


def make_arrivals(kind: str, lam: float, n: int, seed: int = 0,
                  **kw) -> np.ndarray:
    """Dispatch on `kind`, forwarding process-specific kwargs (cv for
    gamma; period/high_frac for square; burst_* for flash)."""
    if kind == "poisson":
        return poisson_arrivals(lam, n, seed, **kw)
    if kind == "gamma":
        return gamma_bursty_arrivals(lam, n, seed=seed, **kw)
    if kind == "square":
        return square_wave_arrivals(lam, n, seed=seed, **kw)
    if kind == "flash":
        return flash_crowd_arrivals(lam, n, seed=seed, **kw)
    raise ValueError(kind)
