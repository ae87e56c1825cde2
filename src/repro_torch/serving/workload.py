"""Arrival processes: Poisson, the paper's default.

Port of `repro.serving.workload` (numpy, unchanged); the bursty,
square-wave and flash-crowd processes come with the scenario port
(ROADMAP queue 1, item 2)."""
from __future__ import annotations

import numpy as np


def poisson_arrivals(lam: float, n: int, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / lam, n)
    return start + np.cumsum(gaps)
