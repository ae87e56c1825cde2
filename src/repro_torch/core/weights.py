"""3-simplex scheduling weights and named operating points (§4.1).

Port of `repro.core.weights` (numpy, unchanged).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

Weights = Tuple[float, float, float]   # (w_qual, w_lat, w_cost)

PRESETS: Dict[str, Weights] = {
    "quality": (0.8, 0.1, 0.1),
    "uniform": (1 / 3, 1 / 3, 1 / 3),
    "latency": (0.1, 0.8, 0.1),
    "cost": (0.1, 0.1, 0.8),
}


def validate(w: Weights) -> Weights:
    wq, wl, wc = w
    s = wq + wl + wc
    assert abs(s - 1.0) < 1e-6, f"weights must lie on the 3-simplex: {w}"
    assert min(w) >= 0.0
    return w


def sweep(n: int = 16) -> List[Weights]:
    """The paper sweeps 16 weight tuples on the simplex (§6.1)."""
    pts = []
    for wq in (0.0, 0.2, 1 / 3, 0.4, 0.6, 0.8, 1.0):
        for wl in (0.0, 0.1, 0.2, 1 / 3, 0.4, 0.6):
            wc = 1.0 - wq - wl
            if wc < -1e-9:
                continue
            pts.append((round(wq, 4), round(wl, 4), round(max(wc, 0.0), 4)))
    # dedupe, keep a stable subset of n
    uniq = sorted(set(pts))
    if len(uniq) <= n:
        return uniq
    step = len(uniq) / n
    return [uniq[int(i * step)] for i in range(n)]
