"""Peaks of the card and the least time K1 could take for one call.

`k1_counts` is a frozen copy of the decision kernel's count of bytes and
operations (`chip_smoke.py` `bound_ms`: inputs read and outputs written
once; of the label planes only the neighbours' rows; of
the TPOT trees each node once, or where the walks cover less, the nodes
walked), written over the call's shapes instead of its tensors.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and the float32 rate
# of the CUDA cores (K1 runs no tensor-core instruction)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def k1_counts(K: int, R: int, E: int, N: int, M: int, I: int, *,
              use_gbm: bool, n_tiers: int, n_trees: int, depth: int,
              w_aff: float, n_neighbour_rows: int, sig_width: int = 8,
              sketch_slots: int = 64) -> Dict:
    """Bytes and float32 operations one call of K windows of R rows (E
    wide) over an N-row index with M models and I instance columns
    needs: {"bytes", "flops", "bound_s", "bound_by"}."""
    per_row = 4 * E + 1 + 4 + 4             # emb, row_valid, budget, len_in
    per_inst = 4 * 8 + 1 + 4 * 2            # 8 float planes, alive, 2 ints
    nbytes = (K * R * per_row + N * E * 4 + N * 4
              + n_neighbour_rows * M * 4 * 2 + I * per_inst
              + K * R * 12 + K * I * 12)
    if use_gbm:
        per_tier = n_trees * ((2 ** depth - 1) * 8 + 2 ** depth * 4) + 4
        nbytes += min(I * n_trees * (depth * 8 + 4), n_tiers * per_tier)
    if w_aff > 0:
        nbytes += K * R * sig_width * 4 + I * sketch_slots * 4
    flops = 2 * K * R * N * E + 3 * K * R * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "flops": flops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
