"""K1's count restates the bounds `chip_smoke.py` measured against (the
14,886-row index, R = 8, four tiers of 60 depth-3 trees, one window):
0.00256 ms at I = 16,384, 0.00231 / 0.00232 ms at I = 512 / 1,024."""
import pytest

from portbench.yard.roofline import k1_counts


@pytest.mark.parametrize("I, want_ms", [(16384, 0.00256), (512, 0.00231),
                                        (1024, 0.00232)])
def test_k1_bound_restates_pr26(I, want_ms):
    c = k1_counts(1, 8, 128, 14886, 4, I, use_gbm=True, n_tiers=4,
                  n_trees=60, depth=3, w_aff=0.0, n_neighbour_rows=80)
    assert c["bound_by"] == "bytes"
    assert round(c["bound_s"] * 1e3, 5) == want_ms


def test_k1_large_batch_is_bound_by_operations():
    c = k1_counts(1, 256, 128, 14886, 4, 16384, use_gbm=True, n_tiers=16,
                  n_trees=60, depth=3, w_aff=0.0, n_neighbour_rows=2560)
    assert c["bound_by"] == "operations"
    assert c["flops"] == 2 * 256 * 14886 * 128 + 3 * 256 * 14886
