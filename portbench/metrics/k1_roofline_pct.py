"""k1_roofline_pct: the least time the H100 could take for a K1 call of
the window (the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, `yard.roofline.k1_counts`), averaged over
the window's calls, over K1's device time per launch in the traced
window (%). Where the profiler recorded every launch this is the summed
bound over the summed device time."""


def read(view):
    tr = view["trace"]
    if (tr is None or not tr["k1_launches"] or not view["k1_calls"]
            or view["k1_bound_s"] is None):
        return None
    bound = view["k1_bound_s"] / view["k1_calls"]
    return 100.0 * bound / (tr["k1_device_s"] / tr["k1_launches"])
