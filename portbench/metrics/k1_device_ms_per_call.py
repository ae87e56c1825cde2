"""k1_device_ms_per_call: device time of K1's kernel (`decision_fused`)
in the traced window over its launches there (ms)."""


def read(view):
    tr = view["trace"]
    if tr is None or not tr["k1_launches"]:
        return None
    return 1e3 * tr["k1_device_s"] / tr["k1_launches"]
