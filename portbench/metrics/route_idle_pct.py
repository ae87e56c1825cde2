"""route_idle_pct: the share of the controller's spans in the traced
window with no activity on the device (%), from the profiler's timeline,
on which the spans are marked as ranges."""


def read(view):
    tr = view["trace"]
    if tr is None or tr["controller_s"] <= 0:
        return None
    return 100.0 * tr["controller_idle_s"] / tr["controller_s"]
