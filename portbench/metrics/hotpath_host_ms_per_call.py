"""hotpath_host_ms_per_call: the hot paths' host time per decision call
in the window: (host_s + dispatch_s) / calls of `FusedHotPath.stats`,
summed over every hot path (staging, the telemetry mirror's sync, the
launch and the copy back queued)."""


def read(view):
    hot = view["hot"]
    if not hot.get("calls"):
        return None
    return 1e3 * (hot["host_s"] + hot["dispatch_s"]) / hot["calls"]
