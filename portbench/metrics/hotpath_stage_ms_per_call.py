"""hotpath_stage_ms_per_call: the hot paths' staging pass and affinity
plane per decision call (ms): the summed `rb.stage` spans of the
program's tracer over the calls of `FusedHotPath.stats`."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.stage" not in spans or not calls:
        return None
    return 1e3 * spans["rb.stage"]["total_s"] / calls
