"""hotpath_launch_ms_per_call: the hot paths' K1 call up to the answer's
event per decision call (ms): the summed `rb.launch` spans of the
program's tracer over the calls of `FusedHotPath.stats`."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.launch" not in spans or not calls:
        return None
    return 1e3 * spans["rb.launch"]["total_s"] / calls
