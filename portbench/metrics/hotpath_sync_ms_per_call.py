"""hotpath_sync_ms_per_call: the hot paths' telemetry mirror sync per
decision call (ms): the summed `rb.sync` spans of the program's tracer
over the calls of `FusedHotPath.stats`."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.sync" not in spans or not calls:
        return None
    return 1e3 * spans["rb.sync"]["total_s"] / calls
