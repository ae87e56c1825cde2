"""k1_wait_ms_per_call: the host's wait on K1's event per decision call
(ms): the summed `rb.k1_wait` spans of the program's tracer over the
calls of `FusedHotPath.stats`, the part of K1's time that the host's
work after the launch did not hide."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.k1_wait" not in spans or not calls:
        return None
    return 1e3 * spans["rb.k1_wait"]["total_s"] / calls
