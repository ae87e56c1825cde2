"""plane_ms_per_call: the hot paths' prefix plane per decision call
(ms): the summed `rb.plane` spans of the program's tracer (the fleet's
sketches copied into the pinned plane, the plane and the rows'
signatures uploaded) over the calls of `FusedHotPath.stats`. Nothing to
read where the affinity term is off, or in a program without the span."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.plane" not in spans or not calls:
        return None
    return 1e3 * spans["rb.plane"]["total_s"] / calls
