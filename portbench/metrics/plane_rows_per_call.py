"""plane_rows_per_call: prefix-sketch rows the hot paths stage into the
prefix plane per decision call: the summed `rows` of the program's
`rb.plane` spans over the calls of `FusedHotPath.stats` (the whole
roster while the plane is shipped whole). Nothing to read where the
affinity term is off, or in a program without the span."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.plane" not in spans or not calls:
        return None
    return spans["rb.plane"]["sums"].get("rows", 0) / calls
