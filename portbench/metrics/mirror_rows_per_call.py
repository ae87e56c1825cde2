"""mirror_rows_per_call: telemetry rows the hot paths ship to the
card's mirror per decision call: the summed `rows` of the program's
`rb.sync` spans (a delta's dirty rows, a reseed's whole roster, a
carry's none) over the calls of `FusedHotPath.stats`."""


def read(view):
    spans, calls = view.get("spans"), view["hot"].get("calls")
    if not spans or "rb.sync" not in spans or not calls:
        return None
    return spans["rb.sync"]["sums"].get("rows", 0) / calls
