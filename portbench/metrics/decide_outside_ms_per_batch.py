"""decide_outside_ms_per_batch: the engines' own work around the hot path
per decided batch (ms): every `rb.fire` span of the program's tracer
less the hot path's `rb.stage`, `rb.sync`, `rb.launch` and `rb.fetch`
spans and the instances' `rb.submit` inside it (the window, the batch
view, the dispatch loop, a cell's telemetry refresh), over the batches
decided. In a window those spans occur only inside a fire."""

INSIDE = ("rb.stage", "rb.sync", "rb.launch", "rb.fetch", "rb.submit")


def read(view):
    spans = view.get("spans")
    if not spans or "rb.fire" not in spans or not view["batches"]:
        return None
    inside = sum(spans[n]["total_s"] for n in INSIDE if n in spans)
    return 1e3 * (spans["rb.fire"]["total_s"] - inside) / view["batches"]
