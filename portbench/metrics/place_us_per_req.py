"""place_us_per_req: the balancer's placement per arriving request (us):
the mean `rb.place` span of the program's tracer; nothing to read
without a hierarchy."""


def read(view):
    spans = view.get("spans")
    if not view["hier"] or not spans or "rb.place" not in spans:
        return None
    p = spans["rb.place"]
    return 1e6 * p["total_s"] / p["count"]
