"""route_ms_p95: the 95th percentile, over every request decided in the
window, of the controller's time on it: its own ingest span plus the
span of the batch decision it was in (ms)."""
import numpy as np


def read(view):
    v = view["per_request_ms"]
    return float(np.percentile(v, 95)) if len(v) else None
