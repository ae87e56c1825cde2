"""route_req_per_s: requests decided in the window over the controller's
time in the window (every ingest, decision and digest span summed)."""


def read(view):
    if not view["decided"] or view["controller_s"] <= 0:
        return None
    return view["decided"] / view["controller_s"]
