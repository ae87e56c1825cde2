"""balancer_share_pct: the hierarchy's placement and digest spans over
the controller's time in the window (%); nothing to read without a
hierarchy."""


def read(view):
    if not view["hier"] or view["controller_s"] <= 0:
        return None
    return 100.0 * (view["place_s"] + view["digest_s"]) / view["controller_s"]
