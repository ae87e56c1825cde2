"""The benchmark's spans leave out the time inside the simulated
instances' `submit`, on the host clock and on the profiler's timeline."""
import time

import pytest

from portbench import tinycell
from portbench.bench import cell as cl
from portbench.bench.trace import _minus


def test_submit_is_not_controller_time(monkeypatch):
    """Each submit in the window sleeps 0.3 s, far longer than a tiny
    decision takes: no decision span holds that time."""
    from repro_torch.serving.cluster import Instance
    submit, delay = Instance.submit, [0.0]

    def slow(self, *a, **kw):
        time.sleep(delay[0])
        return submit(self, *a, **kw)
    monkeypatch.setattr(Instance, "submit", slow)
    _, _, cfg, mix = tinycell.tiny("fleet10k_flat.mix400")
    d = cl.Drive(cl.Fleet.build(cfg, "cpu"), mix, 5)
    d.warm()
    delay[0] = 0.3
    d.window(3.0)
    p = d.probe
    assert p.batches
    assert p.fleet_s >= 0.3 * d.decided()
    for rows, dt in p.batches:
        assert dt < 0.3 * len(rows)


@pytest.mark.parametrize("a, b, want", [
    ([(0, 10)], [], [(0, 10)]),
    ([(0, 10)], [(0, 10)], []),
    ([(5, 6)], [(0, 10)], []),
    ([(0, 10), (12, 20)], [(1, 2), (3, 4), (9, 13), (15, 16), (19, 25)],
     [(0, 1), (2, 3), (4, 9), (13, 15), (16, 19)]),
])
def test_interval_difference(a, b, want):
    assert _minus(a, b) == want
