"""The control comes out not correct: the reference computed with its
matrix products in TF32, the precision below the configurations' float32
with TF32 off, put in the program's place, reads above the limit that
the program's sound runs keep (at a CPU size; on the card the same
readings come from control.py at each cell's own size)."""
import pytest

from portbench import tinycell
from portbench.bench import cell as cl


@pytest.mark.parametrize("workload", ["fleet10k_flat.surge1600",
                                      "fleet10k_cells16.mix400"])
def test_control_is_not_correct(workload):
    d, fleet, cfg = tinycell.drive(workload, 29, rate=0.1, prompts=600)
    ref = tinycell.reference(cfg, fleet)
    ctl = tinycell.reference(cfg, fleet, tf32=True)
    read = cl.readings(d, ref, ctl)
    limits = cfg["check"]["limits"]
    for key in ("rows_off_pct", "batches_off_pct"):
        assert read[key] <= limits[key]
        assert read["control"][key] > limits[key]
    ok, lines = cl.judge(read["control"] | {"rows_checked": 1},
                         {k: limits[k] for k in ("rows_off_pct",
                                                 "batches_off_pct")})
    assert not ok, lines


def test_control_is_not_correct_on_sessions():
    """The same on a tiny cell of the session deployment: the control
    reads the affinity term alike, so only its precision departs."""
    from portbench.bench.cell import Drive, Fleet
    _, _, cfg, mix = tinycell.tiny_sessions(rate=0.4)
    cfg["dataset"]["n"] = 600
    fleet = Fleet.build(cfg, "cpu")
    d = Drive(fleet, mix, 29)
    d.warm()
    d.window(1.0)
    read = cl.readings(d, tinycell.reference(cfg, fleet),
                       tinycell.reference(cfg, fleet, tf32=True))
    limits = cfg["check"]["limits"]
    assert read["aff_rows_pct"] > 0
    assert all(read[k] <= limits[k] for k in limits)
    assert any(read["control"][k] > limits[k] for k in limits)
