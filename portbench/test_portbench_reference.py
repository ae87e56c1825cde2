"""The frozen reference agrees with the program on a small roster on the
CPU: with the decision kernel's plain version (the default backend
there) and with the staged numpy backend, every checked row is the
reference's, and in the hierarchy every placement is."""
import pytest

from portbench import tinycell
from portbench.bench import cell as cl


@pytest.mark.parametrize("workload, backend", [
    ("fleet10k_flat.mix400", "megakernel"),
    ("fleet10k_flat.mix400", "numpy"),
    ("fleet10k_cells16.surge1600", "megakernel")])
def test_reference_agrees_with_program(workload, backend):
    d, fleet, cfg = tinycell.drive(workload, 11, decision_backend=backend)
    read = cl.readings(d, tinycell.reference(cfg, fleet))
    assert read["rows_checked"] >= 20
    assert read["rows_off_pct"] == read["batches_off_pct"] == 0.0
    assert read["gap_max"] == 0.0 and read["l_err_max"] < 1e-5
    if d.hier:
        assert read["placements_checked"] >= 20
        assert read["placement_off_pct"] == 0.0
    ok, _ = cl.judge(read, cfg["check"]["limits"])
    assert ok
