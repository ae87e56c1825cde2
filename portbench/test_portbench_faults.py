"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run (set-up,
warm prefix, window, reference, judgement) is driven on the CPU at a
small size, once for each fault a cell of this benchmark can have."""
import numpy as np
import pytest

from portbench import run, tinycell
from portbench.faults import (affinity_dropped, altered_answer, half_batch,
                              moved_placement, stale_mirror,
                              stale_prefix_plane)

CASES = [("fleet10k_flat.surge1600", stale_mirror),
         ("fleet10k_flat.surge1600", half_batch),
         ("fleet10k_flat.surge1600", altered_answer),
         ("fleet10k_cells16.mix400", stale_mirror),
         ("fleet10k_cells16.mix400", half_batch),
         ("fleet10k_cells16.mix400", altered_answer),
         ("fleet10k_cells16.mix400", moved_placement)]


@pytest.mark.parametrize("workload, fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    bench, cell, cfg, mix = tinycell.tiny(workload, rate=0.1)
    fault(monkeypatch)
    res = run.run_cell(bench, cell, cfg, mix, 2 ** 33 + 17, 1.0, False,
                       "cpu", t_start=0.0)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [affinity_dropped, stale_prefix_plane],
                         ids=lambda f: f.__name__)
def test_session_fault_is_not_correct(monkeypatch, fault):
    """The faults of the affinity path, on a tiny cell of the session
    deployment (the term on, two tenants in sessions), with a window
    longer than the gap between a conversation's turns."""
    bench, cell, cfg, mix = tinycell.tiny_sessions()
    fault(monkeypatch)
    res = run.run_cell(bench, cell, cfg, mix, 2 ** 33 + 17, 2.0, False,
                       "cpu", t_start=0.0)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_sound_run_is_correct():
    bench, cell, cfg, mix = tinycell.tiny("fleet10k_flat.surge1600",
                                          rate=0.1)
    res = run.run_cell(bench, cell, cfg, mix, 2 ** 33 + 17, 1.0, False,
                       "cpu", t_start=0.0)
    assert res["correct"] is True, res["checks"]
    assert list(res["metrics"]) == ["route_ms_p95", "route_req_per_s",
                                    "setup_s"]
    assert np.isfinite(res["metrics"]["route_ms_p95"]["value"])
