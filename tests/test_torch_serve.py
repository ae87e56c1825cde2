"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU:
the hierarchy through the CLI, balanced and span, on the `cluster`
scenario at 2 cells and 60 requests.

The launcher charges measured decision time (`charge_compute` stays on,
as in the reference's launcher), so its simulated clock follows the wall
clock and values are not compared here; the exact comparison with the
reference is `tests/test_torch_hierarchy.py`'s. The `cluster` scenario
kills 15% of its instances at t = 6 s with recovery off, so requests in
flight on them fail at that instant, in both packages' launchers: the
checks are that every request is terminal once and that every failure is
the schedule's. The key-for-key comparison with the reference launcher
builds two 6,000-prompt bundles per case (over 30 s on the CPU), so it
is marked slow.
"""
import json
import sys

import pytest

ARGS = ["--scenario", "cluster", "--cells", "2", "--n", "60"]
KILL_AT = 6.0          # the cluster scenario's FailureEvent(t=6.0, "fail")


def _port(routing, capsys, monkeypatch):
    """(printed JSON, requests, scheduler) of the port's launcher."""
    from repro_torch.launch import serve
    kept = {}
    real = serve.serve

    def keep(args):
        kept["out"] = real(args)
        return kept["out"]
    monkeypatch.setattr(serve, "serve", keep)
    capsys.readouterr()
    serve.main(ARGS + ["--cell-routing", routing, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    _, reqs, sched = kept["out"]
    return printed, reqs, sched


@pytest.mark.parametrize("routing", ["balanced", "span"])
def test_launcher_runs_the_hierarchy(routing, capsys, monkeypatch):
    from repro_torch.core import RouteBalance
    from repro_torch.serving.hierarchy import HierarchicalScheduler
    m, reqs, sched = _port(routing, capsys, monkeypatch)
    assert m["cells"] == 2 and m["cell_routing"] == routing
    assert m["scenario"] == "cluster" and m["n_instances"] == 48
    assert m["n"] + m["failed"] + m["shed"] == len(reqs) == 60
    assert [r.finish_time for r in reqs if r.failed] == [KILL_AT] * m["failed"]
    if routing == "balanced":
        assert m["decision_backend"] == "megakernel"
        assert isinstance(sched, HierarchicalScheduler)
        assert m["digests"] > 0 and m["digest_bytes"] > 0
        assert 0.0 <= m["intercell_imbalance"] < 1.0
    else:
        assert m["decision_backend"] == "torch"
        assert isinstance(sched, RouteBalance)
        assert sched.cfg.shard_cells == 2 and sched._fused is None
        assert "digests" not in m


def test_launcher_refuses_cells_for_a_baseline(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--policy", "bestroute-sq", "--device", "cpu"] + ARGS)


@pytest.mark.slow
@pytest.mark.parametrize("routing", ["balanced", "span"])
def test_launcher_keys_match_the_reference(routing, capsys, monkeypatch):
    """The same keys as the reference launcher's JSON on the same
    arguments, plus `decision_backend` (which arm decided)."""
    from repro.launch import serve as ref
    m, _, _ = _port(routing, capsys, monkeypatch)
    monkeypatch.setattr(sys, "argv",
                        ["serve"] + ARGS + ["--cell-routing", routing])
    ref.main()
    rm = json.loads(capsys.readouterr().out)
    assert set(m) == set(rm) | {"decision_backend"}
    assert rm["cells"] == m["cells"] == 2
