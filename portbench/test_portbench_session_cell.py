"""The session deployment's cell, `fleet10k_sessions.sessions400`: its
files are the flat configuration with the affinity term on and `mix400`
with two tenants in sessions; its tiny stand-in is correct with rows
whose best instance the term moves, and not correct with the term
dropped; and the readers of the prefix plane's span and of K1's pass A
give their ratios from the tracer's summary, and nothing without it."""
import importlib

import pytest

from portbench import run, tinycell
from portbench.bench import cell as cl
from portbench.faults import affinity_dropped

CELL = "fleet10k_sessions.sessions400"
SEED = 2 ** 33 + 17
# a made-up summary of the tracer: the spans the three readers read
SUMMARY = {
    "rb.stage": {"count": 8, "total_s": 0.004, "self_s": 0.001,
                 "sums": {"K": 8, "R": 128}},
    "rb.plane": {"count": 8, "total_s": 0.003, "self_s": 0.003,
                 "sums": {"rows": 80000, "bytes": 8 * 4196352}},
    "k1.scan_a": {"count": 8, "total_s": 0.006, "self_s": 0.006,
                  "sums": {}},
    "k1.call": {"count": 8, "total_s": 0.024, "self_s": 0.024, "sums": {}},
}
READERS = {"plane_ms_per_call": 1e3 * 0.003 / 8,
           "plane_rows_per_call": 80000 / 8,
           "k1_scan_a_share_pct": 100 * 0.006 / 0.024}


def stand_in():
    """The cell's own files cut to CPU size (`tinycell.tiny`), with a 40
    s stream (a conversation's turns 8 s apart), a warm prefix past the
    first turns and every batch checked, so that a window of a CPU
    second or two checks follow-ups of turns dispatched inside it."""
    bench, cell, cfg, mix = tinycell.tiny(CELL, rate=0.1)
    cfg["check"].update(max_batches=400)
    return bench, cell, cfg, dict(mix, stream_s=40.0, warm_s=9.0)


def test_the_cell_is_the_flat_deployment_with_the_term_and_sessions():
    _, cell, cfg, mix = cl.find_cell(CELL)
    flat = cl.load_json(cl.ROOT / "portbench" / "configs"
                        / "fleet10k_flat.json")
    assert cfg["scheduler"]["rbconfig"] == {"affinity_weight": 0.35,
                                            "charge_compute": False}
    assert cfg["scheduler"]["hierarchy"] is None
    for key in ("roster", "world", "dataset", "estimators", "precision"):
        assert cfg[key] == flat[key], key
    assert cfg["check"]["limits"] == {"rows_off_pct": 5.0,
                                      "batches_off_pct": 40.0}
    assert cfg["check"]["batch_share"] == 0.03
    plain = cl.load_json(cl.ROOT / "portbench" / "traffic" / "mix400.json")
    want = tinycell.with_sessions(plain)
    for key in ("tenants", "lam_scale", "stream_s", "slice_s",
                "warm_buckets"):
        assert mix[key] == want[key], key
    assert mix["warm_s"] == 36.0
    assert cell["chips"] == 1


def test_stand_in_is_correct_and_the_term_moves_rows():
    bench, cell, cfg, mix = stand_in()
    res = run.run_cell(bench, cell, cfg, mix, SEED, 1.0, False, "cpu",
                       t_start=0.0)
    read = res["info"]["readings"]
    assert res["correct"] is True, res["checks"]
    assert read["rows_checked"] >= 20
    assert read["aff_rows_pct"] > 0


def test_stand_in_with_the_term_dropped_is_not_correct(monkeypatch):
    bench, cell, cfg, mix = stand_in()
    affinity_dropped(monkeypatch)
    res = run.run_cell(bench, cell, cfg, mix, SEED, 2.0, False, "cpu",
                       t_start=0.0)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_its_ratio_and_nothing_without_spans(name):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    view = dict(spans=SUMMARY, hot={"calls": 8})
    assert mod.read(view) == pytest.approx(READERS[name], rel=1e-12)
    assert mod.read(dict(view, spans=None)) is None
    left = {k: v for k, v in SUMMARY.items() if k not in ("rb.plane",
                                                          "k1.scan_a")}
    assert mod.read(dict(view, spans=left)) is None


@pytest.mark.parametrize("name", ["fleet10k_flat.mix400", CELL])
def test_a_traced_run_reads_the_plane_only_with_the_term(name):
    """`run_cell` traced on a tiny cell on the CPU: the plane's two
    metrics are read where the term is on (the whole roster's 24 sketch
    rows a call, inside the staging span), and not where it is off;
    K1's pass A has no stamps off the card."""
    bench, cell, cfg, mix = tinycell.tiny(name)
    res = run.run_cell(bench, cell, cfg, mix, 7, 1.0, True, "cpu")
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert "k1_scan_a_share_pct" not in m
    if name != CELL:
        assert not {"plane_ms_per_call", "plane_rows_per_call"} & set(m)
        return
    assert m["plane_rows_per_call"] == 24
    assert 0 < m["plane_ms_per_call"] <= m["hotpath_stage_ms_per_call"]
