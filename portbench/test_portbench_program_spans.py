"""The readers of the program's spans, the device's idle time by program
span, and the traced run with the program's tracer on and off on a tiny
cell on the CPU."""
import json

import pytest

from portbench.bench import cell as cl
from portbench.bench.trace import (NONE, idle_by_program_span, innermost,
                                   read_profile)

SUMMARY = {
    "rb.fire": {"count": 10, "total_s": 0.050, "self_s": 0.004, "sums": {}},
    "rb.stage": {"count": 8, "total_s": 0.004, "self_s": 0.004,
                 "sums": {"K": 8, "R": 128}},
    "rb.sync": {"count": 8, "total_s": 0.006, "self_s": 0.006,
                "sums": {"kind": 8, "rows": 1200}},
    "rb.launch": {"count": 8, "total_s": 0.002, "self_s": 0.002, "sums": {}},
    "rb.fetch": {"count": 8, "total_s": 0.030, "self_s": 0.001, "sums": {}},
    "rb.k1_wait": {"count": 8, "total_s": 0.029, "self_s": 0.029,
                   "sums": {}},
    "rb.submit": {"count": 100, "total_s": 0.005, "self_s": 0.005,
                  "sums": {"rid": 4950, "slot": 700}},
    "rb.place": {"count": 120, "total_s": 0.012, "self_s": 0.012,
                 "sums": {"rid": 7140, "cell": 300}},
    "k1.trees": {"count": 8, "total_s": 0.018, "self_s": 0.018, "sums": {}},
    "k1.call": {"count": 8, "total_s": 0.024, "self_s": 0.024, "sums": {}},
}
# the per-layer metrics that read the tracer's summary
SPAN_METRICS = ("hotpath_stage_ms_per_call", "hotpath_sync_ms_per_call",
                "hotpath_launch_ms_per_call", "mirror_rows_per_call",
                "k1_wait_ms_per_call", "decide_outside_ms_per_batch",
                "place_us_per_req", "k1_trees_share_pct")


def view(**kw):
    v = dict(spans=SUMMARY, hot={"calls": 8}, hier=True, batches=8)
    v.update(kw)
    return v


@pytest.mark.parametrize("name, want", [
    ("hotpath_stage_ms_per_call", 1e3 * 0.004 / 8),
    ("hotpath_sync_ms_per_call", 1e3 * 0.006 / 8),
    ("hotpath_launch_ms_per_call", 1e3 * 0.002 / 8),
    ("mirror_rows_per_call", 1200 / 8),
    ("k1_wait_ms_per_call", 1e3 * 0.029 / 8),
    ("decide_outside_ms_per_batch",
     1e3 * (0.050 - 0.004 - 0.006 - 0.002 - 0.030 - 0.005) / 8),
    ("place_us_per_req", 1e6 * 0.012 / 120),
    ("k1_trees_share_pct", 100 * 0.018 / 0.024),
])
def test_reader_gives_its_ratio_and_nothing_without_spans(name, want):
    import importlib
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert mod.read(view()) == pytest.approx(want, rel=1e-12)
    assert mod.read(view(spans=None)) is None
    assert name in {m["name"] for m in cl.load_json(
        cl.ROOT / "BENCHMARK.json")["per_layer"]}


def test_placement_reads_nothing_without_a_hierarchy():
    from portbench.metrics import place_us_per_req
    assert place_us_per_req.read(view(hier=False)) is None
    no_place = {k: v for k, v in SUMMARY.items() if k != "rb.place"}
    assert place_us_per_req.read(view(spans=no_place)) is None


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


BASE = [_x("window", 0, 1000), _x("ingest", 50, 40), _x("decide", 100, 200),
        _x("fleet", 250, 30), _x("decide", 500, 200), _x("digest", 800, 50),
        _x("decision_fused_8", 150, 50, "kernel"),
        _x("Memcpy DtoH", 600, 50, "gpu_memcpy")]
PROGRAM = [_x("rb.fire", 100, 200), _x("rb.stage", 110, 20),
           _x("rb.launch", 130, 30), _x("rb.fetch", 160, 80),
           _x("rb.k1_wait", 170, 60), _x("rb.dispatch", 240, 59),
           _x("rb.submit", 250, 30), _x("rb.fire", 500, 200),
           _x("rb.digest", 800, 50)]


class _Stub:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_program_ranges_leave_the_profile_readings_as_they_were():
    plain = read_profile(_Stub(BASE), "decision_fused")
    traced = read_profile(_Stub(BASE + PROGRAM), "decision_fused")
    split = traced.pop("idle_by_program_span")
    assert dict(plain.pop("idle_by_program_span")) == pytest.approx(
        {NONE: 320e-6})
    assert traced == plain
    assert split == idle_by_program_span(BASE + PROGRAM)
    gaps = dict(plain["idle_gaps"])
    assert gaps["decide"] == pytest.approx(270e-6)
    assert gaps["digest"] == pytest.approx(50e-6)


def test_idle_by_program_span_sums_to_the_decide_and_digest_idle():
    gaps = dict(read_profile(_Stub(BASE + PROGRAM),
                             "decision_fused")["idle_gaps"])
    got = dict(idle_by_program_span(BASE + PROGRAM))
    assert sum(got.values()) == pytest.approx(gaps["decide"]
                                              + gaps["digest"])
    want = {"rb.fire": 161, "rb.stage": 20, "rb.launch": 20,
            "rb.fetch": 10, "rb.k1_wait": 30, "rb.dispatch": 29,
            "rb.submit": 0, "rb.digest": 50, NONE: 0}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    alone = dict(idle_by_program_span(BASE))
    assert alone == pytest.approx({NONE: 320e-6})


@pytest.mark.parametrize("ranges, want", [
    ([], []),
    ([(0, 10, "a")], [(0, 10, "a")]),
    ([(0, 10, "a"), (2, 4, "b"), (5, 10, "c")],
     [(0, 2, "a"), (2, 4, "b"), (4, 5, "a"), (5, 10, "c")]),
    ([(0, 10, "a"), (2, 8, "b"), (3, 4, "c"), (12, 13, "d")],
     [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 8, "b"), (8, 10, "a"),
      (12, 13, "d")]),
    ([(0, 10, "a"), (8, 12, "b")], [(0, 8, "a"), (8, 10, "b")]),
])
def test_innermost_pieces(ranges, want):
    assert innermost(ranges) == want


@pytest.mark.parametrize("name", ["fleet10k_flat.mix400",
                                  "fleet10k_cells16.mix400"])
def test_a_traced_run_with_the_tracer_on(name):
    """`run_cell` traced on a tiny cell, on the CPU (no device trace and
    no event, so no K1 stamps, wait or idle split): every span metric
    the cell can read is in the result, the hot path's three spans sum
    to its host clock within the tracer's own cost, and the tracer's
    summary is in `info.spans`."""
    from portbench import run as pr
    from portbench import tinycell
    bench, cell, cfg, mix = tinycell.tiny(name)
    res = pr.run_cell(bench, cell, cfg, mix, 7, 1.0, True, "cpu")
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    want = set(SPAN_METRICS) - {"k1_trees_share_pct", "k1_wait_ms_per_call"}
    if "cells" not in name:
        want.discard("place_us_per_req")
    assert set(m) & set(SPAN_METRICS) == want
    parts = (m["hotpath_stage_ms_per_call"] + m["hotpath_sync_ms_per_call"]
             + m["hotpath_launch_ms_per_call"])
    assert parts == pytest.approx(m["hotpath_host_ms_per_call"], rel=0.1)
    assert m["decide_outside_ms_per_batch"] > 0
    spans = res["info"]["spans"]
    assert "rb.fire" in spans and "k1.call" not in spans
    assert spans["rb.stage"][0] == res["info"]["hot"]["calls"]


def test_a_traced_run_with_the_tracer_off():
    """`tracer=False` (`run.py --tracer 0`): the traced run's other
    per-layer metrics are read, the span metrics are left out, and the
    tracer stays off."""
    from portbench import run as pr
    from portbench import tinycell
    from repro_torch import tracing
    bench, cell, cfg, mix = tinycell.tiny("fleet10k_cells16.mix400")
    res = pr.run_cell(bench, cell, cfg, mix, 7, 1.0, True, "cpu",
                      tracer=False)
    assert res["correct"]
    assert not set(res["metrics"]) & set(SPAN_METRICS)
    assert {"batch_rows_mean", "balancer_share_pct",
            "hotpath_host_ms_per_call"} <= set(res["metrics"])
    assert res["info"]["spans"] is None and not tracing.ON
