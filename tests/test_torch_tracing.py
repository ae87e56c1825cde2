"""The port's tracer (`repro_torch.tracing`) on the benchmark's tiny flat
and tiny cells stand-ins (`portbench/tinycell.py`), driven on the CPU for
the same simulated seconds with the tracer off and on.

Off, it keeps nothing and opens no profiler range; on, it changes no
choice, its spans nest, every decided request is in one ingest and one
fire, and its counts agree with the hot path's own counters.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch import tracing  # noqa: E402

CELLS = {"flat": "fleet10k_flat.mix400", "cells": "fleet10k_cells16.mix400",
         "sessions": "fleet10k_sessions.sessions400"}
HORIZON_S = 3.0          # simulated seconds from an empty fleet
IN_FIRE = ("rb.stage", "rb.sync", "rb.launch", "rb.fetch", "rb.dispatch")


def _run(fleet, mix, traced: bool):
    """One seed's stream from an empty fleet to HORIZON_S; returns each
    request's (instance, predicted length), the tracer's records and
    the hot paths' counters."""
    from portbench.bench import cell as cl
    from portbench.bench.fleet import engines_of
    d = cl.Drive(fleet, mix, 11)
    tracing.enable()             # an empty store, whatever ran before
    if not traced:
        tracing.disable()
    try:
        d.advance(HORIZON_S)
    finally:
        tracing.disable()
    stats = [e.policy._fused.stats for e in engines_of(d.sched)
             if e.policy._fused is not None]
    out = {"choices": [(r.instance, r.pred_len) for r in d.reqs],
           "decided": [r.rid for r in d.reqs if r.instance is not None],
           "records": tracing.records(), "summary": tracing.summary(),
           "calls": sum(s["calls"] for s in stats),
           "delta_rows": sum(s["delta_rows"] for s in stats)}
    d.release()
    return out


@pytest.fixture(scope="module", params=sorted(CELLS))
def runs(request):
    """The tracer off (with `record_function` made to raise) and on,
    on one tiny cell."""
    from portbench import tinycell
    from portbench.bench import cell as cl
    torch.set_num_threads(2)
    _, _, cfg, mix = tinycell.tiny(CELLS[request.param])
    fleet = cl.Fleet.build(cfg, "cpu")

    def refuse(*a, **kw):
        raise AssertionError("a profiler range was opened, tracer off")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        off = _run(fleet, mix, traced=False)
    on = _run(fleet, mix, traced=True)
    return request.param, off, on


def test_off_keeps_nothing(runs):
    _, off, _ = runs
    assert off["decided"]
    assert off["records"] == [] and off["summary"] == {}


def test_choices_are_the_same_on_and_off(runs):
    _, off, on = runs
    assert on["choices"] == off["choices"]


def test_spans_nest(runs):
    _, _, on = runs
    recs = on["records"]
    assert recs and all(r.t1 is not None for r in recs)
    for r in recs:
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1, (r.name, p.name)
        if r.name in IN_FIRE:
            a = r
            while a.parent >= 0 and a.name != "rb.fire":
                a = recs[a.parent]
            assert a.name == "rb.fire", r.name
    for name, s in on["summary"].items():
        assert s["self_s"] >= 0.0 and s["total_s"] >= s["self_s"], name


def test_every_decided_request_is_in_one_ingest_and_one_fire(runs):
    _, _, on = runs
    recs = on["records"]
    ingest = [r.ids["rid"] for r in recs if r.name == "rb.ingest"]
    fired = [rid for r in recs if r.name == "rb.fire"
             for rid in r.ids["rids"]]
    assert len(ingest) == len(set(ingest))
    assert len(fired) == len(set(fired))
    assert set(on["decided"]) == set(fired)
    assert set(fired) <= set(ingest)
    for r in recs:
        if r.name == "rb.fire":
            assert r.ids["rows"] == len(r.ids["rids"])
    submits = [r.ids["rid"] for r in recs if r.name == "rb.submit"]
    assert sorted(submits) == sorted(fired)


def test_place_only_in_the_cells(runs):
    kind, _, on = runs
    recs = on["records"]
    place = [r for r in recs if r.name == "rb.place"]
    n_ingest = sum(r.name == "rb.ingest" for r in recs)
    if kind != "cells":
        assert not place
        assert {r.ids["cell"] for r in recs if r.name == "rb.fire"} == {-1}
        return
    assert len(place) == n_ingest
    for r in place:
        assert recs[r.parent].name == "rb.ingest"
        assert recs[r.parent].ids["rid"] == r.ids["rid"]
        assert r.ids["cell"] >= 0
    assert on["summary"]["rb.digest"]["count"] > 0
    assert on["summary"]["rb.cell_refresh"]["count"] > 0


def test_counts_agree_with_the_hot_paths_counters(runs):
    _, _, on = runs
    recs = on["records"]
    assert sum(r.name == "rb.stage" for r in recs) == on["calls"]
    assert sum(r.name == "rb.sync" for r in recs) == on["calls"]
    assert sum(r.ids["rows"] for r in recs
               if r.name == "rb.sync" and r.ids["kind"] == 1) \
        == on["delta_rows"]
    kinds = {r.ids["kind"] for r in recs if r.name == "rb.sync"}
    assert kinds <= {0, 1, 2, 3} and 2 in kinds      # the first call reseeds


def test_plane_inside_stage_only_with_the_term(runs):
    """With the affinity term on, each call's `rb.stage` holds one
    `rb.plane`: the whole roster's sketch rows, and the bytes of the
    staged plane (the roster's pow2 bucket x 64 int32 slots) and of the
    rows' signatures (K x R buckets x 8 int32); with the term off, none."""
    kind, _, on = runs
    recs = on["records"]
    plane = [r for r in recs if r.name == "rb.plane"]
    if kind != "sessions":
        assert not plane
        return
    stages = [r for r in recs if r.name == "rb.stage"]
    assert len(plane) == len(stages) == on["calls"]
    n_inst = 24                               # the tiny cell's roster
    for r in plane:
        st = recs[r.parent]
        assert st.name == "rb.stage"
        assert r.ids["rows"] == n_inst
        assert r.ids["bytes"] == 4 * (32 * 64 + st.ids["K"] * st.ids["R"] * 8)
    assert on["summary"]["rb.plane"]["sums"]["rows"] == n_inst * on["calls"]


def test_summary_counts_self_time_and_sums_integer_ids():
    """Self time is a span's duration less its children's; integer ids
    are summed, others are not; `add` stores a parentless duration."""
    tracing.enable()
    try:
        a = tracing.begin("a", k=2, rids=[7, 8])
        b = tracing.begin("b", k=3)
        assert tracing.open_id("a", "k") == 2
        tracing.end(b)
        tracing.end(a, extra=1)
        tracing.add("dev", 5_000, batch=4)
        c = tracing.begin("c")
        tracing.begin("left_open")
        tracing.end(c)
        s = tracing.summary()
        recs = tracing.records()
    finally:
        tracing.disable()
    da, db = (r.t1 - r.t0 for r in recs[:2])
    assert recs[1].parent == 0 and recs[2].parent == -1
    assert s["a"]["sums"] == {"k": 2, "extra": 1}
    assert s["a"]["self_s"] == pytest.approx((da - db) * 1e-9)
    assert s["b"]["self_s"] == pytest.approx(db * 1e-9)
    assert s["dev"] == {"count": 1, "total_s": 5e-6, "self_s": 5e-6,
                        "sums": {"batch": 4}}
    assert "left_open" not in s and s["c"]["count"] == 1
    assert tracing.open_id("a", "k") == -1


def test_the_tracer_imports_nothing_from_the_package():
    src = (ROOT / "src" / "repro_torch" / "tracing.py").read_text()
    assert "from ." not in src and "import repro_torch" not in src
    assert not tracing.ON


@pytest.mark.parametrize("aff_rows", [0, 2 * 16], ids=["noaff", "aff"])
def test_stamps_become_device_durations(aff_rows):
    """A K = 2 call's stamps (1 + 4K): the trees (and the affinity
    factors) once, from the entry to their end (stamped into every
    window), with the rows whose factors the grid wrote (K R = 32 with the
    term on, 0 off); per window the rest of stage 1, the scan and its
    pass A (a duration, not a stamp); the call from the entry to the last
    window's end."""
    from repro_torch.core.hotpath import _K1Stamps
    host = torch.tensor([100, 130, 190, 200, 4, 130, 180, 260, 55],
                        dtype=torch.int64)
    tracing.enable()
    try:
        fire = tracing.begin("rb.fire", batch=9)
        st = _K1Stamps(host, 2, aff_rows, 16, 1)
        st.store()
        st.store()                       # once per call
        tracing.end(fire)
        s = tracing.summary()
    finally:
        tracing.disable()
    ns = {k: round(v["total_s"] * 1e9) for k, v in s.items()}
    assert ns["k1.trees"] == 30 and s["k1.trees"]["count"] == 1
    assert s["k1.trees"]["sums"] == {"batch": 9, "aff_rows": aff_rows}
    assert ns["k1.stage1"] == 60 + 50 and ns["k1.scan"] == 10 + 80
    assert ns["k1.scan_a"] == 4 + 55 and s["k1.scan_a"]["count"] == 2
    assert ns["k1.call"] == 160
    assert s["k1.call"]["sums"] == {"batch": 9}
    assert np.isclose(s["rb.fire"]["self_s"], s["rb.fire"]["total_s"])


@pytest.mark.parametrize("K, steps, ctas", [(1, 8, 1), (2, 16, 16),
                                            (4, 128, 8)],
                         ids=["warp-R8", "cluster16-R16", "cluster8-R128"])
def test_stamps_count_scan_steps_and_ctas(K, steps, ctas):
    """Each window's `k1.scan` record carries the steps its loop ran (the
    call's R bucket) and the CTAs that ran it, so that the tracer's
    summary sums them over the windows; nothing else records them. The
    stamp buffer is a CPU tensor, as the pinned host copy is."""
    from repro_torch.core.hotpath import _K1Stamps
    host = torch.tensor([0] + [10, 20, 30, 5] * K, dtype=torch.int64)
    tracing.enable()
    try:
        fire = tracing.begin("rb.fire", batch=3)
        _K1Stamps(host, K, 0, steps, ctas).store()
        tracing.end(fire)
        s = tracing.summary()
    finally:
        tracing.disable()
    assert s["k1.scan"]["count"] == K
    assert s["k1.scan"]["sums"] == {"batch": 3 * K, "steps": K * steps,
                                    "ctas": K * ctas}
    assert round(s["k1.scan"]["total_s"] * 1e9) == 10 * K
    for name in ("k1.trees", "k1.stage1", "k1.scan_a", "k1.call"):
        assert not {"steps", "ctas"} & set(s[name]["sums"])
