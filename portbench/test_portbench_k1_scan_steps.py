"""The readers of K1's scan counters, `k1_scan_us_per_step` and
`k1_scan_ctas_mean`, on a traced window's span summary: their values,
and nothing where the program records no `k1.scan` or records it
without its `steps` and `ctas` ids (a program that does not count
them)."""
import importlib

import pytest

from portbench.bench import cell as cl

# four windows' scans: two at R = 16 on a cluster of 16 CTAs, two at
# R = 64 on one of 8
SCAN = {"count": 4, "total_s": 0.0008, "self_s": 0.0008,
        "sums": {"batch": 10, "steps": 2 * 16 + 2 * 64,
                 "ctas": 2 * 16 + 2 * 8}}
SUMMARY = {"k1.call": {"count": 4, "total_s": 0.0012, "self_s": 0.0012,
                       "sums": {"batch": 10}},
           "k1.scan": SCAN}


def view(spans):
    return dict(spans=spans, hot={"calls": 4}, hier=False, batches=4)


@pytest.mark.parametrize("name, want", [
    ("k1_scan_us_per_step", 1e6 * 0.0008 / 160),
    ("k1_scan_ctas_mean", 48 / 4)])
def test_reader_gives_its_ratio(name, want):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert mod.read(view(SUMMARY)) == pytest.approx(want, rel=1e-12)
    entry = {m["name"]: m for m in cl.load_json(
        cl.ROOT / "BENCHMARK.json")["per_layer"]}[name]
    assert entry["layer"] == "kernel K1"
    assert entry["moves"] == "route_req_per_s"
    assert "workloads" not in entry          # every cell reads it


@pytest.mark.parametrize("name", ["k1_scan_us_per_step",
                                  "k1_scan_ctas_mean"])
@pytest.mark.parametrize("case", ["no_spans", "no_scan", "no_ids",
                                  "no_records"])
def test_reader_reads_nothing_without_the_counters(name, case):
    """No tracer summary, no `k1.scan` (off the card), `k1.scan` without
    the ids (a program before the counters), or a zero count."""
    mod = importlib.import_module(f"portbench.metrics.{name}")
    spans = {"no_spans": None,
             "no_scan": {"k1.call": SUMMARY["k1.call"]},
             "no_ids": {**SUMMARY, "k1.scan": {**SCAN,
                                               "sums": {"batch": 10}}},
             "no_records": {**SUMMARY, "k1.scan": {
                 "count": 0, "total_s": 0.0, "self_s": 0.0,
                 "sums": {"steps": 0, "ctas": 0}}}}[case]
    assert mod.read(view(spans)) is None
