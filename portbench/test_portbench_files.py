"""Every file BENCHMARK.json names loads by name, and the file keeps the
benchmark's contract."""
import importlib
import json
import re

import pytest

from portbench.bench import cell as cl
from portbench.yard.traffic import check_mix

BENCH = json.loads((cl.ROOT / "BENCHMARK.json").read_text())
CONFIGS = sorted((cl.ROOT / "portbench" / "configs").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_loads(path):
    cfg = cl.load_json(path)
    assert cfg["name"] == path.stem
    assert sum(t["n_instances"] for t in cfg["roster"]["tiers"]) \
        == cfg["roster"]["n_instances"]
    assert cfg["scheduler"]["rbconfig"]["charge_compute"] is False
    assert set(cfg["check"]["limits"]) <= {"rows_off_pct",
                                            "batches_off_pct",
                                            "placement_off_pct"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_load(cell):
    _, got, cfg, mix = cl.find_cell(cell["name"])
    assert got == cell and cell["chips"] == 1
    assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
    check_mix(mix)
    assert mix["warm_s"] > 0 and mix["slice_s"] > 0


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_named_has_a_reader(m):
    assert NAME.match(m["name"])
    if m["name"] != "setup_s":
        assert (cl.ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("path", sorted(
    (cl.ROOT / "portbench" / "metrics").glob("[a-z]*.py")),
    ids=lambda p: p.stem)
def test_metric_reader_reads_nothing_from_an_empty_window(path):
    mod = importlib.import_module(f"portbench.metrics.{path.stem}")
    view = dict(decided=0, batches=0, controller_s=0.0, place_s=0.0,
                digest_s=0.0, hier=False, hot={}, per_request_ms=[],
                k1_calls=0, window_s=1.0, trace=None, k1_bound_s=None)
    assert mod.read(view) is None


def test_named_configs_are_the_files():
    for conf in BENCH["configs"]:
        assert conf["file"] == f"portbench/configs/{conf['name']}.json"
        assert conf["reduced"] == []


def test_names_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"route_ms_p95", "route_req_per_s", "setup_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e - {"setup_s"}
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
