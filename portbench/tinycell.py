"""Small stand-ins of the benchmark's cells for its CPU tests: the cell's
own configuration and mix with the roster cut to a few instances, the
world to a few hundred prompts and the rate to what a CPU decides in a
second or two. Everything else (the estimators' settings, the check, the
scheduler) is the configuration file's."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.bench import cell as cl  # noqa: E402


SESSION = {"turns": 5, "base_len": 48, "extend": [12, 28]}


def with_sessions(mix: dict, tenants=("interactive", "agents")) -> dict:
    """The mix with the named tenants in multi-turn sessions of
    `SESSION` (the session deployment's turns)."""
    return dict(mix, tenants=[dict(t, session=SESSION)
                              if t["name"] in tenants else t
                              for t in mix["tenants"]])


def tiny(name: str, n_tiers: int = 4, n_instances: int = 24,
         n_cells: int = 2, prompts: int = 400, rate: float = 0.05,
         **rbconfig):
    """(bench, cell, cfg, mix) of `<configuration>.<mix>`, cut to CPU
    size; the pair need not be a cell of BENCHMARK.json."""
    from repro_torch.serving.scenarios import synthetic_pool
    conf, traffic = name.split(".", 1)
    bench = cl.load_json(ROOT / "BENCHMARK.json")
    cell = {"name": name, "config": conf, "traffic": traffic, "chips": 1}
    cfg = cl.load_json(ROOT / "portbench" / "configs" / f"{conf}.json")
    mix = cl.load_json(ROOT / "portbench" / "traffic" / f"{traffic}.json")
    tiers, names, world = synthetic_pool(n_tiers, n_instances, seed=3)
    rows = []
    for t in tiers:
        d = dataclasses.asdict(t)
        d.pop("model_cfg")
        rows.append(d)
    cfg["roster"] = {"n_instances": n_instances, "model_names": names,
                     "tiers": rows}
    cfg["world"].update(capacities=[float(c) for c in world.capacity],
                        verbosities=[float(v) for v in world.verbosity],
                        seed=3)
    cfg["dataset"]["n"] = prompts
    cfg["estimators"]["sweep"]["rows"] = 300
    if cfg["scheduler"].get("hierarchy"):
        cfg["scheduler"]["hierarchy"]["n_cells"] = n_cells
    cfg["scheduler"]["rbconfig"].update(rbconfig)
    cfg["check"].update(batch_share=1.0, max_batches=40)
    mix = dict(mix, stream_s=100.0, warm_s=1.0, warm_buckets=[8, 16],
               lam_scale=mix["lam_scale"] * rate)
    return bench, cell, cfg, mix


def tiny_sessions(rate: float = 0.1):
    """A tiny flat cell of the session deployment: the affinity weight
    0.35 and `mix400` with two tenants in sessions. A 40 s stream puts a
    conversation's turns 8 s apart; the warm prefix passes the first
    turns, and every batch is checked, so that a window of two CPU
    seconds (about 18 simulated ones) checks follow-ups whose earlier
    turns were dispatched inside it."""
    bench, cell, cfg, mix = tiny("fleet10k_flat.mix400", rate=rate,
                                 affinity_weight=0.35)
    cfg["check"].update(max_batches=400)
    mix = dict(with_sessions(mix), stream_s=40.0, warm_s=9.0)
    return bench, cell, cfg, mix


def drive(name: str, seed: int, seconds: float = 1.0, **kw):
    """A tiny cell's run up to the close of its window, on the CPU:
    (drive, fleet, cfg)."""
    bench, cell, cfg, mix = tiny(name, **kw)
    fleet = cl.Fleet.build(cfg, "cpu")
    d = cl.Drive(fleet, mix, seed)
    d.warm()
    d.window(seconds)
    return d, fleet, cfg


def reference(cfg, fleet, tf32: bool = False):
    from portbench.yard.reference import Reference
    from portbench.yard.training import encoder_params
    e = cfg["estimators"]["encoder"]
    return Reference(cfg, fleet.world, encoder_params(e, e["seed"]),
                     fleet.pairs, device="cpu", tf32=tf32)
