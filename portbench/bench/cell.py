"""One run of one cell: build it, bring the fleet to steady occupancy,
measure for the requested wall seconds, check the decisions, and return
the result.

A cell is a configuration (`configs/<config>.json`: the roster, the
world, the estimators and the scheduler) under a traffic mix
(`traffic/<mix>.json`: the tenants, the stream's length, the warm
prefix). The simulated fleet (`serving.cluster.ClusterSim`) stands in
for the LLM instances; the controller under test is the program's
scheduler, timed by the benchmark's own spans (`probe.Probe`).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..yard import reference as ref_mod
from ..yard.traffic import stream_for_mix
from ..yard.world import world_from_config
from . import fleet as fl
from .probe import Probe

ROOT = Path(__file__).resolve().parents[2]
K1_KERNEL = "decision_fused"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT):
    """(cell entry, configuration file, traffic mix file) of a cell of
    BENCHMARK.json, each file found by the name the entry gives."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / conf["file"])
    mix = load_json(root / "portbench" / "traffic"
                    / f"{cell['traffic']}.json")
    return bench, cell, cfg, mix


def cell_files(workload=None, config=None, traffic=None, root: Path = ROOT):
    """(name, configuration, traffic mix) of a cell of BENCHMARK.json by
    its name, or of a configuration file under a mix file that no cell
    names yet (`<config>.<mix>`)."""
    if workload is not None:
        _, _, cfg, mix = find_cell(workload, root)
        return workload, cfg, mix
    if config is None or traffic is None:
        raise ValueError("give a workload, or a configuration and a mix")
    cfg, mix = load_json(Path(config)), load_json(Path(traffic))
    return f"{cfg['name']}.{mix['name']}", cfg, mix


@dataclasses.dataclass
class Fleet:
    """The configuration's fixed part, built once per process: the
    world, the program's prompts, tiers and estimator bundle, and the
    training pairs handed to it."""
    cfg: Dict
    world: object
    prompts: List
    tiers: List
    bundle: object
    pairs: List
    device: str

    @staticmethod
    def build(cfg: Dict, device: str) -> "Fleet":
        world = world_from_config(cfg)
        prompts = fl.make_prompts(world)
        tiers = fl.make_tiers(cfg)
        bundle, pairs = fl.make_bundle(cfg, world, prompts, tiers, device)
        return Fleet(cfg, world, prompts, tiers, bundle, pairs, device)


class Drive:
    """One seed's stream through a fresh simulator and scheduler."""

    def __init__(self, fleet: Fleet, mix: Dict, seed: int,
                 annotate=None, check: bool = True):
        from repro_torch.serving.cluster import ClusterSim
        cfg = fleet.cfg
        w = fleet.world
        self.fleet, self.mix = fleet, mix
        te = w.test_idx
        self.stream = stream_for_mix(w.topic[te], w.len_in[te], mix, seed,
                                     tokens=[w.tokens[i] for i in te])
        self.reqs = fl.make_requests(self.stream, fleet.prompts, w)
        self.sched = fl.make_scheduler(cfg, fleet.bundle, fleet.tiers)
        self.hier = hasattr(self.sched, "balancer")
        ck = cfg["check"]
        self.probe = Probe(
            self.stream, w.test_idx[self.stream.prompt], self.reqs,
            np.random.default_rng((seed, 0xC4EC)) if check else None,
            ck["batch_share"], ck["max_batches"],
            record_events=check and self.hier, annotate=annotate)
        self.sim = ClusterSim(list(fleet.tiers), cfg["roster"]["model_names"],
                              seed=0)
        self.probe.install(self.sched, self.sim)
        self.sched.attach(self.sim)
        self.probe.wrap_engines(self.sched)
        enqueue = self.probe.enqueue
        for r in self.reqs:
            self.sim.push(r.arrival, lambda t, rr=r: enqueue(rr, t))
        self.t_sim = 0.0
        self.window_sim = (0.0, 0.0)

    def advance(self, until: float):
        step = self.mix["slice_s"]
        while self.t_sim < until:
            self.t_sim = min(self.t_sim + step, until)
            self.sim.run(until=self.t_sim)

    def warm(self):
        """The mix's warm prefix: the fleet from empty to steady
        occupancy (set-up the traffic needs); then one decision call of
        every batch bucket the mix can reach (`warm_buckets`) on every
        engine's hot path, so that no staging buffer is first allocated
        inside the window. Those calls dispatch nothing."""
        self.advance(self.mix["warm_s"])
        cols = self.reqs[0].cols
        cols.ensure_embeddings(self.fleet.bundle.encoder)
        for eng in fl.engines_of(self.sched):
            if eng.policy.cfg.decision_backend != "megakernel":
                continue
            hp = eng.policy._fused_runner(eng.sim)
            for b in self.mix["warm_buckets"]:
                hp.decide_cols(cols, np.arange(b), eng.sim.tel).fetch()

    def window(self, seconds: float, on_start=None) -> float:
        """Advance the simulator in slices of simulated time until
        `seconds` of wall time have passed; the spans count only here.
        Returns the window's wall seconds. Raises when the stream runs
        out before the window closes."""
        step = self.mix["slice_s"]
        hot0 = self.hot_stats()
        sim_start = self.t_sim
        if on_start is not None:
            on_start()
        self.probe.on = True
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.t_sim += step
            self.sim.run(until=self.t_sim)
        wall = time.perf_counter() - t0
        self.probe.on = False
        self.window_sim = (sim_start, self.t_sim)
        self.hot = {k: v - hot0.get(k, 0) for k, v in
                    self.hot_stats().items()}
        end = float(self.stream.ends.min())
        if self.t_sim >= end:
            raise RuntimeError(
                f"the stream ran out: the window reached simulated second "
                f"{self.t_sim:.2f}, a tenant's last arrival is at {end:.2f}")
        return wall

    def hot_stats(self) -> Dict:
        """FusedHotPath.stats summed over every engine's hot path."""
        out: Dict = {}
        for eng in fl.engines_of(self.sched):
            hp = eng.policy._fused
            if hp is None:
                continue
            for k in ("calls", "host_s", "dispatch_s", "stage_s"):
                out[k] = out.get(k, 0) + hp.stats[k]
            out["variants"] = out.get("variants", 0) + hp.shape_variants()
        return out

    def decided(self) -> int:
        return sum(len(rows) for rows, _ in self.probe.batches)

    def release(self):
        """Drop the program's state of this run."""
        for name in ("sched", "sim", "reqs"):
            setattr(self, name, None)
        gc.collect()


# -- the check ------------------------------------------------------------------

def roster_views(cfg: Dict):
    """The reference's roster, and per cell (hierarchy) its rows."""
    roster = ref_mod.roster_of(cfg["roster"]["tiers"],
                               cfg["roster"]["model_names"])
    h = cfg["scheduler"].get("hierarchy")
    cells = ref_mod.partition(roster, h["n_cells"]) if h else None
    return roster, cells


def readings(drive: Drive, ref, ctl=None) -> Dict:
    """The numbers compared, from the batches the window recorded (and
    for the hierarchy, every placement in the window)."""
    cfg = drive.fleet.cfg
    ck = cfg["check"]
    roster, cells = roster_views(cfg)
    weights = tuple(cfg["check"]["weights"])
    gaps, lerr, cgaps, clerr, moved = [], [], [], [], []
    for bt in drive.probe.checked:
        ros = ref_mod.sub_roster(roster, cells[bt.cell]) if cells else roster
        out = ref_mod.check_batch(ref, ros, bt, weights, ctl)
        gaps.append(out["gap"])
        lerr.append(out["l_err"])
        moved.append(out["aff_moved"])
        if ctl is not None:
            cgaps.append(out["ctl_gap"])
            clerr.append(out["ctl_l_err"])
    n = int(sum(len(g) for g in gaps))
    gq = ck["gap_quanta"] * ref_mod.SCORE_QUANTUM

    def shares(g, le):
        off = [(a > gq) | (b > ck["l_rel"]) for a, b in zip(g, le)]
        g, le = np.concatenate(g), np.concatenate(le)
        return {"rows_off_pct": 100.0 * float(np.mean(np.concatenate(off))),
                "batches_off_pct": 100.0 * float(np.mean(
                    [o.any() for o in off])),
                "gap_max": float(g.max()), "l_err_max": float(le.max())}
    out = {"rows_checked": n, "batches_checked": len(gaps)}
    if n:
        out.update(shares(gaps, lerr))
        # rows whose reference best the affinity term moves: it is
        # exercised (not a limit; 0 where the weight is 0)
        out["aff_rows_pct"] = 100.0 * float(np.mean(np.concatenate(moved)))
        if ctl is not None:
            out["control"] = shares(cgaps, clerr)
    if drive.hier:
        ev = drive.probe.events
        want = ref_mod.replay_placement(
            roster, cells, ev, cfg["scheduler"]["hierarchy"],
            len(cfg["roster"]["tiers"]))
        got = np.array([e[2] for e in ev if e[0] == "pick"])
        ts = np.array([e[1] for e in ev if e[0] == "pick"])
        lo, hi = drive.window_sim
        inw = (ts > lo) & (ts <= hi)
        out["placements_checked"] = int(inw.sum())
        out["placement_off_pct"] = (100.0 * float(np.mean(
            got[inw] != want[inw])) if inw.any() else 0.0)
    return out


def judge(read: Dict, limits: Dict) -> Tuple[bool, List[str]]:
    """`correct` and one line per number compared: its value beside its
    limit."""
    ok, lines = True, []
    if not read.get("rows_checked"):
        return False, ["rows_checked 0 (limit: at least 1)"]
    for key, lim in limits.items():
        if key not in read:
            continue
        v = read[key]
        good = v <= lim
        ok &= good
        lines.append(f"{key} {v:.6g} (limit {lim:g}){'' if good else ' FAIL'}")
    return bool(ok), lines
