"""Hierarchical scheduling: per-cell RouteBalance engines under a
digest-routed global balancer, for rosters beyond one controller.

Port of `repro.serving.hierarchy` (lines 1-615). Two routing modes:

  * **span** (`HierarchyConfig.routing="span"`): every decision still
    covers the whole roster; only the scan's instance axis is split
    into `n_cells` contiguous blocks, combined per step with exact
    max / argmax reductions (`repro_torch.core.decision.
    sharded_greedy_scan`). Choices are bitwise the single controller's
    at any cell count. In the port this runs on the staged torch
    backend (`RBConfig(decision_backend="torch", shard_cells=n)`): each
    step of the greedy scan needs the global normalizers and the global
    winner before the next row, so the cells cannot scan apart, and the
    decision kernel is one launch over the whole roster (the reference
    refuses its megakernel for span too). A whole roster on the kernel
    is the single controller: `RBConfig()` at any size.
  * **balanced** (`HierarchicalScheduler`): the roster is partitioned
    into cells; each cell runs its own RouteBalance engine on the
    decision kernel (its own hot path and carried telemetry mirror,
    alive mask, affinity planes and, when the sim is armed, its own
    `CellRecovery`). A `GlobalBalancer` places arriving requests into
    cells from compressed per-cell telemetry digests
    (`repro_torch.distributed.compression`): every heartbeat it encodes
    each cell's per-tier occupancy / depth / free summary to wire bytes,
    decodes them, and routes only from what survived the round trip,
    under the `digest_fresh` staleness bound. A cell whose digests stop
    is first penalized (`ElasticMembership.staleness_penalty`), then
    treated as dark. With one cell the hierarchy is the single
    controller: same engine, same decisions, same trajectory.

Cells see the parent `ClusterSim` through two narrow views: `CellSim`
(what a cell's engine schedules against: the cell's instances and a
`_CellTelemetry` mirror in cell-local row order, refreshed from the
parent's version counters) and `_CellScope` (what a cell's recovery
manager probes: the parent's telemetry, since watchdog writes address
global slots, with the instance list narrowed to the cell). Dispatch
needs no translation: a chosen `Instance` is the parent's object.

With `repro_torch.tracing` on, the scheduler records `rb.ingest` per
arrival with `rb.place` inside, the balancer `rb.digest` per heartbeat
and a cell's mirror `rb.cell_refresh` whenever the parent's telemetry
moved since its last refresh (`rows`: the telemetry rows it copied).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import tracing
from ..distributed.compression import (DIGEST_MODES, TelemetryDigest,
                                       decode_digest, digest_fresh,
                                       digest_from_telemetry, encode_digest)
from ..distributed.elastic import ElasticMembership
from .cluster import ClusterSim, Instance
from .recovery import RecoveryManager
from .request import Request

ROUTINGS = ("span", "balanced")
_TEL_PLANES = ("pending", "batch", "free", "ctx", "queue", "t")


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Two-level scheduling knobs. `digest_interval_s` is the control
    heartbeat; `digest_stale_s` the staleness bound past which a cell
    is dark to the balancer (also the membership timeout, so the hard
    and the soft arm share one clock)."""
    n_cells: int = 1
    routing: str = "balanced"          # balanced | span
    digest_interval_s: float = 0.25
    digest_stale_s: float = 1.0
    digest_mode: str = "exact"         # exact | int8 wire codec
    staleness_decay: float = 2.0       # soft load inflation per bound

    def __post_init__(self):
        if self.routing not in ROUTINGS:
            raise ValueError(f"routing={self.routing!r} not in {ROUTINGS}")
        if self.n_cells < 1:
            raise ValueError(f"n_cells={self.n_cells} < 1")
        if not self.digest_interval_s > 0.0:
            raise ValueError("digest_interval_s must be positive")
        if self.digest_stale_s < self.digest_interval_s:
            raise ValueError("a digest must live at least one heartbeat "
                             "(digest_stale_s >= digest_interval_s)")
        if self.digest_mode not in DIGEST_MODES:
            raise ValueError(f"digest_mode={self.digest_mode!r} not in "
                             f"{DIGEST_MODES}")


def partition_roster(instances: Sequence[Instance], n_cells: int
                     ) -> List[List[Instance]]:
    """Split a roster into `n_cells` cells, round-robin within each tier,
    so every cell inherits its share of the whole capacity ladder. Tiers
    with fewer replicas than cells land in a subset of the cells; the
    digests' per-tier planes (global tier order) keep the balancer aware
    of where capacity lives. Cell lists stay in parent-slot order, so
    cell-local row k maps monotonically to a parent slot."""
    n = len(instances)
    if not 1 <= n_cells <= n:
        raise ValueError(f"{n_cells} cells for {n} instances")
    by_tier: Dict[str, List[Instance]] = {}
    for inst in instances:                   # instances are slot-ordered
        by_tier.setdefault(inst.tier.name, []).append(inst)
    cells: List[List[Instance]] = [[] for _ in range(n_cells)]
    k = 0
    for insts in by_tier.values():
        for inst in insts:
            cells[k % n_cells].append(inst)
            k += 1
    for cell in cells:
        cell.sort(key=lambda i: i.slot)
    return cells


class _CellTelemetry:
    """A cell-local mirror of the parent `TelemetryArrays`: the same
    planes and version-counter contract over the cell's slots in
    cell-local row order, so a cell's `FusedHotPath` syncs its device
    mirror (delta rows, roster reseeds) as it does against the real one.

    Refresh is incremental and guarded by the parent's counters: rows
    whose parent ``last_write`` stamp moved are copied and stamped dirty
    locally; an alive-mask change (kill, quarantine: the parent does not
    stamp ``last_write`` for those) bumps the local ``roster_version``,
    so the cell's runner reseeds. Mirrored rows are copies of the
    parent's float64 values, bitwise equal, which is what makes the
    1-cell hierarchy's decisions the single controller's."""

    def __init__(self, parent, slots: np.ndarray, cell: int = -1):
        self.parent = parent
        self.cell = cell
        self.slots = np.asarray(slots, np.int64)
        n = len(self.slots)
        for name in _TEL_PLANES:
            setattr(self, name, getattr(parent, name)[self.slots].copy())
        self.max_batch = parent.max_batch[self.slots].copy()
        self.alive = parent.alive[self.slots].copy()
        self.version = 1
        self.roster_version = 0
        self.last_write = np.full(n, 1, np.int64)
        self.prefix_sig = parent.prefix_sig[self.slots].copy()
        self.prefix_hit = parent.prefix_hit[self.slots].copy()
        self.prefix_version = 0
        self._seen_writes = parent.last_write[self.slots].copy()
        self._p_version = parent.version
        self._p_roster = parent.roster_version
        self._p_prefix = parent.prefix_version

    def refresh(self) -> "_CellTelemetry":
        p = self.parent
        if (p.version == self._p_version
                and p.roster_version == self._p_roster
                and p.prefix_version == self._p_prefix):
            return self
        sp = (tracing.begin("rb.cell_refresh", True, cell=self.cell)
              if tracing.ON else None)
        n_rows = 0
        if (p.version != self._p_version
                or p.roster_version != self._p_roster):
            pw = p.last_write[self.slots]
            changed = np.flatnonzero(pw != self._seen_writes)
            n_rows = len(changed)
            if n_rows:
                rows = self.slots[changed]
                self.version += 1
                for name in _TEL_PLANES:
                    getattr(self, name)[changed] = getattr(p, name)[rows]
                self.last_write[changed] = self.version
                self._seen_writes[changed] = pw[changed]
            a = p.alive[self.slots]
            if not np.array_equal(a, self.alive):
                self.alive[:] = a
                self.version += 1
                self.roster_version += 1
            self._p_version = p.version
            self._p_roster = p.roster_version
        if p.prefix_version != self._p_prefix:
            self.prefix_sig[:] = p.prefix_sig[self.slots]
            self.prefix_hit[:] = p.prefix_hit[self.slots]
            self.prefix_version += 1
            self._p_prefix = p.prefix_version
        if sp is not None:
            tracing.end(sp, rows=n_rows)
        return self

    def dirty_rows(self, since: int) -> np.ndarray:
        return np.flatnonzero(self.last_write > since)


class CellSim:
    """What a cell's engine schedules against: the parent sim's event
    loop, clock, completion list and overload controller, with the
    roster narrowed to the cell and telemetry served from the cell's
    mirror. The same duck type as `ClusterSim` wherever the engine and
    the policy touch it."""

    def __init__(self, parent: ClusterSim, instances: Sequence[Instance],
                 cell_id: int):
        self.parent = parent
        self.cell_id = cell_id
        self.instances = list(instances)
        self.by_id = {i.iid: i for i in self.instances}
        self._tel = _CellTelemetry(parent.tel,
                                   np.array([i.slot for i in instances]),
                                   cell_id)
        self.recovery: Optional["CellRecovery"] = None

    @property
    def tel(self) -> _CellTelemetry:
        return self._tel.refresh()

    @property
    def now(self) -> float:
        return self.parent.now

    @property
    def completed(self):
        return self.parent.completed

    @property
    def overload(self):
        return getattr(self.parent, "overload", None)

    def push(self, t: float, fn):
        self.parent.push(t, fn)

    def has_noncontrol_events(self) -> bool:
        return self.parent.has_noncontrol_events()

    def alive_instances(self) -> List[Instance]:
        return [i for i in self.instances if i.alive]


class _CellScope:
    """What a cell's `CellRecovery` sees as its sim: the parent's
    telemetry and event heap (watchdog probes and quarantine writes
    address global slots, ``tel.t[inst.slot]``), with the instance list
    narrowed to the cell so staleness scans, hedge targets and degraded
    picks stay inside the cell."""

    def __init__(self, parent: ClusterSim, instances: Sequence[Instance]):
        self.parent = parent
        self.tel = parent.tel
        self.instances = list(instances)
        self.by_id = {i.iid: i for i in self.instances}

    @property
    def now(self) -> float:
        return self.parent.now

    @property
    def completed(self):
        return self.parent.completed

    def push(self, t: float, fn):
        self.parent.push(t, fn)

    def has_noncontrol_events(self) -> bool:
        return self.parent.has_noncontrol_events()


class CellRecovery(RecoveryManager):
    """One cell's retry / hedge / watchdog manager over a `_CellScope`.
    It inherits the whole lifecycle (retries re-enter through the
    cell's engine, so a victim keeps its cell) and overrides only the
    degraded fallback, whose base version takes ``inst.slot`` as an
    index into ``sim.instances``: true of the parent's roster, not of a
    cell's slice of it."""

    def degraded_assign(self, batch, sim):
        from ..core.engine import AssignmentResult, Ready
        cand = [(k, i) for k, i in enumerate(sim.instances) if i.alive]
        if not cand:
            raise RuntimeError("no alive instances to schedule onto")
        R = len(batch.reqs)
        choice = np.empty(R, np.int64)
        load = {k: len(i.running) + len(i.queue) for k, i in cand}
        for r in range(R):
            bk, _ = min(cand, key=lambda ki: (
                load[ki[0]] / max(ki[1].tier.max_batch, 1), ki[1].slot))
            choice[r] = bk             # cell-local POSITION, not slot
            load[bk] += 1
        self.degraded_decisions += R
        self.degraded_batches += 1
        l_chosen = np.full(R, self.cfg.degraded_pred_len)
        return AssignmentResult(sim.instances, Ready(choice, l_chosen))


class _RecoveryRouter:
    """The parent sim's ``recovery`` under balanced routing:
    `Instance.fail()` and direct `watch_dispatch` callers find the
    victim's owning cell manager here (by slot), and `run_cell`'s
    counter probes read fleet-wide sums. The cell engines bind their own
    managers at attach; binding the router is a no-op."""

    _is_controller = True

    def __init__(self, managers: List[CellRecovery],
                 slot_cell: Dict[int, int], cfg):
        self.managers = managers
        self._slot_cell = slot_cell
        self.cfg = cfg
        self.degraded = False          # engines consult their cell's

    def _mgr(self, inst: Instance) -> CellRecovery:
        return self.managers[self._slot_cell[inst.slot]]

    def bind(self, engine):
        return self

    def on_failure(self, req, inst: Instance, lost_tokens: int,
                   now: float) -> bool:
        return self._mgr(inst).on_failure(req, inst, lost_tokens, now)

    def watch_dispatch(self, req, inst: Instance, t: float):
        self._mgr(inst).watch_dispatch(req, inst, t)

    def __getattr__(self, name):
        # fleet-wide counter sums (retries, hedges, quarantines, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        vals = [getattr(m, name) for m in self.managers]
        if vals and all(isinstance(v, (int, np.integer)) for v in vals):
            return int(sum(vals))
        raise AttributeError(name)


class _CellEngine:
    """Mixed into `RouteBalance` per cell: the fire loop parks on the
    GLOBAL expected count instead of a local one. A cell cannot know its
    share of the trace upfront (placement is the balancer's runtime
    choice), and parking on a local count would shift the idle-fire
    phase against a single controller's. The property makes
    ``decisions + shed >= expected`` hold on a cell exactly when it
    holds fleet-wide; its setter ignores the writes of
    `ServingEngine.__init__`, `run_cell` and `resume`."""

    @property
    def expected(self):
        h = self._hier
        if h is None or h.expected is None:
            return None
        return (h.expected - (h.decisions - self.decisions)
                - (h.shed_count - self.shed_count))

    @expected.setter
    def expected(self, v):
        pass        # the global scheduler owns the count

    def _window(self) -> float:
        # A cell sees about 1/C of the arrivals, so the same window
        # collects C times fewer requests per decision. Stretch the
        # adaptive window by the cell count toward the flat controller's
        # occupancy per decision, capped at its adaptive ceiling. At
        # C = 1 this is the identity.
        w = super()._window()
        h = self._hier
        if h is None:
            return w
        c = len(h.engines)
        if c <= 1:
            return w
        return float(min(w * c, max(self.ecfg.base_window, 0.30)))


def _make_cell_engine(cfg, bundle, tiers, hier):
    from ..core.scheduler import RouteBalance

    cls = type("CellRouteBalance", (_CellEngine, RouteBalance), {})
    eng = cls.__new__(cls)
    eng._hier = None            # park-proof while __init__ runs
    RouteBalance.__init__(eng, cfg, bundle, tiers)
    eng._hier = hier
    return eng


class GlobalBalancer:
    """Inter-cell request placement from compressed telemetry digests.

    Every ``digest_interval_s`` the balancer summarizes each cell's
    mirror into a `TelemetryDigest`, serializes it with the configured
    codec, counts the wire bytes and decodes, routing strictly from the
    decoded digest. A digest's arrival heartbeats its cell's
    `ElasticMembership` entry: a cell that stops publishing is
    soft-penalized (apparent load grows with digest age), then, past
    ``digest_stale_s``, treated as dark and routed around; blind
    round-robin only when every cell is dark. Between heartbeats the
    balancer dead-reckons its own placements (``assigned_since``).

    Digest depth is in work units (pending decode tokens + queued
    requests) while the balancer counts requests, so each heartbeat it
    divides the fleet-depth growth by the placements of the interval and
    folds that into an EWMA work quantum (at least one unit)."""

    _is_controller = True

    def __init__(self, hcfg: HierarchyConfig):
        self.hcfg = hcfg
        self.membership = ElasticMembership(
            heartbeat_timeout=hcfg.digest_stale_s,
            staleness_decay=hcfg.staleness_decay)
        self.digests: Dict[int, TelemetryDigest] = {}
        self.assigned_since: Dict[int, int] = {}
        self.assigned_total: Dict[int, int] = {}
        self.bytes_sent = 0
        self.digests_sent = 0
        self.seq = 0
        self._rr = 0
        # placement -> work-unit conversion, calibrated from digests
        self._quantum = 1.0
        self._fleet_depth: Optional[float] = None
        self._armed = False
        self.sim: Optional[ClusterSim] = None
        self.cell_sims: List[CellSim] = []
        self._tos: List[np.ndarray] = []
        self.n_tiers = 0

    def attach(self, sim: ClusterSim, cell_sims: List[CellSim],
               tier_names: List[str]):
        self.sim = sim
        self.cell_sims = cell_sims
        self.n_tiers = len(tier_names)
        tindex = {n: k for k, n in enumerate(tier_names)}
        # per-cell row -> tier maps in GLOBAL tier order, so digest planes
        # compare across cells even where a small tier lives in a few
        self._tos = [np.array([tindex[i.tier.name] for i in cs.instances])
                     for cs in cell_sims]
        for ci in range(len(cell_sims)):
            self.membership.register(f"cell{ci}", "cell", now=sim.now)
            self.assigned_since[ci] = 0
            self.assigned_total[ci] = 0
        self._tick(sim.now)

    # -- the heartbeat ------------------------------------------------------
    def _tick(self, t: float):
        sp = (tracing.begin("rb.digest", True, seq=self.seq)
              if tracing.ON else None)
        self._armed = False
        placed = sum(self.assigned_since.values())
        for ci, cs in enumerate(self.cell_sims):
            d = digest_from_telemetry(cs.tel, self._tos[ci], self.n_tiers,
                                      cell=ci, seq=self.seq, t=t)
            wire = encode_digest(d, mode=self.hcfg.digest_mode)
            self.bytes_sent += len(wire)
            self.digests_sent += 1
            self.digests[ci] = decode_digest(wire)   # only what crossed
            self.membership.heartbeat(f"cell{ci}", t)
            self.assigned_since[ci] = 0
        # calibrate the dead-reckoning quantum: fleet depth growth per
        # placement made this interval
        depth = sum(d.depth_total for d in self.digests.values())
        if self._fleet_depth is not None and placed > 0:
            q = max(1.0, (depth - self._fleet_depth) / placed)
            self._quantum = 0.5 * self._quantum + 0.5 * q
        self._fleet_depth = depth
        self.seq += 1
        self._arm(t)
        if sp is not None:
            tracing.end(sp)

    def _arm(self, t: float):
        """Re-arm the heartbeat while real work remains. The loop is a
        controller event (`_is_controller`), so it never keeps the sim
        alive on its own, and `pick` revives it after it parked."""
        if self._armed or self.sim is None:
            return
        if self.sim.has_noncontrol_events():
            self._armed = True
            self.sim.push(t + self.hcfg.digest_interval_s, self._tick)

    # -- placement ----------------------------------------------------------
    def pick(self, t: float, viable: Sequence[int]) -> int:
        """Choose a cell for one arriving request: staleness-penalized
        least load over the fresh digests (depth + placements since the
        digest, over free headroom), round-robin when every cell is
        dark. A pure function of the digests and the placement
        history."""
        hcfg = self.hcfg
        best, best_key = None, None
        for ci in viable:
            d = self.digests.get(ci)
            if d is None or not digest_fresh(d, t, hcfg.digest_stale_s):
                continue
            if d.n_alive == 0:
                continue               # the digest says: no capacity
            pen = self.membership.staleness_penalty(f"cell{ci}", t)
            load = pen * (d.depth_total
                          + self._quantum * self.assigned_since[ci]
                          + 1.0) / (d.free_total + 1.0)
            key = (load, self.assigned_total[ci], ci)
            if best_key is None or key < best_key:
                best, best_key = ci, key
        if best is None:               # every cell dark: blind rotation
            best = viable[self._rr % len(viable)]
            self._rr += 1
        self.assigned_since[best] += 1
        self.assigned_total[best] += 1
        self._arm(t)
        return best

    def imbalance(self) -> float:
        """Coefficient of variation of per-cell placements (0 = even)."""
        tot = np.array([self.assigned_total[ci]
                        for ci in sorted(self.assigned_total)], float)
        if len(tot) == 0 or tot.sum() == 0:
            return 0.0
        return float(tot.std() / max(tot.mean(), 1e-9))


class HierarchicalScheduler:
    """Balanced two-level scheduling with the single controller's
    `repro_torch.core.run_cell` contract: partition the roster at
    attach, run one RouteBalance engine per cell (each with its own
    policy and so its own hot path, and, when the sim is recovery-armed,
    its own `CellRecovery`), and place each arrival through the
    `GlobalBalancer`. Cell engines park their fire loops on the global
    expected count (`_CellEngine`)."""

    def __init__(self, cfg, bundle, tiers, hcfg: HierarchyConfig):
        if hcfg.routing != "balanced":
            raise ValueError(f"HierarchicalScheduler runs balanced "
                             f"routing, not {hcfg.routing!r}")
        if cfg.shard_cells > 1:
            raise ValueError("balanced routing runs whole engines per "
                             "cell; use routing='span' for the sharded "
                             "scan")
        self.cfg = cfg                 # the RBConfig template of the cells
        self.bundle = bundle
        self.tiers = list(tiers)
        self.hcfg = hcfg
        self.balancer = GlobalBalancer(hcfg)
        self.engines: List = []
        self.cells: List[List[Instance]] = []
        self.cell_sims: List[CellSim] = []
        self.expected: Optional[int] = None   # set by run_cell
        self.sim: Optional[ClusterSim] = None

    def attach(self, sim: ClusterSim):
        self.sim = sim
        self.cells = partition_roster(sim.instances, self.hcfg.n_cells)
        parent_mgr = getattr(sim, "recovery", None)
        self.engines, self.cell_sims = [], []
        managers: List[CellRecovery] = []
        slot_cell: Dict[int, int] = {}
        for ci, insts in enumerate(self.cells):
            for inst in insts:
                slot_cell[inst.slot] = ci
            cs = CellSim(sim, insts, ci)
            if parent_mgr is not None:
                mgr = CellRecovery(_CellScope(sim, insts), parent_mgr.cfg)
                cs.recovery = mgr
                managers.append(mgr)
            eng = _make_cell_engine(self.cfg, self.bundle, self.tiers, self)
            eng.cell_id = ci
            eng.attach(cs)             # binds the cell's manager too
            self.engines.append(eng)
            self.cell_sims.append(cs)
        if parent_mgr is not None:
            # Instance.fail() and hedge probes on the PARENT sim route to
            # the victim's owning cell from here on
            sim.recovery = _RecoveryRouter(managers, slot_cell,
                                           parent_mgr.cfg)
        tier_names: List[str] = []
        for inst in sim.instances:
            if inst.tier.name not in tier_names:
                tier_names.append(inst.tier.name)
        self.balancer.attach(sim, self.cell_sims, tier_names)

    def enqueue(self, req: Request, t: float):
        """One arrival: `route`, inside an `rb.ingest` span when traced
        (the cell engine is handed it through `admit`, which opens no
        second one)."""
        if tracing.ON:
            sp = tracing.begin("rb.ingest", rid=req.rid)
            self.route(req, t)
            tracing.end(sp)
        else:
            self.route(req, t)

    def route(self, req: Request, t: float):
        # a guard the digests cannot give: never hand work to a cell with
        # no alive instance (its engine could not build a roster), unless
        # the whole fleet is down
        viable = [ci for ci, insts in enumerate(self.cells)
                  if any(i.alive for i in insts)]
        if not viable:
            viable = list(range(len(self.cells)))
        sp = tracing.begin("rb.place", rid=req.rid) if tracing.ON else None
        ci = self.balancer.pick(t, viable)
        if sp is not None:
            tracing.end(sp, cell=ci)
        self.engines[ci].admit(req, t)

    # -- the run_cell contract ----------------------------------------------
    @property
    def decisions(self) -> int:
        return sum(e.decisions for e in self.engines)

    @property
    def shed_count(self) -> int:
        return sum(e.shed_count for e in self.engines)

    @property
    def compute_log(self):
        out = []
        for e in self.engines:
            out.extend(e.compute_log)
        return out

    @property
    def policy(self):
        return self.engines[0].policy

    @property
    def ecfg(self):
        return self.engines[0].ecfg


def build_scheduler(cfg, bundle, tiers, hcfg: HierarchyConfig):
    """The hierarchy's factory: ``span`` routing returns a plain
    `RouteBalance` whose scan is cell-sharded (``RBConfig.shard_cells``;
    bitwise the single controller, on the staged torch backend, which
    `cfg` must name), ``balanced`` routing the two-level
    `HierarchicalScheduler`. ``n_cells=1`` in either mode is the single
    controller itself."""
    from ..core.scheduler import RouteBalance
    if hcfg.routing == "span":
        return RouteBalance(
            dataclasses.replace(cfg, shard_cells=hcfg.n_cells),
            bundle, tiers)
    return HierarchicalScheduler(cfg, bundle, tiers, hcfg)
