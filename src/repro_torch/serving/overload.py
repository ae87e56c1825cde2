"""Overload control + elastic roster: the control surface that makes
the overload regime a first-class scenario axis.

The paper's headline claim — pricing latency at model-selection time
keeps the joint decision on the quality-cost-throughput frontier *under
load* — only bites when the cluster is actually allowed to overload.
This module supplies the three production controls real routers wrap
around that regime (the vLLM production-stack shape: an overload
detector plus an autoscaling operator plus admission control):

  * **overload detector** — a periodic probe over the scheduler-side
    columnar telemetry (`TelemetryArrays`): ``load_score`` folds decode
    slot occupancy and queue backlog into one scalar where 1.0 means
    the alive fleet is exactly at decode capacity. Hysteresis
    (`up_patience`/`down_patience` consecutive checks + a cooldown)
    keeps the controller from flapping on burst noise;
  * **elastic autoscaler** — scale-up/scale-down through the existing
    kill/revive/alive-mask machinery. Spare instances are
    *pre-provisioned cold* (`provision_reserve`): they are real roster
    rows, built into the sim and failed at arm time, sized to ride in
    the pow2-I bucket the fused hot path already runs — so a scale
    event is an alive-mask flip + telemetry reseed
    (``roster_version``), never a new kernel shape. Scale-up pays a
    configurable provisioning lag (`scale_up_lag_s`) before the slot
    revives; scale-down only retires reserve slots that are fully
    idle, so no in-flight work is ever revoked by elasticity;
  * **SLO-aware admission shedding** — per-tenant priority classes
    (`Request.priority`, 0 = premium): class p is shed at admission
    once the detector's load crosses ``shed_thresholds[p]``. The
    verdict is wired through ``ServingEngine`` *before* batch
    formation and is policy-visible (`SchedulingPolicy.shed_verdict`),
    so a policy can veto or tighten shedding; shed requests never
    reach a decision batch and are charged to the new ``shed_rate``
    metric axis, not to failures.

``arm_elastic(sim, cfg, reserve_iids)`` attaches one
`ElasticController` to a `ClusterSim` (exposed as ``sim.overload``,
which the engine consults on every admission); the scenario subsystem
(`repro_torch.serving.scenarios.ElasticSpec`) does this automatically for
elastic scenarios.

Port of `repro.serving.overload` (pure Python, unchanged). In the port
the hot path's kernel takes the roster as a pow2 bucket of instances,
so a scale event is an alive-mask flip and a mirror reseed and never a
new kernel shape variant (`FusedHotPath.shape_variants`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from .cluster import ClusterSim, Instance, TelemetryArrays
from .tiers import Tier


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Detector thresholds + autoscaler/shedding knobs.

    `load_score` units: 1.0 = the alive fleet's decode slots are
    exactly full with zero queue backlog; queue backlog adds on top in
    units of fleet decode capacity (so 2.0 ≈ one full fleet of work
    queued behind a full fleet running)."""
    check_interval: float = 0.25   # detector probe period (s)
    # -- autoscaler -----------------------------------------------------
    autoscale: bool = True
    up_threshold: float = 1.25     # load above => hot check
    down_threshold: float = 0.40   # load below => cold check
    up_patience: int = 2           # consecutive hot checks to scale up
    down_patience: int = 12        # consecutive cold checks to scale down
    cooldown_s: float = 1.5        # min gap between scale events
    scale_up_lag_s: float = 1.5    # provisioning delay before revive
    max_step: int = 2              # instances per scale-up event
    # -- SLO-aware shedding ---------------------------------------------
    shed_enabled: bool = True
    # priority class p (0 = premium) sheds at load >= shed_thresholds[p]
    # (classes beyond the tuple use the last entry)
    shed_thresholds: Tuple[float, ...] = (6.0, 3.0, 1.8)


def load_score(tel: TelemetryArrays) -> float:
    """Scalar cluster load off the columnar telemetry view: decode
    slot occupancy plus queue backlog, both normalized by the ALIVE
    fleet's decode capacity. Dead/cold rows contribute nothing, so the
    score rises when capacity is lost and falls when a reserve slot
    revives — exactly the feedback the autoscaler closes on."""
    alive = tel.alive
    if not alive.any():
        return float("inf")
    cap = float(tel.max_batch[alive].sum())
    if cap <= 0:
        return float("inf")
    util = float(tel.batch[alive].sum()) / cap
    backlog = float(tel.queue[alive].sum()) / cap
    return util + backlog


def provision_reserve(tiers: Sequence[Tier], k: int
                      ) -> Tuple[List[Tier], Tuple[str, ...]]:
    """Add `k` pre-provisioned reserve replicas to a roster, spread
    round-robin over the tiers that already concentrate capacity
    (highest replica count first — elasticity adds where the fleet is
    already cheap to grow). Returns the expanded tier list plus the
    iids of the reserve instances (``ClusterSim`` numbers replicas
    ``{tier.name}#{j}``, so the reserves are the trailing j's of each
    expanded tier). The reserves are real roster rows: size them so
    ``bucket_pow2(base + k) == bucket_pow2(base)`` and the fused hot
    path's I bucket absorbs them for free."""
    if k <= 0:
        return list(tiers), ()
    order = sorted(range(len(tiers)),
                   key=lambda i: (-tiers[i].n_instances, i))
    extra = [0] * len(tiers)
    for j in range(k):
        extra[order[j % len(order)]] += 1
    out: List[Tier] = []
    reserve: List[str] = []
    for i, t in enumerate(tiers):
        out.append(dataclasses.replace(
            t, n_instances=t.n_instances + extra[i]))
        reserve.extend(f"{t.name}#{j}"
                       for j in range(t.n_instances,
                                      t.n_instances + extra[i]))
    return out, tuple(reserve)


class ElasticController:
    """Overload detector + autoscaler + admission shedder over one
    `ClusterSim`. Armed once per sim (`arm_elastic`); the detector is
    an ordinary sim event that re-schedules itself while the cell has
    work in flight, so controller decisions are deterministic functions
    of the telemetry trajectory — identical across decision backends,
    which keeps the backends' differential parity meaningful under
    roster churn."""

    # marks the detector's self-loop as controller-owned: it re-arms on
    # `ClusterSim.has_noncontrol_events`, and a simulated controller
    # crash (`repro_torch.serving.recovery.simulate_controller_crash`) strips
    # its pending events from the heap
    _is_controller = True

    def __init__(self, sim: ClusterSim, cfg: OverloadConfig,
                 reserve_iids: Sequence[str] = ()):
        self.sim = sim
        self.cfg = cfg
        self.reserve = [sim.by_id[iid] for iid in reserve_iids
                        if iid in sim.by_id]
        self.load = 0.0
        self._hot = 0
        self._cold = 0
        self._last_scale = -float("inf")
        self._provisioning: Dict[str, float] = {}   # iid -> ready time
        # counters / audit trail
        self.scale_ups = 0
        self.scale_downs = 0
        self.sheds = 0
        self.shed_by_priority: Dict[int, int] = {}
        self.events: List[Tuple[float, str, str]] = []  # (t, kind, iid)
        self.peak_alive = int(sim.tel.alive.sum())

    # -- wiring ---------------------------------------------------------
    def arm(self) -> "ElasticController":
        """Cold-start the reserve pool (kill/alive-mask path — the rows
        stay in the kernel's roster bucket) and start the detector loop."""
        for inst in self.reserve:
            if inst.alive:
                inst.fail()                    # empty engine: nothing lost
        self.peak_alive = int(self.sim.tel.alive.sum())
        self.sim.push(self.cfg.check_interval, self._check)
        self.sim.overload = self
        return self

    # -- detector ---------------------------------------------------------
    def _check(self, t: float):
        cfg = self.cfg
        self.load = load_score(self.sim.tel)
        self.peak_alive = max(self.peak_alive,
                              int(self.sim.tel.alive.sum()))
        if self.load >= cfg.up_threshold:
            self._hot += 1
            self._cold = 0
        elif self.load <= cfg.down_threshold:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        if cfg.autoscale and t - self._last_scale >= cfg.cooldown_s:
            if self._hot >= cfg.up_patience:
                self._scale_up(t)
            elif self._cold >= cfg.down_patience:
                self._scale_down(t)
        # the detector only re-arms while the cell still has work in
        # flight (arrivals, decode iterations, provisioning timers) —
        # once only controller self-loops remain, the run is over
        # (bare `sim._events` would let this loop and the telemetry
        # watchdog keep each other alive forever)
        if self.sim.has_noncontrol_events():
            self.sim.push(t + cfg.check_interval, self._check)

    # -- autoscaler -------------------------------------------------------
    def _scale_up(self, t: float):
        cold = [i for i in self.reserve
                if not i.alive and i.iid not in self._provisioning]
        took = cold[:max(self.cfg.max_step, 1)]
        for inst in took:
            self._provisioning[inst.iid] = t + self.cfg.scale_up_lag_s
            self.sim.push(t + self.cfg.scale_up_lag_s,
                          lambda tt, ii=inst: self._provisioned(ii, tt))
            self.scale_ups += 1
            self.events.append((t, "scale_up", inst.iid))
        if took:
            self._last_scale = t
            self._hot = 0

    def _provisioned(self, inst: Instance, t: float):
        self._provisioning.pop(inst.iid, None)
        if not inst.alive:
            inst.recover(t)                    # alive-mask flip, no new shape
            self.events.append((t, "ready", inst.iid))
        self.peak_alive = max(self.peak_alive,
                              int(self.sim.tel.alive.sum()))

    def _scale_down(self, t: float):
        idle = [i for i in self.reserve
                if i.alive and not i.running and not i.queue]
        if not idle:
            return                             # nothing safely retirable
        inst = idle[0]
        inst.fail()                            # empty engine: nothing lost
        self.scale_downs += 1
        self.events.append((t, "scale_down", inst.iid))
        self._last_scale = t
        self._cold = 0

    # -- admission shedding -------------------------------------------------
    def wants_shed(self, priority: int) -> bool:
        """The default SLO-aware verdict: class `priority` sheds once
        the detector's load crosses its threshold. Policies route
        through `SchedulingPolicy.shed_verdict`, which defaults to this
        but may veto or tighten it."""
        cfg = self.cfg
        if not cfg.shed_enabled or not cfg.shed_thresholds:
            return False
        p = min(max(int(priority), 0), len(cfg.shed_thresholds) - 1)
        return self.load >= cfg.shed_thresholds[p]

    def record_shed(self, req, t: float):
        req.shed = True
        self.sheds += 1
        p = int(req.priority)
        self.shed_by_priority[p] = self.shed_by_priority.get(p, 0) + 1


def arm_elastic(sim: ClusterSim, cfg: OverloadConfig,
                reserve_iids: Sequence[str] = ()) -> ElasticController:
    """Attach + arm an `ElasticController` on a sim. The controller is
    exposed as ``sim.overload`` — `ServingEngine` finds it there and
    routes every admission through the policy's shed verdict."""
    return ElasticController(sim, cfg, reserve_iids).arm()
