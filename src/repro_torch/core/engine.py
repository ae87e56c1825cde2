"""The policy-agnostic serving engine.

Port of `repro.core.engine` (lines 52-586): `EngineConfig`,
`BatchView`, `Ready`, `AssignmentResult`, the `SchedulingPolicy`
protocol and `ServingEngine` with its four deployments, the §6.3 ladder
axis, orthogonal to the policy:

  * "windowed" — RouteBalance's amortized batch scoring: adaptive-window
    batch formation, the SoA row-index ring over the request stream's
    `RequestColumns`, async dispatch with the residual decomposition;
  * "serial_published" — one scoring call per request on one server,
    each charged the policy's `serial_scoring_s` (the baselines as
    published; alias "serial");
  * "microbatch" — a co-located collector scoring up to
    `microbatch_size` requests per `microbatch_time`, one batch at a
    time;
  * "concurrent" — groups of up to 8 scored on `n_workers` workers.

The station deployments charge the router queue wait and drop arrivals
beyond a bounded `queue_capacity`. Every deployment measures decision
time per call (`compute_log`, which feeds `charge_compute` in the
windowed one). The engine reaches `sim.recovery`
(`repro_torch.serving.recovery`) and `sim.overload`
(`repro_torch.serving.overload`) through `getattr`, so it runs without
them: arrivals go through the overload controller's shed verdict before
batch formation, a dark telemetry mirror routes batches to the recovery
manager's degraded least-loaded assignment, and every dispatch arms a
hedge deadline. The windowed deployment checkpoints its controller state
as a flat numpy tree and resumes from it after a controller crash
(`checkpoint_tree`, `save_checkpoint`, `resume`).

With `repro_torch.tracing` on, the windowed engine records `rb.ingest`
per arrival (`enqueue`; a hierarchy's cell engines are handed arrivals
through `admit`, their scheduler's span around it), `rb.fire` per fire
with `rb.window` and `rb.dispatch` (one `rb.submit` per request handed
to an instance) inside.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..serving.cluster import ClusterSim, Instance
from ..serving.request import Request
from ..serving.tiers import Tier

from .budget import max_tokens_clamp

DEPLOYMENTS = ("windowed", "concurrent", "serial_published", "microbatch")
# legacy PipelineConfig spelling, accepted as an alias
_DEPLOYMENT_ALIASES = {"serial": "serial_published"}


@dataclasses.dataclass
class EngineConfig:
    """Policy-agnostic engine knobs. `deployment` is the §6.3 ladder
    axis (see the module docstring)."""
    deployment: str = "windowed"
    # windowed-deployment knobs (RouteBalance's batch formation)
    base_window: float = 0.10
    adaptive: bool = True
    fixed_batch: Optional[int] = None
    charge_compute: bool = True
    # scoring-station knobs (§6.3 ladder deployments)
    n_workers: int = 32            # concurrent scoring workers
    microbatch_size: int = 64
    microbatch_time: float = 1.72  # padded batch service time (§6.3)
    queue_capacity: Optional[int] = None   # bounded => drops (vLLM-SR)


class BatchView:
    """One fired decision batch as the policy sees it: the request
    objects plus (when the batch is a slice of one ingest stream) the
    shared `RequestColumns` and row indices, so policies stage with
    vectorized gathers instead of per-request Python."""

    __slots__ = ("reqs", "cols", "rows", "t", "_attempts")

    def __init__(self, reqs: Sequence[Request], cols=None,
                 rows: Optional[np.ndarray] = None, t: float = 0.0):
        self.reqs = reqs
        self.cols = cols
        self.rows = rows
        self.t = t
        self._attempts = None

    def __len__(self) -> int:
        return len(self.reqs)

    @property
    def attempts(self) -> np.ndarray:
        """(R,) int64 per-request dispatch attempts beyond the first —
        how the policy sees retries re-entering admission after an
        instance failure (repro.serving.recovery). Zero for the fresh
        arrivals that dominate steady state; lazily built so the hot
        path never pays for it."""
        if self._attempts is None:
            self._attempts = np.fromiter(
                (r.attempt for r in self.reqs), np.int64,
                count=len(self.reqs))
        return self._attempts

    def columns(self, encoder):
        """(cols, rows) with embeddings guaranteed — resolving the
        batch's shared stream columns, or building ephemeral
        non-stamping columns for direct/legacy callers."""
        if self.cols is None:
            from ..serving.request import RequestColumns
            self.cols, self.rows = RequestColumns.for_batch(
                self.reqs, encoder)
        else:
            self.cols.ensure_embeddings(encoder)
        return self.cols, self.rows


class Ready:
    """Already-materialized decision payload: the eager twin of
    `repro_torch.core.hotpath.LazyDecision`, so `AssignmentResult.fetch`
    goes through one interface regardless of backend."""

    __slots__ = ("_out",)

    def __init__(self, choice: np.ndarray, l_chosen: np.ndarray):
        self._out = (choice, l_chosen)

    def fetch(self):
        return self._out


class AssignmentResult:
    """A policy's answer for one batch: the candidate roster plus a
    possibly-deferred (choice, l_chosen) pair. `choice[r]` indexes
    `instances`; `l_chosen[r]` is the predicted output length at the
    chosen instance. The payload exposes `fetch()` — the fused
    backend hands a `LazyDecision` (device arrays, transfer deferred
    to the dispatch point), everything else a `Ready`."""

    __slots__ = ("instances", "_res")

    def __init__(self, instances: Sequence[Instance], res):
        self.instances = instances
        self._res = res

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._res.fetch()


class SchedulingPolicy:
    """The pluggable decision layer. Subclasses override `assign`;
    `prepare`/`on_attach`/`fit` are optional hooks.

    Class attributes consumed by the engine:

      * `serial_scoring_s` — per-request scoring service time charged
        by the `serial_published` deployment. Policies that batch by
        construction keep the default; decoupled baselines surface
        their router's serial forward.
      * `budget_clamp` — whether dispatch applies the runtime
        max-tokens budget clamp (Eq. 2's execution-side half).

    `engine_overrides()` lets a policy pin `EngineConfig` fields its
    own config owns (RouteBalance's batch-formation knobs live in
    `RBConfig`): the engine applies them over whatever config it was
    constructed with, so a policy built with e.g. `fixed_batch=8`
    behaves the same whether it reaches the engine through the
    `RouteBalance` convenience class or a hand-built `ServingEngine`.
    """

    name = "policy"
    serial_scoring_s = 0.0
    budget_clamp = True

    def engine_overrides(self) -> dict:
        """EngineConfig fields this policy's own config dictates."""
        return {}

    def prepare(self, bundle, tiers: Sequence[Tier]):
        """Bind the estimator stack once per engine. Policies that
        keep a reference may rebind a private copy (e.g. a different
        KNN backend) and expose it as `self.bundle` — the engine picks
        the rebound copy up."""
        self.bundle = bundle

    def fit(self, emb: np.ndarray, quality: np.ndarray,
            lengths: np.ndarray, prices: np.ndarray):
        """Train policy-owned predictors on the shared supervision
        (the paper's fairness control: identical labels, identical
        train split as RouteBalance's KNN estimator)."""
        return self

    def on_attach(self, sim: ClusterSim):
        """New roster: drop per-roster compiled/cached state."""

    def shed_verdict(self, req: Request, controller) -> bool:
        """Admission-control hook, consulted by the engine BEFORE the
        request can join batch formation whenever the sim carries an
        overload controller (`sim.overload`). The default defers to the
        controller's SLO-aware per-priority verdict; a policy may veto
        shedding (return False), tighten it, or reimplement it — the
        verdict is policy-visible state, like every other scheduling
        decision."""
        return controller.wants_shed(req.priority)

    def assign(self, batch: BatchView, cluster: ClusterSim
               ) -> AssignmentResult:
        raise NotImplementedError


class ServingEngine:
    """Event-driven scheduler over a ClusterSim, generic in the policy.

    The windowed deployment is the zero-allocation serving path: SoA
    ingest ring, adaptive batch window, async dispatch with residual
    accounting. The station deployments queue arrivals in front of
    `n_servers` scoring servers (see the module docstring)."""

    def __init__(self, policy: SchedulingPolicy, bundle,
                 tiers: Sequence[Tier],
                 cfg: Optional[EngineConfig] = None):
        cfg = cfg if cfg is not None else EngineConfig()
        overrides = policy.engine_overrides()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        dep = _DEPLOYMENT_ALIASES.get(cfg.deployment, cfg.deployment)
        if dep not in DEPLOYMENTS:
            raise ValueError(f"deployment={cfg.deployment!r} not in "
                             f"{DEPLOYMENTS}")
        if dep != cfg.deployment:
            cfg = dataclasses.replace(cfg, deployment=dep)
        self.policy = policy
        self.ecfg = cfg
        self.tiers = list(tiers)
        policy.prepare(bundle, self.tiers)
        # a policy may rebind a private bundle copy (knn_backend): the
        # engine must stage/ingest through the same stack it decides on
        self.bundle = getattr(policy, "bundle", None) or bundle
        self.sim: Optional[ClusterSim] = None
        self._measured_compute = 0.004  # warm estimate, updated online
        self.decisions = 0
        self.shed_count = 0             # refused at admission (overload)
        self.batches = 0
        self.cell_id = -1               # a hierarchy's cell, -1 when flat
        self.expected: Optional[int] = None   # stop firing once all served
        # windowed fire-loop liveness: the loop parks once the expected
        # count is met, and a late retry/requeue must be able to revive
        # it (repro.serving.recovery re-enters through `enqueue`)
        self._fire_armed = False
        self._next_fire = 0.0
        self.compute_log: List[Tuple[int, float]] = []
        # windowed deployment: the waiting queue's SoA twin — a
        # row-index buffer parallel to `self.waiting`, so a decision
        # batch is an index slice into the stream's RequestColumns with
        # no per-request work at fire time. _wait_cols: the stream's
        # columns | None (queue empty) | False (mixed/columnless
        # stream -> legacy AoS marshaling)
        self.waiting: List[Request] = []
        self._wait_rows = np.empty(256, np.int64)
        self._wait_start = 0
        self._wait_n = 0
        self._wait_cols = None
        # station deployments: scoring queue + worker occupancy
        self.queue: List[Request] = []
        self.busy_servers = 0
        self.n_servers = (cfg.n_workers if cfg.deployment == "concurrent"
                          else 1)

    # -- wiring ---------------------------------------------------------------
    def attach(self, sim: ClusterSim):
        self.sim = sim
        self.policy.on_attach(sim)            # new sim -> new roster
        mgr = getattr(sim, "recovery", None)
        if mgr is not None:
            mgr.bind(self)       # retries requeue into us; watchdog starts
        if self.ecfg.deployment != "windowed":
            return                            # station mode drains on arrival
        self._wait_start = self._wait_n = 0
        # requests queued from before a re-attach have no rows in the
        # (just-cleared) ring, so the ring is no longer parallel to
        # `waiting` — marshal AoS until the queue drains (`_fire`'s
        # drain reset re-enables the SoA path)
        self._wait_cols = False if self.waiting else None
        self._fire_armed = False
        self._arm_fire(sim.now + self.ecfg.base_window)

    def _arm_fire(self, t: float):
        if self._fire_armed:
            return
        self._fire_armed = True
        self._next_fire = t
        self.sim.push(t, self._fire)

    def _maybe_shed(self, req: Request, t: float) -> bool:
        """Overload admission control, ahead of batch formation for
        every deployment: when the sim carries an `ElasticController`
        (`sim.overload`, armed by `repro.serving.overload.arm_elastic`)
        the policy's shed verdict runs on arrival. Shed requests never
        reach a decision batch — they leave immediately, marked
        `shed` (charged to `shed_rate`, not to failures)."""
        ctl = getattr(self.sim, "overload", None)
        if ctl is None or not self.policy.shed_verdict(req, ctl):
            return False
        if req.attempt > 0:
            # retries are never shed: the request was already admitted
            # once — admission control gates NEW work, and shedding a
            # victim of an instance failure would double-charge it
            return False
        ctl.record_shed(req, t)
        self.shed_count += 1
        self.sim.completed.append(req)
        return True

    def enqueue(self, req: Request, t: float):
        """One arrival: `admit`, inside an `rb.ingest` span when traced."""
        if tracing.ON:
            sp = tracing.begin("rb.ingest", rid=req.rid)
            self.admit(req, t)
            tracing.end(sp)
        else:
            self.admit(req, t)

    def admit(self, req: Request, t: float):
        if self._maybe_shed(req, t):
            return
        if self.ecfg.deployment != "windowed":
            self._enqueue_station(req, t)
            return
        # a retry delivered after the fire loop parked (expected count
        # met before the failure) must revive it, or the request waits
        # forever; queueing ahead of attach() is still allowed
        if self.sim is not None:
            self._arm_fire(t + self.ecfg.base_window)
        self.waiting.append(req)
        cols = req.cols
        if cols is None or req.row < 0 or (
                self._wait_cols is not None
                and self._wait_cols is not cols):
            self._wait_cols = False           # fall back to AoS marshaling
            return
        if self._wait_cols is None:
            # first sight of the stream: fill the embedding column now
            # (ingest time, off the measured decision path; a no-op when
            # the workload generator pre-embedded)
            cols.ensure_embeddings(self.bundle.encoder)
            self._wait_cols = cols
        end = self._wait_start + self._wait_n
        if end >= len(self._wait_rows):
            if self._wait_start:              # compact, then maybe grow
                self._wait_rows[:self._wait_n] = \
                    self._wait_rows[self._wait_start:end].copy()
                self._wait_start = 0
                end = self._wait_n
            if end >= len(self._wait_rows):
                self._wait_rows = np.concatenate(
                    [self._wait_rows, np.empty_like(self._wait_rows)])
        self._wait_rows[end] = req.row
        self._wait_n += 1

    # -- windowed deployment --------------------------------------------------
    def _window(self) -> float:
        if not self.ecfg.adaptive:
            return self.ecfg.base_window
        sp = tracing.begin("rb.window", True) if tracing.ON else None
        tel = self.sim.tel
        alive = tel.alive
        busy = float(np.mean(np.minimum(
            tel.batch[alive] / np.maximum(tel.max_batch[alive], 1.0),
            1.0))) if alive.any() else 0.0
        if sp is not None:
            tracing.end(sp)
        return float(np.clip(self.ecfg.base_window * (0.4 + 1.8 * busy),
                             0.04, 0.30))

    def _fire(self, t: float):
        self._fire_armed = False
        batch = self.waiting
        if self.ecfg.fixed_batch:
            batch = batch[:self.ecfg.fixed_batch]
        self.waiting = self.waiting[len(batch):]
        k = len(batch)
        sp = (tracing.begin("rb.fire", True, cell=self.cell_id,
                            batch=self.batches, rows=k,
                            rids=[r.rid for r in batch])
              if tracing.ON else None)
        cols = rows = None
        if self._wait_cols not in (None, False):
            cols = self._wait_cols
            rows = self._wait_rows[self._wait_start:self._wait_start + k]
            self._wait_start += k
            self._wait_n -= k
        if not self.waiting:                  # drained: accept a new
            self._wait_start = self._wait_n = 0   # stream (or recover
            self._wait_cols = None                # from a mixed one)
        if batch:
            t0 = time.perf_counter()
            self._decide(batch, t, cols, rows)
            dt_meas = time.perf_counter() - t0
            self._measured_compute = (0.8 * self._measured_compute
                                      + 0.2 * dt_meas)
            self.compute_log.append((len(batch), dt_meas))
        # once all are dispatched or shed, the loop parks: enqueue re-arms it
        if (self.expected is None or self.waiting
                or self.decisions + self.shed_count < self.expected):
            self._arm_fire(t + self._window())
        if sp is not None:
            tracing.end(sp)

    def _assign(self, view: BatchView):
        """Route one batch through the policy — or, when the telemetry
        watchdog has declared the whole mirror dark, through the
        recovery manager's degraded least-loaded fallback (the policy's
        inputs are all stale; dead-reckoned occupancy is the only
        trustworthy signal left)."""
        mgr = getattr(self.sim, "recovery", None)
        if mgr is not None and mgr.degraded:
            return mgr.degraded_assign(view, self.sim)
        return self.policy.assign(view, self.sim)

    def _decide(self, batch: List[Request], t: float, cols=None,
                rows: Optional[np.ndarray] = None):
        res = self._assign(BatchView(batch, cols, rows, t))
        R = len(batch)
        I = int(self.sim.tel.alive.sum())

        # dispatch + residual accounting. The bookkeeping between the
        # dispatch above and res.fetch() below runs while an async
        # policy's device program executes; eager policies fetch here
        # for free (already numpy).
        compute = (self._measured_compute if self.ecfg.charge_compute
                   else 0.0)
        stats = 0.0005 * I / 13                       # non-blocking fetch
        per_req_compute = compute / max(R, 1) + compute * 0.2
        now = t + compute + stats
        choice, l_chosen = res.fetch()
        instances = res.instances
        clamp = self.policy.budget_clamp
        mgr = getattr(self.sim, "recovery", None)
        sp = tracing.begin("rb.dispatch", True) if tracing.ON else None
        for r_idx, req in enumerate(batch):
            inst = instances[int(choice[r_idx])]
            req.sched_compute = per_req_compute
            req.sched_stats_fetch = stats
            req.sched_batch_wait = max(t - req.arrival, 0.0)
            mt = (max_tokens_clamp(req.budget, req.prompt.len_in,
                                   inst.tier.price_in,
                                   inst.tier.price_out)
                  if clamp else None)
            if sp is not None:
                sub = tracing.begin("rb.submit", rid=req.rid, slot=inst.slot)
                inst.submit(req, now, float(l_chosen[r_idx]), mt)
                tracing.end(sub)
            else:
                inst.submit(req, now, float(l_chosen[r_idx]), mt)
            self.decisions += 1
            if mgr is not None:
                mgr.watch_dispatch(req, inst, now)
        if sp is not None:
            tracing.end(sp)
        self.batches += 1

    # -- station deployments (§6.3 ladder) ------------------------------------
    def _enqueue_station(self, req: Request, t: float):
        cap = self.ecfg.queue_capacity
        if cap is not None and len(self.queue) >= cap:
            req.failed = True
            req.finish_time = t   # terminal-state invariant: failures
            self.sim.completed.append(req)   # carry a terminal timestamp
            return
        self.queue.append(req)
        self._drain(t)

    def _service_time(self) -> float:
        if self.ecfg.deployment == "microbatch":
            return self.ecfg.microbatch_time
        return self.policy.serial_scoring_s

    def _drain(self, t: float):
        while self.queue and self.busy_servers < self.n_servers:
            dep = self.ecfg.deployment
            if dep == "microbatch":
                n = min(len(self.queue), self.ecfg.microbatch_size)
            elif dep == "concurrent":
                # micro-batched off the scheduling loop: each worker
                # takes a small group; workers overlap
                n = min(len(self.queue),
                        max(1, len(self.queue) // self.n_servers))
                n = min(n, 8)
            else:
                n = 1
            group = self.queue[:n]
            self.queue = self.queue[n:]
            self.busy_servers += 1
            dt = self._service_time()
            self.sim.push(t + dt, lambda tt, g=group: self._scored(g, tt))

    def _scored(self, group: List[Request], t: float):
        self.busy_servers -= 1
        t0 = time.perf_counter()
        res = self._assign(BatchView(group, t=t))
        choice, l_chosen = res.fetch()
        instances = res.instances
        clamp = self.policy.budget_clamp
        mgr = getattr(self.sim, "recovery", None)
        for j, req in enumerate(group):
            req.router_queue_wait = t - req.arrival
            inst = instances[int(choice[j])]
            mt = (max_tokens_clamp(req.budget, req.prompt.len_in,
                                   inst.tier.price_in,
                                   inst.tier.price_out)
                  if clamp else None)
            inst.submit(req, t, float(l_chosen[j]), mt)
            self.decisions += 1
            if mgr is not None:
                mgr.watch_dispatch(req, inst, t)
        self.batches += 1
        self.compute_log.append((len(group), time.perf_counter() - t0))
        self._drain(t)

    # -- checkpoint/restore (windowed deployment) -----------------------------
    # The controller's durable state — everything a fresh scheduler
    # process needs to resume a trace exactly where a crashed one
    # stopped — is tiny and flat: the waiting queue (rids; request
    # payloads are replayable from the trace), the admission counters,
    # the fire-loop clock, and the recovery manager's pending retry and
    # hedge timers. `repro_torch.distributed.checkpoint.CheckpointManager`
    # persists it atomically; `resume` rebuilds a (possibly brand-new)
    # engine onto the surviving sim. Checkpoints must be coordinated
    # with the crash point (save at the instant the controller dies, as
    # a write-ahead log would guarantee): state that changed after the
    # snapshot is rolled back on the controller but not on the workers.

    def checkpoint_tree(self) -> dict:
        """The controller's durable state as a flat numpy tree (the
        shape `_checkpoint_template` describes)."""
        mgr = (getattr(self.sim, "recovery", None)
               if self.sim is not None else None)
        tree = self._checkpoint_template()
        tree["waiting_rids"] = np.array([r.rid for r in self.waiting],
                                        np.int64)
        tree["counters"] = np.array(
            [self.decisions, self.shed_count, self.batches,
             -1 if self.expected is None else self.expected], np.int64)
        tree["clock"] = np.array(
            [self._next_fire if self._fire_armed else -1.0,
             self._measured_compute], np.float64)
        if mgr is not None:
            tree.update(mgr.pending_state())
        return tree

    @staticmethod
    def _checkpoint_template() -> dict:
        """A dtype-correct skeleton of `checkpoint_tree` — what
        `CheckpointManager.restore` needs as its `tree_like` (restore
        takes shapes from the stored arrays, dtypes from this)."""
        return {
            "waiting_rids": np.zeros(0, np.int64),
            "counters": np.zeros(4, np.int64),
            "clock": np.zeros(2, np.float64),
            "retry_rids": np.zeros(0, np.int64),
            "retry_due": np.zeros(0, np.float64),
            "watch_keys": np.zeros((0, 3), np.int64),
            "watch_due": np.zeros(0, np.float64),
            "watch_slot": np.zeros(0, np.int64),
            "recovery_counters": np.zeros(7, np.int64),
        }

    def save_checkpoint(self, ckpt, step: int):
        """Persist the controller state via a
        `repro_torch.distributed.checkpoint.CheckpointManager`."""
        ckpt.save(step, self.checkpoint_tree(),
                  metadata={"now": self.sim.now if self.sim else 0.0})

    def resume(self, sim: ClusterSim, tree: dict,
               requests: Sequence[Request]) -> "ServingEngine":
        """Rebuild this (typically freshly constructed) engine from a
        checkpoint onto a sim whose controller died
        (`repro_torch.serving.recovery.simulate_controller_crash`): worker
        decode chains and future arrivals survived; the waiting queue,
        counters, pending retries/hedge timers and the fire loop come
        back from the tree. Windowed deployment only. `requests` is the
        trace the checkpointed rids index into."""
        if self.ecfg.deployment != "windowed":
            raise ValueError(f"resume needs the windowed deployment, not "
                             f"{self.ecfg.deployment!r}")
        by_rid = {r.rid: r for r in requests}
        c = tree["counters"]
        self.decisions, self.shed_count, self.batches = (
            int(c[0]), int(c[1]), int(c[2]))
        self.expected = None if int(c[3]) < 0 else int(c[3])
        self._measured_compute = float(tree["clock"][1])
        self.waiting = [by_rid[int(rid)] for rid in tree["waiting_rids"]]
        self.sim = sim
        self.policy.on_attach(sim)
        mgr = getattr(sim, "recovery", None)
        if mgr is not None:
            mgr.bind(self)
            mgr.restore_pending(tree, by_rid)
        self._wait_start = self._wait_n = 0
        self._wait_cols = False if self.waiting else None
        self._fire_armed = False
        next_fire = float(tree["clock"][0])
        if next_fire >= 0.0:
            self._arm_fire(max(next_fire, sim.now))
        elif self.waiting:
            self._arm_fire(sim.now + self.ecfg.base_window)
        return self
