"""Fault-tolerant request lifecycle: retry/requeue, hedged re-dispatch,
telemetry watchdog, and scheduler checkpoint/restore.

The overload controller makes the *roster* resilient (alive-mask
autoscaling, SLO shedding); this module makes the *requests*
resilient, the way production routers do (the Intelligent-Router /
data-parallel load-balancing lines of work in PAPERS.md):

  * **retry/requeue** — `Instance.fail()` hands its in-flight and
    queued work to `RecoveryManager.on_failure` instead of stamping it
    terminally failed: bounded attempts, exponential backoff with
    seeded jitter, and re-entry through the ordinary
    `ServingEngine.enqueue` admission path. The `Request.attempt` /
    `first_arrival` split keeps metrics charging the true end-to-end
    clock while the scheduler sees a freshly-arrived request, and the
    policy sees retries via `BatchView.attempts`;
  * **timeouts + hedged re-dispatch** — every dispatch arms a deadline
    derived from the tier's roofline TPOT at the predicted output
    length. On expiry (a hidden straggler, an overloaded loser) the
    request is re-dispatched to the next-best instance off the live
    telemetry mirror and the loser is cancelled; the loser's generated
    tokens are charged to `duplicate-work`, not thrown away silently;
  * **telemetry watchdog** — a staleness detector over
    `TelemetryArrays.t`/`last_write`: rows that stop publishing while
    they hold work are *quarantined* through the existing alive-mask +
    `roster_version` path (`TelemetryArrays.quarantine`) — masked like
    dead instances, with no new kernel shape — and released with a fresh
    reseed when they publish again. If the whole mirror goes dark the
    engine falls back to a degraded least-loaded policy
    (`degraded_assign`) until rows come back;
  * **checkpoint/restore** — `ServingEngine.checkpoint_tree()` +
    `RecoveryManager.pending_state()` capture the controller's dead-
    reckoned scheduler state (waiting queue, counters, pending retry
    and hedge timers) as a flat numpy tree the atomic
    `repro_torch.distributed.checkpoint.CheckpointManager` persists;
    `simulate_controller_crash` strips every controller-owned event
    from a live sim (worker decode chains survive — a controller crash
    is not a node crash) and `ServingEngine.resume` rebuilds the
    scheduler mid-trace with no lost or duplicated requests.

Determinism contract: every decision here — backoff jitter (counter-
based, keyed on (seed, rid, attempt) so no RNG state needs
checkpointing), hedge targets, quarantine verdicts — is a function of
the simulation trajectory, never of wall clock or shared RNG state, so
the backends' differential parity holds through retry /
hedge / quarantine churn, and a crash/restore replays bitwise.

Port of `repro.serving.recovery` (numpy; the same counter-based jitter,
so retries, hedges and quarantines replay the reference's bitwise).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster import ClusterSim, Instance


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Retry / hedge / watchdog knobs (see module docstring)."""
    # -- retry/requeue ---------------------------------------------------
    max_attempts: int = 3          # total dispatch attempts per request
    backoff_base_s: float = 0.25   # first-retry delay
    backoff_mult: float = 2.0      # exponential growth per attempt
    backoff_jitter: float = 0.25   # ± fraction, drawn per (rid, attempt)
    # -- timeouts + hedged re-dispatch -----------------------------------
    hedge: bool = True
    hedge_factor: float = 4.0      # deadline = factor * predicted service
    hedge_slack_s: float = 2.0     # + constant slack
    max_hedges: int = 1            # hedged re-dispatches per request
    # -- telemetry watchdog ----------------------------------------------
    watchdog: bool = True
    check_interval_s: float = 0.5  # staleness probe period
    stale_after_s: float = 2.0     # no write for this long + work = stale
    degraded_pred_len: float = 128.0   # l_chosen stand-in in degraded mode
    seed: int = 0


def _jitter_u(seed: int, rid: int, attempt: int) -> float:
    """Deterministic uniform draw in [0, 1) per (request, attempt):
    counter-based so retries replay bitwise across backends and across
    a controller crash/restore (no RNG state to checkpoint)."""
    return float(np.random.default_rng(
        (seed, 0xFA117, rid, attempt)).random())


def least_loaded_instance(sim: ClusterSim, exclude: Tuple[str, ...] = ()
                          ) -> Optional[Instance]:
    """Deterministic degraded-mode pick: the alive, un-quarantined
    instance with the lowest occupancy fraction (slot order breaks
    ties). Quarantined rows are suspect and only used when nothing else
    is left."""
    def key(i: Instance):
        return ((len(i.running) + len(i.queue))
                / max(i.tier.max_batch, 1), i.slot)
    pool = [i for i in sim.instances
            if i.alive and not i.quarantined and i.iid not in exclude]
    if not pool:
        pool = [i for i in sim.instances
                if i.alive and i.iid not in exclude]
    return min(pool, key=key) if pool else None


def fastest_drain_instance(sim: ClusterSim, exclude: Tuple[str, ...] = ()
                           ) -> Optional[Instance]:
    """Hedge-target pick: minimize expected time-to-serve, not raw
    occupancy. An empty heavyweight tier is a WORSE hedge target than a
    moderately loaded fast one — the whole point of hedging is to beat
    the loser's clock — so the score is the tier's nominal TPOT scaled
    by the instance's load. Pure sim-side state + tier constants: the
    pick is identical under every decision backend."""
    def key(i: Instance):
        occ = ((len(i.running) + len(i.queue))
               / max(i.tier.max_batch, 1))
        return (i.tier.tpot(float(i.tier.max_batch), 1024.0)
                * (1.0 + occ), i.slot)
    pool = [i for i in sim.instances
            if i.alive and not i.quarantined and i.iid not in exclude]
    return min(pool, key=key) if pool else None


class RecoveryManager:
    """Retry + hedge + watchdog controller over one `ClusterSim`,
    exposed as ``sim.recovery`` (`arm_recovery`). `Instance.fail()`
    routes victims through `on_failure`; `ServingEngine` binds itself
    at attach time, registers every dispatch (`watch_dispatch`), and
    consults `degraded` before each policy call."""

    _is_controller = True          # see ClusterSim.has_noncontrol_events

    def __init__(self, sim: ClusterSim, cfg: RecoveryConfig):
        self.sim = sim
        self.cfg = cfg
        self.engine = None                     # bound by ServingEngine
        self.degraded = False                  # whole mirror dark
        self._watch_armed = False
        # pending retries: rid -> (req, due) — checkpointed
        self._pending: Dict[int, Tuple[object, float]] = {}
        # armed hedge timers: (rid, attempt, hedges) -> (due, slot)
        self._watches: Dict[Tuple[int, int, int], Tuple[float, int]] = {}
        # counters / audit trail
        self.retries = 0
        self.gave_up = 0
        self.hedges = 0
        self.duplicate_tokens = 0
        self.quarantines = 0
        self.releases = 0
        self.degraded_decisions = 0
        self.degraded_entries = 0
        # batches decided by `degraded_assign` (the policy saw none of
        # them); a count of this manager's calls, not checkpointed
        self.degraded_batches = 0

    # -- wiring -----------------------------------------------------------
    def bind(self, engine) -> "RecoveryManager":
        """Attach the scheduler the manager requeues into; starts the
        watchdog loop (idempotent across re-binds)."""
        self.engine = engine
        if self.cfg.watchdog and not self._watch_armed:
            self._watch_armed = True
            self.sim.push(self.sim.now + self.cfg.check_interval_s,
                          self._watch)
        return self

    # -- retry/requeue ----------------------------------------------------
    def on_failure(self, req, inst: Instance, lost_tokens: int,
                   now: float) -> bool:
        """Instance death handed us a victim. True = requeued for retry
        (the caller must NOT mark it terminal); False = attempts
        exhausted (or already terminal) — the caller fails it."""
        if req.finish_time is not None or req.shed:
            return False           # already terminal; don't resurrect
        req.wasted_tokens += lost_tokens
        if req.attempt + 1 >= self.cfg.max_attempts:
            self.gave_up += 1
            return False
        req.requeue(now)           # attempt += 1, dispatch state cleared
        a = req.attempt
        delay = (self.cfg.backoff_base_s
                 * self.cfg.backoff_mult ** (a - 1)
                 * (1.0 + self.cfg.backoff_jitter
                    * (2.0 * _jitter_u(self.cfg.seed, req.rid, a) - 1.0)))
        due = now + delay
        self.retries += 1
        self._pending[req.rid] = (req, due)
        self.sim.push(due, self._make_delivery(req))
        return True

    def _make_delivery(self, req):
        def deliver(t):
            if self._pending.pop(req.rid, None) is None:
                return             # superseded (crash/restore re-armed it)
            if self.engine is not None:
                self.engine.enqueue(req, t)
        deliver._controller = True     # dies with the controller; the
        return deliver                 # checkpoint re-arms it on resume

    # -- timeouts + hedged re-dispatch ------------------------------------
    def watch_dispatch(self, req, inst: Instance, t: float):
        """Arm the per-request deadline for a dispatch that just
        happened. Deadline = hedge_factor x the tier's roofline service
        estimate at the predicted output length (prefill + pred_len
        decode steps at worst-case batch), plus slack — generous enough
        that healthy instances never trip it, tight enough that a 4x
        hidden straggler does."""
        cfg = self.cfg
        if not cfg.hedge or req.hedges >= cfg.max_hedges:
            return
        due = t + self._deadline_s(req, inst)
        key = (req.rid, req.attempt, req.hedges)
        self._watches[key] = (due, inst.slot)
        self.sim.push(due, self._make_hedge_check(
            req, inst.iid, req.attempt, req.hedges))

    def _deadline_s(self, req, inst: Instance) -> float:
        tier = inst.tier
        pred = (float(req.pred_len) if req.pred_len is not None
                else self.cfg.degraded_pred_len)
        est = (tier.prefill_time(req.prompt.len_in)
               + max(pred, 8.0) * tier.tpot(tier.max_batch, 1024.0))
        return self.cfg.hedge_factor * est + self.cfg.hedge_slack_s

    def _make_hedge_check(self, req, iid: str, attempt: int, hedges: int):
        def check(t):
            self._watches.pop((req.rid, attempt, hedges), None)
            self._maybe_hedge(req, iid, attempt, hedges, t)
        check._controller = True
        return check

    def _maybe_hedge(self, req, iid: str, attempt: int, hedges: int,
                     t: float):
        if req.finish_time is not None or req.failed or req.shed:
            return
        if (req.attempt != attempt or req.hedges != hedges
                or req.instance != iid):
            return                 # moved since the timer was armed
        loser = self.sim.by_id.get(iid)
        if loser is None or not loser.alive:
            return                 # the failure path owns this request
        target = fastest_drain_instance(self.sim, exclude=(iid,))
        if target is None:
            return
        gen = loser.cancel(req)
        if gen is None:
            return                 # completing concurrently — let it win
        req.wasted_tokens += gen
        req.hedges += 1
        self.hedges += 1
        self.duplicate_tokens += gen
        mt = req.max_tokens
        if self.engine is not None and self.engine.policy.budget_clamp:
            from ..core.budget import max_tokens_clamp
            mt = max_tokens_clamp(req.budget, req.prompt.len_in,
                                  target.tier.price_in,
                                  target.tier.price_out)
        pred = (float(req.pred_len) if req.pred_len is not None
                else self.cfg.degraded_pred_len)
        target.submit(req, t, pred, mt)
        self.watch_dispatch(req, target, t)

    # -- telemetry watchdog -----------------------------------------------
    def _watch(self, t: float):
        cfg = self.cfg
        tel = self.sim.tel
        stale: List[Instance] = []
        fresh = 0
        for inst in self.sim.instances:
            if not inst.alive:
                continue
            has_work = bool(inst.running or inst.queue)
            is_stale = has_work and (t - tel.t[inst.slot]
                                     ) > cfg.stale_after_s
            if inst.quarantined:
                if not is_stale:
                    self._release(inst, t)
                continue
            if is_stale:
                stale.append(inst)
            else:
                fresh += 1
        if stale and fresh == 0:
            # whole mirror dark: masking everything would leave the
            # policy nothing to schedule onto — flip to the degraded
            # least-loaded fallback instead and leave the masks alone
            if not self.degraded:
                self.degraded_entries += 1
            self.degraded = True
        else:
            self.degraded = False
            for inst in stale:
                if int(tel.alive.sum()) <= 1:
                    break          # never mask the last visible row
                inst.quarantined = True
                tel.quarantine(inst.slot)
                self.quarantines += 1
        if self.sim.has_noncontrol_events():
            self.sim.push(t + cfg.check_interval_s, self._watch)
        else:
            self._watch_armed = False

    def _release(self, inst: Instance, t: float):
        """A quarantined row published again (or drained): unmask it
        and reseed the row from the worker's live snapshot — unlike a
        revive, the instance was serving the whole time."""
        inst.quarantined = False
        tel = self.sim.tel
        tel.unquarantine(inst.slot)
        s = inst.snapshot
        tel.write(inst.slot, s["pending_decode"], s["batch_size"],
                  s["free_slots"], s["mean_ctx"], s["queue_depth"], t)
        self.releases += 1

    def degraded_assign(self, batch, sim: ClusterSim):
        """Mirror-dark fallback: least-loaded dispatch off the live
        instance state, bypassing the policy (whose telemetry inputs
        are all stale). Deterministic, backend-independent."""
        from ..core.engine import AssignmentResult, Ready
        cand = [i for i in sim.instances if i.alive]
        assert cand, "no alive instances to schedule onto"
        R = len(batch.reqs)
        choice = np.empty(R, np.int64)
        load = {i.slot: len(i.running) + len(i.queue) for i in cand}
        for r in range(R):
            best = min(cand, key=lambda i: (
                load[i.slot] / max(i.tier.max_batch, 1), i.slot))
            choice[r] = best.slot      # slot == index into sim.instances
            load[best.slot] += 1       # spread the batch, dead-reckoned
        self.degraded_decisions += R
        self.degraded_batches += 1
        l_chosen = np.full(R, self.cfg.degraded_pred_len)
        return AssignmentResult(sim.instances, Ready(choice, l_chosen))

    # -- checkpoint/restore -----------------------------------------------
    def pending_state(self) -> Dict[str, np.ndarray]:
        """The manager's durable state as flat numpy arrays (merged
        into `ServingEngine.checkpoint_tree`): pending retry deliveries
        and armed hedge timers, plus the counters."""
        pend = sorted(self._pending.values(), key=lambda p: p[0].rid)
        watches = sorted((rid, att, hg, due, slot) for
                         (rid, att, hg), (due, slot)
                         in self._watches.items())
        return {
            "retry_rids": np.array([p[0].rid for p in pend], np.int64),
            "retry_due": np.array([p[1] for p in pend], np.float64),
            "watch_keys": np.array([w[:3] for w in watches],
                                   np.int64).reshape(-1, 3),
            "watch_due": np.array([w[3] for w in watches], np.float64),
            "watch_slot": np.array([w[4] for w in watches], np.int64),
            "recovery_counters": np.array(
                [self.retries, self.gave_up, self.hedges,
                 self.duplicate_tokens, self.quarantines, self.releases,
                 self.degraded_decisions], np.int64),
        }

    def restore_pending(self, tree: Dict[str, np.ndarray], by_rid):
        """Re-arm checkpointed retry deliveries and hedge timers on a
        (possibly fresh) manager after a controller crash."""
        (self.retries, self.gave_up, self.hedges, self.duplicate_tokens,
         self.quarantines, self.releases, self.degraded_decisions) = (
            int(x) for x in tree["recovery_counters"])
        for rid, due in zip(tree["retry_rids"], tree["retry_due"]):
            req = by_rid[int(rid)]
            self._pending[req.rid] = (req, float(due))
            self.sim.push(float(due), self._make_delivery(req))
        for (rid, att, hg), due, slot in zip(
                tree["watch_keys"].reshape(-1, 3).tolist(),
                tree["watch_due"], tree["watch_slot"]):
            req = by_rid[int(rid)]
            iid = self.sim.instances[int(slot)].iid
            self._watches[(int(rid), int(att), int(hg))] = (
                float(due), int(slot))
            self.sim.push(float(due), self._make_hedge_check(
                req, iid, int(att), int(hg)))


def arm_recovery(sim: ClusterSim,
                 cfg: Optional[RecoveryConfig] = None) -> RecoveryManager:
    """Attach a `RecoveryManager` to a sim as ``sim.recovery``.
    `Instance.fail()` finds it there; `ServingEngine.attach` binds
    itself and starts the watchdog."""
    mgr = RecoveryManager(sim, cfg if cfg is not None
                          else RecoveryConfig())
    sim.recovery = mgr
    return mgr


def simulate_controller_crash(sim: ClusterSim, engine=None) -> int:
    """Kill the scheduler side of a live sim: strip every controller-
    owned event from the heap — the engine's fire loop, retry
    deliveries, hedge timers, the watchdog and overload detector loops
    — while worker decode chains and future arrivals survive (a
    controller crash is not a node crash). Detaches ``sim.recovery``;
    the restore path re-arms a fresh manager from the checkpoint.
    Returns the number of events dropped."""
    from ..core.engine import ServingEngine

    def is_controller_event(fn) -> bool:
        if getattr(fn, "_controller", False):
            return True
        owner = getattr(fn, "__self__", None)
        if owner is None:
            return False
        return (owner is engine or isinstance(owner, ServingEngine)
                or getattr(owner, "_is_controller", False))

    kept = [e for e in sim._events if not is_controller_event(e[2])]
    dropped = len(sim._events) - len(kept)
    heapq.heapify(kept)
    sim._events = kept
    sim.recovery = None
    return dropped
