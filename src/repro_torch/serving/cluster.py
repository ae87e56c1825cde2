"""Discrete-event simulation of a heterogeneous continuous-batching
cluster (the vLLM-analogue substrate).

Each instance runs iteration-level continuous batching: every decode
iteration advances all running sequences by one token in
``tier.tpot(batch, mean_ctx)`` seconds (the calibrated roofline), admits
queued requests into free slots (charging roofline prefill time, which
blocks the engine like vLLM's default non-chunked prefill), and retires
finished sequences. Telemetry is a non-blocking snapshot refreshed at
iteration boundaries — the paper's worker-side-cache contract (§5) — so
the scheduler always reads slightly-stale state, which is exactly what
dead reckoning exists to correct.

Port of `repro.serving.cluster` (numpy, unchanged). The recovery and
overload managers the code reaches through `getattr(sim, ...)` are
`repro_torch.serving.recovery.RecoveryManager` (``sim.recovery``) and
`repro_torch.serving.overload.ElasticController` (``sim.overload``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import heapq
import itertools
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .affinity import SKETCH_SLOTS, PrefixSketch, prompt_signatures
from .request import Request
from .tiers import Tier


@dataclasses.dataclass
class _Seq:
    req: Request
    target_tokens: int          # true completion length for this model
    max_tokens: int             # dispatch-time clamp (budget worst case)
    budget_tokens: Optional[int]  # streaming early-stop bound
    generated: int = 0
    ctx: int = 0                # prompt + generated


class TelemetryArrays:
    """Structure-of-arrays telemetry over the full instance roster.

    The dict snapshots (`Instance.snapshot`) are the worker-side cache
    the paper describes; this is the scheduler-side columnar view of the
    same numbers, written in place at iteration boundaries so the hot
    path reads (I,) arrays instead of marshalling one dict per instance
    per batch.

    Incremental consumers (the fused hot path's device-resident state
    mirror) track two counters plus a per-row stamp instead of copying
    the whole view every batch:

      * `version` bumps on every write; `last_write[slot]` records the
        version at which each row last changed, so a reader that synced
        at version v refreshes exactly the rows with
        ``last_write > v`` — a handful of scatter rows per batch instead
        of a full (I,)x5 re-upload;
      * `roster_version` bumps only on roster-shape events (kill /
        revive). Those flip the alive mask, which incremental readers
        keep device-resident, so they fall back to a full reseed.

    Bulk in-place edits of the columns (test fixtures, benchmarks) must
    call `mark_all_dirty()` so stamp-based readers see them.
    """

    def __init__(self, instances: List["Instance"]):
        I = len(instances)
        self.pending = np.zeros(I)                  # pending decode tokens
        self.batch = np.zeros(I)                    # decode batch size
        self.free = np.array([i.tier.max_batch for i in instances], float)
        self.ctx = np.zeros(I)                      # mean context length
        self.queue = np.zeros(I)                    # queue depth
        self.t = np.zeros(I)                        # snapshot timestamp
        self.max_batch = np.array([i.tier.max_batch for i in instances],
                                  float)
        self.alive = np.ones(I, bool)
        self.version = 0
        self.roster_version = 0
        self.last_write = np.zeros(I, np.int64)     # version stamp per row
        # prefix-cache affinity planes (serving.affinity): per-instance
        # sketch mirrors the decision backends score reuse against, and
        # a cumulative matched-token diagnostic. Dead-reckoned on the
        # SCHEDULER side (Instance.submit), not at iteration
        # boundaries, so they ride their own version counter: bumping
        # `version`/`last_write` here would make the fused mirror
        # re-pull d/b/free/ctx rows the worker never reported, and a
        # sketch write must never look like a telemetry heartbeat to
        # the staleness watchdog.
        self.prefix_sig = np.zeros((I, SKETCH_SLOTS), np.int32)
        self.prefix_hit = np.zeros(I)       # cumulative matched tokens
        self.prefix_version = 0

    def write(self, slot: int, pending: float, batch: int, free: int,
              ctx: float, queue: int, t: float):
        self.pending[slot] = pending
        self.batch[slot] = batch
        self.free[slot] = free
        self.ctx[slot] = ctx
        self.queue[slot] = queue
        self.t[slot] = t
        self.version += 1
        self.last_write[slot] = self.version

    def write_prefix(self, slot: int, sketch: PrefixSketch,
                     hit_tokens: float = 0.0):
        """Mirror an instance's prefix sketch into its `prefix_sig` row
        (dead-reckoned at dispatch) and accrue the matched tokens the
        dispatch was credited with. Deliberately does NOT touch
        `version`/`last_write` — see the class docstring."""
        sketch.mirror(out=self.prefix_sig[slot])
        self.prefix_hit[slot] += hit_tokens
        self.prefix_version += 1

    def clear_prefix(self, slot: int):
        """Drop a row's prefix credit (instance failure: the cache died
        with the node, and a revived instance comes back cold)."""
        self.prefix_sig[slot, :] = 0
        self.prefix_version += 1

    def dirty_rows(self, since: int) -> np.ndarray:
        """Rows written after version `since` (ascending slot order)."""
        return np.flatnonzero(self.last_write > since)

    def mark_all_dirty(self):
        """Stamp every row as freshly written — required after editing
        the columns in place (rather than through `write`)."""
        self.version += 1
        self.last_write[:] = self.version

    def kill(self, slot: int):
        self.alive[slot] = False
        self.version += 1
        self.roster_version += 1

    def revive(self, slot: int, t: float):
        """Recovered instance re-enters the roster with a clean slate
        (it lost all running/queued work when it failed)."""
        self.alive[slot] = True
        self.roster_version += 1
        self.write(slot, pending=0.0, batch=0, free=int(self.max_batch[slot]),
                   ctx=0.0, queue=0, t=t)

    def quarantine(self, slot: int):
        """Mask a stale row exactly like a dead one (the telemetry
        watchdog's path): an alive-mask flip + `roster_version` bump, so
        incremental readers full-reseed at the shapes they already run
        — quarantine churn never adds a kernel shape variant. The
        instance itself keeps serving what it has; it just receives no
        new dispatches until the row is released."""
        self.alive[slot] = False
        self.version += 1
        self.roster_version += 1

    def unquarantine(self, slot: int):
        """Release a quarantined row back into the roster. The caller
        reseeds the row with a fresh `write` (the instance was serving
        the whole time, so — unlike `revive` — its true state is not a
        clean slate)."""
        self.alive[slot] = True
        self.version += 1
        self.roster_version += 1


class Instance:
    def __init__(self, iid: str, tier: Tier, model_idx: int, sim: "ClusterSim"):
        self.iid = iid
        self.tier = tier
        self.model_idx = model_idx
        self.sim = sim
        self.slot = 0               # row in ClusterSim.tel (set by the sim)
        # FIFO of (req, pred_len); deque so _admit pops are O(1) even
        # when overload piles thousands of requests behind one instance
        self.queue: Deque[Tuple[Request, float]] = collections.deque()
        self.running: List[_Seq] = []
        self.iter_scheduled = False
        self.busy_until = 0.0
        self.alive = True
        self.epoch = 0              # bumped on fail(): one life = one epoch
        self.quarantined = False    # watchdog-masked (tel row dark)
        self.tel_mute = False       # blackout: stop publishing telemetry
        self.slowdown = 1.0         # >1 = straggler (hidden from telemetry)
        # dead-reckoned model of this instance's prefix cache
        # (serving.affinity): credited at submit, cleared on fail
        self.sketch = PrefixSketch()
        # telemetry snapshot (refreshed at iteration boundaries)
        self.snapshot: Dict = self._idle_snapshot(0.0)
        self.total_tokens = 0

    def _idle_snapshot(self, t: float) -> Dict:
        return {"queue_depth": 0, "pending_decode": 0.0, "batch_size": 0,
                "free_slots": self.tier.max_batch, "mean_ctx": 0.0,
                "t": t}

    # -- scheduler-facing ---------------------------------------------------
    def submit(self, req: Request, t: float, pred_len: float,
               max_tokens: Optional[int]):
        req.instance = self.iid
        req.model_idx = self.model_idx
        req.dispatch_time = t
        req.pred_len = pred_len
        req.max_tokens = max_tokens
        # prefix-cache dead reckoning, here because submit is the ONE
        # dispatch funnel (windowed engine, station drain, AND the
        # hedge's direct re-submit): stamp the achieved hit against the
        # sketch as it stands, then credit the sketch and refresh the
        # scheduler-side mirror. A requeued retry re-hashes against the
        # CURRENT target — never the cache its failed victim lost.
        sigs = prompt_signatures(req.prompt)
        hit_tok = self.sketch.hit_tokens(sigs, req.prompt.len_in)
        req.prefix_hit = hit_tok / max(float(req.prompt.len_in), 1.0)
        self.sketch.insert(sigs)
        self.sim.tel.write_prefix(self.slot, self.sketch, hit_tok)
        self.queue.append((req, pred_len))
        self._kick(t)

    def telemetry(self) -> Dict:
        return dict(self.snapshot)

    # -- engine -------------------------------------------------------------
    def _kick(self, t: float):
        if not self.iter_scheduled and self.alive:
            self.iter_scheduled = True
            # iterate events carry the epoch they were scheduled in: an
            # event from a previous life (pre-fail) is a no-op when it
            # fires, so it can never race a post-recovery chain
            self.sim.push(max(t, self.busy_until),
                          functools.partial(self._iterate, epoch=self.epoch))

    def _admit(self, t: float) -> float:
        """Admit queued requests into free slots; returns prefill seconds."""
        dt = 0.0
        while self.queue and len(self.running) < self.tier.max_batch:
            req, pred_len = self.queue.popleft()
            true_len = int(req.true_length[self.model_idx])
            # None means "no dispatch-time clamp"; 0 is a real (1-token,
            # see the post-increment limit check) budget, not unlimited
            max_tok = req.max_tokens if req.max_tokens is not None else 10 ** 9
            budget_tok = None
            if req.budget is not None:
                # streaming early-stop: remaining budget at output prices
                in_cost = req.prompt.len_in * self.tier.price_in / 1e6
                rem = max(req.budget - in_cost, 0.0)
                budget_tok = int(rem / (self.tier.price_out / 1e6 + 1e-30))
            # matched-prefix KV reuse skips the cached share of prefill
            # — the physical effect the affinity term routes toward
            # (the cache exists whether or not the scheduler scores it,
            # so incidental hits discount the affinity-off arms too)
            dt += (self.tier.prefill_time(req.prompt.len_in)
                   * self.slowdown * (1.0 - req.prefix_hit))
            req.first_token_time = t + dt
            self.running.append(_Seq(
                req=req, target_tokens=true_len, max_tokens=max_tok,
                budget_tokens=budget_tok, ctx=req.prompt.len_in))
        return dt

    def _iterate(self, t: float, epoch: Optional[int] = None):
        if epoch is not None and epoch != self.epoch:
            return                  # stale event from a previous life
        self.iter_scheduled = False
        if not self.alive:
            return
        dt = self._admit(t)
        if self.running:
            b = len(self.running)
            mean_ctx = sum(s.ctx for s in self.running) / b
            dt += self.tier.tpot(b, mean_ctx) * self.slowdown
            done = []
            for s in self.running:
                s.generated += 1
                s.ctx += 1
                self.total_tokens += 1
                limit = min(s.target_tokens, s.max_tokens,
                            s.budget_tokens if s.budget_tokens is not None
                            else 10 ** 9)
                if s.generated >= limit:
                    done.append(s)
            for s in done:
                self.running.remove(s)
                r = s.req
                r.finish_time = t + dt
                r.tokens_out = s.generated
                r.exhausted = s.generated < s.target_tokens
                self.sim.completed.append(r)
        self.busy_until = t + dt
        self.snapshot = {
            "queue_depth": len(self.queue),
            "pending_decode": float(sum(
                max(min(s.max_tokens,
                        int(s.req.pred_len) if s.req.pred_len is not None
                        else s.max_tokens)
                    - s.generated, 1) for s in self.running)),
            "batch_size": len(self.running),
            "free_slots": self.tier.max_batch - len(self.running),
            "mean_ctx": (sum(s.ctx for s in self.running)
                         / max(len(self.running), 1)),
            "t": t + dt,
        }
        if not self.tel_mute:
            # telemetry blackout: the worker keeps its own snapshot
            # fresh but the scheduler-side mirror goes dark — the
            # staleness the telemetry watchdog exists to catch
            self.sim.tel.write(self.slot, self.snapshot["pending_decode"],
                               self.snapshot["batch_size"],
                               self.snapshot["free_slots"],
                               self.snapshot["mean_ctx"],
                               self.snapshot["queue_depth"], t + dt)
        if self.running or self.queue:
            self.sim.push(t + dt,
                          functools.partial(self._iterate, epoch=self.epoch))
            self.iter_scheduled = True

    def fail(self):
        """Node failure: mark dead; running + queued requests either
        re-enter the scheduler's admission path (when the sim carries a
        `RecoveryManager`, `sim.recovery` — see
        `repro_torch.serving.recovery`) or fail terminally.

        Terminally failed requests get the failure instant stamped as
        their finish_time — they really do leave the system at that
        moment, and metrics' wall-clock span and per-tenant denominators
        would otherwise skew on failure-heavy cells."""
        self.alive = False
        # new epoch: any _iterate event still in the heap belongs to the
        # old life and no-ops when it fires, so the flag can be reset
        # here and recover() can start a fresh chain immediately
        self.epoch += 1
        self.iter_scheduled = False
        self.quarantined = False
        # the KV cache dies with the node: drop the sketch AND its
        # scheduler-side mirror, so retries/hedges of the victims are
        # never scored against credit this instance no longer holds,
        # and a later recover() re-enters cold
        self.sketch.clear()
        self.sim.tel.clear_prefix(self.slot)
        self.sim.tel.kill(self.slot)
        victims = ([(s.req, s.generated) for s in self.running]
                   + [(req, 0) for req, _ in self.queue])
        self.running = []
        self.queue.clear()
        mgr = getattr(self.sim, "recovery", None)
        for req, lost in victims:
            if mgr is not None and mgr.on_failure(req, self, lost,
                                                  self.sim.now):
                continue            # requeued for retry — not terminal
            req.failed = True
            if req.finish_time is None:
                req.finish_time = self.sim.now
            self.sim.completed.append(req)

    def cancel(self, req: Request) -> Optional[int]:
        """Withdraw a request without completing it (the hedge loser's
        path): remove it from the queue or the running batch. Returns
        the tokens it had already generated here — duplicate work the
        hedge spent — or None when the request is not on this instance
        (it already finished or was never dispatched here)."""
        for j, (r, _) in enumerate(self.queue):
            if r is req:
                del self.queue[j]
                return 0
        for s in self.running:
            if s.req is req:
                self.running.remove(s)
                return s.generated
        return None

    def recover(self, t: float):
        """Node recovery: re-enter the roster with a genuinely clean
        slate — empty engine, healthy speed (a recovered node is a
        replacement, not the same degraded hardware). With no
        `sim.recovery` armed, failed work is not replayed — the paper's
        fleet treats failed requests as lost."""
        if self.alive:
            return
        self.alive = True
        self.busy_until = t
        # fail() reset iter_scheduled and bumped the epoch, so a
        # pre-failure _iterate still pending in the heap is inert — a
        # new submit can safely start a fresh single iteration chain
        # (pinned by tests/test_recovery.py::test_stale_iterate_epoch)
        self.iter_scheduled = False
        self.quarantined = False
        self.tel_mute = False
        self.slowdown = 1.0
        self.snapshot = self._idle_snapshot(t)
        self.sim.tel.revive(self.slot, t)

    def set_slowdown(self, factor: float):
        """Straggler injection: scale this instance's real prefill/decode
        time by `factor` (>1 = slower). Telemetry is NOT adjusted — the
        scheduler's TPOT heads keep predicting healthy-node speed, which
        is exactly the model-mismatch stress the paper's dead-reckoning
        arm is meant to survive."""
        self.slowdown = float(factor)


class ClusterSim:
    """Event-driven cluster + pluggable scheduler callback."""

    def __init__(self, tiers: List[Tier], model_names: List[str],
                 seed: int = 0):
        self.tiers = tiers
        self.model_names = model_names
        self.instances: List[Instance] = []
        for tier in tiers:
            midx = model_names.index(tier.model)
            for j in range(tier.n_instances):
                self.instances.append(
                    Instance(f"{tier.name}#{j}", tier, midx, self))
        self.by_id = {i.iid: i for i in self.instances}
        for slot, inst in enumerate(self.instances):
            inst.slot = slot
        self.tel = TelemetryArrays(self.instances)
        self.completed: List[Request] = []
        self._events: List = []
        self._counter = itertools.count()
        self.now = 0.0

    def push(self, t: float, fn: Callable[[float], None]):
        heapq.heappush(self._events, (t, next(self._counter), fn))

    def run(self, until: float = float("inf")):
        while self._events:
            t, _, fn = heapq.heappop(self._events)
            if t > until:
                heapq.heappush(self._events, (t, next(self._counter), fn))
                break
            self.now = t
            fn(t)

    def telemetry(self) -> Dict[str, Dict]:
        return {i.iid: i.telemetry() for i in self.instances
                if i.alive}

    def alive_instances(self) -> List[Instance]:
        return [i for i in self.instances if i.alive]

    def has_noncontrol_events(self) -> bool:
        """True while the heap holds anything besides controller
        self-loops (overload detector, telemetry watchdog). Periodic
        controllers re-arm on THIS predicate instead of bare
        `sim._events`, so two controllers can never keep each other —
        and the run — alive forever."""
        for _, _, fn in self._events:
            owner = getattr(fn, "__self__", None)
            if owner is not None and getattr(owner, "_is_controller",
                                             False):
                continue
            return True
        return False
