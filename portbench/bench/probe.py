"""The benchmark's own spans around the calls into each layer, taken with
the host clock from outside the program.

`Probe.install` wraps, on the scheduler's objects (never its code):

  * the scheduler's `enqueue` (ingest: the engine's, or the hierarchy's
    placement plus the cell engine's);
  * in the hierarchy, the balancer's `pick` (placement, nested in
    ingest) and `_tick` (one digest heartbeat);
  * each engine's `_fire` (a batch decision: from the fire of a window
    until the decision's outputs are on the host and dispatched; the
    fetch waits on the kernel's event, so the span ends after the device
    has finished);
  * each simulated instance's `submit` (the fleet receiving a request:
    its prefix sketch, telemetry writes and event queue). The instances
    stand in for other machines, so the time inside `submit` is taken
    out of whichever span it lies in, and in a traced run it is marked
    as a "fleet" range inside the span.

Spans are kept in memory. Recording for the output check (telemetry
snapshots, the program's answers, the balancer's events) happens outside
the timed spans. A checked batch's snapshot also holds its session
turns' tokens where the stream has sessions, and the prefix plane
(`tel.prefix_sig`) where the engine's affinity weight is above 0.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..yard.reference import Batch


class Probe:
    def __init__(self, stream, prompt_rows: np.ndarray, reqs,
                 check_rng: Optional[np.random.Generator],
                 check_share: float, check_max: int, record_events: bool,
                 annotate=None):
        self.stream = stream
        self.prompt_rows = prompt_rows  # each request's row in the world
        self.reqs = reqs
        self.rng = check_rng
        self.share = check_share
        self.check_max = check_max
        self.annotate = annotate      # a context-manager factory, or None
        self.on = False               # inside the measured window
        self.ingest_s = np.zeros(stream.n)   # every request's ingest
        self.ingest_win_s = 0.0              # ingest inside the window
        self.place_s = 0.0
        self.digest_s = 0.0
        self.fire_s = 0.0             # every fire in the window
        self.fleet_s = 0.0            # inside the instances' submit
        self.batches: List = []       # (rows, seconds) of decided batches
        self.checked: List[Batch] = []
        self.n_fires = 0
        self.events: List = []        # the balancer's beats and picks
        self.record_events = record_events
        self.cur_rows = 0             # rows of the batch being decided

    # -- wrappers -----------------------------------------------------------
    def install(self, scheduler, sim):
        """Wrap the ingest, the balancer (if any) and every instance's
        `submit`; each engine's fire is wrapped once the scheduler has
        attached (`wrap_engines`)."""
        enqueue = scheduler.enqueue
        ingest_s = self.ingest_s
        probe = self

        def timed_enqueue(req, t):
            f0 = probe.fleet_s
            t0 = time.perf_counter()
            enqueue(req, t)
            dt = time.perf_counter() - t0 - (probe.fleet_s - f0)
            ingest_s[req.rid] += dt
            if probe.on:
                probe.ingest_win_s += dt
        self.enqueue = self._annotated(timed_enqueue, "ingest")
        bal = getattr(scheduler, "balancer", None)
        if bal is not None:
            self._wrap_balancer(bal, sim)
        for inst in sim.instances:
            inst.submit = self._timed_submit(inst.submit)

    def _timed_submit(self, submit):
        submit = self._annotated(submit, "fleet")
        probe = self

        def timed_submit(*a, **kw):
            t0 = time.perf_counter()
            submit(*a, **kw)
            probe.fleet_s += time.perf_counter() - t0
        return timed_submit

    def _annotated(self, fn, name):
        if self.annotate is None:
            return fn

        def run(*a, **kw):
            with self.annotate(name):
                return fn(*a, **kw)
        return run

    def _wrap_balancer(self, bal, sim):
        pick, tick = bal.pick, bal._tick
        probe = self

        def timed_pick(t, viable):
            t0 = time.perf_counter()
            ci = pick(t, viable)
            dt = time.perf_counter() - t0
            if probe.on:
                probe.place_s += dt
            if probe.record_events:
                probe.events.append(("pick", t, ci))
            return ci

        def timed_tick(t):
            if probe.record_events:
                tel = sim.tel
                probe.events.append(("beat", t, {
                    "alive": tel.alive.copy(), "batch": tel.batch.copy(),
                    "pending": tel.pending.copy(), "queue": tel.queue.copy(),
                    "free": tel.free.copy()}))
            t0 = time.perf_counter()
            tick(t)
            dt = time.perf_counter() - t0
            if probe.on:
                probe.digest_s += dt
        bal.pick = timed_pick
        bal._tick = self._annotated(timed_tick, "digest")

    def wrap_engines(self, scheduler):
        from .fleet import engines_of
        for c, eng in enumerate(engines_of(scheduler)):
            eng._fire = self._annotated(self._timed_fire(eng, c), "decide")

    def _timed_fire(self, eng, cell: int):
        fire = eng._fire
        probe = self
        slot_of = {inst.iid: k for k, inst in enumerate(eng.sim.instances)}
        affinity = eng.policy.cfg.affinity_weight > 0.0
        tokens = self.stream.tokens

        def timed_fire(t):
            rows = [r.rid for r in eng.waiting]
            snap = None
            if rows and probe.on:
                probe.n_fires += 1
                if (probe.rng is not None and len(probe.checked)
                        < probe.check_max and probe.rng.uniform()
                        < probe.share):
                    tel = eng.sim.tel
                    snap = [a.copy() for a in (tel.pending, tel.batch,
                                               tel.free, tel.ctx, tel.alive)]
                    snap.append(None if tokens is None
                                else [tokens[r] for r in rows])
                    snap.append(tel.prefix_sig.copy() if affinity else None)
            probe.cur_rows = len(rows)
            f0 = probe.fleet_s
            t0 = time.perf_counter()
            fire(t)
            dt = time.perf_counter() - t0 - (probe.fleet_s - f0)
            if not probe.on:
                return
            probe.fire_s += dt
            if rows:
                probe.batches.append((rows, dt))
            if snap is not None:
                reqs = [probe.reqs[r] for r in rows]
                probe.checked.append(Batch(
                    prompts=probe.prompt_rows[rows],
                    budget=probe.stream.budget[rows], len_in=np.array(
                        [r.prompt.len_in for r in reqs], np.float64),
                    pending=snap[0], batch=snap[1], free=snap[2],
                    ctx=snap[3], alive=snap[4],
                    choice=np.array([slot_of[r.instance] for r in reqs]),
                    l_chosen=np.array([r.pred_len for r in reqs]),
                    cell=cell, tokens=snap[5], prefix_sig=snap[6]))
        return timed_fire

    # -- the window's numbers -----------------------------------------------
    def controller_s(self) -> float:
        """The controller's time in the window: ingest, decision and
        digest spans (placement lies inside ingest), each without the
        time inside the instances' `submit`."""
        return self.ingest_win_s + self.fire_s + self.digest_s

    def per_request_ms(self) -> np.ndarray:
        """Each request decided in the window: its ingest span (which
        may lie before the window) plus the span of its batch."""
        out = [self.ingest_s[rows] + dt for rows, dt in self.batches]
        return np.concatenate(out) * 1e3 if out else np.zeros(0)
