"""Serving-cell driver: arrivals -> scheduler -> cluster -> metrics.

Port of `repro.core.driver` (lines 21-123). One ``run_cell`` = one
configuration cell of the paper's evaluation (fixed scheduler, weights,
arrival rate, prompt set), optionally under a scenario's perturbation
schedule and with overload and recovery controllers armed on the sim.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..serving.cluster import ClusterSim
from ..serving.metrics import aggregate
from ..serving.request import Request, RequestColumns
from ..serving.tiers import Tier
from ..serving.world import Dataset


def make_requests(dataset: Dataset, which: str, arrivals: np.ndarray,
                  budgets: Optional[np.ndarray] = None,
                  limit: Optional[int] = None,
                  encoder=None) -> List[Request]:
    """Build a request stream plus its SoA ingest columns, once, at
    workload-generation time. Pass `encoder` (e.g. ``bundle.encoder``)
    to pre-fill the prompt-embedding column; otherwise the first
    scheduler to see the stream fills it at enqueue time."""
    prompts, Q, L = dataset.split(which)
    n = len(arrivals) if limit is None else min(limit, len(arrivals))
    reqs = []
    for i in range(n):
        j = i % len(prompts)
        reqs.append(Request(
            rid=i, prompt=prompts[j], arrival=float(arrivals[i]),
            true_quality=Q[j], true_length=L[j],
            budget=None if budgets is None or np.isnan(budgets[i])
            else float(budgets[i])))
    cols = RequestColumns.from_requests(reqs)
    if encoder is not None:
        cols.ensure_embeddings(encoder)
    return reqs


def run_cell(scheduler, tiers: Sequence[Tier], model_names: List[str],
             requests: List[Request], seed: int = 0,
             fail_at: Optional[Dict] = None,
             schedule: Optional[Sequence] = None,
             schedule_seed: int = 0,
             setup: Optional[Callable[[ClusterSim], None]] = None) -> Dict:
    """fail_at: optional {time: t, instances: [iids]} failure injection.
    schedule: optional scenario perturbation schedule (a sequence of
    `repro_torch.serving.scenarios.FailureEvent`) armed on the sim.
    setup: optional hook called on the fresh sim before the scheduler
    attaches — the arming point for overload control
    (`repro_torch.serving.overload.arm_elastic`) and recovery
    (`repro_torch.serving.recovery.arm_recovery`)."""
    sim = ClusterSim(list(tiers), model_names, seed=seed)
    if setup is not None:
        setup(sim)
    if hasattr(scheduler, "expected"):
        scheduler.expected = len(requests)
    scheduler.attach(sim)
    for r in requests:
        sim.push(r.arrival, lambda t, rr=r: scheduler.enqueue(rr, t))
    if fail_at:
        def kill(t):
            for iid in fail_at["instances"]:
                sim.by_id[iid].fail()
        sim.push(fail_at["time"], kill)
    if schedule:
        from ..serving.scenarios import apply_schedule
        apply_schedule(sim, schedule, seed=schedule_seed)
    sim.run()
    # exactly-once delivery: the fault-tolerant lifecycle (retry,
    # hedging, controller restore) must terminate every request exactly
    # once — a double-append to `completed` means a request terminated
    # twice and the cell's rates are garbage
    seen_ids = {id(r) for r in sim.completed}
    if len(seen_ids) != len(sim.completed):
        raise RuntimeError(f"{len(sim.completed) - len(seen_ids)} requests "
                           "terminated more than once")
    wall = (max((r.finish_time or r.arrival) for r in requests)
            - min((r.first_arrival if r.first_arrival is not None
                   else r.arrival) for r in requests))
    out = aggregate(requests, list(tiers), model_names, wall)
    policy = getattr(scheduler, "policy", None)
    if policy is not None:
        out["policy"] = getattr(policy, "name", type(policy).__name__)
        ecfg = getattr(scheduler, "ecfg", None)
        if ecfg is not None:
            out["deployment"] = ecfg.deployment
    if getattr(scheduler, "compute_log", None):
        sizes = np.array([s for s, _ in scheduler.compute_log])
        times = np.array([dt for _, dt in scheduler.compute_log])
        out["measured_decide_ms_mean"] = float(times.mean() * 1e3)
        out["measured_decide_ms_per_req"] = float(
            times.sum() / max(sizes.sum(), 1) * 1e3)
        out["mean_batch_size"] = float(sizes.mean())
    ctl = getattr(sim, "overload", None)
    if ctl is not None:
        out["scale_ups"] = ctl.scale_ups
        out["scale_downs"] = ctl.scale_downs
        out["scale_up_lag_s"] = ctl.cfg.scale_up_lag_s
        out["peak_alive"] = ctl.peak_alive
    mgr = getattr(sim, "recovery", None)
    if mgr is not None:
        out["retries"] = mgr.retries
        out["gave_up"] = mgr.gave_up
        out["hedges"] = mgr.hedges
        out["duplicate_tokens"] = mgr.duplicate_tokens
        out["quarantines"] = mgr.quarantines
        out["degraded_decisions"] = mgr.degraded_decisions
    return out
