"""Per-cell metric aggregation: the paper's four axes + residual
decomposition + tails + per-tenant SLO breakdowns.

Port of `repro.serving.metrics` (numpy, unchanged)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .request import Request
from .tiers import Tier


def _pct(x, p):
    return float(np.percentile(x, p)) if len(x) else float("nan")


def check_terminal_states(reqs: List[Request]):
    """Terminal-state invariant: every request that entered the system
    ends in EXACTLY one of {served, failed, shed}. The fault-tolerant
    lifecycle (retry/requeue, hedged re-dispatch, controller
    crash/restore) makes this worth asserting at aggregation time —
    a request silently dropped by a failure path, or double-terminated
    by a retry racing a hedge, corrupts every rate metric downstream.
    """
    for r in reqs:
        assert not (r.failed and r.shed), \
            f"rid={r.rid}: both failed and shed"
        if r.shed:
            assert r.finish_time is None, \
                f"rid={r.rid}: shed but has finish_time"
        elif r.failed:
            assert r.finish_time is not None, \
                f"rid={r.rid}: failed without a terminal timestamp"
        else:
            assert r.finish_time is not None, \
                f"rid={r.rid}: lost — neither served, failed, nor shed"


def aggregate(reqs: List[Request], tiers: List[Tier],
              model_names: List[str], wall: Optional[float] = None,
              slo_s: float = 30.0, strict: bool = True) -> Dict:
    """`slo_s`: end-to-end latency SLO for the goodput metric (served
    requests finishing within the SLO, per wall second). `strict`
    asserts the terminal-state invariant over the whole stream (opt out
    only for deliberately-truncated partial traces, e.g. a checkpoint
    taken mid-run)."""
    if strict:
        check_terminal_states(reqs)
    done = [r for r in reqs
            if r.finish_time is not None and not r.failed and not r.shed]
    failed = [r for r in reqs if r.failed]
    shed = [r for r in reqs if r.shed]
    e2e = np.array([r.e2e for r in done])
    ttft = np.array([r.ttft for r in done if r.ttft is not None])
    lookup_q = np.array([r.lookup_quality() for r in done])
    served_q = np.array([r.served_quality() for r in done])
    tier_by_model = {t.model: t for t in tiers}
    costs = []
    for r in done:
        t = tier_by_model[model_names[r.model_idx]]
        costs.append(t.cost(r.prompt.len_in, r.tokens_out))
    costs = np.asarray(costs)
    if wall is None:
        # span over EVERY request that left the system (served or
        # failed) — a done-only max under-reports the wall on
        # failure-heavy cells and inflates goodput/throughput
        ends = [r.finish_time for r in reqs if r.finish_time is not None]
        if ends:
            wall = max(ends) - min(r.arrival for r in reqs)
    mix = {}
    for r in done:
        m = model_names[r.model_idx]
        mix[m] = mix.get(m, 0) + 1
    mix = {m: c / max(len(done), 1) for m, c in sorted(mix.items())}
    resid = np.array([(r.sched_compute + r.sched_batch_wait
                       + r.sched_stats_fetch + r.router_queue_wait)
                      for r in done])
    return {
        "tenants": tenant_breakdown(reqs, wall, slo_s=slo_s),
        "priorities": priority_breakdown(reqs, wall, slo_s=slo_s),
        "n": len(done), "failed": len(failed),
        "shed": len(shed),
        "shed_rate": len(shed) / max(len(reqs), 1),
        "quality": float(lookup_q.mean()) if len(done) else 0.0,
        "served_quality": float(served_q.mean()) if len(done) else 0.0,
        "mean_e2e": float(e2e.mean()) if len(done) else float("nan"),
        "p50_e2e": _pct(e2e, 50),
        "p95_e2e": _pct(e2e, 95), "p99_e2e": _pct(e2e, 99),
        "goodput": (float((e2e <= slo_s).sum()) / wall
                    if wall and len(done) else 0.0),
        "mean_ttft": float(ttft.mean()) if len(ttft) else float("nan"),
        "p99_ttft": _pct(ttft, 99),
        # mean matched-prefix fraction at final dispatch (the KV-cache
        # reuse the affinity term routes for; serving.affinity)
        "cache_hit_rate": float(np.mean([r.prefix_hit for r in done]))
        if done else 0.0,
        "cost_per_req": float(costs.mean()) if len(done) else 0.0,
        "throughput": len(done) / wall if wall else 0.0,
        "mix": mix,
        # fault-tolerant lifecycle accounting (repro.serving.recovery):
        # retried/hedged requests that ultimately SERVED, plus the
        # duplicate work burned to get them there
        "retried": sum(1 for r in done if r.attempt > 0),
        "hedged": sum(1 for r in done if r.hedges > 0),
        "wasted_tokens": int(sum(r.wasted_tokens for r in reqs)),
        "exhausted_frac": float(np.mean([r.exhausted for r in done]))
        if done else 0.0,
        "mean_residual": float(resid.mean()) if len(done) else 0.0,
        "residual_compute": float(np.mean(
            [r.sched_compute for r in done])) if done else 0.0,
        "residual_batch_wait": float(np.mean(
            [r.sched_batch_wait for r in done])) if done else 0.0,
        "residual_stats_fetch": float(np.mean(
            [r.sched_stats_fetch for r in done])) if done else 0.0,
        "residual_router_queue": float(np.mean(
            [r.router_queue_wait for r in done])) if done else 0.0,
    }


def tenant_breakdown(reqs: List[Request], wall: Optional[float],
                     slo_s: float = 30.0) -> Dict[str, Dict]:
    """Per-`TenantSpec` SLO view of a cell: one entry per tenant class
    in the trace (empty dict for single-class streams built outside the
    scenario subsystem), with the latency tail and goodput the tenant
    actually experienced — the multi-tenant isolation axis the
    composite scenarios exist to expose. Surfaced as `t_<name>_p50` /
    `_p99` / `_goodput` columns in `BENCH_sweep.json` and
    `BENCH_frontier.json`."""
    names = sorted({r.tenant for r in reqs if r.tenant is not None})
    out: Dict[str, Dict] = {}
    for name in names:
        mine = [r for r in reqs if r.tenant == name]
        done = [r for r in mine
                if r.finish_time is not None and not r.failed
                and not r.shed]
        e2e = np.array([r.e2e for r in done])
        within = int((e2e <= slo_s).sum()) if len(done) else 0
        out[name] = {
            "n": len(done),
            "failed": sum(r.failed for r in mine),
            "shed": sum(r.shed for r in mine),
            "p50_e2e": _pct(e2e, 50),
            "p99_e2e": _pct(e2e, 99),
            "goodput": (within / wall if wall and len(done) else 0.0),
            # SLO attainment over everything the tenant SENT — failed
            # and shed requests count against the tenant, not nowhere
            "slo_attainment": within / max(len(mine), 1),
            "quality": (float(np.mean([r.lookup_quality()
                                       for r in done]))
                        if done else 0.0),
        }
    return out


def priority_breakdown(reqs: List[Request], wall: Optional[float],
                       slo_s: float = 30.0) -> Dict[int, Dict]:
    """Per-priority-class SLO view (0 = premium): what admission
    shedding buys the premium class and charges the batch class.
    Surfaced as `prio<k>_goodput` / `prio<k>_shed` columns in
    `BENCH_elastic.json`. Empty for single-class streams (all
    priority 0, no sheds) to keep legacy cells noise-free."""
    classes = sorted({int(r.priority) for r in reqs})
    if classes == [0] and not any(r.shed for r in reqs):
        return {}
    out: Dict[int, Dict] = {}
    for p in classes:
        mine = [r for r in reqs if int(r.priority) == p]
        done = [r for r in mine
                if r.finish_time is not None and not r.failed
                and not r.shed]
        e2e = np.array([r.e2e for r in done])
        within = int((e2e <= slo_s).sum()) if len(done) else 0
        out[p] = {
            "n": len(mine),
            "shed": sum(r.shed for r in mine),
            "failed": sum(r.failed for r in mine),
            "p99_e2e": _pct(e2e, 99),
            "goodput": (within / wall if wall and len(done) else 0.0),
            "slo_attainment": within / max(len(mine), 1),
        }
    return out
