"""Shared helpers of the port's scenario tests (not a test module): build
a scenario in both packages with the port's estimator bundle bridged from
the reference's weights, run one cell on each, and compare the results.

The reference decides on its "fused" backend, the port on "megakernel"
(the kernel's plain version on the CPU), both with
`charge_compute=False`, so the simulated clock never reads the wall
clock. The port's request stream takes the reference's ingest
embeddings, so a difference is the decision's or the simulator's."""
import contextlib
import dataclasses

import numpy as np


def port_bundle(ref_bundle, tiers, names):
    """The port's `EstimatorBundle` on the CPU from the reference's
    trained weights (numpy only)."""
    from repro_torch.estimators.bridge import bundle_from_arrays

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [arrays(v) for v in tree]
        return np.asarray(tree)

    heads = [{"name": t.name,
              "nominal_tpot": ref_bundle.heads[t.name].nominal_tpot,
              "packed": (None if ref_bundle.heads[t.name].model is None
                         else ref_bundle.heads[t.name].model.pack())}
             for t in tiers]
    return bundle_from_arrays(
        arrays(ref_bundle.encoder.params), ref_bundle.knn._x,
        ref_bundle.knn._quality, ref_bundle.knn._length, heads, names,
        device="cpu")


def build_pair(ref_scenario, port_scenario, dataset_n):
    """(reference run, port run) of one scenario, the port's bundle
    bridged from the reference's and put in the run's cache."""
    rrun = ref_scenario.build(dataset_n=dataset_n)
    prun = port_scenario.build(dataset_n=dataset_n)
    assert [t.name for t in prun.tiers] == [t.name for t in rrun.tiers]
    assert prun.reserve_iids == rrun.reserve_iids
    prun._bundle = port_bundle(rrun.bundle(), rrun.tiers, rrun.names)
    return rrun, prun


def completions(reqs):
    """What a request's life came to: the tuple the crash/restore and
    parity checks compare."""
    return [(r.rid, r.finish_time, r.tokens_out, r.model_idx, r.instance,
             bool(r.failed), r.attempt, r.hedges, bool(r.shed))
            for r in reqs]


def same(a, b) -> bool:
    """Equality that takes NaN to equal NaN, through dicts and lists."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


WALL_CLOCK = ("measured_decide_ms_mean", "measured_decide_ms_per_req")


def assert_metrics_equal(rm, pm):
    """Every `run_cell` metric equal, the overload and recovery counters
    included; only the measured wall-clock decision times differ."""
    assert rm.keys() == pm.keys()
    for k in rm:
        if k not in WALL_CLOCK:
            assert same(rm[k], pm[k]), (k, rm[k], pm[k])


def arm_scenario(rrun, prun, schedule=None, recovery="scenario"):
    """Set both runs' schedule (default: the scenario's own as built) and
    recovery config (default: the scenario's own; None disarms it) for
    the cells that follow."""
    from repro_torch.serving.recovery import RecoveryConfig as PortRC

    for run, rc in ((rrun, None), (prun, PortRC)):
        # a run's scenario as built, before any cell rebound it
        base = run.__dict__.setdefault("_built_scenario", run.scenario)
        if recovery == "scenario":
            run.recovery = base.recovery
        else:
            run.recovery = (None if recovery is None else
                            recovery if rc is None else
                            rc(**dataclasses.asdict(recovery)))
        run.scenario = (base if schedule is None else dataclasses.replace(
            base, schedule=schedule(run.tiers)))


def run_pair(rrun, prun, schedule=None, recovery="scenario", n=120,
             lam_scale=1.0, seed=0, **rb_kw):
    """One cell on each package: the scenario's roster and tenants, the
    given schedule (default: the scenario's own) and recovery config
    (default: the scenario's own; None disarms it). Returns
    ((ref reqs, ref metrics), (port reqs, port metrics, port engine))."""
    import repro.core as R
    import repro_torch.core as P

    arm_scenario(rrun, prun, schedule, recovery)
    rreqs = rrun.requests(n, lam_scale=lam_scale, seed=seed)
    rb = R.RouteBalance(R.RBConfig(decision_backend="fused",
                                   charge_compute=False, **rb_kw),
                        rrun.bundle(), rrun.tiers)
    rm = rrun.run_cell(rb, rreqs, seed=0)
    preqs = prun.requests(n, lam_scale=lam_scale, seed=seed)
    assert preqs[0].cols.emb is None
    preqs[0].cols.emb = rreqs[0].cols.emb   # the reference's ingest rows
    pb = P.RouteBalance(P.RBConfig(charge_compute=False, **rb_kw),
                        prun.bundle(), prun.tiers)
    pm = prun.run_cell(pb, preqs, seed=0)
    return (rreqs, rm), (preqs, pm, pb)


@contextlib.contextmanager
def k1_scan_states():
    """Record the post-scan state of every decision-kernel call the
    port's hot path makes inside the block: one (d1, b1, f1) triple of
    (K, I) tensors per call, in call order. The wrapper reads its tap
    and counts off its module's name, so the recorder carries them
    while it stands in, and hands its counts back."""
    from repro_torch.core import hotpath
    real = hotpath.k1.decision_megakernel
    seen = []

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[3:])
        return out
    record.tap = real.tap
    record.launches = record.plain_calls = 0
    hotpath.k1.decision_megakernel = record
    try:
        yield seen
    finally:
        hotpath.k1.decision_megakernel = real
        real.launches += record.launches
        real.plain_calls += record.plain_calls


def assert_kernel_calls(pm, pb):
    """Every fired batch the recovery manager did not decide on its
    degraded path (`degraded_batches`) went through one decision-kernel
    call, and the calls ran at one shape per R bucket: roster churn
    (kill, revive, quarantine, autoscale) added none. Degraded batches
    are among the fired ones, so where there are some the kernel saw a
    subset of the buckets."""
    from repro_torch.core.decision import bucket_pow2
    hp = pb._fused
    mgr = getattr(pb.sim, "recovery", None)
    degraded = mgr.degraded_batches if mgr is not None else 0
    assert (degraded > 0) == bool(pm.get("degraded_decisions"))
    assert hp.stats["calls"] == len(pb.compute_log) - degraded > 0
    buckets = {bucket_pow2(s) for s, _ in pb.compute_log}
    if degraded:
        assert hp.shape_variants() <= len(buckets)
    else:
        assert hp.shape_variants() == len(buckets)
