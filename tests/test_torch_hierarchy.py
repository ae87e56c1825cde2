"""The port's hierarchical scheduling against the JAX reference
(`repro_torch.serving.hierarchy`, `core.decision.sharded_greedy_scan`,
`distributed.{compression, elastic}`), mirroring `tests/test_hierarchy.py`
case for case, and adding the parity checks:

  * span routing: the port's staged torch backend with `shard_cells` in
    {2, 4} chooses, instance for instance, what the reference's "fused"
    backend with the same `shard_cells` chooses, and what the port's own
    unsharded torch backend chooses, on randomized mid-run telemetry
    with kill fractions 0 and 0.25;
  * the sharded scan is bitwise the port's `greedy_scan` (choice, est_T
    and the final d, b, free) in the four latency modes, with and
    without the affinity term;
  * balanced routing at 1 and 2 cells on `cluster` (80 requests, seed 1,
    with and without recovery): completions, placements per cell and
    digest wire bytes identical to the reference's, both on their
    default backends ("fused" there, "megakernel" here, its plain
    version on the CPU) with `charge_compute=False` and the port's
    bundle bridged from the reference's weights;
  * `encode_digest` bytes equal to the reference's in both codecs;
  * signature-twin cells each get their own hot-path runner, and a
    scheduler attached again, flat or in cells, decides on new ones.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_scenario_parity import build_pair, completions

_RUNS = {}


def _cluster():
    """(reference run, port run) of the `cluster` scenario at
    dataset_n=240, the port's bundle bridged from the reference's."""
    if "cluster" not in _RUNS:
        from repro.serving.scenarios import get_scenario as ref_scenario
        from repro_torch.serving.scenarios import get_scenario
        _RUNS["cluster"] = build_pair(ref_scenario("cluster"),
                                      get_scenario("cluster"), 240)
    return _RUNS["cluster"]


def _port():
    return _cluster()[1]


def _traj(reqs):
    return [(r.rid, r.instance, r.finish_time, r.tokens_out,
             bool(r.failed), bool(r.shed), r.attempt) for r in reqs]


def _requests(run, n, seed, like=None):
    """The port's requests, embedded with the reference stream's rows
    when `like` (the reference's requests) is given."""
    reqs = run.requests(n, seed=seed)
    if like is not None:
        reqs[0].cols.emb = like[0].cols.emb
    return reqs


def _arm_recovery(run, on):
    from repro_torch.serving.recovery import RecoveryConfig
    run.recovery = RecoveryConfig() if on else None


# -- partitioning -------------------------------------------------------------

@pytest.mark.parametrize("n_cells", [1, 2, 3, 4, 7])
def test_partition_roster_properties(n_cells):
    from repro.serving.cluster import ClusterSim as RefSim
    from repro.serving.hierarchy import partition_roster as ref_partition
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.hierarchy import partition_roster
    rrun, run = _cluster()
    sim = ClusterSim(run.tiers, run.names, seed=0)
    cells = partition_roster(sim.instances, n_cells)
    assert len(cells) == n_cells
    assert all(cells), "every cell must be non-empty"
    seen = [i.iid for cell in cells for i in cell]
    assert sorted(seen) == sorted(i.iid for i in sim.instances)
    assert len(seen) == len(set(seen))           # disjoint
    for cell in cells:
        slots = [i.slot for i in cell]
        assert slots == sorted(slots)            # parent-slot order
    for tier in {i.tier.name for i in sim.instances}:
        counts = [sum(1 for i in cell if i.tier.name == tier)
                  for cell in cells]
        assert max(counts) - min(counts) <= 1, (tier, counts)
    ref = ref_partition(RefSim(rrun.tiers, rrun.names, seed=0).instances,
                        n_cells)
    assert [[i.iid for i in c] for c in cells] == \
        [[i.iid for i in c] for c in ref]


def test_hierarchy_config_validation():
    from repro_torch.serving.hierarchy import HierarchyConfig
    for kw in (dict(routing="nope"), dict(n_cells=0),
               dict(digest_interval_s=0.0),
               dict(digest_interval_s=1.0, digest_stale_s=0.5),
               dict(digest_mode="fp16")):
        with pytest.raises(ValueError):
            HierarchyConfig(**kw)


# -- the cell telemetry mirror ------------------------------------------------

def test_cell_telemetry_mirror_refresh():
    """The mirror copies parent rows bitwise, refreshes only rows whose
    last_write stamp moved, and turns a parent kill() (which does not
    stamp last_write) into a local roster_version bump."""
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.hierarchy import _CellTelemetry
    run = _port()
    sim = ClusterSim(run.tiers, run.names, seed=0)
    slots = np.array([i.slot for i in sim.instances[::2]])
    ct = _CellTelemetry(sim.tel, slots)
    for name in ("pending", "batch", "free", "ctx", "queue", "t",
                 "max_batch", "alive", "prefix_sig", "prefix_hit"):
        np.testing.assert_array_equal(getattr(ct, name),
                                      getattr(sim.tel, name)[slots])
    v0, r0 = ct.version, ct.roster_version
    assert ct.refresh() is ct            # no parent change: no-op
    assert (ct.version, ct.roster_version) == (v0, r0)
    sim.tel.write(int(slots[1]), pending=123.5, batch=3, free=2,
                  ctx=77.0, queue=4, t=1.25)
    ct.refresh()
    assert ct.version > v0
    assert ct.pending[1] == 123.5 and ct.queue[1] == 4
    assert len(ct.dirty_rows(v0)) == 1
    outside = next(i.slot for i in sim.instances
                   if i.slot not in set(slots.tolist()))
    v1 = ct.version
    sim.tel.write(outside, pending=9.0, batch=1, free=1, ctx=1.0,
                  queue=0, t=1.5)
    ct.refresh()
    assert ct.version == v1
    sim.tel.kill(int(slots[0]))
    ct.refresh()
    assert ct.roster_version > r0
    assert not ct.alive[0]
    for name in ("pending", "batch", "free", "ctx", "queue", "t", "alive"):
        assert getattr(ct, name).tobytes() == \
            getattr(sim.tel, name)[slots].tobytes()


# -- span routing: one logical decision, sharded scan -------------------------

def _span_decide(rb, sim, reqs):
    from repro_torch.core import BatchView
    rb.sim = sim
    res = rb.policy.assign(BatchView(reqs), sim)
    choice, l_chosen = res.fetch()
    return [res.instances[int(i)].iid for i in choice], l_chosen


@pytest.mark.parametrize("n_cells", [2, 4])
def test_span_parity_across_cell_counts(n_cells):
    """The cell-sharded staged torch scan is bitwise the unsharded one on
    randomized mid-run telemetry, dead rows included."""
    import repro_torch.core as P
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import randomize_telemetry
    run = _port()
    reqs = run.requests(64, seed=9)
    for r in reqs:
        r.arrival = 0.0
    cfg = P.RBConfig(charge_compute=False, decision_backend="torch")
    plain = P.RouteBalance(cfg, run.bundle(), run.tiers)
    span = P.RouteBalance(dataclasses.replace(cfg, shard_cells=n_cells),
                          run.bundle(), run.tiers)
    for trial, kill in ((0, 0.0), (1, 0.25)):
        sim = randomize_telemetry(
            ClusterSim(run.tiers, run.names, seed=0), trial, kill)
        iids0, l0 = _span_decide(plain, sim, reqs[:32])
        iids1, l1 = _span_decide(span, sim, reqs[:32])
        assert iids0 == iids1
        np.testing.assert_array_equal(l0, l1)


@pytest.mark.parametrize("kill", [0.0, 0.25])
@pytest.mark.parametrize("n_cells", [2, 4])
def test_span_choices_match_reference(n_cells, kill):
    """The port's span arm (staged torch + `shard_cells`) against the
    reference's (fused + `shard_cells`): the same instance per request."""
    import repro.core as R
    import repro_torch.core as P
    from repro.serving.cluster import ClusterSim as RefSim
    from repro.serving.scenarios import randomize_telemetry as ref_rand
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import randomize_telemetry
    rrun, run = _cluster()
    rreqs = rrun.requests(64, seed=9)
    preqs = _requests(run, 64, 9, like=rreqs)
    for r in rreqs + preqs:
        r.arrival = 0.0
    ref = R.RouteBalance(R.RBConfig(charge_compute=False,
                                    shard_cells=n_cells),
                         rrun.bundle(), rrun.tiers)
    span = P.RouteBalance(P.RBConfig(charge_compute=False,
                                     decision_backend="torch",
                                     shard_cells=n_cells),
                          run.bundle(), run.tiers)
    trial = int(kill > 0)
    rsim = ref_rand(RefSim(rrun.tiers, rrun.names, seed=0), trial, kill)
    psim = randomize_telemetry(ClusterSim(run.tiers, run.names, seed=0),
                               trial, kill)
    np.testing.assert_array_equal(psim.tel.alive, rsim.tel.alive)
    ref.sim = rsim
    insts, c, _ = ref._decide_core(rreqs[:32])
    got, _ = _span_decide(span, psim, preqs[:32])
    assert got == [insts[int(i)].iid for i in c]


@pytest.mark.parametrize("affinity", [False, True])
@pytest.mark.parametrize("mode", ["full", "off_reactive", "off_predictive",
                                  "static_prior"])
def test_sharded_scan_is_bitwise_the_unsharded_scan(mode, affinity):
    from repro_torch.core.decision import greedy_scan, sharded_greedy_scan
    rng = np.random.default_rng((7, affinity))
    R, I = 24, 32

    def u(*shape, lo=0.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32)
    args = (torch.argsort(-u(R), stable=True), u(R, I), u(R, I, hi=1e-3),
            u(R, I, lo=20, hi=500), u(I, lo=0.005, hi=0.05),
            u(I, lo=0.005, hi=0.05), u(I, hi=3000),
            torch.tensor(rng.integers(0, 12, I), dtype=torch.float32),
            torch.tensor(rng.integers(0, 6, I), dtype=torch.float32),
            torch.full((I,), 16.0), (0.4, 0.35, 0.25),
            torch.tensor(rng.uniform(size=(R, I)) < 0.7), mode)
    kw = dict(row_valid=torch.tensor(rng.uniform(size=R) < 0.85),
              affinity=u(R, I, hi=0.6) if affinity else None)
    want = greedy_scan(*args, **kw)
    for n_cells in (2, 4, 8):
        got = sharded_greedy_scan(*args, **kw, n_cells=n_cells)
        assert torch.equal(got[0], want[0])
        for a, b in zip((got[1],) + got[2], (want[1],) + want[2]):
            assert a.numpy().tobytes() == b.numpy().tobytes()


def test_build_scheduler_span_returns_sharded_engine():
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import (HierarchicalScheduler,
                                               HierarchyConfig,
                                               build_scheduler)
    run = _port()
    s = build_scheduler(P.RBConfig(decision_backend="torch"), run.bundle(),
                        run.tiers, HierarchyConfig(n_cells=4, routing="span"))
    assert isinstance(s, P.RouteBalance)
    assert s.cfg.shard_cells == 4
    with pytest.raises(ValueError, match="'torch'"):
        build_scheduler(P.RBConfig(), run.bundle(), run.tiers,
                        HierarchyConfig(n_cells=4, routing="span"))
    s1 = build_scheduler(P.RBConfig(), run.bundle(), run.tiers,
                         HierarchyConfig(n_cells=2, routing="balanced"))
    assert isinstance(s1, HierarchicalScheduler)


# -- balanced routing: per-cell engines + global balancer ---------------------

def test_balanced_1cell_trajectory_matches_single_controller():
    """At one cell the hierarchy (cell mirror, digest loop, global
    expected count) is the single controller: identical per-request
    trajectories through the cluster scenario's failure schedule."""
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    run = _port()
    _arm_recovery(run, False)
    cfg = P.RBConfig(charge_compute=False)
    reqs_a = run.requests(90, seed=0)
    run.run_cell(P.RouteBalance(cfg, run.bundle(), run.tiers), reqs_a,
                 seed=0)
    reqs_b = run.requests(90, seed=0)
    h1 = build_scheduler(cfg, run.bundle(), run.tiers,
                         HierarchyConfig(n_cells=1, routing="balanced"))
    run.run_cell(h1, reqs_b, seed=0)
    assert _traj(reqs_a) == _traj(reqs_b)


def test_balanced_two_cells_runs_clean():
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    from repro_torch.serving.metrics import check_terminal_states
    run = _port()
    _arm_recovery(run, False)
    sched = build_scheduler(
        P.RBConfig(charge_compute=False), run.bundle(), run.tiers,
        HierarchyConfig(n_cells=2, routing="balanced"))
    reqs = run.requests(80, seed=1)
    m = run.run_cell(sched, reqs, seed=1)
    check_terminal_states(reqs)
    assert m["failed"] == 0
    assert m["n"] + m["shed"] == len(reqs)
    assert m["policy"] == "routebalance"
    assert m["deployment"] == "windowed"
    assert sched.decisions + sched.shed_count == len(reqs)
    bal = sched.balancer
    assert bal.digests_sent >= 2 and bal.bytes_sent > 0
    assert all(bal.assigned_total[ci] > 0 for ci in (0, 1))
    assert 0.0 <= bal.imbalance() < 1.0
    cell_iids = [{i.iid for i in cell} for cell in sched.cells]
    for r in reqs:
        if r.instance is not None:
            assert any(r.instance in iids for iids in cell_iids)


def test_balanced_per_cell_recovery():
    """Failures under balanced routing reach the victim's owning cell
    manager: retries re-enter through the cell's engine, nothing is
    lost, and the parent-facing router sums the counters."""
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    from repro_torch.serving.metrics import check_terminal_states
    run = _port()
    _arm_recovery(run, True)
    try:
        sched = build_scheduler(
            P.RBConfig(charge_compute=False), run.bundle(), run.tiers,
            HierarchyConfig(n_cells=2, routing="balanced"))
        reqs = run.requests(160, seed=1)
        m = run.run_cell(sched, reqs, seed=1)
    finally:
        _arm_recovery(run, False)
    check_terminal_states(reqs)
    assert m["failed"] == 0
    assert m["retries"] > 0
    mgrs = [cs.recovery for cs in sched.cell_sims]
    assert all(mgr is not None for mgr in mgrs)
    assert sum(mgr.retries for mgr in mgrs) == m["retries"]
    for r in reqs:
        if r.attempt > 0 and r.instance is not None:
            owner = [any(i.iid == r.instance for i in cell)
                     for cell in sched.cells]
            assert sum(owner) == 1


@pytest.mark.parametrize("recovery", [False, True])
@pytest.mark.parametrize("n_cells", [1, 2])
def test_balanced_matches_reference(n_cells, recovery):
    """The balanced hierarchy on both packages, the cluster scenario's
    schedule armed: identical completions, placements per cell and
    digest wire bytes."""
    import repro.core as R
    import repro_torch.core as P
    from repro.serving.hierarchy import HierarchyConfig as RefHC
    from repro.serving.hierarchy import build_scheduler as ref_build
    from repro.serving.recovery import RecoveryConfig as RefRC
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    rrun, run = _cluster()
    rrun.recovery = RefRC() if recovery else None
    _arm_recovery(run, recovery)
    try:
        rreqs = rrun.requests(80, seed=1)
        rs = ref_build(R.RBConfig(charge_compute=False), rrun.bundle(),
                       rrun.tiers, RefHC(n_cells=n_cells))
        rm = rrun.run_cell(rs, rreqs, seed=1)
        preqs = _requests(run, 80, 1, like=rreqs)
        ps = build_scheduler(P.RBConfig(charge_compute=False), run.bundle(),
                             run.tiers, HierarchyConfig(n_cells=n_cells))
        pm = run.run_cell(ps, preqs, seed=1)
    finally:
        rrun.recovery = None
        _arm_recovery(run, False)
    assert completions(preqs) == completions(rreqs)
    rb, pb = rs.balancer, ps.balancer
    assert pb.assigned_total == rb.assigned_total
    assert (pb.digests_sent, pb.bytes_sent, pb.seq) == \
        (rb.digests_sent, rb.bytes_sent, rb.seq)
    assert pb._quantum == rb._quantum
    for ci in rb.digests:
        from repro.distributed.compression import encode_digest as ref_enc
        from repro_torch.distributed.compression import encode_digest
        assert encode_digest(pb.digests[ci]) == ref_enc(rb.digests[ci])
    for k in ("n", "failed", "shed", "retries", "quality"):
        assert pm.get(k) == rm.get(k), k
    # one K1 call per fired batch of each cell, no degraded batch here
    for e in ps.engines:
        assert e._fused.stats["calls"] == len(e.compute_log) > 0


def test_signature_twin_cells_get_distinct_runners():
    """Cells with equal roster signatures each get their own hot-path
    runner (each cell engine has its own policy): each carries its own
    mirror and sees only delta syncs after its first batch."""
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    run = _port()
    tiers = [dataclasses.replace(t, n_instances=2) for t in run.tiers]
    reqs = run.requests(60, seed=2)
    sched = build_scheduler(P.RBConfig(charge_compute=False), run.bundle(),
                            tiers, HierarchyConfig(n_cells=2))
    m = P.run_cell(sched, tiers, run.names, reqs, seed=0)
    assert m["n"] == len(reqs)
    a, b = sched.cells
    assert [(i.tier.name, i.model_idx) for i in a] == \
        [(i.tier.name, i.model_idx) for i in b]
    runners = [e._fused for e in sched.engines]
    assert runners[0] is not runners[1]
    for e, hp in zip(sched.engines, runners):
        st = hp.stats
        assert st["calls"] == len(e.compute_log) > 1
        assert st["full_reseed"] == 1 and st["roster_reseed"] == 0
        assert st["delta_sync"] + st["carry"] == st["calls"] - 1
        assert st["delta_sync"] > 0
        assert hp._seen_tel is e.sim.tel
    # the cell's expected count is the global one, whatever is written
    eng = sched.engines[0]
    eng.expected = 12345
    assert eng.expected == (len(reqs) - sched.decisions + eng.decisions
                            - sched.shed_count + eng.shed_count)
    assert eng.checkpoint_tree()["counters"][3] == eng.expected


@pytest.mark.parametrize("n_cells", [0, 2])
def test_reattach_builds_fresh_runners(n_cells):
    """A scheduler attached again, to a fresh sim with the same roster,
    decides on new hot-path runners: none of the first attach's, no
    kernel shape counted yet, and the mirror seeded in full at the first
    decision. Flat (`n_cells` 0) and in 2 cells, on one shared bundle."""
    import repro_torch.core as P
    from repro_torch.core.engine import BatchView
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.hierarchy import HierarchyConfig, build_scheduler
    run = _port()
    cfg = P.RBConfig(charge_compute=False)
    if n_cells:
        sched = build_scheduler(cfg, run.bundle(), run.tiers,
                                HierarchyConfig(n_cells=n_cells))
    else:
        sched = P.RouteBalance(cfg, run.bundle(), run.tiers)

    def engines():
        return sched.engines if n_cells else [sched]
    P.run_cell(sched, run.tiers, run.names, run.requests(40, seed=3), seed=0)
    first = [e._fused for e in engines()]
    assert len(first) == max(n_cells, 1)
    assert all(hp.shape_variants() > 0 for hp in first)
    sched.attach(ClusterSim(run.tiers, run.names, seed=0))
    reqs = run.requests(8, seed=4)
    for e in engines():
        hp = e.policy._fused_runner(e.sim)
        assert all(hp is not old for old in first)
        assert hp.shape_variants() == 0
        e.policy.assign(BatchView(reqs), e.sim).fetch()
        assert e._fused is hp and hp.stats["full_reseed"] == 1


# -- digests and the balancer's staleness discipline --------------------------

@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_encode_digest_matches_reference(mode):
    from repro.distributed import compression as ref
    from repro_torch.distributed import compression as port
    rng = np.random.default_rng(5)
    for T in (1, 8, 16):
        planes = [rng.uniform(0, s, T).astype(np.float32)
                  for s in (1.0, 4000.0, 64.0)]
        kw = dict(cell=3, seq=17, t=2.75, n_alive=11, n_total=12)
        wire = port.encode_digest(port.TelemetryDigest(
            **kw, tier_occupancy=planes[0], tier_depth=planes[1],
            tier_free=planes[2]), mode=mode)
        rwire = ref.encode_digest(ref.TelemetryDigest(
            **kw, tier_occupancy=planes[0], tier_depth=planes[1],
            tier_free=planes[2]), mode=mode)
        assert wire == rwire
        d, rd = port.decode_digest(rwire), ref.decode_digest(wire)
        for name in ("tier_occupancy", "tier_depth", "tier_free"):
            assert getattr(d, name).tobytes() == getattr(rd, name).tobytes()
        assert (d.cell, d.seq, d.t, d.n_alive, d.n_total) == \
            (rd.cell, rd.seq, rd.t, rd.n_alive, rd.n_total)


def _fake_digest(bal, ci, t, depth, free, n_alive=4):
    from repro_torch.distributed.compression import (TelemetryDigest,
                                                     decode_digest,
                                                     encode_digest)
    d = TelemetryDigest(
        cell=ci, seq=0, t=t, n_alive=n_alive, n_total=4,
        tier_occupancy=np.zeros(2, np.float32),
        tier_depth=np.array([depth, 0], np.float32),
        tier_free=np.array([free, 0], np.float32))
    bal.digests[ci] = decode_digest(encode_digest(d))


def test_balancer_staleness_and_dark_cells():
    """pick() prefers the least-loaded fresh cell, routes around a stale
    (dark) one, and falls back to round-robin only when every digest is
    past the bound."""
    from repro_torch.serving.hierarchy import GlobalBalancer, HierarchyConfig
    bal = GlobalBalancer(HierarchyConfig(
        n_cells=3, digest_interval_s=0.25, digest_stale_s=1.0))
    for ci in range(3):
        bal.membership.register(f"cell{ci}", "cell", now=0.0)
        bal.assigned_since[ci] = 0
        bal.assigned_total[ci] = 0
        bal.membership.heartbeat(f"cell{ci}", 0.0)
    _fake_digest(bal, 0, t=0.0, depth=50.0, free=2.0)   # busy
    _fake_digest(bal, 1, t=0.0, depth=1.0, free=8.0)    # idle
    _fake_digest(bal, 2, t=0.0, depth=0.0, free=8.0, n_alive=0)
    assert bal.pick(0.1, [0, 1, 2]) == 1
    picks = [bal.pick(0.1, [0, 1]) for _ in range(200)]
    assert 0 in picks and 1 in picks
    assert picks[0] == 1
    _fake_digest(bal, 0, t=2.0, depth=50.0, free=2.0)
    bal.membership.heartbeat("cell0", 2.0)
    bal.assigned_since[0] = 0
    assert all(bal.pick(2.5, [0, 1]) == 0 for _ in range(5))
    picks = {bal.pick(9.0, [0, 1, 2]) for _ in range(6)}
    assert picks == {0, 1, 2}
    m = bal.membership
    assert m.staleness_penalty("cell1", 9.0) == 1.0 + 2.0 * 9.0 / 1.0
    assert m.staleness_penalty("nope", 0.0) == float("inf")
    assert m.active(2.5) == ["cell0"]


def test_balanced_mode_rejects_span_config():
    import repro_torch.core as P
    from repro_torch.serving.hierarchy import (HierarchicalScheduler,
                                               HierarchyConfig)
    run = _port()
    with pytest.raises(ValueError, match="'torch'"):
        P.RBConfig(shard_cells=2)
    with pytest.raises(ValueError, match="span"):
        HierarchicalScheduler(
            P.RBConfig(shard_cells=2, decision_backend="torch"),
            run.bundle(), run.tiers, HierarchyConfig(n_cells=2))
