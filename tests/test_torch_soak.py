"""The reference's randomized differential soak (`tests/test_soak.py`)
held on the port, case for case.

Random serving worlds from `random_scenario` (both packages build the
same roster, tenants and failure schedule from a seed) are decided by
the reference's default backend, ``fused``, and by each of the port's:
``megakernel`` (the decision kernel K1's plain version on the CPU),
``torch`` and ``numpy`` (the staged cores). The port's bundle is bridged
from the reference's trained weights (`torch_scenario_parity.build_pair`)
and its request streams take the reference's ingest embeddings, so a
difference is the decision's or the simulator's.

The bar is the port's parity bar: choices identical; the integral
state identical (the megakernel's post-scan batch and free slots
exactly, its pending tokens within the float tolerance below);
`l_chosen` of every port backend within rtol 1e-5, atol 1e-7 of the
reference's fused (the decision kernel's stated tolerance,
`tests/test_torch_megakernel.py`: XLA contracts some multiply-adds into
FMAs). End to end: completions identical and every `run_cell` metric
equal (`torch_scenario_parity.assert_metrics_equal`).

Cases: decision parity with `affinity_weight` 0 and 0.5 and a killed
quarter of the fleet; whole-cell trajectories through each world's own
failure schedule; the span scan (`RBConfig(decision_backend="torch",
shard_cells=n)` against the reference's fused + `shard_cells`) and the
balanced hierarchy; telemetry invariants under failures with dead slots
never dispatched to; the hot path's carried and post-scan state
physical; exactly-once under random fault schedules with recovery
armed, the lifecycle fingerprints equal across the port's backends and
to the reference's; the hypothesis cases. Tier-1 takes seeds 0-2 at <= 5
tiers x 32 instances, one seed a case (the rest of the small grid runs
with the slow one); the 16 x 128 and 10 x 64 grids are `slow`, as in
the reference.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from torch_scenario_parity import arm_scenario, assert_metrics_equal, \
    build_pair, completions, k1_scan_states, run_pair

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # tier-1 must collect without it
    HAVE_HYPOTHESIS = False

PORT = ("megakernel", "torch", "numpy")
RTOL, ATOL = 1e-5, 1e-7
_PAIRS = {}


def _pair_for(seed, max_tiers, max_instances, dataset_n=220):
    """(reference run, port run) of `random_scenario(seed, ...)`, cached
    per module."""
    from repro.serving.scenarios import random_scenario as ref_random
    from repro_torch.serving.scenarios import random_scenario
    key = (seed, max_tiers, max_instances)
    if key not in _PAIRS:
        _PAIRS[key] = build_pair(
            ref_random(seed, max_tiers=max_tiers,
                       max_instances=max_instances),
            random_scenario(seed, max_tiers=max_tiers,
                            max_instances=max_instances), dataset_n)
    return _PAIRS[key]


def _requests(rrun, prun, n, seed, arrival=None):
    """The same n requests on both packages, the port's with the
    reference's ingest embeddings."""
    rreqs = rrun.requests(n, seed=seed)[:n]
    preqs = prun.requests(n, seed=seed)[:n]
    preqs[0].cols.emb = rreqs[0].cols.emb
    if arrival is not None:
        for r in rreqs + preqs:
            r.arrival = arrival
    return rreqs, preqs


def _loaded_sims(rrun, prun, seed, kill_frac, affinity_weight, rcols,
                 pcols):
    from repro.serving.cluster import ClusterSim as RefSim
    from repro.serving.scenarios import randomize_prefix_state as ref_warm
    from repro.serving.scenarios import randomize_telemetry as ref_load
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import randomize_prefix_state, \
        randomize_telemetry
    rsim = ref_load(RefSim(rrun.tiers, rrun.names, seed=0), seed, kill_frac)
    psim = randomize_telemetry(ClusterSim(prun.tiers, prun.names, seed=0),
                               seed, kill_frac)
    if affinity_weight:
        ref_warm(rsim, rcols, seed)
        randomize_prefix_state(psim, pcols, seed)
    return rsim, psim


def _decision_parity(rrun, prun, seed, R_, kill_frac=0.0,
                     affinity_weight=0.0, port=PORT):
    """One batch of R_ requests decided on randomized telemetry (and
    warmed prefix sketches) by the reference's fused backend and each of
    the port's: choices identical, dead instances never picked, l_chosen
    within the float tolerance, the megakernel's post-scan state the
    fused program's."""
    from repro.core import BatchView as RefView
    from repro_torch.core import BatchView
    rreqs, preqs = _requests(rrun, prun, R_, seed, arrival=0.0)
    rb = R.RouteBalance(R.RBConfig(decision_backend="fused",
                                   affinity_weight=affinity_weight),
                        rrun.bundle(), rrun.tiers)
    rb.sim, _ = _loaded_sims(rrun, prun, seed, kill_frac, affinity_weight,
                             rreqs[0].cols, preqs[0].cols)
    res = rb.policy.assign(RefView(rreqs), rb.sim)
    choice, l_chosen = res.fetch()
    want = ([res.instances[int(i)].iid for i in choice],
            np.asarray(l_chosen, np.float64), rb._fused._post_state)
    got = {}
    for be in port:
        rb = P.RouteBalance(P.RBConfig(decision_backend=be,
                                       affinity_weight=affinity_weight),
                            prun.bundle(), prun.tiers)
        _, rb.sim = _loaded_sims(rrun, prun, seed, kill_frac,
                                 affinity_weight, rreqs[0].cols,
                                 preqs[0].cols)
        with k1_scan_states() as calls:
            res = rb.policy.assign(BatchView(preqs), rb.sim)
            choice, l_chosen = res.fetch()
        dead = {inst.iid for inst in rb.sim.instances if not inst.alive}
        picked = [res.instances[int(i)].iid for i in choice]
        assert not dead.intersection(picked), (be, dead & set(picked))
        post = [x[0] for x in calls[-1]] if be == "megakernel" else None
        got[be] = (picked, np.asarray(l_chosen, np.float64), post)
    for be in port:
        assert got[be][0] == want[0], be
        np.testing.assert_allclose(got[be][1], want[1], rtol=RTOL,
                                   atol=ATOL, err_msg=be)
    if "megakernel" in port:
        d, b, f = (np.asarray(x, np.float64) for x in
                   got["megakernel"][2])
        rd, rb_, rf = (np.asarray(x, np.float64) for x in want[2])
        n = min(len(d), len(rd))        # the pow2 roster pads may differ
        assert np.array_equal(b[:n], rb_[:n])
        assert np.array_equal(f[:n], rf[:n])
        np.testing.assert_allclose(d[:n], rd[:n], rtol=RTOL, atol=ATOL)
        assert len(d) >= rrun.n_instances


# -- decision-level soak ------------------------------------------------------

SMALL = dict(max_tiers=5, max_instances=32)


# tier-1 takes one (affinity weight, killed fraction) pair a seed; the
# others run with the slow grid
TIER1 = {(0, 0.0, 0.0), (1, 0.5, 0.25), (2, 0.0, 0.25)}
SMALL_GRID = [pytest.param(s, a, k, marks=() if (s, a, k) in TIER1
                           else pytest.mark.slow, id=f"{s}-{a}-{k}")
              for s in (0, 1, 2) for a in (0.0, 0.5) for k in (0.0, 0.25)]


def _seeds(tier1, slow):
    """Seeds of a case: `tier1` in the default run, `slow` with -m slow."""
    return list(tier1) + [pytest.param(s, marks=pytest.mark.slow)
                          for s in slow]


@pytest.mark.parametrize("seed,affinity_weight,kill_frac", SMALL_GRID)
def test_soak_decision_parity_small(seed, affinity_weight, kill_frac):
    """Random rosters up to 5 tiers x 32 instances, the affinity term
    off and live on warmed sketches, with and without a quarter of the
    fleet dead (dead rows never contribute affinity)."""
    rrun, prun = _pair_for(seed, **SMALL)
    _decision_parity(rrun, prun, seed, 16, kill_frac, affinity_weight)


@pytest.mark.slow
@pytest.mark.parametrize("kill_frac", [0.0, 0.25])
@pytest.mark.parametrize("affinity_weight", [0.0, 0.5])
@pytest.mark.parametrize("seed", list(range(10)))
def test_soak_decision_parity_full(seed, affinity_weight, kill_frac):
    """Full soak: rosters up to 16 tiers x 128 instances, every seed."""
    rrun, prun = _pair_for(seed, max_tiers=16, max_instances=128)
    _decision_parity(rrun, prun, seed, 48, kill_frac, affinity_weight)


# -- serving-level soak -------------------------------------------------------

def _port_cell(prun, be, rreqs, n, seed, **kw):
    """The port's cell on backend `be` over the same requests as the
    reference's `rreqs` (the run's schedule and recovery as they stand)."""
    preqs = prun.requests(n, seed=seed)
    preqs[0].cols.emb = rreqs[0].cols.emb
    rb = P.RouteBalance(P.RBConfig(decision_backend=be,
                                   charge_compute=False, **kw),
                        prun.bundle(), prun.tiers)
    return preqs, prun.run_cell(rb, preqs, seed=0)


def _trajectories(rrun, prun, n, seed, **kw):
    """The reference's fused cell and the port's on every backend,
    through the world's own schedule: completions identical, every
    metric equal."""
    (rreqs, rm), (preqs, pm, _) = run_pair(rrun, prun, n=n, seed=seed, **kw)
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    for be in ("torch", "numpy"):
        sreqs, sm = _port_cell(prun, be, rreqs, n, seed, **kw)
        assert completions(sreqs) == completions(rreqs), be
        assert_metrics_equal(rm, sm)


@pytest.mark.parametrize("seed", _seeds([0], [2]))
def test_soak_e2e_trajectory_small(seed):
    """A full cluster run through the scenario's own failure schedule
    lands on the reference's trajectory under every port backend."""
    rrun, prun = _pair_for(seed, **SMALL)
    _trajectories(rrun, prun, 40, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(4)))
def test_soak_e2e_trajectory_full(seed):
    rrun, prun = _pair_for(seed, max_tiers=16, max_instances=128)
    _trajectories(rrun, prun, 150, seed + 10)


# -- sharded-parity soak (the hierarchy) --------------------------------------

def _span(rrun, prun, n_cells, n, seed):
    """(reference fused + shard_cells, port staged torch + shard_cells)
    completions of one cell; 1 cell is the unsharded scan."""
    rreqs = rrun.requests(n, seed=seed)
    rb = R.RouteBalance(R.RBConfig(charge_compute=False,
                                   shard_cells=0 if n_cells == 1
                                   else n_cells),
                        rrun.bundle(), rrun.tiers)
    rrun.run_cell(rb, rreqs, seed=0)
    preqs, _ = _port_cell(prun, "torch", rreqs, n, seed,
                          shard_cells=0 if n_cells == 1 else n_cells)
    return completions(rreqs), completions(preqs)


def _balanced(rrun, prun, C, n, seed):
    from repro.serving.hierarchy import HierarchyConfig as RefHC
    from repro.serving.hierarchy import build_scheduler as ref_build
    from repro.serving.metrics import check_terminal_states
    from repro_torch.serving.hierarchy import HierarchyConfig, \
        build_scheduler
    rreqs = rrun.requests(n, seed=seed)
    rs = ref_build(R.RBConfig(charge_compute=False), rrun.bundle(),
                   rrun.tiers, RefHC(n_cells=C, routing="balanced"))
    rrun.run_cell(rs, rreqs, seed=0)
    preqs = prun.requests(n, seed=seed)
    preqs[0].cols.emb = rreqs[0].cols.emb
    ps = build_scheduler(P.RBConfig(charge_compute=False), prun.bundle(),
                         prun.tiers, HierarchyConfig(n_cells=C,
                                                     routing="balanced"))
    prun.run_cell(ps, preqs, seed=0)
    check_terminal_states(rreqs)
    assert completions(preqs) == completions(rreqs)
    assert ps.decisions + ps.shed_count == len(preqs)
    assert [ps.balancer.assigned_total[c] for c in range(C)] == \
        [rs.balancer.assigned_total[c] for c in range(C)]
    return ps


def _sharded(rrun, prun, n, seed, cells, balanced):
    arm_scenario(rrun, prun)                 # the world's own schedule
    trajs = {C: _span(rrun, prun, C, n, seed) for C in cells}
    for C, (ref, port) in trajs.items():
        assert port == ref, C
        assert port == trajs[1][1]
    for C in balanced:
        _balanced(rrun, prun, C, n, seed + 1)


@pytest.mark.parametrize("seed", _seeds([0], [2]))
def test_soak_sharded_parity_small(seed):
    """Span routing shards the scan of one logical controller: the
    port's staged torch scan over 1 / 2 (and, with the slow grid, 4)
    cells gives the reference's fused + `shard_cells` completions, and
    all alike; the balanced hierarchy at 2 (and 3) cells gives the
    reference's completions and placements per cell."""
    rrun, prun = _pair_for(seed, **SMALL)
    if seed == 0:
        _sharded(rrun, prun, 40, seed + 5, (1, 2), (2,))
    else:
        _sharded(rrun, prun, 40, seed + 5, (1, 2, 4), (2, 3))


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(6)))
def test_soak_sharded_parity_full(seed):
    rrun, prun = _pair_for(seed, max_tiers=16, max_instances=128)
    _sharded(rrun, prun, 120, seed + 20, (1, 2, 4), (2, 4))


# -- invariant-level ----------------------------------------------------------

def _probe_invariants(sim, log):
    def probe(t):
        tel = sim.tel
        log.append(tel.version)
        assert np.all(tel.free >= 0)
        assert np.all(tel.free <= tel.max_batch)
        assert np.all(tel.batch <= tel.max_batch)
        assert np.all(tel.batch >= 0) and np.all(tel.pending >= 0)
        for inst in sim.instances:
            assert bool(tel.alive[inst.slot]) == (
                inst.alive and not inst.quarantined)
            if inst.alive and not inst.tel_mute and not inst.quarantined:
                s = inst.snapshot
                assert s["pending_decode"] == tel.pending[inst.slot]
                assert s["batch_size"] == tel.batch[inst.slot]
                assert s["free_slots"] == tel.free[inst.slot]
                assert s["mean_ctx"] == tel.ctx[inst.slot]
                assert s["queue_depth"] == tel.queue[inst.slot]
        if sim._events:
            sim.push(t + 0.2, probe)
    sim.push(0.05, probe)


def _guard_dead_dispatch(monkeypatch, instance_cls):
    orig = instance_cls.submit

    def guarded(self, req, t, pred_len, max_tokens):
        assert self.alive, f"dispatched to dead instance {self.iid}"
        return orig(self, req, t, pred_len, max_tokens)
    monkeypatch.setattr(instance_cls, "submit", guarded)


def _manual_cell(run, rb, reqs):
    """A cell run by hand under the scenario's schedule, the invariants
    probed every 0.2 s of simulated time: returns the versions seen."""
    sim = run.sim(seed=0)
    rb.expected = len(reqs)
    rb.attach(sim)
    for r in reqs:
        sim.push(r.arrival, lambda t, rr=r: rb.enqueue(rr, t))
    versions = []
    _probe_invariants(sim, versions)
    sim.run()
    return versions


@pytest.mark.parametrize("seed", _seeds([1], [2]))
def test_telemetry_invariants_under_failures(seed, monkeypatch):
    """Under the scenario's failure / recovery / straggler schedule the
    port's telemetry stays physical (free >= 0, batch <= capacity, the
    columnar view equals the instances' snapshots), its version is
    monotonic, no dead slot is dispatched to, and the cell makes
    progress (its trajectory is held against the reference's by
    `test_soak_e2e_trajectory_small`)."""
    from repro_torch.serving.cluster import Instance
    _guard_dead_dispatch(monkeypatch, Instance)
    rrun, prun = _pair_for(seed, **SMALL)
    arm_scenario(rrun, prun)                 # the world's own schedule
    reqs = prun.requests(50, seed=seed)
    versions = _manual_cell(prun, P.RouteBalance(P.RBConfig(
        charge_compute=False), prun.bundle(), prun.tiers), reqs)
    assert versions == sorted(versions) and versions[-1] > versions[0]
    assert [r for r in reqs if r.finish_time is not None and not r.failed]


def test_carried_state_stays_physical(monkeypatch):
    """The megakernel backend's device-resident state stays physical
    through a failure-perturbed run: the carried telemetry mirror and
    the post-scan dead-reckoned view respect d >= 0, free >= 0, b <=
    max_batch, the pow2 roster pads included; the delta / carry arms
    outnumber full reseeds; the trajectory is the reference's."""
    from repro_torch.serving.cluster import Instance
    _guard_dead_dispatch(monkeypatch, Instance)
    rrun, prun = _pair_for(1, **SMALL)
    with k1_scan_states() as post:
        (rreqs, _), (preqs, _, rb) = run_pair(rrun, prun, n=60, seed=4)
    assert completions(preqs) == completions(rreqs)
    hp = rb._fused
    st_ = hp.stats
    assert st_["delta_sync"] + st_["carry"] > st_["full_reseed"]
    d, b, free, ctx = (np.asarray(x, np.float64) for x in hp._state)
    maxb = np.asarray(hp._maxb, np.float64)
    assert d.shape == b.shape == free.shape == maxb.shape
    I = prun.n_instances
    assert len(d) >= I
    assert np.all(d >= 0) and np.all(free >= 0) and np.all(ctx >= 0)
    assert np.all(b[:I] <= maxb[:I] + 1e-6)
    d1, b1, f1 = (np.asarray(x[0], np.float64) for x in post[-1])
    assert np.all(d1 >= 0) and np.all(f1 >= 0)
    assert np.all(b1 <= maxb + 1e-6)
    pad = slice(I, None)
    assert np.all(d1[pad] == 0) and np.all(b1[pad] <= 1.0)


# -- fault-lifecycle soak (retry / hedge / watchdog) --------------------------

def _random_fault_schedule(seed, n_events=6, horizon=8.0, pkg="port"):
    """The reference's seeded random mix of crashes, recoveries,
    stragglers and telemetry blackouts, as either package's events."""
    if pkg == "port":
        from repro_torch.serving.scenarios import FailureEvent
    else:
        from repro.serving.scenarios import FailureEvent
    rng = np.random.default_rng((seed, 0xC405))
    events = []
    for _ in range(n_events):
        kind = str(rng.choice(("fail", "recover", "straggle",
                               "mute", "unmute")))
        events.append(FailureEvent(
            t=float(rng.uniform(0.5, horizon)), kind=kind,
            frac=float(rng.uniform(0.2, 0.7)),
            factor=float(rng.uniform(2.0, 6.0))))
    return tuple(sorted(events, key=lambda ev: ev.t))


def _fault_cell(run, rb, reqs, schedule, cfg, pkg, reqs_seed):
    """One manual cell with the recovery manager armed (the cached run's
    own schedule and recovery fields are left alone)."""
    if pkg == "port":
        from repro_torch.serving.cluster import ClusterSim
        from repro_torch.serving.recovery import arm_recovery
        from repro_torch.serving.scenarios import apply_schedule
    else:
        from repro.serving.cluster import ClusterSim
        from repro.serving.recovery import arm_recovery
        from repro.serving.scenarios import apply_schedule
    sim = ClusterSim(run.tiers, run.names, seed=0)
    arm_recovery(sim, cfg)
    rb.expected = len(reqs)
    rb.attach(sim)
    for r in reqs:
        sim.push(r.arrival, lambda t, rr=r: rb.enqueue(rr, t))
    apply_schedule(sim, schedule, seed=reqs_seed)
    sim.run()
    return sim


def _lifecycle_fingerprint(reqs):
    return [(r.rid, r.instance, r.attempt, r.hedges, r.tokens_out,
             bool(r.failed), bool(r.shed)) for r in reqs]


def _assert_exactly_once(reqs, sim, cfg):
    from repro_torch.serving.metrics import check_terminal_states
    check_terminal_states(reqs)                     # no lost requests
    done = list(sim.completed)
    assert len({id(r) for r in done}) == len(done)  # no duplicates
    assert len({r.rid for r in done}) == len(done)
    for r in reqs:                                  # attempt bound
        assert r.attempt < cfg.max_attempts, (r.rid, r.attempt)
        if r.failed:
            assert r.attempt == cfg.max_attempts - 1


def _exactly_once(rrun, prun, seed, n, schedule_seed, n_events, horizon,
                  port=PORT, **rc):
    """The reference's fused cell and the port's on each backend under
    one random fault schedule with recovery armed: every request
    terminal exactly once within the retry bound, progress made, the
    lifecycle fingerprints the reference's and the finish times within
    rtol 1e-6 of its (the reference's own bar between its backends: a
    hedge's deadline is read off est_T, which agrees within rtol 1e-5)."""
    from repro.serving.recovery import RecoveryConfig as RefRC
    from repro_torch.serving.recovery import RecoveryConfig
    rreqs = rrun.requests(n, seed=seed)
    rb = R.RouteBalance(R.RBConfig(decision_backend="fused",
                                   charge_compute=False), rrun.bundle(),
                        rrun.tiers)
    _fault_cell(rrun, rb, rreqs, _random_fault_schedule(
        schedule_seed, n_events, horizon, "ref"), RefRC(**rc), "ref", seed)
    cfg = RecoveryConfig(**rc)
    for be in port:
        preqs = prun.requests(n, seed=seed)
        preqs[0].cols.emb = rreqs[0].cols.emb
        pb = P.RouteBalance(P.RBConfig(decision_backend=be,
                                       charge_compute=False),
                            prun.bundle(), prun.tiers)
        sim = _fault_cell(prun, pb, preqs, _random_fault_schedule(
            schedule_seed, n_events, horizon), cfg, "port", seed)
        _assert_exactly_once(preqs, sim, cfg)
        assert [r for r in preqs if r.finish_time is not None
                and not r.failed]
        assert _lifecycle_fingerprint(preqs) == \
            _lifecycle_fingerprint(rreqs), be
        np.testing.assert_allclose([r.finish_time or -1.0 for r in preqs],
                                   [r.finish_time or -1.0 for r in rreqs],
                                   rtol=1e-6, err_msg=be)


@pytest.mark.parametrize("seed", _seeds([2], [0]))
def test_soak_exactly_once_under_random_faults(seed, monkeypatch):
    from repro_torch.serving.cluster import Instance
    _guard_dead_dispatch(monkeypatch, Instance)
    rrun, prun = _pair_for(seed, **SMALL)
    _exactly_once(rrun, prun, seed, 50, seed, 6, 8.0)


@pytest.mark.slow
@pytest.mark.parametrize("seed", list(range(6)))
def test_soak_exactly_once_under_random_faults_full(seed, monkeypatch):
    """Bigger rosters, longer schedules, tighter hedge deadlines, so the
    hedge path fires across the seeds."""
    from repro_torch.serving.cluster import Instance
    _guard_dead_dispatch(monkeypatch, Instance)
    rrun, prun = _pair_for(seed, max_tiers=10, max_instances=64)
    _exactly_once(rrun, prun, seed, 120, seed + 100, 10, 14.0,
                  hedge_factor=2.5, hedge_slack_s=1.0)


if HAVE_HYPOTHESIS:
    _TINY = {}

    def _tiny_world():
        if not _TINY:
            from repro.serving.scenarios import synthetic_pool as ref_pool
            from repro.serving.world import build_dataset as ref_ds
            from repro_torch.serving.scenarios import synthetic_pool
            from repro_torch.serving.world import build_dataset
            tiers, names, world = synthetic_pool(3, 6, seed=11)
            rt, rn, rw = ref_pool(3, 6, seed=11)
            _TINY.update(tiers=tiers, names=names,
                         ds=build_dataset(world, n=120), rtiers=rt,
                         rnames=rn, rds=ref_ds(rw, n=120))
        return _TINY

    @settings(max_examples=25, deadline=None, derandomize=True)
    @given(st.integers(0, 10 ** 6))
    def test_hypothesis_scenario_generation_is_wellformed(seed):
        """The port's random scenario is well formed and is the
        reference's: the same roster sizes, rate and schedule."""
        from repro.serving.scenarios import random_scenario as ref_random
        from repro_torch.serving.scenarios import random_scenario
        sc = random_scenario(seed, max_tiers=16, max_instances=128)
        rsc = ref_random(seed, max_tiers=16, max_instances=128)
        assert sc.n_tiers <= sc.n_instances
        recovers = sum(1 for ev in sc.schedule if ev.kind == "recover")
        fails = sum(1 for ev in sc.schedule if ev.kind == "fail")
        assert recovers <= fails or recovers == 0
        assert 0 < sc.lam <= 30.0 + 1e-9
        assert (sc.n_tiers, sc.n_instances, sc.lam) == \
            (rsc.n_tiers, rsc.n_instances, rsc.lam)
        assert [dataclasses.astuple(ev) for ev in sc.schedule] == \
            [dataclasses.astuple(ev) for ev in rsc.schedule]

    def _tiny_cell(seed, pkg):
        from repro_torch.serving.request import Request as PortRequest
        tiny = _tiny_world()
        if pkg == "port":
            from repro_torch.serving.cluster import ClusterSim
            from repro_torch.serving.scenarios import FailureEvent, \
                apply_schedule
            Req, tiers, names, ds = (PortRequest, tiny["tiers"],
                                     tiny["names"], tiny["ds"])
        else:
            from repro.serving.cluster import ClusterSim
            from repro.serving.request import Request as Req
            from repro.serving.scenarios import FailureEvent, apply_schedule
            tiers, names, ds = tiny["rtiers"], tiny["rnames"], tiny["rds"]
        rng = np.random.default_rng(seed)
        sim = ClusterSim(tiers, names, seed=0)
        prompts, Q, L = ds.split("test")
        for i in range(int(rng.integers(5, 30))):
            j = int(rng.integers(0, len(prompts)))
            inst = sim.instances[int(rng.integers(0, len(sim.instances)))]
            r = Req(rid=i, prompt=prompts[j],
                    arrival=float(rng.uniform(0, 3)),
                    true_quality=Q[j], true_length=L[j])
            sim.push(r.arrival,
                     lambda t, rr=r, ii=inst: ii.alive and ii.submit(
                         rr, t, float(rr.true_length[ii.model_idx]), None))
        events = []
        for _ in range(int(rng.integers(0, 4))):
            kind = str(rng.choice(("fail", "recover", "straggle")))
            events.append(FailureEvent(
                t=float(rng.uniform(0, 4)), kind=kind,
                frac=float(rng.uniform(0.1, 0.9)),
                factor=float(rng.uniform(1.5, 8.0))))
        apply_schedule(sim, events, seed=seed)
        versions = []
        _probe_invariants(sim, versions)
        sim.run()
        return sim, versions

    @settings(max_examples=15, deadline=None, derandomize=True)
    @given(st.integers(0, 10 ** 6))
    def test_hypothesis_telemetry_invariants(seed):
        """Random submissions and fail / recover / straggle schedules
        never drive the port's telemetry out of its physical envelope,
        and leave it where they leave the reference's."""
        sim, versions = _tiny_cell(seed, "port")
        rsim, rversions = _tiny_cell(seed, "ref")
        assert versions == sorted(versions) == rversions
        assert np.all(sim.tel.free >= 0)
        assert np.all(sim.tel.batch <= sim.tel.max_batch)
        for name in ("pending", "batch", "free", "ctx", "queue", "alive"):
            assert np.array_equal(getattr(sim.tel, name),
                                  getattr(rsim.tel, name)), name

    @settings(max_examples=10, deadline=None, derandomize=True)
    @given(st.integers(0, 10 ** 6))
    def test_hypothesis_exactly_once_with_recovery(seed):
        """Random fault schedules (blackouts that trip the watchdog
        included) on the small worlds, the megakernel backend: no
        request lost or duplicated and the retry bound held, as the
        reference's sweep checks its fused backend (the fingerprints are
        held against the reference's by
        `test_soak_exactly_once_under_random_faults`)."""
        from repro_torch.serving.recovery import RecoveryConfig
        _, prun = _pair_for(seed % 3, **SMALL)
        cfg = RecoveryConfig()
        reqs = prun.requests(30, seed=seed % 7)
        rb = P.RouteBalance(P.RBConfig(charge_compute=False),
                            prun.bundle(), prun.tiers)
        sim = _fault_cell(prun, rb, reqs, _random_fault_schedule(seed, 5),
                          cfg, "port", seed % 7)
        _assert_exactly_once(reqs, sim, cfg)
