"""The port's scenario subsystem against the JAX reference: arrival
processes, budget mixes, synthetic rosters, composite multi-tenant and
multi-turn request streams, failure schedules (`repro_torch.serving.
workload`, `serving.scenarios`, `serving.cluster`), and scenario cells
end to end through `run_cell(schedule=...)`.

Everything that is numpy must be array-equal to the reference on the
same seeds. The cells run the reference's "fused" backend and the port's
"megakernel" (its plain version here), `charge_compute=False`, the
port's bundle bridged from the reference's: identical per-request
completions, equal `run_cell` metrics."""
import dataclasses

import numpy as np
import pytest

from torch_scenario_parity import (assert_kernel_calls,
                                   assert_metrics_equal, build_pair,
                                   completions, run_pair)


# -- workloads -----------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("poisson", {}), ("poisson", {"start": 2.0}), ("gamma", {}),
    ("gamma", {"cv": 1.2}), ("square", {}),
    ("square", {"period": 7.0, "high_frac": 1.9}), ("flash", {}),
    ("flash", {"burst_start": 4.0, "burst_dur": 6.0, "burst_mult": 5.0})])
def test_arrivals_match_reference(kind, kw):
    from repro.serving import workload as ref
    from repro_torch.serving import workload
    for lam, n, seed in ((5.0, 300, 3), (22.0, 1000, 11)):
        got = workload.make_arrivals(kind, lam, n, seed=seed, **kw)
        np.testing.assert_array_equal(
            got, ref.make_arrivals(kind, lam, n, seed=seed, **kw))
    fn = {"poisson": "poisson_arrivals", "gamma": "gamma_bursty_arrivals",
          "square": "square_wave_arrivals",
          "flash": "flash_crowd_arrivals"}[kind]
    np.testing.assert_array_equal(
        getattr(workload, fn)(7.0, 200, seed=1, **kw),
        getattr(ref, fn)(7.0, 200, seed=1, **kw))
    with pytest.raises(ValueError):
        workload.make_arrivals("nope", 5.0, 10)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_sample_budgets_match_reference(frac):
    from repro.serving.workload import sample_budgets as ref
    from repro_torch.serving.workload import sample_budgets
    np.testing.assert_array_equal(sample_budgets(500, frac, seed=4),
                                  ref(500, frac, seed=4))
    np.testing.assert_array_equal(
        sample_budgets(80, frac, 1e-5, 1.5e-4,
                       rng=np.random.default_rng(9)),
        ref(80, frac, 1e-5, 1.5e-4, rng=np.random.default_rng(9)))


# -- rosters -------------------------------------------------------------------

@pytest.mark.parametrize("n_tiers,n_instances,seed",
                         [(1, 1, 0), (4, 13, 1), (8, 48, 3), (16, 128, 4),
                          (16, 10000, 7)])
def test_synthetic_pool_matches_reference(n_tiers, n_instances, seed):
    from repro.serving.scenarios import synthetic_pool as ref
    from repro_torch.serving.scenarios import synthetic_pool
    tiers, names, world = synthetic_pool(n_tiers, n_instances, seed=seed)
    r_tiers, r_names, r_world = ref(n_tiers, n_instances, seed=seed)
    assert names == r_names
    fields = [f.name for f in dataclasses.fields(tiers[0])]
    assert [[getattr(t, f) for f in fields] for t in tiers] == [
        [getattr(t, f) for f in fields] for t in r_tiers]
    np.testing.assert_array_equal(world.capacity, r_world.capacity)
    np.testing.assert_array_equal(world.verbosity, r_world.verbosity)
    assert sum(t.n_instances for t in tiers) == n_instances


@pytest.mark.parametrize("name,n,seed", [("multitenant", 150, 5),
                                         ("session_chat", 120, 0),
                                         ("diurnal_elastic", 100, 2)])
def test_build_requests_match_reference(name, n, seed):
    """Tenant split, arrivals, prompt picks (multi-turn sessions
    included), budgets and priorities, request by request."""
    from repro.serving.scenarios import get_scenario as ref_get
    from repro_torch.serving.scenarios import get_scenario
    rrun = ref_get(name).build(dataset_n=300)
    prun = get_scenario(name).build(dataset_n=300)
    assert prun.reserve_iids == rrun.reserve_iids
    got, want = prun.requests(n, seed=seed), rrun.requests(n, seed=seed)

    def rows(reqs):
        return [(r.rid, r.arrival, r.tenant, r.priority, r.budget,
                 r.prompt.pid, r.prompt.len_in, r.prompt.tokens.tolist(),
                 r.true_quality.tolist(), r.true_length.tolist())
                for r in reqs]
    assert rows(got) == rows(want)
    np.testing.assert_array_equal(got[0].cols.prefix_sig,
                                  want[0].cols.prefix_sig)
    np.testing.assert_array_equal(got[0].cols.prompt_row,
                                  want[0].cols.prompt_row)


def test_registry_and_random_scenarios_match_reference():
    from repro.serving import scenarios as ref
    from repro_torch.serving import scenarios
    assert set(scenarios.SCENARIOS) == set(ref.SCENARIOS)
    for name, sc in scenarios.SCENARIOS.items():
        # the dataclasses are the port's own: compare their fields
        assert repr(sc) == repr(ref.SCENARIOS[name]), name
    with pytest.raises(KeyError):
        scenarios.get_scenario("does-not-exist")
    for seed in range(12):
        assert repr(scenarios.random_scenario(seed)) == repr(
            ref.random_scenario(seed))


def test_schedule_picks_match_reference():
    """`apply_schedule` draws its targets at fire time from the same
    seeded stream: the same instances fail, straggle, mute and recover,
    event by event, and a fail never takes the whole fleet."""
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import FailureEvent as RFE
    from repro.serving.scenarios import apply_schedule as r_apply
    from repro.serving.scenarios import synthetic_pool as r_pool
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import (FailureEvent, apply_schedule,
                                               synthetic_pool)
    events = [dict(t=1.0, kind="fail", frac=0.3),
              dict(t=2.0, kind="straggle", frac=0.4, factor=3.0),
              dict(t=3.0, kind="mute", count=3),
              dict(t=4.0, kind="recover", frac=1.0),
              dict(t=5.0, kind="unmute", frac=1.0),
              dict(t=6.0, kind="fail", frac=1.0)]
    states = []
    for Sim, FE, apply, pool in ((RSim, RFE, r_apply, r_pool),
                                 (ClusterSim, FailureEvent, apply_schedule,
                                  synthetic_pool)):
        tiers, names, _ = pool(4, 24, seed=2)
        sim = Sim(tiers, names, seed=0)
        apply(sim, [FE(**e) for e in events], seed=5)
        seen = []
        for t in (1.5, 2.5, 3.5, 4.5, 5.5, 6.5):
            sim.run(until=t)
            seen.append(([i.alive for i in sim.instances],
                         [i.slowdown for i in sim.instances],
                         [i.tel_mute for i in sim.instances],
                         sim.tel.alive.tolist()))
        states.append(seen)
    assert states[0] == states[1]
    assert sum(states[1][-1][0]) == 1                 # never the whole fleet


def test_randomize_state_matches_reference():
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import get_scenario as ref_get
    from repro.serving.scenarios import randomize_prefix_state as r_prefix
    from repro.serving.scenarios import randomize_telemetry as r_tel
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import (get_scenario,
                                               randomize_prefix_state,
                                               randomize_telemetry)
    rrun = ref_get("session_chat").build(dataset_n=200)
    prun = get_scenario("session_chat").build(dataset_n=200)
    rsim = r_tel(RSim(rrun.tiers, rrun.names), seed=3, kill_frac=0.25)
    psim = randomize_telemetry(ClusterSim(prun.tiers, prun.names), seed=3,
                               kill_frac=0.25)
    r_prefix(rsim, rrun.requests(40, seed=1)[0].cols, seed=3)
    randomize_prefix_state(psim, prun.requests(40, seed=1)[0].cols, seed=3)
    for name in ("pending", "batch", "free", "ctx", "alive", "last_write",
                 "prefix_sig"):
        np.testing.assert_array_equal(getattr(psim.tel, name),
                                      getattr(rsim.tel, name))
    assert psim.tel.roster_version == rsim.tel.roster_version


# -- cells ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """Built (reference, port) runs, one per scenario, on first use."""
    from repro.serving.scenarios import get_scenario as ref_get
    from repro_torch.serving.scenarios import get_scenario
    cache = {}

    def get(name, dataset_n):
        if name not in cache:
            cache[name] = build_pair(ref_get(name), get_scenario(name),
                                     dataset_n)
        return cache[name]
    return get


@pytest.mark.parametrize("name,dataset_n,n,seed,rb_kw", [
    # the scenario-stream case of the reference's engine-parity tests
    ("multitenant", 400, 150, 5, {}),
    # paper pool: fail 25% at 4 s, straggle 20% at 8 s, recover at 12 s,
    # no recovery manager, so the failures are terminal
    ("failover", 300, 120, 0, {}),
    # multi-turn sessions with the prefix-affinity term on
    ("session_chat", 300, 120, 0, {"affinity_weight": 0.5}),
])
def test_scenario_cell_matches_reference(pairs, name, dataset_n, n, seed,
                                         rb_kw):
    (rreqs, rm), (preqs, pm, pb) = run_pair(*pairs(name, dataset_n), n=n,
                                            seed=seed, **rb_kw)
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    assert_kernel_calls(pm, pb)       # no shape from churn or sessions
    assert pm["n"] + pm["failed"] + pm["shed"] == len(preqs)
    if name == "failover":
        assert pm["failed"] > 0 and pb._fused.stats["roster_reseed"] > 0
    if name == "multitenant":
        assert set(pm["tenants"]) == {"chat", "code", "batch"}
    if name == "session_chat":
        assert np.mean([r.prefix_hit for r in preqs]) > 0


@pytest.fixture(scope="module")
def wide_pair():
    """A 4,097-instance roster (I bucket 8,192, past the decision
    kernel's shared carry) in both packages: the reference's bundle and
    the port's bridged from it, and the port's dataset."""
    from repro.core import EstimatorBundle as RBundle
    from repro.serving.scenarios import synthetic_pool as r_pool
    from repro.serving.world import build_dataset as r_build
    from repro_torch.serving.scenarios import synthetic_pool
    from repro_torch.serving.world import build_dataset
    from torch_scenario_parity import port_bundle
    tiers, names, world = synthetic_pool(3, 4097, seed=2)
    r_tiers, r_names, r_world = r_pool(3, 4097, seed=2)
    r_ds = r_build(r_world, n=150, seed=3)
    r_bundle = RBundle.train(r_ds, r_tiers, r_names)
    return dict(tiers=tiers, names=names, ds=build_dataset(world, n=150,
                                                           seed=3),
                bundle=port_bundle(r_bundle, r_tiers, r_names),
                r_tiers=r_tiers, r_names=r_names, r_ds=r_ds,
                r_bundle=r_bundle)


@pytest.mark.parametrize("fail", [False, True], ids=["steady", "half_dead"])
def test_megakernel_serves_a_roster_past_the_shared_carry(wide_pair, fail):
    """One controller on the port's default megakernel backend (the
    plain version on the CPU) over 4,097 instances, against the
    reference's default "fused" backend on the same roster and
    requests, with and without a `FailureEvent` that kills half the
    roster: the same instance for every request, identical completions
    and `run_cell` metrics, `pred_len` (the chosen l) within rtol 1e-5
    as the kernel tests hold l_chosen; one kernel call per fired batch
    at the 8,192 bucket."""
    import repro.core as R
    import repro_torch.core as P
    from repro.serving.scenarios import FailureEvent as RFE
    from repro.serving.workload import poisson_arrivals as r_arrivals
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.serving.scenarios import FailureEvent
    from repro_torch.serving.workload import poisson_arrivals
    w = wide_pair
    kw = dict(t=0.05, kind="fail", frac=0.5)
    rreqs = R.make_requests(w["r_ds"], "test",
                            r_arrivals(200.0, 40, seed=0))
    rm = R.run_cell(R.RouteBalance(R.RBConfig(charge_compute=False),
                                   w["r_bundle"], w["r_tiers"]),
                    w["r_tiers"], w["r_names"], rreqs,
                    schedule=(RFE(**kw),) if fail else None, schedule_seed=1)
    preqs = P.make_requests(w["ds"], "test",
                            poisson_arrivals(200.0, 40, seed=0))
    preqs[0].cols.emb = rreqs[0].cols.emb   # the reference's ingest rows
    rb = P.RouteBalance(P.RBConfig(charge_compute=False), w["bundle"],
                        w["tiers"])
    calls = mk.decision_megakernel.plain_calls
    pm = P.run_cell(rb, w["tiers"], w["names"], preqs,
                    schedule=(FailureEvent(**kw),) if fail else None,
                    schedule_seed=1)
    assert rb._fused._Itot == 8192 and rb._fused._n_real == 4097
    assert [r.instance for r in preqs] == [r.instance for r in rreqs]
    assert completions(preqs) == completions(rreqs)
    assert [r.pred_len for r in preqs] == pytest.approx(
        [r.pred_len for r in rreqs], rel=1e-5)
    assert_metrics_equal(rm, pm)
    assert (mk.decision_megakernel.plain_calls - calls
            == rb._fused.stats["calls"] == len(rb.compute_log) > 0)
    assert pm["n"] + pm["failed"] == len(preqs) and pm["n"] > 0
    if fail:
        assert 2 * int(rb.sim.tel.alive.sum()) <= 4097 + 1   # half dead


@pytest.mark.slow
def test_hyperfleet_flat_matches_reference(pairs):
    """`hyperfleet_10k` as one controller (10,000 instances, I bucket
    16,384) on both packages' default backends, 200 requests: identical
    completions and metrics, one kernel call per fired batch."""
    (rreqs, rm), (preqs, pm, pb) = run_pair(*pairs("hyperfleet_10k", 1200),
                                            n=200)
    assert pb._fused._Itot == 16384
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    assert_kernel_calls(pm, pb)


def test_run_cell_schedule_over_a_staged_roster_beyond_the_limit():
    """A roster one instance past the kernel's shared carry serves a
    short stream through `run_cell(schedule=...)` on the staged torch
    backend, its requests all terminal."""
    from repro_torch.core import EstimatorBundle, RBConfig, RouteBalance
    from repro_torch.core import make_requests, run_cell
    from repro_torch.kernels import decision_megakernel as mk
    from repro_torch.serving.scenarios import FailureEvent, synthetic_pool
    from repro_torch.serving.workload import poisson_arrivals
    from repro_torch.serving.world import build_dataset
    tiers, names, world = synthetic_pool(3, mk.MAX_SHARED_I + 1, seed=2)
    ds = build_dataset(world, n=150, seed=3)
    bundle = EstimatorBundle.train(ds, tiers, names, device="cpu")
    reqs = make_requests(ds, "test", poisson_arrivals(200.0, 40, seed=0))
    rb = RouteBalance(RBConfig(decision_backend="torch",
                               charge_compute=False), bundle, tiers)
    m = run_cell(rb, tiers, names, reqs,
                 schedule=(FailureEvent(t=0.05, kind="fail", frac=0.5),),
                 schedule_seed=1)
    assert m["n"] + m["failed"] == len(reqs) and m["n"] > 0
    assert rb._fused is None and len(rb.compute_log) > 0
