"""The port's overload control and elastic roster against the JAX
reference (`repro_torch.serving.overload`): the detector's load score,
hysteresis and cooldown, the autoscaler's provisioning lag and idle-only
scale-down, SLO-aware priority shedding, the fail/recover pins the
autoscaler rides on, and the `flashcrowd_elastic` scenario end to end —
reference "fused" against port "megakernel" (its plain version here),
`charge_compute=False`, identical per-request completions and equal
`run_cell` metrics, the overload counters included."""
import numpy as np
import pytest

from torch_scenario_parity import (assert_kernel_calls,
                                   assert_metrics_equal, build_pair,
                                   completions, run_pair)


def _mini_sim(n_tiers=2, n_instances=4, seed=0):
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import synthetic_pool
    tiers, names, _ = synthetic_pool(n_tiers, n_instances, seed=seed)
    return ClusterSim(tiers, names, seed=0)


def _req(rid=0, priority=0, arrival=0.0):
    from repro_torch.serving.request import Request
    from repro_torch.serving.world import Prompt
    prompt = Prompt(pid=rid, topic=0, difficulty=0.5, verbosity=0.5,
                    tokens=np.zeros(4, np.int32), len_in=64)
    return Request(rid=rid, prompt=prompt, arrival=arrival,
                   true_quality=np.full(8, 0.5),
                   true_length=np.full(8, 40.0), priority=priority)


# -- detector, autoscaler, shedding -------------------------------------------

def test_load_score_normalizes_by_alive_capacity():
    from repro_torch.serving.overload import load_score
    sim = _mini_sim()
    tel = sim.tel
    assert load_score(tel) == 0.0
    tel.batch[:] = tel.max_batch            # fleet exactly full
    assert load_score(tel) == pytest.approx(1.0)
    tel.queue[:] = tel.max_batch            # one fleet of backlog behind
    assert load_score(tel) == pytest.approx(2.0)
    sim.instances[0].fail()
    assert load_score(tel) == pytest.approx(2.0)
    tel.alive[:] = False
    assert load_score(tel) == float("inf")


def test_detector_hysteresis_and_cooldown():
    from repro_torch.serving.overload import ElasticController, OverloadConfig
    sim = _mini_sim(n_tiers=2, n_instances=6)
    reserve = [i.iid for i in sim.instances[-2:]]
    cfg = OverloadConfig(up_threshold=1.25, up_patience=2, cooldown_s=5.0,
                         scale_up_lag_s=0.5, max_step=1,
                         shed_enabled=False)
    ctl = ElasticController(sim, cfg, reserve).arm()
    tel = sim.tel

    def pressure(on):
        tel.queue[:] = tel.max_batch * (3.0 if on else 0.0)

    pressure(True)
    ctl._check(0.25)
    assert ctl._hot == 1 and ctl.scale_ups == 0     # patience not met
    pressure(False)
    ctl._check(0.50)
    assert ctl._hot == 0                            # streak reset
    pressure(True)
    ctl._check(0.75)
    ctl._check(1.00)
    assert ctl.scale_ups == 1                       # 2 consecutive hots
    ctl._check(1.25)
    ctl._check(1.50)
    assert ctl.scale_ups == 1                       # cooldown gates
    ctl._check(7.00)
    ctl._check(7.25)
    assert ctl.scale_ups == 2                       # cooldown expired


def test_scale_up_pays_provisioning_lag():
    from repro_torch.serving.overload import ElasticController, OverloadConfig
    sim = _mini_sim(n_tiers=2, n_instances=6)
    reserve = [i.iid for i in sim.instances[-2:]]
    cfg = OverloadConfig(up_patience=1, cooldown_s=0.0, scale_up_lag_s=2.0,
                         max_step=1, shed_enabled=False)
    ctl = ElasticController(sim, cfg, reserve).arm()
    assert not any(sim.by_id[iid].alive for iid in reserve)   # armed cold
    sim.tel.queue[:] = sim.tel.max_batch * 5.0      # sustained pressure
    sim.push(10.0, lambda t: None)                  # keep the loop alive
    sim.run(until=1.0)
    ups = [(t, iid) for t, kind, iid in ctl.events if kind == "scale_up"]
    assert ups and ups[0][0] <= 1.0
    t_up, iid = ups[0]
    assert not sim.by_id[iid].alive                 # still provisioning
    sim.run(until=t_up + 2.0 + 1e-9)
    assert sim.by_id[iid].alive                     # ready after the lag
    ready = [(t, i) for t, kind, i in ctl.events if kind == "ready"]
    assert ready[0] == (pytest.approx(t_up + 2.0), iid)


def test_scale_down_retires_idle_reserves_only():
    from repro_torch.serving.overload import ElasticController, OverloadConfig
    sim = _mini_sim(n_tiers=2, n_instances=6)
    r0, r1 = sim.instances[-2], sim.instances[-1]
    ctl = ElasticController(sim, OverloadConfig(shed_enabled=False),
                            [r0.iid, r1.iid])
    r0.queue.append((_req(), 10.0))
    ctl._scale_down(1.0)
    assert r0.alive and not r1.alive                # idle one retired
    assert ctl.scale_downs == 1
    ctl._last_scale = -10.0
    ctl._scale_down(2.0)
    assert r0.alive and ctl.scale_downs == 1        # busy: never revoked


def test_shed_thresholds_and_policy_veto():
    from repro_torch.core import RBConfig, RouteBalancePolicy
    from repro_torch.serving.overload import ElasticController, OverloadConfig
    sim = _mini_sim()
    ctl = ElasticController(sim, OverloadConfig(shed_thresholds=(6.0, 3.0,
                                                                 1.8)), [])
    for load, want in ((2.0, [False, False, True]),
                       (4.0, [False, True, True]),
                       (7.0, [True, True, True])):
        ctl.load = load
        assert [ctl.wants_shed(p) for p in (0, 1, 2)] == want
    assert ctl.wants_shed(9)                        # beyond: the last entry
    assert not ElasticController(
        sim, OverloadConfig(shed_enabled=False), []).wants_shed(2)
    ctl.load = 100.0
    req = _req(priority=2)
    assert RouteBalancePolicy(RBConfig()).shed_verdict(req, ctl)
    assert not RouteBalancePolicy(RBConfig(shed=False)).shed_verdict(req,
                                                                      ctl)


@pytest.mark.parametrize("n_tiers,base,k", [(4, 6, 2), (3, 5, 3), (2, 4, 0)])
def test_provision_reserve_matches_reference(n_tiers, base, k):
    from repro.serving.overload import provision_reserve as ref_provision
    from repro.serving.scenarios import synthetic_pool as ref_pool
    from repro_torch.core.decision import bucket_pow2
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.overload import provision_reserve
    from repro_torch.serving.scenarios import synthetic_pool
    tiers, names, _ = synthetic_pool(n_tiers, base, seed=5)
    out, reserve = provision_reserve(tiers, k)
    r_out, r_reserve = ref_provision(ref_pool(n_tiers, base, seed=5)[0], k)
    assert reserve == r_reserve
    assert [(t.name, t.n_instances) for t in out] == [
        (t.name, t.n_instances) for t in r_out]
    assert sum(t.n_instances for t in out) == base + k
    assert bucket_pow2(base + k) == bucket_pow2(base)
    sim = ClusterSim(out, names, seed=0)
    assert all(iid in sim.by_id for iid in reserve)


# -- fail/recover pins the autoscaler rides on --------------------------------

def test_kill_does_not_stamp_last_write():
    """`TelemetryArrays.kill` bumps version + roster_version but not the
    row's stamp, so the hot path reseeds on roster_version; revive
    writes the row."""
    sim = _mini_sim()
    tel = sim.tel
    inst = sim.instances[1]
    v0, r0 = tel.version, tel.roster_version
    inst.fail()
    assert tel.version > v0
    assert inst.slot not in tel.dirty_rows(v0)
    assert tel.roster_version == r0 + 1
    inst.recover(1.0)
    assert tel.roster_version == r0 + 2
    assert inst.slot in tel.dirty_rows(v0)


def test_recover_keeps_pending_iterate_single_chained():
    """fail -> recover -> resubmit while a pre-failure `_iterate` is
    still in the heap runs exactly one live decode chain."""
    sim = _mini_sim(n_tiers=1, n_instances=1)
    inst = sim.instances[0]
    inst.busy_until = 1.0
    inst.submit(_req(0), 0.0, 10.0, None)
    assert inst.iter_scheduled

    def live_iterates():
        n = 0
        for _, _, fn in sim._events:
            f = getattr(fn, "func", None)
            if (getattr(f, "__self__", None) is inst
                    and getattr(f, "__func__", None) is type(inst)._iterate
                    and fn.keywords.get("epoch") == inst.epoch):
                n += 1
        return n

    assert live_iterates() == 1
    sim.push(0.1, lambda t: inst.fail())
    sim.push(0.2, lambda t: inst.recover(t))
    sim.push(0.3, lambda t: inst.submit(_req(1), t, 10.0, None))
    sim.run(until=0.5)
    assert inst.alive and inst.iter_scheduled
    assert live_iterates() == 1
    sim.run()
    assert live_iterates() == 0
    assert [r.rid for r in sim.completed if not r.failed] == [1]


def test_quarantine_and_mark_all_dirty_reach_the_mirror():
    """Quarantine / unquarantine flip the alive mask with a roster bump
    (the hot path reseeds); `mark_all_dirty` stamps every row, so a
    delta sync re-reads all of them."""
    sim = _mini_sim(n_tiers=2, n_instances=4)
    tel = sim.tel
    r0, v0 = tel.roster_version, tel.version
    tel.quarantine(2)
    assert not tel.alive[2] and tel.roster_version == r0 + 1
    tel.unquarantine(2)
    assert tel.alive[2] and tel.roster_version == r0 + 2
    tel.mark_all_dirty()
    assert tel.dirty_rows(v0).tolist() == list(range(4))
    assert sim.alive_instances() == sim.instances
    assert set(sim.telemetry()) == {i.iid for i in sim.instances}


# -- the elastic scenario end to end ------------------------------------------

@pytest.fixture(scope="module")
def elastic_pair():
    from repro.serving.scenarios import get_scenario as ref_get
    from repro_torch.serving.scenarios import get_scenario
    return build_pair(ref_get("flashcrowd_elastic"),
                      get_scenario("flashcrowd_elastic"), dataset_n=300)


@pytest.mark.parametrize("shed", [True, False])
def test_elastic_scenario_matches_reference(elastic_pair, shed):
    """flashcrowd_elastic (4 tiers, 6 + 2 reserve instances), 420
    requests at 4x the tenants' rates: autoscaling and shedding, the
    same trajectory and counters as the reference."""
    (rreqs, rm), (preqs, pm, pb) = run_pair(*elastic_pair, n=420,
                                            lam_scale=4.0, seed=3,
                                            shed=shed)
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    assert pm["scale_ups"] > 0
    assert pm["n"] + pm["shed"] + pm["failed"] == len(preqs)
    assert (pm["shed"] > 0) == shed
    assert_kernel_calls(pm, pb)                  # no shape on autoscale
    assert pb._fused.stats["roster_reseed"] > 0
    for r in preqs:
        if r.shed:
            assert r.instance is None and r.finish_time is None
