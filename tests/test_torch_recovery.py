"""The port's fault-tolerant request lifecycle against the JAX reference:
retry/requeue, hedged re-dispatch, the telemetry watchdog's quarantine
and its degraded least-loaded fallback, and the controller's checkpoint
and restore across a simulated crash (`repro_torch.serving.recovery`,
`serving.faults`, `ServingEngine.checkpoint_tree`/`resume`,
`distributed.checkpoint`).

The chaos cells run the reference's `chaos_world` (4 tiers, 8
instances, dataset_n=300, 120 requests) on its "fused" backend and the
port's on "megakernel" (the kernel's plain version here), both with
`charge_compute=False` and the port's bundle bridged from the
reference's: the per-request completion tuples must be identical, and
every `run_cell` metric equal, the recovery counters included.
"""
import numpy as np
import pytest

from torch_scenario_parity import (assert_kernel_calls,
                                   assert_metrics_equal, build_pair,
                                   completions, run_pair)


@pytest.fixture(scope="module")
def chaos_pair():
    from repro.serving.faults import chaos_world
    from repro_torch.serving import faults
    return build_pair(chaos_world(), faults.chaos_world(), dataset_n=300)


def _campaign(name):
    """(schedule builder over tiers, recovery config or "scenario" / None,
    lam_scale) of each chaos cell; builders take the package's tiers."""
    import repro.serving.faults as F
    from repro.serving.recovery import RecoveryConfig
    return {
        "crash_storm": (F.crash_storm, "scenario", 1.0),
        "correlated_failure": (F.correlated_failure, "scenario", 1.0),
        "straggler_storm_hedged": (
            lambda t: F.straggler_storm(t, frac=0.7, factor=8.0,
                                        duration=10.0),
            RecoveryConfig(hedge_factor=2.5, hedge_slack_s=1.0), 1.0),
        "blackout_half": (lambda t: F.telemetry_blackout(t, frac=0.5),
                          "scenario", 1.0),
        "blackout_full": (lambda t: F.telemetry_blackout(t, frac=1.0),
                          "scenario", 1.0),
        # the same full blackout under half again the load: every
        # instance holds work while the mirror is dark, so the watchdog
        # declares it dark and the degraded least-loaded path decides
        "blackout_full_loaded": (
            lambda t: F.telemetry_blackout(t, frac=1.0), "scenario", 1.5),
        "crash_storm_no_recovery": (F.crash_storm, None, 1.0),
    }[name]


def _chaos_cell(pair, name, **rb_kw):
    sched, rec, scale = _campaign(name)
    rrun, prun = pair
    return run_pair(rrun, prun, schedule=sched, recovery=rec, n=120,
                    lam_scale=scale, **rb_kw)


@pytest.mark.parametrize("name", [
    "crash_storm", "correlated_failure", "straggler_storm_hedged",
    "blackout_half", "blackout_full", "blackout_full_loaded",
    "crash_storm_no_recovery"])
def test_chaos_cell_matches_reference(chaos_pair, name):
    (rreqs, rm), (preqs, pm, pb) = _chaos_cell(chaos_pair, name)
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    armed = name != "crash_storm_no_recovery"
    assert ("retries" in pm) == armed
    if armed:
        assert pm["failed"] == 0 and pm["n"] == len(preqs)
    else:
        assert pm["failed"] > 0                  # lost work, terminal
    want = {"crash_storm": ("retries",), "correlated_failure": ("retries",),
            "straggler_storm_hedged": ("hedges", "duplicate_tokens"),
            "blackout_half": ("quarantines",),
            "blackout_full_loaded": ("degraded_decisions",)}
    for key in want.get(name, ()):
        assert pm[key] > 0, key
    if name == "blackout_full":
        # what the reference's test_full_blackout_degrades_to_least_loaded
        # cell produces (seed 0, lam_scale 1): no degraded decision. An
        # idle instance counts as fresh, so the watchdog quarantines the
        # busy rows one by one and the mirror is never wholly dark; under
        # half again the load ("blackout_full_loaded") it is
        assert (rm["failed"], rm["degraded_decisions"]) == (0, 0)
        assert rm["quarantines"] > 0
    assert_kernel_calls(pm, pb)
    if name == "blackout_half":                  # quarantine churn
        assert pb._fused.stats["roster_reseed"] > 0


# -- checkpoint/restore across a controller crash -----------------------------

def _controlled_run(run, reqs, sched, pkg, crash_at=None, ckpt=None):
    """One windowed cell with recovery armed (the reference's
    `test_recovery._controlled_run`), in package `pkg`; optionally crash
    the controller at `crash_at` and resume a FRESH engine from the
    checkpoint taken at the crash instant — in memory, or through a
    `CheckpointManager` when `ckpt` is given."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    cluster = importlib.import_module(f"{pkg}.serving.cluster")
    rec = importlib.import_module(f"{pkg}.serving.recovery")
    scen = importlib.import_module(f"{pkg}.serving.scenarios")
    metrics = importlib.import_module(f"{pkg}.serving.metrics")
    cfg = (dict(decision_backend="fused", charge_compute=False)
           if pkg == "repro" else dict(charge_compute=False))
    sim = cluster.ClusterSim(run.tiers, run.names, seed=0)
    rec.arm_recovery(sim, rec.RecoveryConfig())
    eng1 = core.RouteBalance(core.RBConfig(**cfg), run.bundle(), run.tiers)
    eng1.expected = len(reqs)
    eng1.attach(sim)
    holder = {"eng": eng1}
    for r in reqs:
        sim.push(r.arrival, lambda t, rr=r: holder["eng"].enqueue(rr, t))
    scen.apply_schedule(sim, sched, seed=1)
    if crash_at is not None:
        def crash(t):
            if ckpt is None:
                tree = holder["eng"].checkpoint_tree()
            else:
                holder["eng"].save_checkpoint(ckpt, step=1)
            dropped = rec.simulate_controller_crash(sim, holder["eng"])
            assert dropped > 0                   # something actually died
            if ckpt is not None:
                tree, step = ckpt.restore(
                    core.ServingEngine._checkpoint_template())
                assert step == 1
            rec.arm_recovery(sim, rec.RecoveryConfig())
            eng2 = core.RouteBalance(core.RBConfig(**cfg), run.bundle(),
                                     run.tiers)
            eng2.resume(sim, tree, reqs)
            holder["eng"] = eng2
        sim.push(crash_at, crash)
    sim.run()
    metrics.check_terminal_states(reqs)
    return completions(reqs)


@pytest.fixture(scope="module")
def uncrashed(chaos_pair):
    """The uncrashed crash-storm trace on both packages (identical)."""
    from repro.serving.faults import crash_storm
    from repro_torch.serving import faults
    rrun, prun = chaos_pair
    rreqs = rrun.requests(120, seed=0)
    ref = _controlled_run(rrun, rreqs, crash_storm(rrun.tiers), "repro")
    preqs = prun.requests(120, seed=0)
    preqs[0].cols.emb = rreqs[0].cols.emb
    got = _controlled_run(prun, preqs, faults.crash_storm(prun.tiers),
                          "repro_torch")
    assert got == ref
    return ref, rreqs[0].cols.emb


@pytest.mark.parametrize("through", ["memory", "manager"])
@pytest.mark.parametrize("crash_at", [2.0, 5.3, 9.1])
def test_controller_crash_restore_bitwise_identical(chaos_pair, uncrashed,
                                                    tmp_path, crash_at,
                                                    through):
    """A controller crash + restore mid-trace resumes the port to the
    completion set of the uncrashed port run and of the reference's,
    bitwise — through an active crash storm, before, during and after
    the fault window, from memory and from disk."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.serving import faults
    ref, emb = uncrashed
    prun = chaos_pair[1]
    reqs = prun.requests(120, seed=0)
    reqs[0].cols.emb = emb
    ckpt = (CheckpointManager(tmp_path / "ckpt") if through == "manager"
            else None)
    got = _controlled_run(prun, reqs, faults.crash_storm(prun.tiers),
                          "repro_torch", crash_at=crash_at, ckpt=ckpt)
    assert got == ref, f"divergence after crash at t={crash_at}"


def test_checkpoint_tree_matches_reference_layout(chaos_pair):
    """The port's controller tree has the reference's keys, dtypes and
    template, so either package's checkpoint reads back the same."""
    from repro.core import ServingEngine as RefEngine
    from repro_torch.core import ServingEngine
    want = RefEngine._checkpoint_template()
    got = ServingEngine._checkpoint_template()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape


def test_checkpoint_manager_keeps_newest_and_casts(tmp_path):
    """Atomic step directories, `keep` GC, latest/all steps, dtypes from
    the template and shapes from the stored arrays."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    mgr = CheckpointManager(tmp_path, keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": np.zeros(0)})
    for step in (1, 2, 3):
        mgr.save(step, {"a": np.arange(step, dtype=np.int32),
                        "b": np.full((step, 2), 0.5)}, metadata={"s": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not list(tmp_path.glob(".tmp_*"))
    tree, step = mgr.restore({"a": np.zeros(0, np.int64),
                              "b": np.zeros((0, 2), np.float32)})
    assert step == 3 and tree["a"].dtype == np.int64
    np.testing.assert_array_equal(tree["a"], [0, 1, 2])
    assert tree["b"].dtype == np.float32 and tree["b"].shape == (3, 2)
    tree, step = mgr.restore({"a": np.zeros(0, np.int64)}, step=2)
    assert step == 2 and tree["a"].tolist() == [0, 1]
    with pytest.raises(TypeError):
        mgr.save(4, {"a": {"nested": np.zeros(1)}})


# -- the lifecycle's units, against the reference -----------------------------

def _mini_sims(n_tiers=2, n_instances=4, seed=0):
    """The same synthetic roster as a reference and a port sim."""
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import synthetic_pool as rpool
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import synthetic_pool
    rt, rn, _ = rpool(n_tiers, n_instances, seed=seed)
    pt, pn, _ = synthetic_pool(n_tiers, n_instances, seed=seed)
    assert [t.name for t in pt] == [t.name for t in rt]
    return RSim(rt, rn, seed=0), ClusterSim(pt, pn, seed=0)


def _req(pkg, rid=0, arrival=0.0):
    import importlib
    request = importlib.import_module(f"{pkg}.serving.request")
    world = importlib.import_module(f"{pkg}.serving.world")
    prompt = world.Prompt(pid=rid, topic=0, difficulty=0.5, verbosity=0.5,
                          tokens=np.zeros(4, np.int32), len_in=64)
    return request.Request(rid=rid, prompt=prompt, arrival=arrival,
                           true_quality=np.full(8, 0.5),
                           true_length=np.full(8, 40.0))


@pytest.mark.parametrize("attempt", [1, 2, 3])
def test_backoff_replays_the_reference(attempt):
    """Counter-based jitter keyed on (seed, rid, attempt): the port's
    retry due time is the reference's, bitwise, and inside the band."""
    from repro.serving.recovery import RecoveryConfig as RCfg
    from repro.serving.recovery import arm_recovery as r_arm
    from repro_torch.serving.recovery import (RecoveryConfig, _jitter_u,
                                              arm_recovery)
    from repro.serving.recovery import _jitter_u as r_jitter
    rsim, psim = _mini_sims()
    dues = []
    for sim, arm, cfg, pkg in ((rsim, r_arm, RCfg(max_attempts=4), "repro"),
                               (psim, arm_recovery,
                                RecoveryConfig(max_attempts=4),
                                "repro_torch")):
        mgr = arm(sim, cfg)
        r = _req(pkg, 11)
        r.attempt = attempt - 1
        assert mgr.on_failure(r, sim.instances[0], 5, now=2.0)
        (_, due), = mgr._pending.values()
        dues.append(due)
        nominal = cfg.backoff_base_s * cfg.backoff_mult ** (attempt - 1)
        assert (2.0 + nominal * (1 - cfg.backoff_jitter) <= due
                <= 2.0 + nominal * (1 + cfg.backoff_jitter))
    assert dues[0] == dues[1]
    for rid in range(5):
        assert _jitter_u(3, rid, attempt) == r_jitter(3, rid, attempt)


def test_attempt_bound_gives_up():
    from repro_torch.serving.recovery import RecoveryConfig, arm_recovery
    _, sim = _mini_sims()
    mgr = arm_recovery(sim, RecoveryConfig(max_attempts=3))
    r = _req("repro_torch", 5)
    assert mgr.on_failure(r, sim.instances[0], 0, 0.0)    # attempt 0 -> 1
    assert mgr.on_failure(r, sim.instances[0], 0, 1.0)    # attempt 1 -> 2
    assert not mgr.on_failure(r, sim.instances[0], 0, 2.0)   # exhausted
    assert r.attempt == 2 and mgr.gave_up == 1
    done = _req("repro_torch", 6)
    done.finish_time = 1.0
    assert not mgr.on_failure(done, sim.instances[0], 0, 2.0)
    assert done.attempt == 0                     # terminal: untouched


def test_fail_routes_inflight_and_queued_through_recovery():
    from repro_torch.serving.cluster import _Seq
    from repro_torch.serving.recovery import RecoveryConfig, arm_recovery
    _, sim = _mini_sims(n_tiers=1, n_instances=2)
    mgr = arm_recovery(sim, RecoveryConfig())
    inst = sim.instances[0]
    a, b = _req("repro_torch", 0), _req("repro_torch", 1)
    a.instance = b.instance = inst.iid
    inst.running.append(_Seq(req=a, target_tokens=40, max_tokens=10 ** 9,
                             budget_tokens=None, generated=7, ctx=71))
    inst.queue.append((b, 50.0))
    inst.fail()
    assert mgr.retries == 2 and not a.failed and not b.failed
    assert a.finish_time is None and b.finish_time is None
    assert a.wasted_tokens == 7 and b.wasted_tokens == 0
    assert a.attempt == 1 and b.attempt == 1 and sim.completed == []


def test_degraded_assign_counts_batches_and_decisions():
    """`degraded_assign` spreads a batch least-loaded over the alive
    instances and counts it (`degraded_batches`) beside its requests
    (`degraded_decisions`); the batch count stays out of the checkpoint,
    whose layout is the reference's."""
    from repro_torch.core.engine import BatchView
    from repro_torch.serving.recovery import RecoveryConfig, arm_recovery
    _, sim = _mini_sims(n_tiers=1, n_instances=3)
    mgr = arm_recovery(sim, RecoveryConfig())
    sim.instances[1].fail()
    for n, rids in enumerate(((0, 1, 2, 3), (4, 5))):
        res = mgr.degraded_assign(
            BatchView([_req("repro_torch", r) for r in rids]), sim)
        choice, l_chosen = res.fetch()
        assert 1 not in set(choice.tolist())    # the dead instance
        np.testing.assert_array_equal(
            l_chosen, np.full(len(rids), RecoveryConfig().degraded_pred_len))
        assert mgr.degraded_batches == n + 1
    assert mgr.degraded_decisions == 6
    assert mgr.pending_state()["recovery_counters"].shape == (7,)


def test_stale_iterate_epoch():
    """A pre-failure `_iterate` firing after fail -> recover is a no-op."""
    _, sim = _mini_sims(n_tiers=1, n_instances=1)
    inst = sim.instances[0]
    inst.busy_until = 1.0
    inst.submit(_req("repro_torch", 0), 0.0, 10.0, None)
    assert inst.epoch == 0 and inst.iter_scheduled
    sim.push(0.1, lambda t: inst.fail())
    sim.push(0.2, lambda t: inst.recover(t))
    sim.run(until=0.5)
    assert inst.epoch == 1 and not inst.iter_scheduled
    v = sim.tel.version
    sim.run(until=1.5)                           # the stale event fires
    assert not inst.iter_scheduled and sim.tel.version == v
    assert inst.running == [] and sim.completed[0].failed


def test_least_loaded_and_fastest_drain_match_reference():
    import repro.serving.recovery as RR
    import repro_torch.serving.recovery as PR
    picks = []
    for sim, mod, pkg in zip(_mini_sims(n_tiers=2, n_instances=4),
                             (RR, PR), ("repro", "repro_torch")):
        a, b, c, d = sim.instances
        a.quarantined = True
        b.queue.append((_req(pkg, 0), 10.0))
        row = [mod.least_loaded_instance(sim).iid,
               mod.least_loaded_instance(sim, exclude=(c.iid, d.iid)).iid,
               mod.fastest_drain_instance(sim).iid,
               mod.fastest_drain_instance(sim, exclude=(c.iid,)).iid]
        b.alive = c.alive = d.alive = False
        row.append(mod.least_loaded_instance(sim, exclude=(a.iid,)))
        picks.append(row)
    assert picks[0] == picks[1] and picks[1][-1] is None


def test_retries_are_never_shed():
    """Admission control gates NEW work only."""
    from repro_torch.core import EngineConfig, ServingEngine
    from repro_torch.serving.overload import OverloadConfig, arm_elastic

    class _Policy:
        budget_clamp = False
        name = "stub"

        def engine_overrides(self):
            return {}

        def prepare(self, bundle, tiers):
            self.bundle = bundle

        def on_attach(self, sim):
            pass

        def shed_verdict(self, req, ctl):
            return True                           # shed EVERYTHING

    class _Bundle:
        encoder = None

    _, sim = _mini_sims()
    arm_elastic(sim, OverloadConfig())
    eng = ServingEngine(_Policy(), _Bundle(), sim.tiers, EngineConfig())
    eng.attach(sim)
    fresh, retry = _req("repro_torch", 0), _req("repro_torch", 1)
    retry.attempt = 1
    eng.enqueue(fresh, 0.0)
    eng.enqueue(retry, 0.0)
    assert fresh.shed and not retry.shed and eng.waiting == [retry]
