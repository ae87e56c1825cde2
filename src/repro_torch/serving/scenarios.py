"""Cluster-scale scenario subsystem: parameterized serving worlds far
beyond the seed fixture.

The paper's headline results are fleet-scale — a 13-instance, 28-GPU
heterogeneous pool traced across a quality-cost-throughput frontier at
up to 30 req/s, with serial-scoring baselines collapsing 23x under load
(§6). This module generates the worlds those experiments need, and the
randomized ones a differential soak feeds to the megakernel, staged
and numpy backends:

  * **synthetic rosters** (`synthetic_pool`): capacity-laddered pools
    scaling from the paper's 4-tier/13-instance cell up to 16 tiers x
    128+ instances, with heterogeneous price / TPOT-roofline / batch
    profiles and a matched `World` so estimator training works exactly
    as on the paper pool;
  * **scripted failure, recovery and straggler injection**
    (`FailureEvent` + `apply_schedule`): timed events against a running
    `ClusterSim` — node death (`Instance.fail`), re-entry with a clean
    slate (`Instance.recover`) and hidden slowdowns
    (`Instance.set_slowdown`) that telemetry does NOT report, the
    model-mismatch stress dead reckoning must survive;
  * **composite workload traces** (`TenantSpec` + `build_requests`):
    multi-tenant mixes layered on `serving.workload` — each tenant has
    its own arrival process (poisson / gamma-bursty / diurnal square
    wave / flash crowd), prompt topic/length distribution and budget
    mix; traces are merged into one arrival-ordered request stream.

`SCENARIOS` names ready-made worlds (`get_scenario`); `random_scenario`
draws a seeded random world for a soak.

Port of `repro.serving.scenarios` (numpy): the same seeds build the same
rosters, datasets, request streams and schedules. `ScenarioRun` trains
its estimator bundle through the port's `EstimatorBundle.train`, on the
card unless given ``device="cpu"``, and runs cells through the port's
`run_cell`. `hyperfleet_10k` (10,000 instances, roster bucket 16,384)
runs on every backend: as one controller through the decision kernel
(past `kernels.decision_megakernel.MAX_SHARED_I` instances the kernel
spreads its scan's per-instance arrays over a thread-block cluster; on
the CPU the plain version decides), on the staged backends, or in the hierarchy's
cells.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster import ClusterSim
from .overload import OverloadConfig, arm_elastic, provision_reserve
from .recovery import RecoveryConfig, arm_recovery
from .request import Request
from .tiers import Tier, paper_pool_tiers
from .workload import make_arrivals, sample_budgets
from .world import TOPICS, Dataset, World, build_dataset, paper_world


# -- synthetic rosters --------------------------------------------------------

def synthetic_pool(n_tiers: int, n_instances: int, seed: int = 0
                   ) -> Tuple[List[Tier], List[str], World]:
    """A heterogeneous capacity ladder of `n_tiers` models spread over
    `n_instances` instances, with per-tier price / roofline / batch
    profiles calibrated to bracket the paper pool (3b..72b-class).

    Replica counts are skewed toward the cheap tiers (as in Table 1:
    2/3/5/3), every tier keeps >= 1 instance, and the returned `World`
    uses the ladder's capacities/verbosities so datasets and estimator
    bundles train exactly as on the paper pool.
    """
    assert n_tiers >= 1 and n_instances >= n_tiers, (n_tiers, n_instances)
    rng = np.random.default_rng(seed)
    caps = np.linspace(0.26, 0.74, n_tiers) if n_tiers > 1 \
        else np.array([0.5])
    caps = np.clip(caps + rng.uniform(-0.015, 0.015, n_tiers), 0.05, 0.95)
    verb = (np.linspace(1.18, 0.82, n_tiers) if n_tiers > 1
            else np.array([1.0])) * np.exp(rng.normal(0, 0.04, n_tiers))
    # params grow geometrically with capacity rank: ~0.8B .. ~72B active
    n_params = np.geomspace(8e8, 7.2e10, n_tiers) if n_tiers > 1 \
        else np.array([7e9])
    n_params = n_params * np.exp(rng.normal(0.0, 0.08, n_tiers))
    # replicas skew cheap: weight ~ params^-0.4, largest remainder >= 1
    w = n_params ** -0.4
    share = w / w.sum() * n_instances
    counts = np.maximum(np.floor(share).astype(int), 1)
    while counts.sum() > n_instances:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_instances:
        counts[np.argmin(counts - share)] += 1
    tiers, names = [], []
    for j in range(n_tiers):
        p = float(n_params[j])
        name = f"syn{p / 1e9:.1f}b"
        while name in names:                       # jitter collisions
            name += "x"
        names.append(name)
        chips = int(min(2 ** max(int(np.ceil(np.log2(p / 6e9))), 0), 16))
        price_out = 0.06 * (p / 3e9) ** 0.6 * \
            float(np.exp(rng.normal(0.0, 0.06)))
        tiers.append(Tier(
            name=f"{name}/v5e-{chips}", model=name, model_cfg=None,
            n_chips=chips, n_instances=int(counts[j]),
            price_in=price_out * float(rng.uniform(0.85, 1.0)),
            price_out=price_out,
            bw_eff=float(rng.uniform(0.3, 1.0)),
            overhead_s=float(rng.uniform(0.0015, 0.003)),
            max_batch=int(rng.choice((16, 24, 32, 48, 64))),
            n_params=p,
            kv_bytes_per_token=5.7e4 * (p / 7e9) ** 0.65))
    world = World(caps, verb, seed=seed)
    return tiers, names, world


# -- workload composition -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Multi-turn session structure for a tenant (the prefix-affinity
    workload): the tenant's requests are grouped into conversations that
    share a growing prompt prefix — turn u's prompt is turn u-1's prompt
    plus `extend` fresh tokens, so a router that lands follow-up turns
    on the instance holding the conversation's KV prefix skips most of
    the prefill (`serving.affinity`)."""
    turns: int = 4                    # turns per conversation
    base_len: int = 48                # first-turn prompt cap (tokens)
    extend: Tuple[int, int] = (12, 28)   # fresh tokens per follow-up


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class in a composite trace: its own arrival process,
    prompt-population slice, and budget mix."""
    name: str
    lam: float                                   # req/s for this tenant
    arrival: str = "poisson"                     # workload.make_arrivals
    arrival_kw: Tuple[Tuple[str, float], ...] = ()
    topics: Optional[Tuple[str, ...]] = None     # restrict world topics
    len_band: Optional[Tuple[float, float]] = None  # len_in quantile band
    budget_frac: float = 0.0                     # P(request has a budget)
    budget_range: Tuple[float, float] = (2e-5, 4e-4)   # log-uniform USD
    priority: int = 0        # SLO class for admission shedding (0=premium)
    session: Optional[SessionSpec] = None   # multi-turn prefix sessions


def _tenant_prompt_pool(prompts, tenant: TenantSpec) -> np.ndarray:
    idx = np.arange(len(prompts))
    if tenant.topics is not None:
        keep = {TOPICS.index(t) for t in tenant.topics}
        idx = np.array([i for i in idx if prompts[i].topic in keep],
                       dtype=int)
    if tenant.len_band is not None and len(idx):
        lens = np.array([prompts[i].len_in for i in idx], float)
        lo, hi = np.quantile(lens, tenant.len_band)
        sub = idx[(lens >= lo) & (lens <= hi)]
        idx = sub if len(sub) else idx
    return idx if len(idx) else np.arange(len(prompts))


def _session_prompts(prompts, pool: np.ndarray, sess: SessionSpec,
                     n_t: int, rng) -> Tuple[list, list]:
    """Materialize `n_t` session-turn prompts: conversations are
    interleaved round-robin over the tenant's (time-ordered) arrival
    slots, so turn u of a conversation always arrives after turn u-1.
    Each turn's prompt is a FRESH `Prompt` object — turn u's tokens are
    turn u-1's plus `extend` new ones (capped at the world's 128-token
    embedding window), so consecutive turns share a growing prefix and
    the rolling-hash signatures (`affinity.prefix_signatures`) of a
    follow-up begin with its predecessor's. Returns (prompt per slot,
    base dataset index per slot — follow-ups reuse the base row's Q/L
    supervision)."""
    from .world import VOCAB

    n_sess = max(1, -(-n_t // max(sess.turns, 1)))   # ceil
    base_js = rng.choice(pool, n_sess, replace=True)
    convo: list = [None] * n_sess                    # running token state
    out_prompts, out_js = [], []
    for i in range(n_t):
        s = i % n_sess
        j = int(base_js[s])
        base = prompts[j]
        if convo[s] is None:
            toks = np.asarray(base.tokens[:sess.base_len], np.int32).copy()
        else:
            ext = int(rng.integers(sess.extend[0], sess.extend[1] + 1))
            toks = np.concatenate(
                [convo[s],
                 rng.integers(1, VOCAB, ext).astype(np.int32)])[:128]
        convo[s] = toks
        p = dataclasses.replace(base, tokens=toks,
                                len_in=int(toks.size))
        out_prompts.append(p)
        out_js.append(j)
    return out_prompts, out_js


def build_requests(ds: Dataset, tenants: Tuple[TenantSpec, ...], n: int,
                   lam_scale: float = 1.0, seed: int = 0, which="test"
                   ) -> List[Request]:
    """A merged, arrival-ordered multi-tenant request stream. `n` total
    requests split across tenants proportionally to their rates; each
    tenant draws prompts from its own slice of the world and stamps its
    budget mix. `lam_scale` scales every tenant's rate (the sweep's
    load axis)."""
    prompts, Q, L = ds.split(which)
    lam_total = sum(t.lam for t in tenants)
    reqs: List[Request] = []
    for k, ten in enumerate(tenants):
        n_t = max(int(round(n * ten.lam / lam_total)), 1)
        rng = np.random.default_rng((seed, k, 0xA11CE))
        arr = make_arrivals(ten.arrival, ten.lam * lam_scale, n_t,
                            seed=int(rng.integers(2 ** 31)),
                            **dict(ten.arrival_kw))
        pool = _tenant_prompt_pool(prompts, ten)
        if ten.session is not None:
            # note the draw order (prompts, then budgets) mirrors the
            # one-shot arm below — session-free tenants must keep
            # byte-identical streams to before the affinity workloads
            # existed, so the branch never perturbs rng consumption
            # for anyone else
            sess_prompts, sess_js = _session_prompts(
                prompts, pool, ten.session, n_t, rng)
            lo, hi = ten.budget_range
            budgets = sample_budgets(n_t, ten.budget_frac, lo, hi,
                                     rng=rng)
            for i in range(n_t):
                j = sess_js[i]
                reqs.append(Request(
                    rid=0, prompt=sess_prompts[i], arrival=float(arr[i]),
                    true_quality=Q[j], true_length=L[j],
                    budget=None if np.isnan(budgets[i])
                    else float(budgets[i]),
                    tenant=ten.name, priority=ten.priority))
            continue
        picks = rng.choice(pool, n_t, replace=True)
        lo, hi = ten.budget_range
        budgets = sample_budgets(n_t, ten.budget_frac, lo, hi, rng=rng)
        for i in range(n_t):
            j = int(picks[i])
            reqs.append(Request(
                rid=0, prompt=prompts[j], arrival=float(arr[i]),
                true_quality=Q[j], true_length=L[j],
                budget=None if np.isnan(budgets[i]) else float(budgets[i]),
                tenant=ten.name, priority=ten.priority))
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = i
    from .request import RequestColumns
    RequestColumns.from_requests(reqs)
    return reqs


# -- failure / recovery / straggler schedules ---------------------------------

@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One timed perturbation. Targets are either explicit `instances`
    iids or `frac`/`count` of the eligible set drawn at fire time
    (alive instances for fail/straggle/mute, dead ones for recover,
    muted ones for unmute). A fail event always leaves at least one
    instance alive. `mute`/`unmute` drive the telemetry-blackout
    failure mode: a muted worker keeps serving (and keeps its local
    snapshot fresh) but stops publishing to the scheduler's mirror —
    the staleness the recovery watchdog exists to catch."""
    t: float
    kind: str = "fail"          # fail | recover | straggle | mute | unmute
    frac: float = 0.0
    count: int = 0
    factor: float = 4.0             # straggle slowdown multiplier
    instances: Tuple[str, ...] = ()


def _fire_event(sim: ClusterSim, ev: FailureEvent, rng, t: float):
    if ev.instances:
        targets = [sim.by_id[iid] for iid in ev.instances
                   if iid in sim.by_id]
    else:
        if ev.kind == "recover":
            pool = [i for i in sim.instances if not i.alive]
        elif ev.kind == "unmute":
            pool = [i for i in sim.instances if i.tel_mute]
        else:
            pool = sim.alive_instances()
        k = ev.count if ev.count else int(round(ev.frac * len(pool)))
        k = min(max(k, 0), len(pool))
        targets = list(rng.choice(pool, k, replace=False)) if k else []
    for inst in targets:
        if ev.kind == "fail":
            if sum(i.alive for i in sim.instances) <= 1:
                break                       # never kill the whole fleet
            inst.fail()
        elif ev.kind == "recover":
            inst.recover(t)
        elif ev.kind == "straggle":
            inst.set_slowdown(ev.factor)
        elif ev.kind == "mute":
            inst.tel_mute = True
        elif ev.kind == "unmute":
            inst.tel_mute = False
        else:
            raise ValueError(ev.kind)


def apply_schedule(sim: ClusterSim, schedule, seed: int = 0):
    """Arm a failure/recovery/straggler schedule on a ClusterSim. Target
    draws happen at fire time so they compose with whatever has already
    failed or recovered."""
    rng = np.random.default_rng((seed, 0xFA11))
    for ev in schedule:
        sim.push(ev.t, functools.partial(_fire_event, sim, ev, rng))


def randomize_telemetry(sim: ClusterSim, seed: int,
                        kill_frac: float = 0.0) -> ClusterSim:
    """Load a sim's telemetry arrays with mid-run-looking state (and
    optionally kill a fraction of the roster) — the shared fixture for
    the soak suite's decision-parity checks and the sweep benchmark's
    parity probe."""
    rng = np.random.default_rng((seed, 0xD1CE))
    tel, I = sim.tel, len(sim.instances)
    tel.pending[:] = rng.uniform(0, 3000, I)
    tel.batch[:] = rng.integers(0, 12, I)
    tel.free[:] = rng.integers(0, 6, I)
    tel.ctx[:] = rng.uniform(0, 2048, I)
    tel.mark_all_dirty()          # in-place edit: stamp every row
    if kill_frac:
        k = min(int(round(kill_frac * I)), I - 1)
        for inst in rng.choice(sim.instances, k, replace=False):
            inst.fail()
    return sim


def randomize_prefix_state(sim: ClusterSim, cols, seed: int,
                           frac: float = 0.6) -> ClusterSim:
    """Warm a random subset of instance prefix sketches with random
    prompt prefixes from a request stream's columns — the shared
    fixture for affinity-enabled decision-parity checks. State is
    installed through the live dead-reckoning path (`sketch.insert` +
    `tel.write_prefix`), so the host sketches and the mirrored
    `TelemetryArrays.prefix_sig` planes end up exactly as a real run
    would leave them (dead instances stay cold: `Instance.fail`
    clears both)."""
    rng = np.random.default_rng((seed, 0xAFF1))
    sig = cols.prefix_sig
    for inst in sim.instances:
        if not inst.alive or rng.uniform() > frac:
            continue
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, sig.shape[0]))
            depth = int(rng.integers(1, sig.shape[1] + 1))
            inst.sketch.insert(sig[p, :depth])
        sim.tel.write_prefix(inst.slot, inst.sketch)
    return sim


# -- scenarios ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Overload control for a scenario: `reserve` pre-provisioned cold
    instances added to the roster (spread by `provision_reserve` — size
    them to stay inside the fused hot path's pow2-I bucket) plus the
    detector/autoscaler/shedding config armed on every sim the scenario
    builds."""
    reserve: int = 4
    overload: OverloadConfig = OverloadConfig()


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A full serving world: roster + composite workload + perturbation
    schedule. `build()` materializes the pool, world and dataset."""
    name: str
    pool: str = "paper"             # paper | synthetic
    n_tiers: int = 4
    n_instances: int = 13
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("all", 12.0),)
    schedule: Tuple[FailureEvent, ...] = ()
    elastic: Optional[ElasticSpec] = None   # overload control, if any
    # fault-tolerant lifecycle (serving.recovery): armed on every
    # sim the scenario builds, so failures in `schedule` feed the
    # retry/hedge path instead of terminally failing their victims
    recovery: Optional["RecoveryConfig"] = None
    seed: int = 0

    @property
    def lam(self) -> float:
        return sum(t.lam for t in self.tenants)

    def build(self, dataset_n: int = 1200) -> "ScenarioRun":
        if self.pool == "paper":
            world, names = paper_world(seed=self.seed)
            tiers = paper_pool_tiers()
        else:
            tiers, names, world = synthetic_pool(
                self.n_tiers, self.n_instances, seed=self.seed)
        reserve_iids: Tuple[str, ...] = ()
        if self.elastic is not None:
            tiers, reserve_iids = provision_reserve(
                tiers, self.elastic.reserve)
        ds = build_dataset(world, n=dataset_n, seed=self.seed + 1)
        return ScenarioRun(self, tiers, names, world, ds,
                           reserve_iids=reserve_iids)


class ScenarioRun:
    """A built scenario: roster, world, dataset, and helpers to train
    the estimator stack and run cells against it."""

    def __init__(self, scenario: Scenario, tiers: List[Tier],
                 names: List[str], world: World, ds: Dataset,
                 reserve_iids: Tuple[str, ...] = ()):
        self.scenario = scenario
        self.tiers = tiers
        self.names = names
        self.world = world
        self.ds = ds
        self.reserve_iids = reserve_iids
        # mutable copies of the scenario's control-plane configs so one
        # built world can be re-armed per experiment arm (the elastic
        # bench sweeps scale_up_lag_s / shed, the chaos bench sweeps
        # lost-work vs retry vs retry+hedge, on a single trained bundle)
        self.elastic: Optional[ElasticSpec] = scenario.elastic
        self.recovery: Optional[RecoveryConfig] = scenario.recovery
        self._bundle = None
        self._train_data = None

    @property
    def n_instances(self) -> int:
        return sum(t.n_instances for t in self.tiers)

    def bundle(self, **kw):
        """Train (and cache) the estimator bundle for this roster;
        keywords go to `EstimatorBundle.train` (``device="cpu"`` to train
        on the CPU, the card otherwise)."""
        if self._bundle is None:
            from ..core import EstimatorBundle
            self._bundle = EstimatorBundle.train(
                self.ds, self.tiers, self.names, **kw)
        return self._bundle

    def train_data(self):
        """(emb, Q, L, prices) for fitting decoupled baseline routers
        on this world's shared supervision (cached)."""
        if self._train_data is None:
            from ..core.policies import train_data
            self._train_data = train_data(self.bundle(), self.ds,
                                          self.tiers, self.names)
        return self._train_data

    def policy(self, name: str, **kw):
        """A fitted `SchedulingPolicy` from the registry for this
        world: `make_policy(name, **kw)` trained on `train_data()`."""
        from ..core.policies import make_policy
        return make_policy(name, **kw).fit(*self.train_data())

    def engine(self, policy, deployment: str = "windowed", **engine_kw):
        """A `ServingEngine` over this world's roster. `policy` is a
        registry name (fitted via `self.policy`) or an already-built
        `SchedulingPolicy`."""
        from ..core import EngineConfig, ServingEngine
        if isinstance(policy, str):
            policy = self.policy(policy)
        return ServingEngine(policy, self.bundle(), self.tiers,
                             EngineConfig(deployment=deployment,
                                          **engine_kw))

    def requests(self, n: int, lam_scale: float = 1.0, seed: int = 0
                 ) -> List[Request]:
        return build_requests(self.ds, self.scenario.tenants, n,
                              lam_scale=lam_scale, seed=seed)

    def arm(self, sim: ClusterSim) -> ClusterSim:
        """Arm this run's control plane (if any) on a sim: overload
        reserves go cold and the detector loop starts (`sim.overload`);
        the fault-tolerant lifecycle attaches (`sim.recovery`) so the
        schedule's failures feed retry/hedge instead of terminal
        failure."""
        if self.elastic is not None:
            arm_elastic(sim, self.elastic.overload, self.reserve_iids)
        if self.recovery is not None:
            arm_recovery(sim, self.recovery)
        return sim

    def sim(self, seed: int = 0) -> ClusterSim:
        s = ClusterSim(self.tiers, self.names, seed=seed)
        self.arm(s)
        apply_schedule(s, self.scenario.schedule,
                       seed=self.scenario.seed + seed)
        return s

    def run_cell(self, scheduler, reqs: List[Request], seed: int = 0
                 ) -> Dict:
        """`repro_torch.core.run_cell` with this scenario's schedule
        armed."""
        from ..core import run_cell
        return run_cell(scheduler, self.tiers, self.names, reqs,
                        seed=seed, schedule=self.scenario.schedule,
                        schedule_seed=self.scenario.seed + seed,
                        setup=self.arm)


def random_scenario(seed: int, max_tiers: int = 16,
                    max_instances: int = 128, max_lam: float = 30.0
                    ) -> Scenario:
    """A seeded random serving world for the differential soak harness:
    random roster scale, 1-3 tenants with random arrival processes and
    prompt slices, and a random fail/recover/straggle schedule."""
    rng = np.random.default_rng((seed, 0x5CEB))
    n_tiers = int(rng.integers(2, max_tiers + 1))
    n_instances = int(rng.integers(n_tiers, max_instances + 1))
    kinds = ("poisson", "gamma", "square", "flash")
    tenants = []
    for k in range(int(rng.integers(1, 4))):
        kind = str(rng.choice(kinds))
        kw: Tuple[Tuple[str, float], ...] = ()
        if kind == "gamma":
            kw = (("cv", float(rng.uniform(1.5, 4.0))),)
        elif kind == "square":
            kw = (("period", float(rng.uniform(10.0, 60.0))),
                  ("high_frac", float(rng.uniform(1.2, 1.8))))
        elif kind == "flash":
            kw = (("burst_start", float(rng.uniform(2.0, 10.0))),
                  ("burst_mult", float(rng.uniform(2.0, 6.0))))
        topics = None
        if rng.uniform() < 0.5:
            m = int(rng.integers(1, len(TOPICS)))
            topics = tuple(rng.choice(TOPICS, m, replace=False))
        tenants.append(TenantSpec(
            name=f"t{k}", lam=float(rng.uniform(2.0, max_lam / 2)),
            arrival=kind, arrival_kw=kw, topics=topics,
            budget_frac=float(rng.choice((0.0, 0.3, 0.6))),
        ))
    total = sum(t.lam for t in tenants)
    if total > max_lam:                # keep the aggregate rate bounded
        tenants = [dataclasses.replace(t, lam=t.lam * max_lam / total)
                   for t in tenants]
    schedule = []
    if rng.uniform() < 0.7:
        t_fail = float(rng.uniform(1.0, 6.0))
        schedule.append(FailureEvent(t=t_fail, kind="fail",
                                     frac=float(rng.uniform(0.1, 0.3))))
        if rng.uniform() < 0.6:
            schedule.append(FailureEvent(
                t=t_fail + float(rng.uniform(2.0, 6.0)), kind="recover",
                frac=1.0))
    if rng.uniform() < 0.5:
        schedule.append(FailureEvent(
            t=float(rng.uniform(1.0, 8.0)), kind="straggle",
            frac=float(rng.uniform(0.1, 0.4)),
            factor=float(rng.uniform(2.0, 6.0))))
    return Scenario(
        name=f"random{seed}", pool="synthetic", n_tiers=n_tiers,
        n_instances=n_instances, tenants=tuple(tenants),
        schedule=tuple(schedule), seed=seed)


# Named worlds: the paper cell, its non-stationary variants, and the
# beyond-paper cluster scales.
SCENARIOS: Dict[str, Scenario] = {
    "paper": Scenario(name="paper"),
    "flashcrowd": Scenario(
        name="flashcrowd",
        tenants=(TenantSpec("all", 12.0, arrival="flash",
                            arrival_kw=(("burst_start", 8.0),
                                        ("burst_dur", 6.0),
                                        ("burst_mult", 4.0))),)),
    "diurnal": Scenario(
        name="diurnal",
        tenants=(TenantSpec("all", 12.0, arrival="square",
                            arrival_kw=(("period", 30.0),
                                        ("high_frac", 1.7))),)),
    "failover": Scenario(
        name="failover",
        schedule=(FailureEvent(t=4.0, kind="fail", frac=0.25),
                  FailureEvent(t=8.0, kind="straggle", frac=0.2,
                               factor=3.0),
                  FailureEvent(t=12.0, kind="recover", frac=1.0))),
    # Multi-turn conversations sharing growing prompt prefixes — the
    # workload the prefix-affinity term (RBConfig.affinity_weight,
    # serving.affinity) is for. `benchmarks/affinity.py` runs this
    # world affinity-on vs affinity-off across all three backends.
    "session_chat": Scenario(
        name="session_chat",
        tenants=(
            TenantSpec("chat", 10.0, arrival="gamma",
                       arrival_kw=(("cv", 2.0),),
                       session=SessionSpec(turns=5)),
            TenantSpec("oneshot", 4.0),
        )),
    "multitenant": Scenario(
        name="multitenant", pool="synthetic", n_tiers=6, n_instances=24,
        seed=2,
        tenants=(
            TenantSpec("chat", 8.0, arrival="gamma",
                       arrival_kw=(("cv", 3.0),),
                       topics=("chat", "instruct"),
                       len_band=(0.0, 0.6)),
            TenantSpec("code", 4.0, topics=("code", "math"),
                       len_band=(0.4, 1.0)),
            TenantSpec("batch", 4.0, topics=("reading", "reward"),
                       budget_frac=0.8, budget_range=(1e-5, 1.5e-4)),
        )),
    "cluster": Scenario(
        name="cluster", pool="synthetic", n_tiers=8, n_instances=48,
        seed=3,
        tenants=(
            TenantSpec("interactive", 10.0, arrival="gamma",
                       arrival_kw=(("cv", 2.5),), len_band=(0.0, 0.7)),
            TenantSpec("bulk", 6.0, budget_frac=0.5),
        ),
        schedule=(FailureEvent(t=6.0, kind="fail", frac=0.15),
                  FailureEvent(t=14.0, kind="recover", frac=1.0))),
    "hyperscale": Scenario(
        name="hyperscale", pool="synthetic", n_tiers=16, n_instances=128,
        seed=4,
        tenants=(
            TenantSpec("interactive", 20.0, arrival="gamma",
                       arrival_kw=(("cv", 2.0),)),
            TenantSpec("batch", 10.0, budget_frac=0.4),
        )),
    # The 10k-instance world the hierarchical scheduler exists for
    # (`serving.hierarchy`). It runs as one controller on the decision
    # kernel (I bucket 16,384, the kernel's cluster carry), in balanced
    # cells (16 cells: I bucket 1,024 each, on the kernel) or on the
    # staged backends (span) — a 10k roster is deliberately not tier-1.
    "hyperfleet_10k": Scenario(
        name="hyperfleet_10k", pool="synthetic", n_tiers=16,
        n_instances=10000, seed=7,
        tenants=(
            TenantSpec("interactive", 220.0, arrival="gamma",
                       arrival_kw=(("cv", 2.0),), len_band=(0.0, 0.7),
                       priority=0),
            TenantSpec("agents", 90.0, arrival="gamma",
                       arrival_kw=(("cv", 3.0),),
                       topics=("code", "math"), priority=1),
            TenantSpec("batch", 90.0, budget_frac=0.5, priority=2),
        )),
    # Elastic worlds: overload control armed on every sim. The 6-base
    # + 2-reserve roster is deliberate — bucket_pow2(6) == bucket_pow2
    # (8) == 8, so the autoscaler's whole range rides one fused-hot-path
    # I bucket (no new kernel shape on scale events), and the small
    # fleet actually overloads during the diurnal peaks / flash burst
    # instead of absorbing them.
    "diurnal_elastic": Scenario(
        name="diurnal_elastic", pool="synthetic", n_tiers=4,
        n_instances=6, seed=5,
        tenants=(
            TenantSpec("premium", 14.0, arrival="square",
                       arrival_kw=(("period", 20.0),
                                   ("high_frac", 1.8)),
                       priority=0),
            TenantSpec("standard", 8.0, arrival="gamma",
                       arrival_kw=(("cv", 2.5),), priority=1),
            TenantSpec("batch", 6.0, budget_frac=0.6,
                       budget_range=(1e-5, 1.5e-4), priority=2),
        ),
        elastic=ElasticSpec(reserve=2, overload=OverloadConfig())),
    "flashcrowd_elastic": Scenario(
        name="flashcrowd_elastic", pool="synthetic", n_tiers=4,
        n_instances=6, seed=6,
        tenants=(
            TenantSpec("premium", 9.0, arrival="flash",
                       arrival_kw=(("burst_start", 4.0),
                                   ("burst_dur", 6.0),
                                   ("burst_mult", 5.0)),
                       priority=0),
            TenantSpec("batch", 7.0, budget_frac=0.5, priority=2),
        ),
        elastic=ElasticSpec(
            reserve=2,
            overload=OverloadConfig(up_patience=1, cooldown_s=1.0))),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None
