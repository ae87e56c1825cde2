"""Chaos harness: named fault campaigns over the scenario subsystem.

`repro_torch.serving.scenarios.FailureEvent` gives timed, seeded
perturbations; this module composes them into the recurring failure
*shapes* production serving fleets actually see, so the recovery stack
(`repro_torch.serving.recovery`) is exercised against campaigns rather than
single events:

  * **crash_storm** — rolling waves of node death and re-entry: each
    wave kills a fraction of the alive fleet mid-decode, then revives
    everything a few seconds later. The retry path's bread and butter;
  * **correlated_failure** — every replica of one tier dies at the same
    instant (a rack/PSU/rollout-shaped blast radius), so the victims'
    work must re-route across *heterogeneous* capacity, not to a twin;
  * **telemetry_blackout** — a fraction of workers keep serving but
    stop publishing to the scheduler's mirror (`mute`), then come back
    (`unmute`): the watchdog's quarantine/release cycle, plus the
    degraded-mode fallback when the blackout covers the whole fleet;
  * **straggler_storm** — a hidden slowdown sweeps the fleet and then
    clears; telemetry keeps reporting, TPOT quietly multiplies. What
    hedged re-dispatch exists to cap;
  * **controller_crash** — not a `FailureEvent`: the scheduler process
    itself dies (`repro_torch.serving.recovery.simulate_controller_crash`)
    and resumes from its checkpoint. Driven directly by the tests and
    ``chip_smoke.py``, listed here for the campaign registry.

Every campaign is a pure function of (tiers, base time), returning a
`FailureEvent` tuple — target draws stay seeded and fire-time-resolved
exactly as for hand-written schedules, so chaos cells remain
deterministic and backend-parity-comparable.

Port of `repro.serving.faults` (pure Python, unchanged).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from .overload import OverloadConfig
from .recovery import RecoveryConfig
from .scenarios import ElasticSpec, FailureEvent, Scenario, TenantSpec
from .tiers import Tier


def crash_storm(tiers: Sequence[Tier], t0: float = 3.0, waves: int = 3,
                period: float = 5.0, frac: float = 0.3
                ) -> Tuple[FailureEvent, ...]:
    """`waves` rolling kill/revive cycles: at each wave start, `frac`
    of the alive fleet dies mid-decode; everything dead revives before
    the next wave hits."""
    ev: List[FailureEvent] = []
    for w in range(waves):
        t = t0 + w * period
        ev.append(FailureEvent(t=t, kind="fail", frac=frac))
        ev.append(FailureEvent(t=t + 0.6 * period, kind="recover",
                               frac=1.0))
    return tuple(ev)


def correlated_failure(tiers: Sequence[Tier], t0: float = 4.0,
                       recover_after: float = 6.0
                       ) -> Tuple[FailureEvent, ...]:
    """Kill EVERY replica of one tier at the same instant — the tier
    with the most replicas, so the blast radius is maximal and the
    displaced work must land on heterogeneous capacity. Explicit iids:
    the point is correlation, not a random draw."""
    victim = max(tiers, key=lambda t: (t.n_instances, t.name))
    iids = tuple(f"{victim.name}#{j}" for j in range(victim.n_instances))
    return (FailureEvent(t=t0, kind="fail", instances=iids),
            FailureEvent(t=t0 + recover_after, kind="recover",
                         instances=iids))


def telemetry_blackout(tiers: Sequence[Tier], t0: float = 3.0,
                       duration: float = 4.0, frac: float = 0.5
                       ) -> Tuple[FailureEvent, ...]:
    """`frac` of the fleet stops publishing telemetry for `duration`
    seconds while continuing to serve. frac=1.0 drives the scheduler's
    whole mirror dark — the degraded-fallback path."""
    return (FailureEvent(t=t0, kind="mute", frac=frac),
            FailureEvent(t=t0 + duration, kind="unmute", frac=1.0))


def straggler_storm(tiers: Sequence[Tier], t0: float = 3.0,
                    duration: float = 6.0, frac: float = 0.4,
                    factor: float = 5.0) -> Tuple[FailureEvent, ...]:
    """A hidden `factor`x slowdown hits `frac` of the fleet, then
    clears (straggle back to factor 1.0). Telemetry keeps flowing, so
    only deadline-based hedging notices."""
    return (FailureEvent(t=t0, kind="straggle", frac=frac,
                         factor=factor),
            FailureEvent(t=t0 + duration, kind="straggle", frac=1.0,
                         factor=1.0))


def compose(*campaigns: Sequence[FailureEvent]
            ) -> Tuple[FailureEvent, ...]:
    """Merge campaigns into one time-ordered schedule."""
    ev = [e for c in campaigns for e in c]
    return tuple(sorted(ev, key=lambda e: e.t))


# campaign registry: name -> schedule builder. `controller_crash` has
# an empty schedule — the crash/restore cycle is driven by the harness
# (tests, chip_smoke.py) via simulate_controller_crash + the
# engine checkpoint, not by a sim event.
CHAOS_SUITES: Dict[str, Callable[[Sequence[Tier]],
                                 Tuple[FailureEvent, ...]]] = {
    "crash_storm": crash_storm,
    "correlated_failure": correlated_failure,
    "telemetry_blackout": telemetry_blackout,
    "straggler_storm": straggler_storm,
    "controller_crash": lambda tiers: (),
}


def chaos_world(seed: int = 7) -> Scenario:
    """The shared world chaos campaigns run against: a small synthetic
    fleet (pow2-friendly roster, so kill/revive/quarantine churn rides
    one fused-hot-path bucket) under enough sustained load
    that lost work actually moves goodput. No elastic reserve — the
    chaos bench isolates the recovery stack from the autoscaler."""
    return Scenario(
        name="chaos", pool="synthetic", n_tiers=4, n_instances=8,
        seed=seed,
        tenants=(
            TenantSpec("interactive", 10.0, arrival="gamma",
                       arrival_kw=(("cv", 2.0),)),
            TenantSpec("bulk", 5.0, budget_frac=0.3),
        ),
        recovery=RecoveryConfig())


def elastic_chaos_world(seed: int = 8) -> Scenario:
    """chaos_world plus overload control: asserts the recovery stack
    and the autoscaler coexist (two controllers, one heap) without
    keeping each other alive or double-terminating sheds."""
    base = chaos_world(seed)
    return Scenario(
        name="elastic_chaos", pool=base.pool, n_tiers=base.n_tiers,
        n_instances=6, seed=seed, tenants=base.tenants,
        recovery=RecoveryConfig(),
        elastic=ElasticSpec(reserve=2, overload=OverloadConfig()))
