"""DEPRECATED shim: pipeline mode is now the `ServingEngine` with a
`RouterDispatchPolicy` and a `deployment=` knob.

Port of `repro.core.pipeline` (lines 1-62), a copy.

The decoupled router -> dispatcher baselines and the §6.3 deployment
ladder (serial-as-published / microbatch / concurrent, plus the
vLLM-SR bounded-queue variant via `queue_capacity`) live on the shared
engine (`repro_torch.core.engine`), selected through the `POLICIES`
registry (`repro_torch.core.policies`):

    from repro_torch.core import EngineConfig, ServingEngine, make_policy
    policy = make_policy("bestroute-sq", threshold=0.5)
    policy.fit(emb, Q, L, prices)
    eng = ServingEngine(policy, bundle, tiers,
                        EngineConfig(deployment="serial_published"))

`PipelineScheduler(...)` keeps constructing exactly that engine, but
warns — new code should build the engine directly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

from ..serving.tiers import Tier

from .dispatchers import Dispatcher
from .engine import EngineConfig, ServingEngine
from .routers import Router


@dataclasses.dataclass
class PipelineConfig:
    deployment: str = "serial"     # serial | microbatch | concurrent
    n_workers: int = 32            # concurrent scoring workers
    microbatch_size: int = 64
    microbatch_time: float = 1.72  # padded batch service time (§6.3)
    queue_capacity: Optional[int] = None   # bounded => drops (vLLM-SR)
    budget_clamp: bool = True


def PipelineScheduler(router: Router, dispatcher: Dispatcher,
                      bundle, tiers: Sequence[Tier],
                      cfg: PipelineConfig = PipelineConfig()
                      ) -> ServingEngine:
    """Deprecated constructor for the legacy pipeline-mode scheduler;
    returns the equivalent `ServingEngine`."""
    warnings.warn(
        "PipelineScheduler is deprecated: build a ServingEngine with a "
        "RouterDispatchPolicy (repro_torch.core.policies) and an EngineConfig "
        "deployment instead", DeprecationWarning, stacklevel=2)
    from .policies import RouterDispatchPolicy
    policy = RouterDispatchPolicy(router, dispatcher,
                                  budget_clamp=cfg.budget_clamp)
    return ServingEngine(policy, bundle, tiers, EngineConfig(
        deployment=cfg.deployment,          # "serial" alias accepted
        n_workers=cfg.n_workers,
        microbatch_size=cfg.microbatch_size,
        microbatch_time=cfg.microbatch_time,
        queue_capacity=cfg.queue_capacity))
