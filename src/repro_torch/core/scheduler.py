"""RouteBalance: the fused routing + load-balancing policy (§4) on the
policy-agnostic `ServingEngine`.

Port of `repro.core.scheduler` (lines 38-287, 399-429). Per fired batch
one call of the decision kernel gives every request its instance: KNN
quality/length estimates over the memoized prompt embeddings, per-tier
TPOT heads over the dead-reckoned instance state, Eq. 2 admission and
the LPT-ordered greedy pass maximizing Eq. 1.

In this slice the decision has one backend: `decision_backend=
"megakernel"`, the kernel in `repro_torch.kernels.decision_megakernel`
(the card's CUDA kernel, or its plain version on the CPU). The
reference's other backends and options are refused with the ROADMAP
item that will bring them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..estimators.embedding import SentenceEncoder, pad_tokens
from ..estimators.knn import KNNEstimator
from ..estimators.latency import LatencyHead, tpot_features
from ..serving.cluster import ClusterSim
from ..serving.request import Request
from ..serving.tiers import Tier
from .decision import LATENCY_MODES
from .device import resolve_device
from .engine import (AssignmentResult, BatchView, EngineConfig,
                     SchedulingPolicy, ServingEngine)
from .weights import PRESETS, Weights, validate

# reference options this slice does not carry yet -> (default, ROADMAP item)
_NOT_PORTED = {
    "decision_backend": ("megakernel", "queue 1, item 1 (staged numpy/jax "
                         "backends)"),
    "window_coalesce": (1, "queue 1, item 2 (decide_cols_multi/"
                        "assign_windows)"),
    "knn_backend": (None, "queue 1, item 1 (K2 knn_topk feed)"),
    "shard_cells": (0, "queue 1, item 5 (hierarchy)"),
    "cell_tag": (None, "queue 1, item 5 (hierarchy)"),
}


@dataclasses.dataclass
class RBConfig:
    weights: Weights = PRESETS["uniform"]
    base_window: float = 0.10          # batch formation window (s)
    adaptive: bool = True
    lpt: bool = True
    fixed_batch: Optional[int] = None  # fixed-size batching ablation
    budget_filter: bool = True
    latency_mode: str = "full"         # full|off_reactive|off_predictive|
    #                                    static_prior (§6.3 arms)
    learned_tpot: bool = True
    knn_k: int = 10
    charge_compute: bool = True        # charge measured decision time
    decision_backend: str = "megakernel"   # the only backend ported
    window_coalesce: int = 1
    knn_backend: Optional[str] = None
    shed: bool = True                  # honor overload admission control
    affinity_weight: float = 0.0       # prefix-cache affinity term: the
    #                                    predicted latency scales by
    #                                    (1 - weight x matched fraction)
    shard_cells: int = 0
    cell_tag: Optional[int] = None

    def __post_init__(self):
        for name, (default, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"RBConfig({name}={value!r}) is not ported yet: "
                    f"ROADMAP {item}")


class EstimatorBundle:
    """The predictor stack: encoder + KNN index + per-tier TPOT heads,
    resident on one device."""

    def __init__(self, encoder: SentenceEncoder, knn: KNNEstimator,
                 heads: Dict[str, LatencyHead], model_names: List[str],
                 device):
        self.encoder = encoder
        self.knn = knn
        self.heads = heads
        self.model_names = model_names
        self.device = torch.device(device)

    @staticmethod
    def train(dataset, tiers: Sequence[Tier], model_names: List[str],
              k: int = 10, seed: int = 0,
              device=None) -> "EstimatorBundle":
        """Embed the train split, fit the KNN index and one GBM TPOT head
        per tier. `device=None` means the card ("cuda"); pass "cpu" to
        run on the CPU. The heads are fitted on the host (numpy)."""
        dev = resolve_device(device)
        enc = SentenceEncoder(seed=7, device=dev)
        prompts, Q, L = dataset.split("train")
        toks = pad_tokens([p.tokens for p in prompts], enc.max_len)
        lens = np.array([min(len(p.tokens), enc.max_len) for p in prompts])
        emb = np.concatenate([enc.encode(toks[i:i + 512], lens[i:i + 512])
                              for i in range(0, len(prompts), 512)])
        knn = KNNEstimator(k=k, device=dev).fit(emb, Q, L)
        heads = {}
        rng = np.random.default_rng(seed)
        for t in tiers:
            X, y = _tier_sweep(t, rng)
            heads[t.name] = LatencyHead(
                t.name, nominal_tpot=t.tpot(8, 500)).fit(X, y)
        return EstimatorBundle(enc, knn, heads, model_names, dev)


def _tier_sweep(tier: Tier, rng) -> Tuple[np.ndarray, np.ndarray]:
    """Tier-local QPS sweep -> (features, true TPOT) training pairs."""
    rows, ys = [], []
    for _ in range(2000):
        b = rng.integers(1, tier.max_batch + 1)
        ctx = rng.uniform(32, 2048)
        pend = b * rng.uniform(8, 600)
        rows.append(tpot_features(b, pend, ctx))
        ys.append(tier.tpot(b, ctx) * np.exp(rng.normal(0, 0.03)))
    return np.stack(rows), np.asarray(ys, np.float32)


class RouteBalancePolicy(SchedulingPolicy):
    """The fused Eq. 1/Eq. 2 objective as a `SchedulingPolicy`: one
    decision-kernel call over the full roster per fired batch."""

    name = "routebalance"
    budget_clamp = True

    def __init__(self, cfg: RBConfig):
        self.cfg = cfg
        validate(cfg.weights)
        if cfg.latency_mode not in LATENCY_MODES:
            raise ValueError(f"latency_mode={cfg.latency_mode!r}")
        if not 0.0 <= cfg.affinity_weight <= 1.0:
            raise ValueError(f"affinity_weight={cfg.affinity_weight}")
        self.bundle = None
        self._fused = None                    # lazily-built FusedHotPath

    def engine_overrides(self) -> dict:
        cfg = self.cfg
        return dict(base_window=cfg.base_window, adaptive=cfg.adaptive,
                    fixed_batch=cfg.fixed_batch,
                    charge_compute=cfg.charge_compute)

    def prepare(self, bundle, tiers: Sequence[Tier]):
        self.bundle = bundle

    def on_attach(self, sim: ClusterSim):
        self._fused = None                    # new sim -> new roster

    def shed_verdict(self, req: Request, controller) -> bool:
        if not self.cfg.shed:
            return False
        return controller.wants_shed(req.priority)

    def assign(self, batch: BatchView, cluster: ClusterSim
               ) -> AssignmentResult:
        """Dispatch the batch's decision; the payload is a LazyDecision
        whose host copy is waited for at the dispatch point."""
        runner = self._fused_runner(cluster)
        cols, rows = batch.columns(self.bundle.encoder)
        return AssignmentResult(cluster.instances,
                                runner.decide_cols(cols, rows, cluster.tel))

    def _fused_runner(self, sim: ClusterSim):
        if not sim.tel.alive.any():
            raise RuntimeError("no alive instances to schedule onto")
        if self._fused is None:
            from .hotpath import FusedHotPath
            self._fused = FusedHotPath.for_bundle(
                self.bundle, sim.instances, self.cfg)
        return self._fused


class RouteBalance(ServingEngine):
    """The paper's deployment of the RouteBalance policy: windowed
    amortized batch scoring on the shared `ServingEngine`, with the
    reference's constructor ``RouteBalance(RBConfig(), bundle, tiers)``."""

    def __init__(self, cfg: RBConfig, bundle: EstimatorBundle,
                 tiers: Sequence[Tier]):
        super().__init__(RouteBalancePolicy(cfg), bundle, tiers,
                         EngineConfig(deployment="windowed"))
        self.cfg = cfg

    @property
    def _fused(self):
        """The policy's lazily-built FusedHotPath (diagnostics)."""
        return self.policy._fused
