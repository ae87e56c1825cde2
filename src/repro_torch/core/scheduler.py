"""RouteBalance: the fused routing + load-balancing policy (§4) on the
policy-agnostic `ServingEngine`.

Port of `repro.core.scheduler` (lines 38-429). Per
fired batch every request gets its instance: KNN quality/length
estimates over the memoized prompt embeddings, per-tier TPOT heads over
the dead-reckoned instance state, Eq. 2 admission and the LPT-ordered
greedy pass maximizing Eq. 1.

`RBConfig.decision_backend` selects how:
  * "megakernel" (default) — one call of the decision kernel
    `repro_torch.kernels.decision_megakernel` (the card's CUDA kernel,
    or its plain version on the CPU); bitwise the reference's "fused";
  * "numpy" — the staged path with the host greedy loop
    (`core.assignment.greedy_assign`);
  * "torch" — the staged path with the tensor core `core.decision.
    decide` on the bundle's device (the reference's "jax").
The staged paths take their estimates from one KNN query per batch,
through the bundle's KNN backend or `RBConfig.knn_backend` ("numpy",
"torch", or "kernel" — the K2 kernel). `assign_windows` decides K
scheduler windows in one kernel call on the megakernel backend; the
engine does not call it, as in the reference. `RBConfig.window_coalesce`
is accepted and validated (>= 1, > 1 only on the megakernel) to match
the reference's API, and, as there, nothing reads it: a caller groups
the windows itself and passes them to `assign_windows`. The megakernel
decides a roster of any size as one controller, as the reference's
"fused" does (the hierarchy, `serving.hierarchy`, can split a fleet
into cells instead). `RBConfig.shard_cells > 1` (the hierarchy's span
routing) runs the staged torch backend's scan cell-sharded, bitwise the
unsharded scan:
over the ranks of a ``("cell",)`` mesh when there is one (a mesh pinned
with `distributed.shardctx.sharding_rules` whose "cell" dimension has
`shard_cells` ranks, else `launch.mesh.make_cell_mesh`; this process is
then rank 0), else as the single-program emulation; `cell_tag` keys the
hot-path cache per cell engine. The reference's
names "fused", "jax" and "pallas" raise ValueError naming the port's
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..estimators.embedding import SentenceEncoder, pad_tokens
from ..estimators.knn import KNNEstimator, check_backend
from ..estimators.latency import LatencyHead, tpot_features
from ..serving.cluster import ClusterSim
from ..serving.request import Request, batch_columns
from ..serving.tiers import Tier
from .assignment import greedy_assign, lpt_order
from .budget import admission_mask, cost_matrix
from .decision import LATENCY_MODES
from .device import resolve_device
from .engine import (AssignmentResult, BatchView, EngineConfig, Ready,
                     SchedulingPolicy, ServingEngine)
from .weights import PRESETS, Weights, validate

DECISION_BACKENDS = ("megakernel", "numpy", "torch")
# the reference's backend names, with the port's counterpart
_REFERENCE_BACKENDS = {"fused": "megakernel", "jax": "torch"}


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
    decision_backend: str = "megakernel"   # | numpy | torch (staged)
    window_coalesce: int = 1           # validated, read by nothing (as
    #                                    in the reference): a caller
    #                                    groups windows for assign_windows
    knn_backend: Optional[str] = None  # override the bundle's KNN backend
    #                                    (numpy | torch | kernel); staged
    #                                    backends only — the megakernel
    #                                    has the lookup built in
    shed: bool = True                  # honor overload admission control
    affinity_weight: float = 0.0       # prefix-cache affinity term: the
    #                                    predicted latency scales by
    #                                    (1 - weight x matched fraction)
    shard_cells: int = 0               # hierarchical "span" routing: > 1
    #                                    splits the staged torch scan's
    #                                    instance axis into that many
    #                                    cells (a power of two), combined
    #                                    with exact reductions: bitwise
    #                                    the unsharded decision
    cell_tag: Optional[int] = None     # per-cell engine identity under
    #                                    balanced routing: keys the
    #                                    FusedHotPath cache, so cells
    #                                    with equal rosters still get
    #                                    their own carried mirrors

    def __post_init__(self):
        if self.decision_backend in _REFERENCE_BACKENDS:
            raise ValueError(
                f"decision_backend={self.decision_backend!r} is the "
                f"reference's; the port's counterpart is "
                f"{_REFERENCE_BACKENDS[self.decision_backend]!r}")
        if self.decision_backend not in DECISION_BACKENDS:
            raise ValueError(f"decision_backend={self.decision_backend!r} "
                             f"not in {DECISION_BACKENDS}")
        if self.knn_backend is not None:
            check_backend(self.knn_backend)
        if self.window_coalesce < 1:
            raise ValueError(f"window_coalesce={self.window_coalesce} < 1")
        if self.window_coalesce > 1 and self.decision_backend != "megakernel":
            raise ValueError("window_coalesce > 1 needs decision_backend="
                             "'megakernel'")
        sc = self.shard_cells
        if sc < 0 or sc & (sc - 1):
            raise ValueError(f"shard_cells={self.shard_cells} must be 0 or "
                             "a power of two")
        if sc > 1 and self.decision_backend != "torch":
            # the decision kernel is one monolithic launch over the
            # roster: the per-step cross-cell reductions of the span
            # scan live in the staged torch core (the reference likewise
            # refuses its megakernel)
            raise ValueError("shard_cells > 1 needs decision_backend="
                             "'torch' (the staged torch backend), not "
                             f"{self.decision_backend!r}")


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
              k: int = 10, backend: str = "torch", seed: int = 0,
              device=None) -> "EstimatorBundle":
        """Embed the train split, fit the KNN index (queried through
        `backend`: "numpy", "torch" or "kernel") and one GBM TPOT head
        per tier. `device=None` means the card ("cuda"); pass "cpu" to
        run on the CPU. The heads are fitted on the host (numpy)."""
        dev = resolve_device(device)
        enc = SentenceEncoder(seed=7, device=dev)
        prompts, Q, L = dataset.split("train")
        toks = pad_tokens([p.tokens for p in prompts], enc.max_len)
        lens = np.array([min(len(p.tokens), enc.max_len) for p in prompts])
        emb = np.concatenate([enc.encode(toks[i:i + 512], lens[i:i + 512])
                              for i in range(0, len(prompts), 512)])
        knn = KNNEstimator(k=k, backend=backend, device=dev).fit(emb, Q, L)
        heads = {}
        rng = np.random.default_rng(seed)
        for t in tiers:
            X, y = _tier_sweep(t, rng)
            heads[t.name] = LatencyHead(
                t.name, nominal_tpot=t.tpot(8, 500)).fit(X, y)
        return EstimatorBundle(enc, knn, heads, model_names, dev)

    def with_knn_backend(self, backend: str) -> "EstimatorBundle":
        """A copy sharing every estimator, its KNN index queried through
        `backend`; the bundle itself is not changed."""
        return EstimatorBundle(self.encoder, self.knn.with_backend(backend),
                               self.heads, self.model_names, self.device)

    def predict_prompts(self, reqs: Sequence[Request], cols=None,
                        rows: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched Q̂/L̂ for a request batch: one KNN query. When the
        batch is a slice of a SoA ingest stream the memoized per-prompt
        embedding column is gathered instead of running the encoder."""
        if cols is None:
            cols, rows = batch_columns(reqs)
        if cols is not None:
            cols.ensure_embeddings(self.encoder)
            emb = cols.emb[cols.prompt_row[rows]]
        else:
            toks = pad_tokens([r.prompt.tokens for r in reqs],
                              self.encoder.max_len)
            lens = np.array([min(len(r.prompt.tokens),
                                 self.encoder.max_len) for r in reqs])
            emb = self.encoder.encode(toks, lens)
        return self.knn.query(emb)


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
    batched decision over the full roster per fired batch, through the
    decision kernel or the staged numpy / torch paths
    (`RBConfig.decision_backend`)."""

    name = "routebalance"
    # under the serial_published deployment, the warm per-batch decision
    # estimate is charged as the per-request service time
    serial_scoring_s = 0.004
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
        self._cell_mesh = None                # the span scan's mesh

    def engine_overrides(self) -> dict:
        cfg = self.cfg
        return dict(base_window=cfg.base_window, adaptive=cfg.adaptive,
                    fixed_batch=cfg.fixed_batch,
                    charge_compute=cfg.charge_compute)

    def prepare(self, bundle, tiers: Sequence[Tier]):
        kb = self.cfg.knn_backend
        if kb is not None and kb != bundle.knn.backend:
            # rebind the estimator feed on a copy, so a bundle shared
            # across schedulers is never mutated
            bundle = bundle.with_knn_backend(kb)
        self.bundle = bundle

    def on_attach(self, sim: ClusterSim):
        self._fused = None                    # new sim -> new roster
        self._cell_mesh = self._resolve_cell_mesh()

    def _resolve_cell_mesh(self):
        """The span scan's mesh, as the reference's hot path resolves it
        (`repro.core.hotpath`, lines 212-226): a pinned mesh whose
        "cell" dimension has `shard_cells` ranks, else
        `make_cell_mesh(shard_cells)`; None (the emulation) without
        one."""
        n = self.cfg.shard_cells
        if n <= 1:
            return None
        from ..distributed.shardctx import current
        mesh = current()
        names = () if mesh is None else (mesh.mesh_dim_names or ())
        if "cell" in names and mesh.size(names.index("cell")) == n:
            return mesh
        from ..launch.mesh import make_cell_mesh
        return make_cell_mesh(n)

    def shed_verdict(self, req: Request, controller) -> bool:
        if not self.cfg.shed:
            return False
        return controller.wants_shed(req.priority)

    def assign(self, batch: BatchView, cluster: ClusterSim
               ) -> AssignmentResult:
        """Dispatch the batch's decision. The megakernel's payload is a
        LazyDecision whose host copy is waited for at the dispatch
        point; the staged backends' is already numpy."""
        if self.cfg.decision_backend == "megakernel":
            runner = self._fused_runner(cluster)
            cols, rows = batch.columns(self.bundle.encoder)
            return AssignmentResult(
                cluster.instances, runner.decide_cols(cols, rows,
                                                      cluster.tel))
        instances, choice, l_chosen = self._decide_staged(batch, cluster)
        return AssignmentResult(instances, Ready(choice, l_chosen))

    def assign_windows(self, batches: List[BatchView],
                       cluster: ClusterSim) -> List[AssignmentResult]:
        """K scheduler windows as ONE kernel call on the megakernel
        backend (`FusedHotPath.decide_cols_multi`). All K windows decide
        against the same telemetry snapshot — exactly what K back-to-back
        `assign` calls see when telemetry has not moved between them, so
        coalescing is assignment-exact there while paying one call for K
        windows. Falls back to per-window `assign` on the staged backends
        (and for K == 1)."""
        if (self.cfg.decision_backend != "megakernel"
                or len(batches) <= 1):
            return [self.assign(bv, cluster) for bv in batches]
        runner = self._fused_runner(cluster)
        slices = [bv.columns(self.bundle.encoder) for bv in batches]
        lazies = runner.decide_cols_multi(slices, cluster.tel)
        return [AssignmentResult(cluster.instances, lz) for lz in lazies]

    def _fused_runner(self, sim: ClusterSim):
        if not sim.tel.alive.any():
            raise RuntimeError("no alive instances to schedule onto")
        if self._fused is None:
            from .hotpath import FusedHotPath
            self._fused = FusedHotPath.for_bundle(
                self.bundle, sim.instances, self.cfg)
        return self._fused

    def _decide_staged(self, batch: BatchView, sim: ClusterSim):
        """Host numpy around one KNN query (reference lines 289-396)."""
        cfg = self.cfg
        reqs = batch.reqs
        # candidate roster = the scheduler-visible rows (tel.alive), the
        # roster the megakernel masks (slot k <-> sim.instances[k])
        tel = sim.tel
        alive_rows = np.flatnonzero(tel.alive)
        instances = [sim.instances[int(k)] for k in alive_rows]
        I = len(instances)
        R = len(reqs)
        m_of_i = np.array([inst.model_idx for inst in instances])
        tiers_of_i = [inst.tier for inst in instances]
        cols, rows = batch.cols, batch.rows
        if cols is None:
            cols, rows = batch_columns(reqs)

        # 1. batched prompt-intrinsic estimation (one KNN query)
        Q, L = self.bundle.predict_prompts(reqs, cols=cols, rows=rows)
        q_inst = Q[:, m_of_i]                            # (R, I)
        l_inst = L[:, m_of_i]

        # 2. telemetry seed from the columnar view
        d = tel.pending[alive_rows].copy()
        b = np.maximum(tel.batch[alive_rows], 1.0)
        free = tel.free[alive_rows].copy()
        ctx = np.maximum(tel.ctx[alive_rows], 64.0)
        maxb = tel.max_batch[alive_rows].copy()

        # 3. one TPOT-head call per tier (not per instance)
        tpot = np.zeros(I)
        if cfg.latency_mode == "static_prior":
            tpot = np.array([self.bundle.heads[ti.name].nominal_tpot
                             for ti in tiers_of_i])
        else:
            by_tier: Dict[str, List[int]] = {}
            for i, ti in enumerate(tiers_of_i):
                by_tier.setdefault(ti.name, []).append(i)
            for tname, idxs in by_tier.items():
                feats = np.stack([
                    tpot_features(b[i], d[i], ctx[i]) for i in idxs])
                tpot[idxs] = self.bundle.heads[tname].tpot_batch(
                    feats, learned=cfg.learned_tpot)

        # 4+5. Eq. 2 admission + the LPT-ordered greedy pass
        price_in = np.array([ti.price_in for ti in tiers_of_i])
        price_out = np.array([ti.price_out for ti in tiers_of_i])
        if cols is not None:
            budgets = cols.budget[rows]
            len_in = cols.len_in[rows]
        else:
            budgets = np.array([np.nan if r.budget is None else r.budget
                                for r in reqs])
            len_in = np.array([r.prompt.len_in for r in reqs], float)
        nominal = np.array([self.bundle.heads[ti.name].nominal_tpot
                            for ti in tiers_of_i])
        aff = None
        if cfg.affinity_weight > 0.0:
            aff = self._affinity(cols, rows, reqs, len_in,
                                 tel.prefix_sig[alive_rows])
        if cfg.decision_backend == "torch":
            from .decision import decide
            choice, _ = decide(
                q_inst, l_inst, L.max(axis=1), tpot, nominal, d, b, free,
                maxb, budgets, len_in, price_in, price_out, cfg.weights,
                latency_mode=cfg.latency_mode, lpt=cfg.lpt,
                budget_filter=cfg.budget_filter, affinity=aff,
                device=self.bundle.device, n_cells=cfg.shard_cells,
                mesh=self._cell_mesh)
        else:
            # the host loop evaluates the decision arithmetic in float32,
            # the tensor core's precision, so the quantized Eq. 1 tie
            # groups are identical across the backends (greedy_assign
            # follows the dtype of its inputs)
            f32 = np.float32
            budgets32, len_in32 = budgets.astype(f32), len_in.astype(f32)
            pi32, po32 = price_in.astype(f32), price_out.astype(f32)
            if cfg.budget_filter:
                allowed, c_hat = admission_mask(budgets32, len_in32,
                                                l_inst, pi32, po32)
            else:
                allowed = np.ones((R, I), bool)
                c_hat = cost_matrix(len_in32, l_inst, pi32, po32)
            order = lpt_order(L.max(axis=1), enable=cfg.lpt)
            choice, _ = greedy_assign(
                order, q_inst.astype(f32), c_hat, l_inst.astype(f32),
                tpot.astype(f32), d.astype(f32), b.astype(f32),
                free.astype(f32), maxb.astype(f32),
                cfg.weights, allowed, latency_mode=cfg.latency_mode,
                nominal_tpot=nominal.astype(f32), affinity=aff)
        l_chosen = l_inst[np.arange(R), choice]
        return instances, choice, l_chosen

    def _affinity(self, cols, rows, reqs, len_in, sig_plane) -> np.ndarray:
        """(R, I) float32 prefix-reuse discount, the same integer compare
        + float32 divide the megakernel evaluates on the card."""
        from ..serving.affinity import hit_fraction, prompt_signatures
        if cols is not None:
            req_sig = cols.prefix_sig[cols.prompt_row[rows]]
        else:
            req_sig = np.stack([prompt_signatures(r.prompt) for r in reqs])
        hit = hit_fraction(torch.from_numpy(np.ascontiguousarray(req_sig)),
                           torch.from_numpy(len_in.astype(np.float32)),
                           torch.from_numpy(np.ascontiguousarray(sig_plane)))
        return np.float32(self.cfg.affinity_weight) * hit.numpy()


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

    def _decide_core(self, batch: List[Request]
                     ) -> Tuple[list, np.ndarray, np.ndarray]:
        """The per-batch decision alone (no dispatch), fetched eagerly:
        the candidate roster and (choice (R,) indices into it, l_chosen
        (R,)). The reference's hot-path probe (its `_decide_core`)."""
        res = self.policy.assign(BatchView(batch), self.sim)
        choice, l_chosen = res.fetch()
        return res.instances, choice, l_chosen
