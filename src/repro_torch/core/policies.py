"""The policy registry: every scheduler the repo can serve, as
`SchedulingPolicy` implementations over the one `ServingEngine`.

Port of `repro.core.policies` (lines 36-194). `RouterDispatchPolicy`
adapts the decoupled router -> dispatcher baselines (§5): the router
picks a model per request from the batch's memoized ingest embeddings,
the dispatcher picks a replica among that model's alive instances off
the columnar `TelemetryArrays` view, and the predicted output length
comes from one query of the bundle's KNN estimator per fired group —
the shared supervision, the paper's fairness control. Deployment
(serial_published / microbatch / concurrent / windowed) is the
engine's axis, not the policy's.

`POLICIES` names every registered policy — RouteBalance plus the full
router x dispatcher grid — resolvable by `make_policy(name, **kw)`;
register your own with `register_policy`."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.cluster import ClusterSim
from ..serving.tiers import Tier

from .dispatchers import Dispatcher, RandomDispatch, RoundRobin, \
    ShortestQueue
from .engine import AssignmentResult, BatchView, Ready, SchedulingPolicy
from .routers import AvengersProRouter, BestRouteRouter, \
    PassthroughRouter, Router
from .scheduler import RBConfig, RouteBalancePolicy


class RouterDispatchPolicy(SchedulingPolicy):
    """Decoupled model router + replica dispatcher as one policy.

    `assign` is batched: one embedding gather + one `router.route` +
    one KNN length lookup for the whole fired group, then a per-request
    dispatcher pick over the router's candidate set. Candidate
    filtering and dispatcher state reads are vectorized over the
    columnar telemetry view (`TelemetryArrays`)."""

    def __init__(self, router: Router, dispatcher: Dispatcher,
                 budget_clamp: bool = True, shed: bool = True):
        self.router = router
        self.dispatcher = dispatcher
        self.budget_clamp = budget_clamp
        self.shed = shed            # honor overload admission control
        self.bundle = None
        self._model_of_slot: Optional[np.ndarray] = None

    @property
    def name(self) -> str:
        return f"{self.router.name}-{self.dispatcher.name}"

    @property
    def serial_scoring_s(self) -> float:
        # the router's measured one-request scoring forward — what the
        # serial_published deployment charges per request (§6.3)
        return self.router.serial_scoring_s

    def fit(self, emb, quality, lengths, prices):
        self.router.fit(emb, quality, lengths, prices)
        return self

    def on_attach(self, sim: ClusterSim):
        self._model_of_slot = np.array(
            [i.model_idx for i in sim.instances], np.int64)

    def shed_verdict(self, req, controller) -> bool:
        # shedding is policy-visible: a baseline built with shed=False
        # admits everything even on an elastic sim (the "no admission
        # control" arm of the overload benches)
        if not self.shed:
            return False
        return controller.wants_shed(req.priority)

    def assign(self, batch: BatchView, cluster: ClusterSim
               ) -> AssignmentResult:
        cols, rows = batch.columns(self.bundle.encoder)
        emb = cols.emb[cols.prompt_row[rows]]
        models = self.router.route(emb)                   # (R,) model idx
        _, L = self.bundle.knn.query(emb)                 # (R, M) lengths
        tel = cluster.tel
        model_of = self._model_of_slot
        if model_of is None or len(model_of) != len(tel.alive):
            # direct callers that skipped attach(): derive lazily
            model_of = np.array([i.model_idx for i in cluster.instances],
                                np.int64)
            self._model_of_slot = model_of
        alive_slots = np.flatnonzero(tel.alive)
        alive_models = model_of[alive_slots]
        R = len(batch)
        choice = np.empty(R, np.int64)
        l_chosen = np.empty(R, np.float64)
        for j in range(R):
            m = int(models[j])
            cand = (alive_slots if m < 0
                    else alive_slots[alive_models == m])
            if not len(cand):                 # model has no alive replica
                cand = alive_slots
            slot = int(cand[self.dispatcher.pick_slots(cand, tel)])
            choice[j] = slot
            l_chosen[j] = L[j, model_of[slot]]
        return AssignmentResult(cluster.instances,
                                Ready(choice, l_chosen))


# -- registry -----------------------------------------------------------------

_ROUTERS: Dict[str, Callable[..., Router]] = {
    "avengers": AvengersProRouter,
    "bestroute": BestRouteRouter,
    "passthrough": PassthroughRouter,
}
_DISPATCHERS: Dict[str, Callable[[], Dispatcher]] = {
    "rr": RoundRobin,
    "sq": ShortestQueue,
    "random": RandomDispatch,
}


def _router_dispatch_factory(rname: str, dname: str):
    def make(budget_clamp: bool = True, shed: bool = True, **router_kw):
        return RouterDispatchPolicy(_ROUTERS[rname](**router_kw),
                                    _DISPATCHERS[dname](),
                                    budget_clamp=budget_clamp, shed=shed)
    make.__doc__ = f"{rname} router -> {dname} dispatcher baseline"
    return make


def _routebalance_factory(**cfg_kw):
    return RouteBalancePolicy(RBConfig(**cfg_kw))


# name -> factory(**kw) -> SchedulingPolicy. RouteBalance kwargs are
# RBConfig fields; baseline kwargs are the router's (plus budget_clamp).
POLICIES: Dict[str, Callable[..., SchedulingPolicy]] = {
    "routebalance": _routebalance_factory,
}
for _r in _ROUTERS:
    for _d in _DISPATCHERS:
        POLICIES[f"{_r}-{_d}"] = _router_dispatch_factory(_r, _d)


def register_policy(name: str, factory: Callable[..., SchedulingPolicy]):
    """Add a custom policy to the registry."""
    if name in POLICIES:
        raise ValueError(f"policy {name!r} already registered")
    POLICIES[name] = factory
    return factory


def make_policy(name: str, **kw) -> SchedulingPolicy:
    try:
        factory = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"have {sorted(POLICIES)}") from None
    return factory(**kw)


def train_data(bundle, ds, tiers: Sequence[Tier],
               model_names: List[str]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(emb, quality, lengths, prices) for `SchedulingPolicy.fit`: the
    train-split supervision RouteBalance's KNN estimator consumed —
    the paper's fairness control for fitting decoupled routers. The
    embeddings are read back from the bundle's fitted KNN index
    (`EstimatorBundle.train` already embedded the train split with the
    shared encoder; re-encoding here would be pure recomputation), the
    float64 labels from the dataset split."""
    prompts, Q, L = ds.split("train")
    emb = bundle.knn._x
    if emb is None or len(emb) != len(prompts):
        raise ValueError("bundle KNN was not fitted on this dataset's "
                         "train split")
    by_model = {t.model: t.price_out for t in tiers}
    prices = np.array([by_model.get(m, 0.1) for m in model_names])
    return emb, Q, L, prices


def fit_policy(name: str, bundle, tiers: Sequence[Tier],
               model_names: List[str], ds, **kw) -> SchedulingPolicy:
    """`make_policy` + `fit` on the shared supervision in one call.
    Policies that
    keep the base no-op `fit` (e.g. routebalance: its estimators live
    in the already-trained bundle) skip the supervision assembly."""
    policy = make_policy(name, **kw)
    if type(policy).fit is not SchedulingPolicy.fit:
        policy.fit(*train_data(bundle, ds, tiers, model_names))
    return policy
