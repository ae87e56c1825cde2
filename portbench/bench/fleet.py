"""A configuration file turned into the program's objects: the roster's
tiers, the prompts, the estimator bundle (built through the program's
own estimator classes from the inputs the benchmark makes), the request
stream and the scheduler under test."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..yard.training import encoder_params, training_pairs


def make_tiers(cfg: Dict):
    from repro_torch.serving.tiers import Tier
    return [Tier(model_cfg=None, **t) for t in cfg["roster"]["tiers"]]


def make_prompts(world) -> List:
    from repro_torch.serving.world import Prompt
    return [Prompt(pid=i, topic=int(world.topic[i]),
                   difficulty=float(world.difficulty[i]),
                   verbosity=float(world.verbosity[i]),
                   tokens=world.tokens[i], len_in=int(world.len_in[i]),
                   safety_flagged=int(world.topic[i]) == 2)
            for i in range(len(world.topic))]


def make_bundle(cfg: Dict, world, prompts, tiers, device):
    """The program's `EstimatorBundle`: its encoder loaded with the
    benchmark's weights, its KNN index over its own embeddings of the
    train split, and one TPOT head per tier fitted on the benchmark's
    pairs."""
    from repro_torch.core.scheduler import EstimatorBundle
    from repro_torch.estimators.embedding import SentenceEncoder, pad_tokens
    from repro_torch.estimators.knn import KNNEstimator
    from repro_torch.estimators.latency import LatencyHead
    est = cfg["estimators"]
    e = est["encoder"]
    enc = SentenceEncoder(dim=e["dim"], hidden=e["hidden"],
                          n_layers=e["n_layers"], n_heads=e["n_heads"],
                          hash_vocab=e["hash_vocab"], max_len=e["max_len"],
                          device=device)
    enc.load_params(encoder_params(e, e["seed"]))
    tr = world.train_idx
    toks = pad_tokens([prompts[i].tokens for i in tr], enc.max_len)
    lens = np.array([min(len(prompts[i].tokens), enc.max_len) for i in tr])
    emb = np.concatenate([enc.encode(toks[i:i + 512], lens[i:i + 512])
                          for i in range(0, len(tr), 512)])
    knn = KNNEstimator(k=est["knn_k"], eps=est["knn_eps"], backend="torch",
                       device=device).fit(emb, world.quality[tr],
                                          world.lengths[tr])
    pairs = training_pairs(cfg["roster"]["tiers"], est["sweep"]["seed"],
                           est["sweep"]["rows"])
    heads = {t.name: LatencyHead(t.name, nominal_tpot=t.tpot(8, 500))
             .fit(X, y) for t, (X, y) in zip(tiers, pairs)}
    bundle = EstimatorBundle(enc, knn, heads, cfg["roster"]["model_names"],
                             device)
    return bundle, pairs


def make_requests(stream, prompts, world) -> List:
    """The program's `Request` objects for a stream drawn from the test
    split, with the stream's ingest columns. A session turn gets a fresh
    `Prompt`: its base prompt with the turn's tokens and length."""
    from repro_torch.serving.request import Request, RequestColumns
    te = world.test_idx
    toks = stream.tokens or [None] * stream.n
    reqs = []
    for i in range(stream.n):
        j = int(te[stream.prompt[i]])
        b = stream.budget[i]
        p = prompts[j]
        if toks[i] is not None:
            p = dataclasses.replace(p, tokens=toks[i],
                                    len_in=int(toks[i].size))
        reqs.append(Request(
            rid=i, prompt=p, arrival=float(stream.arrival[i]),
            true_quality=world.quality[j], true_length=world.lengths[j],
            budget=None if np.isnan(b) else float(b),
            tenant=stream.names[int(stream.tenant[i])],
            priority=int(stream.priority[i])))
    RequestColumns.from_requests(reqs)
    return reqs


def make_scheduler(cfg: Dict, bundle, tiers):
    """The scheduler the configuration names: one `RouteBalance`
    controller, or the balanced `HierarchicalScheduler` over cells, each
    on `RBConfig` with the configuration's departures from defaults."""
    from repro_torch.core.scheduler import RBConfig, RouteBalance
    sch = cfg["scheduler"]
    rb = RBConfig(**sch["rbconfig"])
    if sch.get("hierarchy") is None:
        return RouteBalance(rb, bundle, tiers)
    from repro_torch.serving.hierarchy import (HierarchicalScheduler,
                                               HierarchyConfig)
    return HierarchicalScheduler(rb, bundle, tiers,
                                 HierarchyConfig(**sch["hierarchy"]))


def engines_of(scheduler) -> List:
    return list(getattr(scheduler, "engines", None) or [scheduler])

