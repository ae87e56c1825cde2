"""The benchmark's frozen generators give the program's arrays for the
same seeds: the arrival processes, the budgets, the world and its split,
the request stream, the TPOT training pairs, and the roster the
configuration files hold as data."""
import dataclasses

import numpy as np
import pytest

from portbench.bench import cell as cl
from portbench.yard import traffic, training, world

SEEDS = (0, 7, 2 ** 31 + 5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind, kw", [
    ("poisson", {}), ("gamma", {"cv": 2.0}), ("gamma", {"cv": 3.0}),
    ("square", {"period": 20.0, "high_frac": 1.7}),
    ("flash", {"burst_start": 2.0, "burst_dur": 3.0, "burst_mult": 4.0})])
def test_arrivals(kind, kw, seed):
    from repro_torch.serving.workload import make_arrivals
    np.testing.assert_array_equal(
        traffic.make_arrivals(kind, 37.0, 300, seed=seed, **kw),
        make_arrivals(kind, 37.0, 300, seed=seed, **kw))


def test_world_and_split():
    from repro_torch.serving.world import World, build_dataset
    caps, verb = [0.3, 0.45, 0.6], [1.1, 1.0, 0.9]
    got = world.sample_world(caps, verb, 300, seed=5, split_seed=6)
    ds = build_dataset(World(caps, verb, seed=5), n=300, seed=6)
    np.testing.assert_array_equal(got.quality, ds.quality)
    np.testing.assert_array_equal(got.lengths, ds.lengths)
    np.testing.assert_array_equal(got.train_idx, ds.train_idx)
    np.testing.assert_array_equal(got.test_idx, ds.test_idx)
    for i, p in enumerate(ds.prompts):
        np.testing.assert_array_equal(got.tokens[i], p.tokens)
        assert (got.topic[i], got.len_in[i]) == (p.topic, p.len_in)


@pytest.mark.parametrize("mix", ["mix400", "surge1600"])
@pytest.mark.parametrize("seed", SEEDS)
def test_stream(mix, seed):
    from repro_torch.serving.scenarios import TenantSpec, build_requests
    from repro_torch.serving.world import World, build_dataset
    m = cl.load_json(cl.ROOT / "portbench" / "traffic" / f"{mix}.json")
    caps, verb = [0.3, 0.45, 0.6], [1.1, 1.0, 0.9]
    ds = build_dataset(World(caps, verb, seed=5), n=400, seed=6)
    w = world.sample_world(caps, verb, 400, seed=5, split_seed=6)
    te = w.test_idx
    st = traffic.build_stream(w.topic[te], w.len_in[te], m, 500, seed,
                              lam_scale=m["lam_scale"])
    tenants = tuple(TenantSpec(
        name=t["name"], lam=t["lam"], arrival=t["arrival"],
        arrival_kw=tuple(t["arrival_kw"].items()),
        topics=None if t["topics"] is None else tuple(t["topics"]),
        len_band=None if t["len_band"] is None else tuple(t["len_band"]),
        budget_frac=t["budget_frac"], budget_range=tuple(t["budget_range"]),
        priority=t["priority"]) for t in m["tenants"])
    reqs = build_requests(ds, tenants, 500, lam_scale=m["lam_scale"],
                          seed=seed)
    prompts = ds.split("test")[0]
    assert st.n == len(reqs)
    np.testing.assert_array_equal(st.arrival, [r.arrival for r in reqs])
    assert all(prompts[st.prompt[i]] is r.prompt for i, r in enumerate(reqs))
    np.testing.assert_array_equal(
        st.budget, [np.nan if r.budget is None else r.budget for r in reqs])
    assert [st.names[k] for k in st.tenant] == [r.tenant for r in reqs]


def test_training_pairs():
    from repro_torch.core.scheduler import _tier_sweep
    from repro_torch.serving.tiers import Tier
    cfg = cl.load_json(cl.ROOT / "portbench/configs/fleet10k_flat.json")
    rows = cfg["roster"]["tiers"][:3]
    rng = np.random.default_rng(0)
    got = training.training_pairs(rows, 0, 2000)
    for t, (X, y) in zip(rows, got):
        Xw, yw = _tier_sweep(Tier(model_cfg=None, **t), rng)
        np.testing.assert_array_equal(X, Xw)
        np.testing.assert_array_equal(y, yw)


@pytest.mark.parametrize("name", ["fleet10k_flat", "fleet10k_cells16"])
def test_roster_is_hyperfleet_10k(name):
    from repro_torch.serving.scenarios import get_scenario, synthetic_pool
    sc = get_scenario("hyperfleet_10k")
    tiers, names, w = synthetic_pool(sc.n_tiers, sc.n_instances, sc.seed)
    cfg = cl.load_json(cl.ROOT / "portbench" / "configs" / f"{name}.json")
    want = []
    for t in tiers:
        d = dataclasses.asdict(t)
        d.pop("model_cfg")
        want.append(d)
    assert cfg["roster"]["tiers"] == want
    assert cfg["roster"]["model_names"] == names
    assert cfg["world"]["capacities"] == [float(c) for c in w.capacity]
    assert cfg["world"]["verbosities"] == [float(v) for v in w.verbosity]
    assert cfg["world"]["seed"] == sc.seed
    assert cfg["dataset"]["split_seed"] == sc.seed + 1
    mix = cl.load_json(cl.ROOT / "portbench/traffic/mix400.json")
    assert [(t["name"], t["lam"], t["priority"]) for t in mix["tenants"]] \
        == [(t.name, t.lam, t.priority) for t in sc.tenants]
