"""Multi-turn sessions in the benchmark's stream and the prefix-affinity
term in its reference: the one-shot mixes' streams and the reference's
readings without the term are as they were, the session stream keeps
its structure, the yard's signatures and hits are the program's, and a
tiny session cell with the term on is judged correct, with rows whose
best instance the term moves."""
import hashlib

import numpy as np
import pytest
import torch

from portbench import run, tinycell
from portbench.bench import cell as cl
from portbench.yard import affinity, traffic, world
from portbench.yard import reference as rm
from portbench.yard.training import encoder_params, training_pairs

CAPS, VERB = [0.3, 0.45, 0.6], [1.1, 1.0, 0.9]

# sha256 (first 16 hex digits) of the stream's arrays at 500 requests,
# as the generator gave them before it knew sessions
STREAMS = {("mix400", 0): "9a3b21500f7c5638",
           ("mix400", 1): "f8a7b7411827bcf3",
           ("mix400", 2): "dd56eb36e6262bc8",
           ("surge1600", 0): "e95896a5040df282",
           ("surge1600", 1): "50d7b2906059e42f",
           ("surge1600", 2): "c9648a755ff1857b"}
# the same of `check_batch`'s gap and length error, the reference's and
# the TF32 control's, on three synthetic batches of a tiny cell
READINGS = "62d27ff9cd43bec3"


def small_world():
    return world.sample_world(CAPS, VERB, 400, seed=5, split_seed=6)


def stream(mix, seed, w, n=500):
    te = w.test_idx
    return traffic.build_stream(w.topic[te], w.len_in[te], mix, n, seed,
                                lam_scale=mix["lam_scale"],
                                tokens=[w.tokens[i] for i in te])


def load_mix(name):
    return cl.load_json(cl.ROOT / "portbench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix, seed", sorted(STREAMS))
def test_one_shot_streams_are_as_before(mix, seed):
    st = stream(load_mix(mix), seed, small_world())
    h = hashlib.sha256()
    for a in (st.arrival, st.prompt, st.budget, st.tenant, st.priority,
              st.ends):
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest()[:16] == STREAMS[mix, seed]
    assert st.tokens is None


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_session_stream_structure(seed):
    w = small_world()
    te = w.test_idx
    plain = load_mix("mix400")
    mix = tinycell.with_sessions(plain)
    st = stream(mix, seed, w)
    sess = tinycell.SESSION
    lo, hi = sess["extend"]
    assert np.all(np.diff(st.arrival) >= 0)
    # one-shot tenants draw from their own streams: as without sessions
    ref = stream(plain, seed, w)
    for k, name in enumerate(st.names):
        mine = st.tenant == k
        assert (np.array([t is not None for t in st.tokens])[mine]
                == (name != "batch")).all()
        if name == "batch":
            theirs = ref.tenant == k
            np.testing.assert_array_equal(st.arrival[mine],
                                          ref.arrival[theirs])
            np.testing.assert_array_equal(st.prompt[mine],
                                          ref.prompt[theirs])
    # each conversation, as the generator deals the tenant's slots
    for k, ten in enumerate(mix["tenants"]):
        if "session" not in ten:
            continue
        rng = np.random.default_rng((seed, k, 0xA11CE))
        rng.integers(2 ** 31)                   # the arrivals' seed
        pool = traffic._tenant_pool(w.topic[te], w.len_in[te], ten)
        picks, toks = traffic._session_prompts(
            sess, 100, rng, pool, [w.tokens[i] for i in te])
        n_conv = 20
        for c in range(n_conv):
            slots = range(c, 100, n_conv)
            first = toks[c]
            np.testing.assert_array_equal(
                first, w.tokens[te[picks[c]]][:sess["base_len"]])
            for prev_i, i in zip(slots, slots[1:]):
                prev, cur = toks[prev_i], toks[i]
                assert picks[i] == picks[c]
                assert len(cur) <= traffic.SESSION_CAP
                np.testing.assert_array_equal(cur[:len(prev)], prev)
                grown = len(cur) - len(prev)
                if len(cur) < traffic.SESSION_CAP:
                    assert lo <= grown <= hi
                assert np.all((cur[len(prev):] >= 1)
                              & (cur[len(prev):] < world.VOCAB))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_session_stream_is_the_programs(seed):
    """The session tenants' turns are those the program's `SessionSpec`
    draws for the same seed: arrivals, tokens, lengths and base rows."""
    from repro_torch.serving.scenarios import (SessionSpec, TenantSpec,
                                               build_requests)
    from repro_torch.serving.world import World, build_dataset
    ds = build_dataset(World(CAPS, VERB, seed=5), n=400, seed=6)
    w = small_world()
    mix = tinycell.with_sessions(load_mix("mix400"))
    st = stream(mix, seed, w)
    sess = tinycell.SESSION
    tenants = tuple(TenantSpec(
        name=t["name"], lam=t["lam"], arrival=t["arrival"],
        arrival_kw=tuple(t["arrival_kw"].items()),
        topics=None if t["topics"] is None else tuple(t["topics"]),
        len_band=None if t["len_band"] is None else tuple(t["len_band"]),
        budget_frac=t["budget_frac"], budget_range=tuple(t["budget_range"]),
        priority=t["priority"],
        session=SessionSpec(turns=sess["turns"], base_len=sess["base_len"],
                            extend=tuple(sess["extend"]))
        if "session" in t else None) for t in mix["tenants"])
    reqs = build_requests(ds, tenants, 500, lam_scale=mix["lam_scale"],
                          seed=seed)
    prompts, Q, _ = ds.split("test")
    assert st.n == len(reqs)
    np.testing.assert_array_equal(st.arrival, [r.arrival for r in reqs])
    for i, r in enumerate(reqs):
        base = prompts[st.prompt[i]]
        if st.tokens[i] is None:
            assert r.prompt is base
            continue
        np.testing.assert_array_equal(st.tokens[i], r.prompt.tokens)
        assert r.prompt.len_in == len(st.tokens[i])
        np.testing.assert_array_equal(r.true_quality, Q[st.prompt[i]])


@pytest.mark.parametrize("bad", [{"turns": 5}, dict(tinycell.SESSION, x=1)])
def test_check_mix_refuses_unknown_session_keys(bad):
    mix = tinycell.with_sessions(load_mix("mix400"))
    mix["tenants"][0]["session"] = bad
    with pytest.raises(ValueError):
        traffic.check_mix(mix)


def test_signatures_and_hits_are_the_programs():
    from repro_torch.serving.affinity import hit_fraction, prefix_signatures
    rng = np.random.default_rng(3)
    lens = [0, 1, 15, 16, 17, 127, 128, 200]
    base = rng.integers(0, 4096, 200).astype(np.int32)
    # prompts that share prefixes, and some that do not
    prompts = [base[:n] for n in lens] + [
        rng.integers(0, 4096, n).astype(np.int32) for n in lens]
    mat = np.zeros((len(prompts), 200), np.int32)
    for i, p in enumerate(prompts):
        mat[i, :len(p)] = p
    want = prefix_signatures(mat, np.array([len(p) for p in prompts]))
    got = affinity.signatures(prompts)
    np.testing.assert_array_equal(got, want)
    # a plane of 12 instances: random slots, some holding the leading
    # columns of a prompt
    plane = rng.integers(-2 ** 31, 2 ** 31, (12, affinity.SLOTS),
                         dtype=np.int64).astype(np.int32)
    plane[rng.uniform(size=plane.shape) < 0.3] = 0
    for i in range(12):
        src = want[rng.integers(len(prompts))]
        k = int(rng.integers(0, affinity.WIDTH + 1))
        slots = rng.choice(affinity.SLOTS, k, replace=False)
        plane[i, slots] = src[:k]
    len_in = np.array([len(p) if i % 3 else 3 * len(p) + 5
                       for i, p in enumerate(prompts)], np.float32)
    theirs = hit_fraction(torch.as_tensor(want), torch.as_tensor(len_in),
                          torch.as_tensor(plane)).numpy()
    mine = affinity.hit_fraction(got, len_in, plane)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, theirs)
    assert (mine > 0).any() and (mine == 0).any()


def test_readings_without_the_term_are_as_before():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, cfg, _ = tinycell.tiny("fleet10k_flat.mix400")
        w = world.world_from_config(cfg)
        e = cfg["estimators"]["encoder"]
        pairs = training_pairs(cfg["roster"]["tiers"],
                               cfg["estimators"]["sweep"]["seed"],
                               cfg["estimators"]["sweep"]["rows"])
        ref = rm.Reference(cfg, w, encoder_params(e, e["seed"]), pairs)
        ctl = rm.Reference(cfg, w, encoder_params(e, e["seed"]), [],
                           tf32=True)
        ctl.trees = ref.trees
        roster = rm.roster_of(cfg["roster"]["tiers"],
                              cfg["roster"]["model_names"])
        I = len(roster.tier)
        h = hashlib.sha256()
        for s in range(3):
            rng = np.random.default_rng(100 + s)
            R = 12
            prompts = rng.choice(w.test_idx, R)
            budget = np.where(rng.uniform(size=R) < 0.5, np.exp(rng.uniform(
                np.log(2e-5), np.log(4e-4), R)), np.nan)
            alive = rng.uniform(size=I) < 0.9
            bt = rm.Batch(
                prompts=prompts, budget=budget,
                len_in=w.len_in[prompts].astype(np.float64),
                pending=rng.uniform(0, 3000, I),
                batch=rng.integers(0, 20, I), free=rng.integers(0, 3, I),
                ctx=rng.uniform(0, 4000, I), alive=alive,
                choice=rng.choice(np.flatnonzero(alive), R),
                l_chosen=rng.uniform(50, 400, R))
            out = rm.check_batch(ref, roster, bt,
                                 tuple(cfg["check"]["weights"]), ctl)
            for k in ("gap", "l_err", "ctl_gap", "ctl_l_err"):
                h.update(np.ascontiguousarray(out[k]).tobytes())
            assert not out["aff_moved"].any()
    finally:
        torch.set_num_threads(n)
    assert h.hexdigest()[:16] == READINGS


def test_session_cell_is_correct_and_the_term_moves_rows():
    bench, cell, cfg, mix = tinycell.tiny_sessions()
    res = run.run_cell(bench, cell, cfg, mix, 2 ** 33 + 17, 1.0, False,
                       "cpu", t_start=0.0)
    read = res["info"]["readings"]
    assert res["correct"] is True, res["checks"]
    assert read["rows_checked"] >= 20
    assert read["gap_max"] == 0.0
    assert read["aff_rows_pct"] > 0
