"""The reference's prefix-cache / session-affinity tests
(`tests/test_affinity.py`) on both packages.

The signature, sketch, submit / requeue / fail and SoA-ingest cases run
unchanged on the reference and on the port (`pkg`), and where the two
compute the same thing (signatures, mirrors, hit fractions) the port's
must equal the reference's bitwise. The decision cases run the port's
backends on the CPU (``megakernel``, K1's plain version; the staged
``torch`` and ``numpy`` cores) with the bundle bridged from the
reference's weights (`torch_scenario_parity.build_pair`), against the
reference's ``fused``: affinity steers every backend to the warm
replica and a zero weight leaves it inert, bitwise; session churn runs
at one decision-kernel shape per R bucket (the reference's zero
recompiles) with the reference's completions; chat turns share their
prefixes as the reference's do; a retry across two request streams is
decided safely and as the reference decides it.
"""
import types

import numpy as np
import pytest
import torch

from torch_scenario_parity import build_pair, completions, run_pair

PORT = ("megakernel", "torch", "numpy")


def _ns(pkg):
    """The modules a case reads, from either package."""
    if pkg == "ref":
        from repro.serving import affinity, cluster, request, scenarios
        from repro.serving.world import Prompt
    else:
        from repro_torch.serving import affinity, cluster, request, \
            scenarios
        from repro_torch.serving.world import Prompt
    return types.SimpleNamespace(aff=affinity, cluster=cluster,
                                 request=request, scen=scenarios,
                                 Prompt=Prompt)


@pytest.fixture(params=["ref", "port"])
def ns(request):
    return _ns(request.param)


def _prompt(ns, pid, toks):
    toks = np.asarray(toks, np.int32)
    return ns.Prompt(pid=pid, topic=0, difficulty=0.5, verbosity=0.5,
                     tokens=toks, len_in=int(toks.size))


def _req(ns, rid, prompt, arrival=0.0):
    return ns.request.Request(rid=rid, prompt=prompt, arrival=arrival,
                              true_quality=np.full(8, 0.5),
                              true_length=np.full(8, 40.0))


# -- signatures ---------------------------------------------------------------

def test_signatures_are_int32_with_zero_sentinel(ns):
    a = ns.aff
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 4096, (4, 128)).astype(np.int32)
    lens = np.array([128, 40, 16, 7])
    sig = a.prefix_signatures(toks, lens)
    assert sig.dtype == np.int32 and sig.shape == (4, a.SIG_WIDTH)
    blocks = np.minimum(-(-lens // a.PREFIX_BLOCK), a.SIG_WIDTH)
    for p in range(4):
        assert (sig[p, :blocks[p]] != 0).all(), (p, sig[p])
        assert (sig[p, blocks[p]:] == 0).all(), (p, sig[p])
    np.testing.assert_array_equal(
        sig, _ns("ref").aff.prefix_signatures(toks, lens))


def test_signatures_shared_prefix_shares_leading_columns(ns):
    rng = np.random.default_rng(1)
    a = rng.integers(1, 4096, 128).astype(np.int32)
    b = a.copy()
    b[48:] = rng.integers(1, 4096, 80)       # diverge inside block 3
    sig = ns.aff.prefix_signatures(np.stack([a, b]), np.array([128, 128]))
    assert (sig[0, :3] == sig[1, :3]).all()
    assert (sig[0, 3:] != sig[1, 3:]).all()


def test_signatures_padding_invariant(ns):
    rng = np.random.default_rng(2)
    raw = rng.integers(1, 4096, 37).astype(np.int32)
    padded = np.zeros((1, 128), np.int32)
    padded[0, :37] = raw
    s_raw = ns.aff.prefix_signatures(raw[None, :], np.array([37]))
    s_pad = ns.aff.prefix_signatures(padded, np.array([37]))
    np.testing.assert_array_equal(s_raw, s_pad)
    p = _prompt(ns, 0, raw)
    np.testing.assert_array_equal(ns.aff.prompt_signatures(p), s_raw[0])
    assert ns.aff.prompt_signatures(p) is ns.aff.prompt_signatures(p)


def test_columns_prefix_sig_matches_prompt_signatures(ns):
    rng = np.random.default_rng(3)
    reqs = [_req(ns, i, _prompt(ns, i, rng.integers(1, 4096, int(n))))
            for i, n in enumerate(rng.integers(5, 128, 12))]
    cols = ns.request.RequestColumns.from_requests(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            cols.prefix_sig[cols.prompt_row[r.row]],
            ns.aff.prompt_signatures(r.prompt))


# -- sketch -------------------------------------------------------------------

def test_sketch_insert_hit_and_leading_run(ns):
    a = ns.aff
    sig = a.prefix_signatures(np.arange(1, 129)[None, :].astype(np.int32),
                              np.array([128]))[0]
    sk = a.PrefixSketch()
    sk.insert(sig[:3])
    assert sk.hit_tokens(sig, 128) == 3 * a.PREFIX_BLOCK
    assert sk.hit_tokens(sig, 40) == 40
    sk2 = a.PrefixSketch()
    sk2.insert([int(sig[0]), int(sig[2])])
    assert sk2.hit_tokens(sig, 128) == a.PREFIX_BLOCK


def test_sketch_lru_eviction_and_mirror(ns):
    sk = ns.aff.PrefixSketch(capacity=4)
    sk.insert([1, 2, 3, 4])
    sk.insert([1])                           # touch 1: now 2 is LRU
    sk.insert([5])
    assert set(sk.slots) == {1, 3, 4, 5}
    row = sk.mirror()
    assert row.dtype == np.int32 and row.shape == (4,)
    assert set(row.tolist()) == {1, 3, 4, 5}
    sk.clear()
    assert len(sk) == 0 and (sk.mirror() == 0).all()


def test_hit_fraction_port_is_the_reference_bitwise():
    """The port's torch `hit_fraction` against the reference's numpy (and
    so its jnp, which its own test holds bitwise) on partial-prefix
    caches; the scalar sketch walk agrees with the vectorized form."""
    from repro.serving import affinity as ref
    from repro_torch.serving import affinity as port
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 4096, (6, 128)).astype(np.int32)
    lens = rng.integers(4, 129, 6)
    req_sig = ref.prefix_signatures(toks, lens)
    plane = np.zeros((5, ref.SKETCH_SLOTS), np.int32)
    for i in range(5):
        sk = port.PrefixSketch()
        sk.insert(req_sig[i % 6, :rng.integers(1, ref.SIG_WIDTH + 1)])
        sk.mirror(out=plane[i])
    lenf = lens.astype(np.float32)
    h_ref = ref.hit_fraction(req_sig, lenf, plane, np)
    h = port.hit_fraction(torch.from_numpy(req_sig), torch.from_numpy(lenf),
                          torch.from_numpy(plane)).numpy()
    np.testing.assert_array_equal(h, h_ref)
    assert h.dtype == np.float32 and h.max() > 0
    for i in range(5):
        sk = port.PrefixSketch()
        sk.insert(plane[i])
        for r in range(6):
            frac = sk.hit_tokens(req_sig[r], int(lens[r])) \
                / max(float(lens[r]), 1.0)
            assert h[r, i] == pytest.approx(frac), (r, i)


# -- dead reckoning on dispatch / finish / fail -------------------------------

def _mini_sim(ns, n_tiers=1, n_instances=3, seed=0):
    tiers, names, _ = ns.scen.synthetic_pool(n_tiers, n_instances, seed=seed)
    return ns.cluster.ClusterSim(tiers, names, seed=0)


def test_submit_stamps_hit_inserts_and_mirrors(ns):
    sim = _mini_sim(ns)
    inst = sim.instances[0]
    rng = np.random.default_rng(5)
    p = _prompt(ns, 0, rng.integers(1, 4096, 64))
    sig = ns.aff.prompt_signatures(p)
    inst.submit(_req(ns, 0, p), 0.0, 10.0, None)
    assert sim.completed == []
    assert inst.sketch.hit_tokens(sig, 64) == 64
    assert set(sig[sig != 0].tolist()) <= set(
        sim.tel.prefix_sig[inst.slot].tolist())
    v = sim.tel.prefix_version
    r2 = _req(ns, 1, p)
    inst.submit(r2, 0.1, 10.0, None)
    assert r2.prefix_hit == pytest.approx(1.0)
    assert sim.tel.prefix_version > v
    assert sim.tel.prefix_hit[inst.slot] > 0


def test_prefill_discount_shortens_admission(ns):
    sim = _mini_sim(ns)
    inst = sim.instances[0]
    rng = np.random.default_rng(6)
    p = _prompt(ns, 0, rng.integers(1, 4096, 128))
    cold = _req(ns, 0, p)
    inst.submit(cold, 0.0, 10.0, None)
    sim.run()
    assert cold.finish_time is not None and cold.prefix_hit == 0.0
    t1 = sim.now + 1.0
    warm = _req(ns, 1, p, arrival=t1)
    inst.submit(warm, t1, 10.0, None)
    sim.run()
    assert warm.prefix_hit == pytest.approx(1.0)
    cold_prefill = cold.first_token_time - cold.dispatch_time
    warm_prefill = warm.first_token_time - warm.dispatch_time
    assert cold_prefill > 0.0
    assert warm_prefill < 0.5 * cold_prefill


def test_requeue_resets_prefix_hit(ns):
    rng = np.random.default_rng(7)
    r = _req(ns, 0, _prompt(ns, 0, rng.integers(1, 4096, 64)))
    r.prefix_hit = 0.75
    r.requeue(2.0)
    assert r.prefix_hit == 0.0


def test_fail_clears_sketch_and_mirror_for_retries(ns):
    sim = _mini_sim(ns)
    inst = sim.instances[0]
    rng = np.random.default_rng(8)
    p = _prompt(ns, 0, rng.integers(1, 4096, 64))
    inst.submit(_req(ns, 0, p), 0.0, 10.0, None)
    assert len(inst.sketch) > 0
    inst.fail()
    assert len(inst.sketch) == 0
    assert (sim.tel.prefix_sig[inst.slot] == 0).all()
    inst.recover(1.0)
    assert len(inst.sketch) == 0
    assert (sim.tel.prefix_sig[inst.slot] == 0).all()
    assert inst.sketch.hit_tokens(ns.aff.prompt_signatures(p), 64) == 0


# -- SoA ingest re-entrancy ---------------------------------------------------

class _StubEncoder:
    dim = 8
    max_len = 128

    def __init__(self, fail_at_call=None):
        self.calls = 0
        self.fail_at = fail_at_call

    def encode(self, toks, lens):
        self.calls += 1
        if self.calls == self.fail_at:
            self.fail_at = None
            raise RuntimeError("encoder died mid-chunk")
        out = np.zeros((len(toks), self.dim), np.float32)
        out[:, 0] = toks[:, 0]
        out[:, 1] = np.asarray(lens, np.float32)
        return out


def _many_prompt_reqs(ns, n=300, seed=9):
    rng = np.random.default_rng(seed)
    return [_req(ns, i, _prompt(ns, i, rng.integers(1, 4096, 12)))
            for i in range(n)]


def test_ensure_embeddings_all_or_nothing_and_resume(ns):
    RC = ns.request.RequestColumns
    reqs = _many_prompt_reqs(ns)
    cols = RC.from_requests(reqs)
    with pytest.raises(RuntimeError):
        cols.ensure_embeddings(_StubEncoder(fail_at_call=2))
    assert cols.emb is None
    assert cols._emb_partial is not None
    assert cols._emb_partial[1] == 256
    pad_cache = cols._toks_padded
    retry = _StubEncoder()
    cols.ensure_embeddings(retry)
    assert retry.calls == 1
    assert cols._toks_padded is pad_cache
    assert cols.emb is not None and cols._emb_partial is None
    ref = RC.from_requests(reqs, stamp=False)
    ref.ensure_embeddings(_StubEncoder())
    np.testing.assert_array_equal(cols.emb, ref.emb)
    emb = cols.emb
    cols.ensure_embeddings(_StubEncoder(fail_at_call=1))
    assert cols.emb is emb


def test_batch_columns_rejects_foreign_and_stale_rows(ns):
    RC = ns.request.RequestColumns
    a = _many_prompt_reqs(ns, 6, seed=10)
    b = _many_prompt_reqs(ns, 6, seed=11)
    cols_a = RC.from_requests(a)
    RC.from_requests(b)
    got_cols, got_rows = ns.request.batch_columns(a[:4])
    assert got_cols is cols_a
    np.testing.assert_array_equal(got_rows, [r.row for r in a[:4]])
    b[0].requeue(5.0)
    assert ns.request.batch_columns([a[0], b[0]]) == (None, None)
    rogue = a[1]
    rogue.row = cols_a.n + 7
    assert ns.request.batch_columns([a[0], rogue]) == (None, None)


# -- decision steering: the port's backends against the reference's fused -----

@pytest.fixture(scope="module")
def steer_pair():
    from repro.serving.scenarios import Scenario as RefScenario
    from repro.serving.scenarios import TenantSpec as RefTenant
    from repro_torch.serving.scenarios import Scenario, TenantSpec
    kw = dict(name="steer", pool="synthetic", n_tiers=1, n_instances=4,
              seed=7)
    return build_pair(RefScenario(tenants=(RefTenant("all", 8.0),), **kw),
                      Scenario(tenants=(TenantSpec("all", 8.0),), **kw),
                      220)


@pytest.fixture(scope="module")
def chat_pair():
    from repro.serving.scenarios import get_scenario as ref_get
    from repro_torch.serving.scenarios import get_scenario
    return build_pair(ref_get("session_chat"), get_scenario("session_chat"),
                      300)


def _ref_decide(rrun, reqs, be, w, sim):
    import repro.core as R
    rb = R.RouteBalance(R.RBConfig(decision_backend=be, affinity_weight=w),
                        rrun.bundle(), rrun.tiers)
    rb.sim = sim
    instances, choice, l_chosen = rb._decide_core(reqs)
    return [instances[int(i)].iid for i in choice], np.asarray(l_chosen)


def _port_decide(prun, reqs, be, w, sim):
    import repro_torch.core as P
    rb = P.RouteBalance(P.RBConfig(decision_backend=be, affinity_weight=w),
                        prun.bundle(), prun.tiers)
    rb.sim = sim
    res = rb.policy.assign(P.BatchView(reqs), sim)
    choice, l_chosen = res.fetch()
    return [res.instances[int(i)].iid for i in choice], np.asarray(l_chosen)


def _pair_requests(rrun, prun, n, seed):
    rreqs = rrun.requests(n, seed=seed)
    preqs = prun.requests(n, seed=seed)
    preqs[0].cols.emb = rreqs[0].cols.emb
    return rreqs, preqs


def test_affinity_steers_to_warm_instance_all_backends(steer_pair):
    """Four identical idle replicas; one holds the request's full prefix.
    Affinity on routes the request to the warm cache in every port
    backend, as the reference's fused does; w = 0 ignores the sketch."""
    rrun, prun = steer_pair
    rreqs, preqs = _pair_requests(rrun, prun, 4, 0)
    rreqs[0].arrival = preqs[0].arrival = 0.0

    def pick(w, be, warm_slot=None, pkg="port"):
        n = _ns(pkg)
        run, req = (prun, preqs[0]) if pkg == "port" else (rrun, rreqs[0])
        sim = n.cluster.ClusterSim(run.tiers, run.names, seed=0)
        if warm_slot is not None:
            warm = sim.instances[warm_slot]
            warm.sketch.insert(n.aff.prompt_signatures(req.prompt))
            sim.tel.write_prefix(warm.slot, warm.sketch)
        decide = _port_decide if pkg == "port" else _ref_decide
        return decide(run, [req], be, w, sim)[0][0]

    base = pick(0.0, "fused", pkg="ref")
    iids = [i.iid for i in _ns("port").cluster.ClusterSim(
        prun.tiers, prun.names, seed=0).instances]
    warm_slot = next(s for s in range(len(iids)) if iids[s] != base)
    assert pick(0.6, "fused", warm_slot, "ref") == iids[warm_slot]
    for be in PORT:
        assert pick(0.0, be) == base, be
        assert pick(0.6, be, warm_slot) == iids[warm_slot], be
        assert pick(0.0, be, warm_slot) == base, (be, "inert at w=0")


def test_weight_zero_is_bitwise_inert(steer_pair):
    """affinity_weight = 0 leaves the megakernel's choices and l_chosen
    exactly the legacy values with warm sketches everywhere, and they
    are the reference's fused choices."""
    rrun, prun = steer_pair
    rreqs, preqs = _pair_requests(rrun, prun, 12, 1)
    rreqs, preqs = rreqs[:12], preqs[:12]
    for r in rreqs + preqs:
        r.arrival = 0.0
    n = _ns("port")
    out = {}
    for arm in ("legacy", "zero_w"):
        sim = n.scen.randomize_telemetry(
            n.cluster.ClusterSim(prun.tiers, prun.names, seed=0), 3)
        if arm == "zero_w":
            n.scen.randomize_prefix_state(sim, preqs[0].cols, seed=3,
                                          frac=1.0)
        out[arm] = _port_decide(prun, preqs, "megakernel", 0.0, sim)
    assert out["legacy"][0] == out["zero_w"][0]
    np.testing.assert_array_equal(out["legacy"][1], out["zero_w"][1])
    r = _ns("ref")
    sim = r.scen.randomize_telemetry(
        r.cluster.ClusterSim(rrun.tiers, rrun.names, seed=0), 3)
    assert _ref_decide(rrun, rreqs, "fused", 0.0, sim)[0] == \
        out["legacy"][0]


def test_zero_shape_variants_through_session_churn(chat_pair):
    """Session traffic (multi-turn prefix churn, sketch writes every
    dispatch) runs the decision kernel at one shape per pow2 R bucket,
    as the reference's zero recompiles; a second cell over fresh
    sessions runs on its own hot path, at one shape per bucket of its
    own; completions and metrics are the reference's."""
    from repro_torch.core.decision import bucket_pow2
    from torch_scenario_parity import assert_metrics_equal
    rrun, prun = chat_pair
    (rreqs, rm), (preqs, pm, pb) = run_pair(rrun, prun, n=120, seed=0,
                                            affinity_weight=0.35)
    assert completions(preqs) == completions(rreqs)
    assert_metrics_equal(rm, pm)
    assert pm["cache_hit_rate"] > 0
    buckets = {bucket_pow2(s) for s, _ in pb.compute_log}
    hp = pb._fused
    assert hp.shape_variants() == len(buckets)
    import repro_torch.core as P
    reqs2 = prun.requests(120, seed=1)
    pb2 = P.RouteBalance(P.RBConfig(affinity_weight=0.35,
                                    charge_compute=False),
                         prun.bundle(), prun.tiers)
    prun.run_cell(pb2, reqs2, seed=0)
    assert pb2._fused is not hp              # one hot path an engine
    buckets2 = {bucket_pow2(s) for s, _ in pb2.compute_log}
    assert pb2._fused.shape_variants() == len(buckets2)


def test_session_chat_turns_share_prefixes(chat_pair):
    rrun, prun = chat_pair
    rreqs, reqs = _pair_requests(rrun, prun, 80, 0)
    cols = reqs[0].cols
    chat = [r for r in reqs if r.tenant == "chat"]
    assert len(chat) > 20
    sig = cols.prefix_sig[cols.prompt_row[[r.row for r in chat]]]
    first = sig[:, 0]
    _, counts = np.unique(first[first != 0], return_counts=True)
    assert (counts > 1).any()
    lens = np.array([r.prompt.len_in for r in chat])
    assert lens.max() > lens.min()
    rcols = rreqs[0].cols
    rchat = [r for r in rreqs if r.tenant == "chat"]
    np.testing.assert_array_equal(
        sig, rcols.prefix_sig[rcols.prompt_row[[r.row for r in rchat]]])


def test_retry_across_two_streams_decides_safely(steer_pair):
    """A requeued request of one stream joins a batch of another's: every
    port backend falls back to per-request staging, assigns every
    request to an alive instance, and picks as the reference's fused."""
    rrun, prun = steer_pair
    picks = {}
    for pkg, run in (("ref", rrun), ("port", prun)):
        n = _ns(pkg)
        ra, pa = _pair_requests(rrun, prun, 8, 2)
        rb_, pb_ = _pair_requests(rrun, prun, 8, 3)
        stream_a, stream_b = (ra, rb_) if pkg == "ref" else (pa, pb_)
        retry = stream_b[0]
        retry.requeue(0.0)
        batch = stream_a[:4] + [retry]
        for r in batch:
            r.arrival = 0.0
        for be in (("fused",) if pkg == "ref" else PORT):
            sim = n.scen.randomize_telemetry(
                n.cluster.ClusterSim(run.tiers, run.names, seed=0), 5)
            decide = _ref_decide if pkg == "ref" else _port_decide
            got = decide(run, batch, be, 0.35, sim)[0]
            assert len(got) == len(batch)
            assert set(got) <= {i.iid for i in sim.instances if i.alive}
            picks[be] = got
    for be in PORT:
        assert picks[be] == picks["fused"], be
