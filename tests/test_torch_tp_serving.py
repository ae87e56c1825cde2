"""The placement plans carried out: tensor-parallel serving steps on 4
spawned gloo ranks on the CPU (`torch_mesh_ranks.tp_ranks`), against
the reference.

The smoke variants of granite-3-2b (dense), granite-moe (MoE: the
attention split, the experts' d_ff split), phi-3-vision (the
`frontend_proj` split) and mamba2 (the SSD's heads, its gated norm) run
in float32 through `lower_cell`'s prefill and decode steps, each rank
with its pieces of the bridged weights (`sharding.shard_params`), under
(data 2, model 2) and (data 1, model 4). The smoke configs have 4 query
and 2 KV heads of 16, so under model 4 the plan cuts each KV head in
half (`wk` / `wv` 8 columns a rank) and places the cache on its slots:
the head-cut path (`blocks._attn_cut`, `attention.split_decode_attention`).

The reference is its unsharded `Model.prefill` / `decode` on the same
numpy parameters (`torch_mesh_reference`, mode ``tp``), one data
shard's rows at a time (its MoE takes the capacity from the shard's
tokens, as it does under a mesh): a placement moves values, not what
they are. Prefill and 4 greedy steps: tokens identical, logits (each
shard's logits put together from its "model" ranks' vocabulary shares)
within 1e-4, the zoo's float32 limit; the collectives per forward equal
the count the plan implies; the caches lie where `cache_pspecs` places
them; without the gated norm's all-reduce mamba2's tokens change.
"""
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import tp_ranks
from torch_mesh_reference import run_reference
from torch_span_ranks import run_ranks
from torch_tp_plan import want_collectives

ARCHS = ("granite-3-2b", "granite-moe-3b-a800m", "phi-3-vision-4.2b",
         "mamba2-1.3b")
MESHES = ((2, 2), (1, 4))
B, PROMPT, PAD_TO, STEPS = 4, 12, 24, 4
TOL = 1e-4
FSDP = "granite-3-2b/fsdp"     # the same case with the FSDP rule forced on


def _cfg(arch):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(dtype=torch.float32)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    batches = {a: _batch(_cfg(a), 30 + i) for i, a in enumerate(ARCHS)}
    ref = run_reference({"tp": {
        a: dict(arch=a, batch=batches[a], pad_to=PAD_TO, steps=STEPS,
                rows=[(0, 2), (2, 4), (0, 4)]) for a in ARCHS}}, 1,
        tmp)["tp"]
    cases = {a: dict(cfg=_cfg(a), params=ref[a]["params"], batch=batches[a],
                     pad_to=PAD_TO, steps=STEPS, meshes=MESHES,
                     drop_norm_sum=(a == "mamba2-1.3b")) for a in ARCHS}
    cases[FSDP] = dict(cases["granite-3-2b"], meshes=((2, 2),), fsdp=True)
    with open(tmp / "case.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    run_ranks(tp_ranks, 4, tmp, str(tmp / "case.pkl"), str(tmp),
              timeout=300.0)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return ref, ranks


def _shards(mesh):
    """[(rows, [ranks of the shard in "model" order])] on a (data, model)
    mesh (rank r at (r // model, r % model))."""
    d, m = mesh
    per = B // d
    return [((j * per, (j + 1) * per), list(range(j * m, (j + 1) * m)))
            for j in range(d)]


CASES = [pytest.param(a, m, id=f"{a}-{m[0]}x{m[1]}")
         for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tokens_and_logits_match_reference(runs, arch, mesh):
    ref, ranks = runs
    worst = 0.0
    for rows, members in _shards(mesh):
        want = ref[arch][rows]
        got = [ranks[r][(arch, mesh)] for r in members]
        assert len(got[0]["logits"]) == STEPS + 1
        for t in range(STEPS + 1):
            logits = np.concatenate([g["logits"][t] for g in got], -1)
            assert logits.shape == want[t].shape
            worst = max(worst, float(np.abs(logits - want[t]).max()))
            for g in got:        # every "model" rank has the tokens
                assert np.array_equal(g["tokens"][t], want[t].argmax(-1))
    assert worst <= TOL, worst


def test_fsdp_pieces_gather_to_the_reference(runs):
    """granite-3-2b under (data 2, model 2) with `lower_cell(...,
    fsdp=True)`: every layer weight also split over "data" on its
    largest free dimension, all-gathered over "data" where a forward
    reads it (`Params.__getitem__`): tokens identical, logits within
    1e-4 of the reference's, one all-gather per FSDP leaf on top of the
    plan's collectives."""
    from torch_tp_plan import fsdp_leaves
    ref, ranks = runs
    mesh, cfg = (2, 2), _cfg("granite-3-2b")
    sizes = {"data": 2, "model": 2}
    n = fsdp_leaves(cfg, sizes, True)
    worst = 0.0
    for rows, members in _shards(mesh):
        want = ref["granite-3-2b"][rows]
        got = [ranks[r][(FSDP, mesh)] for r in members]
        for t in range(STEPS + 1):
            logits = np.concatenate([g["logits"][t] for g in got], -1)
            worst = max(worst, float(np.abs(logits - want[t]).max()))
            for g in got:
                assert np.array_equal(g["tokens"][t], want[t].argmax(-1))
    assert worst <= TOL, worst
    for res in ranks:
        got = res[(FSDP, mesh)]
        assert len(got["gathered"]) == n > 0
        assert got["local_shapes"]["layers.0.mixer.wq"] == (
            cfg.d_model // 2, cfg.n_heads * cfg.hd // 2)
        assert got["collectives"][0] == want_collectives(
            cfg, sizes, False, fsdp=n, ctx=PAD_TO)
        for step in got["collectives"][1:]:
            assert step == want_collectives(cfg, sizes, True, fsdp=n,
                                            ctx=PAD_TO)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_collectives_per_forward_are_the_plans(runs, arch, mesh):
    cfg = _cfg(arch)
    for res in runs[1]:
        got = res[(arch, mesh)]["collectives"]
        sizes = {"data": mesh[0], "model": mesh[1]}
        assert got[0] == want_collectives(cfg, sizes, False, ctx=PAD_TO)
        for step in got[1:]:
            assert step == want_collectives(cfg, sizes, True, ctx=PAD_TO)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_pieces_lie_where_the_plan_places_them(runs, arch, mesh):
    """Every cache leaf a rank holds has the plan's local shape; the
    first layer's weights are this rank's shares."""
    cfg = _cfg(arch)
    m = mesh[1]
    for res in runs[1]:
        got = res[(arch, mesh)]
        assert got["cache_shapes"] == got["plan_cache_shapes"]
        shapes = got["local_shapes"]
        if cfg.family == "ssm":
            assert shapes["layers.0.mixer.in_x"] == (cfg.d_model,
                                                     cfg.d_inner // m)
            assert shapes["layers.0.mixer.out_proj"] == (cfg.d_inner // m,
                                                         cfg.d_model)
        else:
            assert shapes["layers.0.mixer.wk"] == (
                cfg.d_model, cfg.n_kv_heads * cfg.hd // m)
            assert shapes["layers.0.mixer.wo"] == (
                cfg.n_heads * cfg.hd // m, cfg.d_model)


def test_model_four_cuts_the_kv_heads(runs):
    """Under (data 1, model 4) a rank holds half a KV head of `wk` and a
    quarter of each attention cache's slots: the head-cut path ran."""
    cfg = _cfg("granite-3-2b")
    for res in runs[1]:
        got = res[("granite-3-2b", (1, 4))]
        assert got["local_shapes"]["layers.0.mixer.wk"][1] == cfg.hd // 2
        C = got["plan_cache_shapes"]["layers.0.positions"][0]
        assert got["cache_shapes"]["layers.0.k"] == (B, C // 4,
                                                     cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_gated_norm_needs_its_all_reduce(runs, mesh):
    """mamba2 without the gated norm's sum of squares over "model": its
    norm is another, and its tokens leave the reference's."""
    ref, ranks = runs
    for rows, members in _shards(mesh):
        want = ref["mamba2-1.3b"][rows]
        for r in members:
            toks = ranks[r][("mamba2-1.3b", mesh, "no_norm_sum")]
            assert any(not np.array_equal(t, w.argmax(-1))
                       for t, w in zip(toks, want))


def test_counted_collectives_on_ranks(runs):
    """`shardctx.all_reduce` (sum over "model", max over "data"),
    `all_gather` and `reduce_scatter` on 4 gloo ranks of a (data 2,
    model 2) mesh: the results, and each call counted by kind with its
    payload, link bytes at the ring factors and HBM bytes."""
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(4)]
    for r, res in enumerate(runs[1]):
        got = res["collectives_api"]
        j, k = r // 2, r % 2
        pair = [x[2 * j], x[2 * j + 1]]
        assert np.array_equal(got["sum"], pair[0] + pair[1])
        assert np.array_equal(got["max"], np.maximum(x[k], x[k + 2]))
        assert np.array_equal(got["gather"], np.concatenate(pair, 1))
        full = sum(np.arange(8.0).reshape(2, 4) * (q + 1)
                   for q in (2 * j, 2 * j + 1))
        assert np.array_equal(got["scatter"], full[:, 2 * k:2 * k + 2])
        c = got["counts"]
        assert c["all_reduce"] == dict(count=2, bytes=48, link_bytes=96.0,
                                       hbm_bytes=96)
        assert c["all_gather"] == dict(count=1, bytes=48, link_bytes=48.0,
                                       hbm_bytes=72)
        assert c["reduce_scatter"] == dict(count=1, bytes=16,
                                           link_bytes=16.0, hbm_bytes=48)


@pytest.mark.slow
def test_mesh_ranks_leave_the_group_cleanly(tmp_path):
    """`allreduce_ranks` spawned 20 times on 2 ranks: every rank exits 0
    (each leaves through a barrier and `destroy_process_group`; before,
    a rank could abort with the gloo group alive under load)."""
    from torch_mesh_ranks import allreduce_ranks
    rng = np.random.default_rng(12)
    case = {"float32": dict(
        dtype="float32", same=rng.normal(size=(3, 17)).astype(np.float32),
        per_rank=rng.normal(size=(4, 3, 17)).astype(np.float32),
        axes=(("data",),))}
    with open(tmp_path / "ar.pkl", "wb") as fh:
        pickle.dump(case, fh)
    for i in range(20):
        d = tmp_path / f"run{i}"
        d.mkdir()
        run_ranks(allreduce_ranks, 2, d, str(tmp_path / "ar.pkl"), str(d), 1)


def _k3_case(seed, B=2, C=96, K=3, g=4, d=16, valid=70, pos=80, window=0):
    """q (B, H, d), caches (B, C, K, d) and positions (valid positions
    0..valid-1, -1 after), float32, from a seed."""
    rng = np.random.default_rng(seed)
    q, kc, vc = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, K * g, d), (B, C, K, d), (B, C, K, d)))
    positions = np.full(C, -1, np.int32)
    positions[:valid] = np.arange(valid)
    return q, kc, vc, positions, pos, window


def _reference_attention(q, kc, vc, positions, pos, window):
    import jax.numpy as jnp
    from repro.kernels import ref as kref
    return np.asarray(kref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(positions), pos, window=window))


@pytest.mark.parametrize("valid,window", [(70, 0), (70, 24), (0, 0)])
def test_k3_stats_are_each_heads_max_and_exp_sum(valid, window):
    """K3's `stats` (its plain version here): each head's max of the
    scaled scores over the valid slots and the sum of exp(s - max), held
    against numpy; (-1e30, 0) where no slot is valid; the output is the
    one without `stats`."""
    from repro_torch.kernels import decode_attention as k3
    q, kc, vc, positions, pos, window = _k3_case(40, valid=valid,
                                                 window=window)
    args = [torch.from_numpy(a) for a in (q, kc, vc, positions)]
    o, ml = k3.decode_attention(*args, pos, window, stats=True)
    assert torch.equal(o, k3.decode_attention(*args, pos, window))
    B, H, d = q.shape
    K = kc.shape[2]
    ok = (positions >= 0) & (positions <= pos)
    if window:
        ok &= positions > pos - window
    for b in range(B):
        for h in range(H):
            if not ok.any():
                assert ml[b, h, 0] <= -1e29 and ml[b, h, 1] == 0
                continue
            s = kc[b, ok, h // (H // K)] @ q[b, h].astype(np.float64) \
                * d ** -0.5
            m = s.max()
            np.testing.assert_allclose(float(ml[b, h, 0]), m, rtol=1e-6)
            np.testing.assert_allclose(float(ml[b, h, 1]),
                                       np.exp(s - m).sum(), rtol=1e-5)


def test_split_slots_merge_to_the_whole_cache(monkeypatch):
    """`split_decode_attention` over 4 shares of the slots (`split`): K3
    on each share with its (max, exp-sum), the shares merged as the
    "model" all-gather hands them over (each rank's part recorded, then
    all four given back), for every rank's heads: the reference's
    attention over the whole cache, within 1e-5."""
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.models import attention
    q, kc, vc, positions, pos, window = _k3_case(41, C=96, valid=70,
                                                 window=40)
    want = _reference_attention(q, kc, vc, positions, pos, window)
    H, m, C = q.shape[1], 4, kc.shape[1]
    share = C // m
    t = {k: torch.from_numpy(v) for k, v in
         dict(q=q[:, None], k=kc, v=vc, p=positions).items()}
    parts = []

    def record(part, axis, dim):
        parts.append(part)
        return part
    monkeypatch.setattr(attention, "all_gather", record)
    for r in range(m):
        sl = slice(r * share, (r + 1) * share)
        attention.split_decode_attention(
            t["q"], t["k"][:, sl].contiguous(), t["v"][:, sl].contiguous(),
            t["p"][sl].contiguous(), pos, (0, H), window)
    monkeypatch.setattr(attention, "all_gather",
                        lambda part, axis, dim: torch.cat(parts, 0))
    k3.reset_counts()
    hq = H // m
    for r in range(m):
        sl = slice(r * share, (r + 1) * share)
        got = attention.split_decode_attention(
            t["q"], t["k"][:, sl].contiguous(), t["v"][:, sl].contiguous(),
            t["p"][sl].contiguous(), pos, (r * hq, (r + 1) * hq), window)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   want[:, r * hq:(r + 1) * hq], atol=1e-5)
    assert k3.decode_attention.plain_calls == m


@pytest.mark.parametrize("heads", [(0, 3), (3, 6), (6, 9), (9, 12), (2, 7)])
def test_whole_cache_cut_heads_attend_through_k3(heads):
    """`split_decode_attention` without `split` (every rank holds the
    whole cache): one K3 call on the KV heads the rank's query heads
    read, the reference's attention for those heads within 1e-5, no
    collective."""
    from repro_torch.distributed import shardctx
    from repro_torch.kernels import decode_attention as k3
    from repro_torch.models.attention import split_decode_attention
    q, kc, vc, positions, pos, window = _k3_case(42)
    want = _reference_attention(q, kc, vc, positions, pos, window)
    k3.reset_counts()
    shardctx.reset_collectives()
    got = split_decode_attention(
        torch.from_numpy(q[:, None]), torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(positions), pos, heads,
        window, split=False)
    h0, h1 = heads
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, h0:h1], atol=1e-5)
    assert k3.decode_attention.plain_calls == 1
    assert all(v["count"] == 0 for v in shardctx.COLLECTIVES.values())


def test_moe_route_hook_records_and_replays():
    """`moe_layer.route`: handing back its argument leaves the layer
    bitwise as it was; replaying one call's recorded experts reproduces
    it bitwise; forcing other experts (the tokens' choices in reverse
    order) changes the output."""
    from repro_torch.models import moe
    rng = np.random.default_rng(43)
    D, F, E, T, k = 16, 32, 6, 10, 2
    p = {"router": torch.from_numpy(rng.normal(size=(D, E)).astype(
             np.float32)),
         **{n: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)
            for n, s in (("up", (E, D, F)), ("gate", (E, D, F)),
                         ("down", (E, F, D)))}}
    x = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    kw = dict(top_k=k, capacity_factor=1.0)
    want, want_aux = moe.moe_layer(x, p, **kw)
    seen = []
    try:
        moe.moe_layer.route = lambda idx, probs: seen.append(idx) or idx
        got, aux = moe.moe_layer(x, p, **kw)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)
        moe.moe_layer.route = lambda idx, probs: seen[0]
        got, aux = moe.moe_layer(x, p, **kw)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)
        moe.moe_layer.route = lambda idx, probs: torch.flip(idx, (0,))
        got, aux = moe.moe_layer(x, p, **kw)
        assert not torch.equal(got, want)
    finally:
        moe.moe_layer.route = None
