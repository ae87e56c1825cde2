"""The RG-LRU hybrid's and the encoder-decoder's serving steps under the
placement plans: 4 spawned gloo ranks on the CPU
(`torch_mesh_ranks.tp_ranks`), against the reference.

The smoke variants of recurrentgemma-2b (two RG-LRU layers and a local
attention layer of window 16 a cycle, one RG-LRU remainder layer; W =
64, 4 query heads and 1 KV head of 16) and whisper-tiny (2 encoder and
2 decoder layers, 4 query and 2 KV heads of 16) run in float32 through
`lower_cell`'s prefill and 8 greedy decode steps, each rank with its
pieces of the bridged weights (`sharding.shard_params`), under (data 2,
model 2) and (data 1, model 4):

  * the RG-LRU on its W / model channels: `w_in`, `w_gate_branch`,
    `lam`, `w_i` / `w_r` columns and the conv (the stacked layers'
    conv is kept whole by the plan and read as a share), its `h` and
    `conv` caches split on the channels, `u` gathered for the gates;
  * the hybrid's attention always takes the head-cut path (half or a
    quarter of its one KV head), its cache split on the 16 slots; the
    12-token prompt and 8 steps wrap the ring (positions 12..19 over 16
    slots);
  * whisper's heads whole under model 2 (one KV head a rank, caches on
    their KV heads), cut under model 4 (caches on their slots: 16 self
    slots, 24 cross frames), `frontend_proj` split and gathered.

The reference is its unsharded `Model.prefill` / `decode` on the same
numpy parameters (`torch_mesh_reference`, mode ``tp``), one data
shard's rows at a time: tokens identical, logits (each shard's put
together from its "model" ranks' vocabulary shares) within 1e-4, the
zoo's float32 limit; the collectives of each forward are the plan's
(`torch_tp_plan.want_collectives`); the caches lie where `cache_pspecs`
places them.
"""
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import tp_ranks
from torch_mesh_reference import start_reference
from torch_span_ranks import run_ranks
from torch_tp_plan import want_collectives

ARCHS = ("recurrentgemma-2b", "whisper-tiny")
MESHES = ((2, 2), (1, 4))
B, PROMPT, PAD_TO, STEPS = 4, 12, 24, 8
WHISPER_PROMPT = 4                      # 4 + 8 tokens of 16 self slots
TOL = 1e-4


def _cfg(arch):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(dtype=torch.float32)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.normal(size=(B, PAD_TO, cfg.frontend_dim))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, WHISPER_PROMPT))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT))
            .astype(np.int32)}


def _reference_params(arch):
    """The reference's smoke weights from `jax.random.key(0)`, float32,
    as numpy (the draw `torch_mesh_reference`'s ``tp`` mode makes)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as REF, smoke_variant
    from repro.models import Model as RefModel
    cfg = smoke_variant(REF[arch]).replace(dtype=jnp.float32)
    return jax.tree.map(np.asarray, RefModel(cfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families")
    batches = {a: _batch(_cfg(a), 50 + i) for i, a in enumerate(ARCHS)}
    wait = start_reference({"tp": {
        a: dict(arch=a, batch=batches[a], pad_to=PAD_TO, steps=STEPS,
                rows=[(0, 2), (2, 4), (0, 4)]) for a in ARCHS}}, 1, tmp)
    cases = {a: dict(cfg=_cfg(a), params=_reference_params(a),
                     batch=batches[a], pad_to=PAD_TO, steps=STEPS,
                     meshes=MESHES) for a in ARCHS}
    with open(tmp / "case.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    run_ranks(tp_ranks, 4, tmp, str(tmp / "case.pkl"), str(tmp),
              timeout=300.0)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return wait()["tp"], ranks


def _shards(mesh):
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


@pytest.mark.parametrize("arch,mesh", CASES)
def test_collectives_per_forward_are_the_plans(runs, arch, mesh):
    cfg = _cfg(arch)
    sizes = {"data": mesh[0], "model": mesh[1]}
    for res in runs[1]:
        got = res[(arch, mesh)]["collectives"]
        assert got[0] == want_collectives(cfg, sizes, False, ctx=PAD_TO)
        for step in got[1:]:
            assert step == want_collectives(cfg, sizes, True, ctx=PAD_TO)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_pieces_lie_where_the_plan_places_them(runs, arch, mesh):
    """Every cache leaf a rank holds has the plan's local shape (the
    RG-LRU's `h` / `conv` on W / model channels; the attention caches on
    their KV heads or slots); the first layer's weights are this rank's
    shares."""
    cfg = _cfg(arch)
    m = mesh[1]
    for res in runs[1]:
        got = res[(arch, mesh)]
        assert got["cache_shapes"] == got["plan_cache_shapes"]
        if cfg.is_encdec:
            continue
        W = cfg.lru_width
        assert got["cache_shapes"]["layers.0.h"] == (B // mesh[0], W // m)
        assert got["local_shapes"]["layers.0.mixer.w_in"] == (cfg.d_model,
                                                              W // m)
        assert got["local_shapes"]["layers.0.mixer.w_out"] == (W // m,
                                                               cfg.d_model)


def test_whisper_caches_split_on_heads_then_slots(runs):
    """Under model 2 whisper's caches hold one of the 2 KV heads a rank;
    under model 4 (the heads cut) a quarter of the 16 self slots and of
    the 24 cross frames."""
    cfg = _cfg("whisper-tiny")
    for res in runs[1]:
        two = res[("whisper-tiny", (2, 2))]["cache_shapes"]
        four = res[("whisper-tiny", (1, 4))]["cache_shapes"]
        assert two["layers.0.self_k"] == (2, cfg.dec_max_len, 1, cfg.hd)
        assert two["layers.0.cross_k"] == (2, PAD_TO, 1, cfg.hd)
        assert four["layers.0.self_k"] == (B, cfg.dec_max_len // 4, 2,
                                           cfg.hd)
        assert four["layers.0.cross_v"] == (B, PAD_TO // 4, 2, cfg.hd)
