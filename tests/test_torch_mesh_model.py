"""The granite-moe smoke model under a (data 2, model 2) mesh, on the
CPU: 4 spawned gloo ranks (`torch_mesh_ranks.model_ranks`), each serving
its data shard's rows through `lower_cell`'s prefill and decode steps on
its pieces of the plan (`sharding.shard_params`: the attention's heads
and the vocabulary split over "model", the experts' d_ff too), against
the reference on 4 forced host devices under
`sharding_rules(mesh, residual=residual_spec(mesh))`
(`torch_mesh_reference`), on the reference's weights through the
bridge, in float32: prefill and 4 greedy decode steps, tokens identical
and logits (a shard's two vocabulary shares put together) within 1e-4;
2 all-reduces per MoE layer per forward; the two "model" ranks of a
shard pick the same tokens.
"""
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import model_ranks
from torch_mesh_reference import run_reference
from torch_span_ranks import run_ranks

ARCH, B, PROMPT, PAD_TO, STEPS = "granite-moe-3b-a800m", 4, 12, 16, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_config, smoke_variant
    tmp = tmp_path_factory.mktemp("mesh_model")
    cfg = smoke_variant(get_config(ARCH)).replace(dtype=torch.float32)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    ref = run_reference({"model": dict(arch=ARCH, tokens=tokens,
                                       pad_to=PAD_TO, steps=STEPS)},
                        4, tmp)["model"]
    with open(tmp / "case.pkl", "wb") as fh:
        pickle.dump(dict(cfg=cfg, params=ref["params"],
                         batch={"tokens": tokens}, pad_to=PAD_TO,
                         steps=STEPS), fh)
    run_ranks(model_ranks, 4, tmp, str(tmp / "case.pkl"), str(tmp))
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return cfg, ref, ranks


def test_ranks_serve_the_reference_tokens(runs):
    cfg, ref, ranks = runs
    half = B // 2
    worst = 0.0
    for j in range(2):
        rows = slice(j * half, (j + 1) * half)
        pair = ranks[2 * j:2 * j + 2]
        assert len(pair[0]["logits"]) == STEPS + 1
        for t, want in enumerate(ref["logits"]):
            want = want[rows]
            got = np.concatenate([r["logits"][t] for r in pair], -1)
            assert got.shape == want.shape
            for r in pair:
                assert np.array_equal(r["tokens"][t], want.argmax(-1))
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 1e-4, worst


def test_model_ranks_agree_and_hold_half_the_experts(runs):
    cfg, _, ranks = runs
    for j in range(2):
        for a, b in zip(ranks[2 * j]["tokens"], ranks[2 * j + 1]["tokens"]):
            assert np.array_equal(a, b)
    for res in ranks:
        assert res["local_shapes"]["layers.0.mlp.up"] == (
            cfg.n_experts, cfg.d_model, cfg.d_ff // 2)


def test_two_all_reduces_per_moe_layer_per_forward(runs):
    cfg, _, ranks = runs
    n_moe = sum(b.mlp == "moe" for b in cfg.layer_types)
    for res in ranks:
        assert res["all_reduces"] == [2 * n_moe] * (STEPS + 1)


def test_constrain_is_a_no_op_without_a_mesh():
    """No mesh, or a mesh without the rule: `constrain` returns its
    argument itself; a plain tensor under a mesh and a rule too."""
    from repro_torch.distributed.shardctx import constrain, sharding_rules
    x = torch.randn(2, 3, 4)
    assert constrain(x, "residual") is x
    with sharding_rules({"data": 2, "model": 2}):
        assert constrain(x, "residual") is x
    with sharding_rules({"data": 2, "model": 2},
                        residual=(("data",), (), ())):
        assert constrain(x, "residual") is x
