"""The train step under the placement plans: one step of every family's
smoke variant on 4 spawned gloo ranks on the CPU
(`torch_mesh_ranks.train_ranks`), against the reference's own jitted
step under the same plan.

Each rank holds its pieces of the bridged weights (`shard_params`), its
rows of the batch (`shard_batch`) and its ZeRO pieces of AdamW's
moments (`init_opt_state(..., plan=, mesh=)`), and runs
`make_train_step(..., plan=, mesh=)`: the collectives carry their
backward (`distributed.shardctx`), the loss is the global token mean
over the data shards, the data ranks' gradients are summed into the
moments' pieces and the parameters gathered back.

The reference (`torch_mesh_reference`, mode ``train``) runs
`make_train_step` under `jax.jit` with `lower_cell`'s shardings on a
(data, model) mesh of 4 host devices: its MoE takes the capacity per
data shard, as the port's does. GSPMD places values and leaves them what
they are, so for the families without a MoE layer the reference runs on
(data 2, model 2) only and both of the port's meshes are held against
it; granite-moe runs on both. The cases beyond one step of each family:
a `loss_mask` that keeps 28 of 32 positions on one data shard and 8 on
the other (the global token mean, not a mean of the shards' means),
recurrentgemma with remat, granite with FSDP forced (both held against
the plain step, which they do not change), granite with 2 microbatches
and with the int8 codec (against the reference with the same).

Tolerances are `tests/test_torch_training.py`'s, each relative to the
tensor's largest magnitude: loss, ce and aux 1e-6; grad_norm, the
moments' pieces and the updated parameters' pieces 1e-5. The step
starts from moments drawn from a seed (m 1e-4 N(0, 1), v 1e-4 U(0.5,
1)), as `test_torch_training`'s AdamW test does: m is then 0.1 g of the
clipped gradient to within 1e-5 of its scale, so it holds the gradients,
and the update m / (sqrt(v) + eps) is not the sign of g that a first
step from zero moments takes, where a gradient element near eps decides
the parameter's change. The
collectives of the step's gradients (its microbatches' `value_and_grad`)
and of the whole step, the backward and the recomputation included,
equal the plan's count
(`torch_tp_plan.want_value_and_grad`, `want_train_step`), and every
"model" rank of a data shard holds the same gradient of each leaf the
plan keeps whole over "model".
"""
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import train_ranks
from torch_mesh_reference import start_reference
from torch_span_ranks import run_ranks
from torch_tp_plan import want_train_step, want_value_and_grad

FAMILIES = ("granite-3-2b", "granite-moe-3b-a800m", "phi-3-vision-4.2b",
            "mamba2-1.3b", "recurrentgemma-2b", "whisper-tiny")
MESHES = ((2, 2), (1, 4))
B, S = 4, 16
OCFG = dict(lr=1e-2, warmup_steps=1)
# (port case, its arch, the reference case it is held against, extras)
SPECIAL = {
    "masked": ("granite-3-2b", "masked", {}),
    "remat": ("recurrentgemma-2b", "recurrentgemma-2b@2x2", {"remat": True}),
    "fsdp": ("granite-3-2b", "granite-3-2b@2x2", {"fsdp": True}),
    "microbatches": ("granite-3-2b", "microbatches", {"microbatches": 2}),
    "compression": ("granite-3-2b", "compression", {"compression": True}),
}


def _cfg(arch, **kw):
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config(arch)).replace(
        dtype=torch.float32, vocab_pad_to=256, **kw)


def _batch(arch, seed=3):
    from repro_torch.training.data import batch_for
    return batch_for(_cfg(arch), S, B, seed=seed)


def _masked_batch():
    """granite's batch with a loss mask keeping 28 of shard 0's 32
    positions and 8 of shard 1's."""
    batch = dict(_batch("granite-3-2b", seed=5))
    rng = np.random.default_rng(6)
    keep = np.zeros((B, S), bool)
    for row, n in ((0, 14), (1, 14), (2, 4), (3, 4)):
        keep[row, rng.choice(S, n, replace=False)] = True
    batch["loss_mask"] = keep
    return batch


def _ref_cases():
    cases = {f"{a}@2x2": dict(arch=a, mesh=(2, 2), batch=_batch(a),
                              ocfg=OCFG) for a in FAMILIES}
    cases["granite-moe-3b-a800m@1x4"] = dict(
        cases["granite-moe-3b-a800m@2x2"], mesh=(1, 4))
    g = cases["granite-3-2b@2x2"]
    cases["masked"] = dict(g, batch=_masked_batch())
    cases["microbatches"] = dict(g, microbatches=2)
    cases["compression"] = dict(g, compression=True)
    return cases


def _against(name, mesh):
    """The reference case a port case is held against."""
    if name in SPECIAL:
        return SPECIAL[name][1]
    m = "1x4" if (name == "granite-moe-3b-a800m" and mesh == (1, 4)) \
        else "2x2"
    return f"{name}@{m}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    refc = _ref_cases()
    # the weights: the reference's draw from jax.random.key(0); the
    # moments to start from drawn from a seed over the same tree
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, smoke_variant
    from repro.models import Model as RefModel
    params, state0 = {}, {}
    for i, a in enumerate(FAMILIES):
        rcfg = smoke_variant(ARCHS[a]).replace(dtype=jnp.float32,
                                               vocab_pad_to=256)
        params[a] = jax.tree.map(np.asarray,
                                 RefModel(rcfg).init(jax.random.key(0)))
        rng = np.random.default_rng(70 + i)
        state0[a] = {
            "m": jax.tree.map(lambda p: 1e-4 * rng.standard_normal(
                p.shape).astype(np.float32), params[a]),
            "v": jax.tree.map(lambda p: 1e-4 * rng.uniform(
                0.5, 1.0, p.shape).astype(np.float32), params[a])}
    for c in refc.values():
        c["state0"] = state0[c["arch"]]
    wait = start_reference({"train": refc}, 4, tmp)
    cases = {a: dict(cfg=_cfg(a), params=params[a], batch=_batch(a),
                     ocfg=OCFG, meshes=MESHES, state0=state0[a])
             for a in FAMILIES}
    for name, (arch, against, extra) in SPECIAL.items():
        kw = {k: v for k, v in extra.items() if k == "remat"}
        cases[name] = dict(cases[arch], cfg=_cfg(arch, **kw),
                           batch=refc[against]["batch"], meshes=((2, 2),),
                           **{k: v for k, v in extra.items()
                              if k != "remat"})
    with open(tmp / "case.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    run_ranks(train_ranks, 4, tmp, str(tmp / "case.pkl"), str(tmp),
              timeout=300.0)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return cases, wait()["train"], ranks


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) or 1.0
    return float(np.abs(a - b).max()) / scale


def _plan(case, mesh):
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.config import ShapeSpec
    plan, _, _ = lower_cell(case["cfg"], ShapeSpec("tp_train", S, B,
                                                    "train"),
                            {"data": mesh[0], "model": mesh[1]},
                            fsdp=case.get("fsdp"))
    return plan


def _by_path(tree):
    import jax
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


CASES = [pytest.param(a, m, id=f"{a}-{m[0]}x{m[1]}")
         for a in FAMILIES for m in MESHES] + \
    [pytest.param(n, (2, 2), id=n) for n in SPECIAL]


@pytest.mark.parametrize("name,mesh", CASES)
def test_step_matches_reference(runs, name, mesh):
    """Metrics, every rank's moments' pieces and parameters' pieces."""
    from repro_torch.launch import sharding as shr
    from repro_torch.models.bridge import params_from_jax
    cases, ref, ranks = runs
    case, want = cases[name], ref[_against(name, mesh)]
    cfg, plan = case["cfg"], _plan(case, mesh)
    sizes = {"data": mesh[0], "model": mesh[1]}
    new = params_from_jax(want["new_params"], cfg)
    wm, wv = _by_path(want["m"]), _by_path(want["v"])
    for r, res in enumerate(ranks):
        got = res[(name, mesh)]
        for k in ("loss", "ce", "aux"):
            assert abs(got["mets"][k] - want["mets"][k]) <= 1e-6 * max(
                abs(want["mets"][k]), 1.0), k
        for k in ("grad_norm", "lr") + (("compression_err_sq",)
                                        if case.get("compression") else ()):
            assert _rel(got["mets"][k], want["mets"][k]) <= 1e-5, k
        for key, tree in (("m", wm), ("v", wv)):
            assert sorted(got[key]) == sorted(tree)
            for path, piece in got[key].items():
                cut = shr.local_piece(torch.from_numpy(tree[path]),
                                      plan["opt"]["m"][path].spec, sizes, r)
                assert piece.shape == tuple(cut.shape), (key, path)
                assert _rel(piece, cut.numpy()) <= 1e-5, (key, path)
        for leaf, piece in got["params"].items():
            cut = shr.local_piece(new[leaf], shr._layer_spec(
                cfg, leaf, plan["params"]), sizes, r)
            assert piece.shape == tuple(cut.shape), leaf
            assert _rel(piece, cut.numpy()) <= 1e-5, leaf


def test_masked_loss_is_the_global_token_mean(runs):
    """The two data shards keep 28 and 8 positions: the loss is the sum
    over all 36 kept positions over 36 (the reference's), which a mean of
    the two shards' means is not."""
    cases, ref, ranks = runs
    mask = cases["masked"]["batch"]["loss_mask"]
    assert mask[:2].sum() == 28 and mask[2:].sum() == 8
    got = ranks[0][("masked", (2, 2))]["mets"]["ce"]
    want = ref["masked"]["mets"]["ce"]
    assert abs(got - want) <= 1e-6 * want
    # each shard's own mean, from one process on its rows
    from repro_torch.models import Model
    from repro_torch.models.bridge import params_from_jax
    model = Model(cases["masked"]["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(cases["masked"]["params"],
                                          model.cfg))
    with torch.no_grad():
        means = [float(model.loss({k: v[rows] for k, v in
                                   cases["masked"]["batch"].items()})[0])
                 for rows in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(means) - want) > 1e-3


@pytest.mark.parametrize("name,mesh", CASES)
def test_collectives_per_step_are_the_plans(runs, name, mesh):
    cases, _, ranks = runs
    case = cases[name]
    cfg = case["cfg"]
    sizes = {"data": mesh[0], "model": mesh[1]}
    rows = B // mesh[0]
    S_text = case["batch"]["labels"].shape[1]
    fsdp = 0
    if case.get("fsdp"):
        from torch_tp_plan import fsdp_leaves
        fsdp = fsdp_leaves(cfg, sizes, True)
    k = case.get("microbatches", 1)
    want_vg = {kind: k * n for kind, n in want_value_and_grad(
        cfg, sizes, rows // k, S_text, fsdp).items()}
    want = want_train_step(cfg, sizes, _plan(case, mesh), rows, S_text,
                           fsdp, k, case.get("compression", False))
    for res in ranks:
        got = res[(name, mesh)]
        assert got["grad_collectives"] == want_vg
        assert got["collectives"] == want


@pytest.mark.parametrize("name,mesh", CASES)
def test_model_ranks_hold_the_same_replicated_gradients(runs, name, mesh):
    """Every leaf the plan keeps whole over "model" (norms, routers, the
    SSD's in_B / in_C and per-head parameters, whisper's pos_dec): the
    same gradient, bitwise, on every "model" rank of a data shard."""
    from repro_torch.launch import sharding as shr
    cases, _, ranks = runs
    cfg, plan = cases[name]["cfg"], _plan(cases[name], mesh)
    m = mesh[1]
    whole = [leaf for leaf in ranks[0][(name, mesh)]["grads"]
             if not any("model" in axes for axes in
                        shr._layer_spec(cfg, leaf, plan["params"]))]
    assert whole
    for j in range(mesh[0]):
        first = ranks[j * m][(name, mesh)]["grads"]
        for r in range(j * m + 1, (j + 1) * m):
            got = ranks[r][(name, mesh)]["grads"]
            for leaf in whole:
                assert np.array_equal(got[leaf], first[leaf]), (r, leaf)


def test_each_backward_rule_on_ranks(runs):
    """Each collective's gradient on a (data 2, model 2) mesh, for
    sum(w_r * f(x_r)) with x_r, w_r known per rank: all-reduce -> w_r
    (g), `copy_to` -> the sum of the "model" pair's w (f), all-gather
    with "scatter" -> the pair's w summed at the rank's slice, with
    "slice" -> the rank's own w at its slice, reduce-scatter -> its w
    gathered, a max -> no gradient; one collective each in the
    backward."""
    ranks = runs[2]
    for r, res in enumerate(ranks):
        got = res["rules"]
        j, k = r // 2, r % 2
        pair = (2 * j, 2 * j + 1)
        w4 = {q: np.arange(4.0) + q for q in range(4)}
        w8 = {q: np.arange(8.0) + q for q in range(4)}
        sl = slice(4 * k, 4 * k + 4)
        np.testing.assert_array_equal(got["all_reduce"]["grad"], w4[r])
        np.testing.assert_array_equal(got["copy_to"]["grad"],
                                      w4[pair[0]] + w4[pair[1]])
        np.testing.assert_array_equal(got["gather_scatter"]["grad"],
                                      w8[pair[0]][sl] + w8[pair[1]][sl])
        np.testing.assert_array_equal(got["gather_slice"]["grad"],
                                      w8[r][sl])
        np.testing.assert_array_equal(
            got["reduce_scatter"]["grad"],
            np.concatenate([w4[pair[0]][:2], w4[pair[1]][:2]]))
        assert got["all_reduce_max"]["grad"] is None
        want = {"all_reduce": 0, "copy_to": ("all_reduce", 1),
                "gather_scatter": ("reduce_scatter", 1), "gather_slice": 0,
                "reduce_scatter": ("all_gather", 1), "all_reduce_max": 0}
        for name, w in want.items():
            counts = got[name]["counts"]
            if w == 0:
                assert not any(counts.values()), name
            else:
                assert counts[w[0]] == w[1] and sum(counts.values()) == 1
