"""Config overrides: the dry run's `--overrides`, and the placements the
reference's plans fall back to, executed on 4 spawned gloo ranks on the
CPU against the reference jitted under the same plans on 4 host devices.

The reference's rules fall back from one dimension to the next, and
GSPMD lowers every placement they make. Each is reached here by a named
config override of a smoke variant (float32):

  * ``embed_dmodel`` - granite-3-2b with `{"vocab": 509}` planned as
    configured (`param_pspecs` of the model; `lower_cell` itself pads
    the rows to 256 in both packages, so `{"vocab_pad_to": 1}` alone
    never reaches it): 509 rows do not divide over "model", so the
    embedding and the logits go to d_model (reference
    `launch/sharding.py:54-59`); tied, and untied
    (``embed_dmodel_untied``);
  * ``kv_head_dim`` - granite-3-2b with `{"n_kv_heads": 1}` and a 23-slot
    cache: neither the KV head nor the slots divide, so the cache goes to
    head_dim (`:155-163`); whisper-tiny with `{"n_kv_heads": 1,
    "dec_max_len": 15}` and 13 frames (``kv_head_dim_encdec``), its self
    and cross caches alike;
  * ``ssd_head_cut`` - mamba2-1.3b with `{"ssm_head_dim": 64,
    "ssm_expand": 3}`: 3 heads of 64 over 2 or 4 ranks, `in_x` split by
    columns mid-head, `in_dt` and the state whole;
  * ``ssd_group_cut`` - mamba2-1.3b with `{"ssm_expand": 3,
    "ssm_groups": 3}`: 24 heads in groups of 8, 12 or 6 a rank;
  * ``stacked_fsdp`` - mamba2-1.3b with FSDP forced: `out_norm`'s "data"
    lands on the stack dimension, whole layers on the data ranks.

Serving: prefill and 4 greedy decode steps of `lower_cell`'s steps on
(data 2, model 2) and (data 1, model 4) against the reference's jitted
prefill and decode (`torch_mesh_reference`, mode ``tpjit``): tokens
identical, logits within 1e-4 (float32), the collectives of each
forward the plan's (`torch_tp_plan.want_collectives`), the caches where
`cache_pspecs` places them. Training, where the placement reaches it
(the embedding, the SSD cuts, the stacked FSDP): one step of
`make_train_step(..., plan=, mesh=)` on both meshes against the
reference's jitted step under the same plan on (data 2, model 2) (mode
``train``): loss, ce and aux 1e-6 relative, grad_norm, the moments' and
the parameters' pieces 1e-5 of scale, the collectives of the step the
plan's. The dry run: `--overrides` plans a cell with the overridden
config, its per-device bytes the reference's PartitionSpecs', names its
file by `--tag`, and an unknown field fails as the reference's
`replace` does.
"""
import json
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import tp_ranks, train_ranks
from torch_mesh_reference import start_reference
from torch_span_ranks import run_ranks
from torch_tp_plan import want_collectives, want_train_step, \
    want_value_and_grad

MESHES = ((2, 2), (1, 4))
B, PROMPT, STEPS = 4, 12, 4
TOL = 1e-4
# name: (arch, overrides, meshes, extra)
SERVE = {
    "embed_dmodel": ("granite-3-2b", {"vocab": 509}, MESHES,
                     {"unpadded": True}),
    "embed_dmodel_untied": ("granite-3-2b", {"vocab": 509,
                                             "tie_embeddings": False},
                            ((2, 2),), {"unpadded": True}),
    "kv_head_dim": ("granite-3-2b", {"n_kv_heads": 1}, MESHES,
                    {"pad_to": 23}),
    "kv_head_dim_encdec": ("whisper-tiny", {"n_kv_heads": 1,
                                            "dec_max_len": 15}, MESHES,
                           {"frames": 13, "pad_to": 13}),
    "ssd_head_cut": ("mamba2-1.3b", {"ssm_head_dim": 64, "ssm_expand": 3},
                     MESHES, {}),
    "ssd_group_cut": ("mamba2-1.3b", {"ssm_expand": 3, "ssm_groups": 3},
                      MESHES, {}),
    "stacked_fsdp": ("mamba2-1.3b", {}, ((2, 2),), {"fsdp": True}),
}
TRAIN = ("embed_dmodel", "embed_dmodel_untied", "ssd_head_cut",
         "ssd_group_cut", "stacked_fsdp")
S_TRAIN = 16
OCFG = dict(lr=1e-2, warmup_steps=1)


def _cfg(name):
    from repro_torch.configs import get_config, smoke_variant
    arch, over, _, _ = SERVE[name]
    return smoke_variant(get_config(arch)).replace(dtype=torch.float32,
                                                   **over)


def _pad_to(name):
    return SERVE[name][3].get("pad_to", 24)


def _batch(name, seed):
    cfg, extra = _cfg(name), SERVE[name][3]
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.normal(size=(B, extra["frames"],
                                           cfg.frontend_dim))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, 4))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT))
            .astype(np.int32)}


def _train_batch(name):
    from repro_torch.training.data import batch_for
    return batch_for(_cfg(name), S_TRAIN, B, seed=9)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_overrides")
    refc = {n: dict(arch=SERVE[n][0], overrides=SERVE[n][1],
                    batch=_batch(n, 40 + i), pad_to=_pad_to(n),
                    steps=STEPS, meshes=SERVE[n][2],
                    fsdp=SERVE[n][3].get("fsdp", False))
            for i, n in enumerate(SERVE)}
    trainc = {n: dict(arch=SERVE[n][0], overrides=SERVE[n][1], mesh=(2, 2),
                      batch=_train_batch(n), ocfg=OCFG,
                      fsdp=SERVE[n][3].get("fsdp", False),
                      unpadded=SERVE[n][3].get("unpadded", False))
              for n in TRAIN}
    # the moments to start from, drawn from a seed over the reference's
    # tree (as `test_torch_tp_train` does: a first step from zero moments
    # moves each parameter by the sign of its gradient, which a gradient
    # element near eps decides)
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, smoke_variant
    from repro.models import Model as RefModel
    for i, n in enumerate(TRAIN):
        c = trainc[n]
        rcfg = smoke_variant(ARCHS[c["arch"]]).replace(dtype=jnp.float32,
                                                       **c["overrides"])
        if not c["unpadded"]:
            rcfg = rcfg.replace(vocab_pad_to=256)
        tree = RefModel(rcfg).param_specs()
        rng = np.random.default_rng(80 + i)
        c["state0"] = {
            "m": jax.tree.map(lambda p: 1e-4 * rng.standard_normal(
                p.shape).astype(np.float32), tree),
            "v": jax.tree.map(lambda p: 1e-4 * rng.uniform(
                0.5, 1.0, p.shape).astype(np.float32), tree)}
    # the reference runs in the background while the ranks run; both
    # draw the weights from jax.random.key(0)
    wait = start_reference({"tpjit": refc, "train": trainc}, 4, tmp,
                           timeout=900)
    params = {}
    for n in SERVE:
        rcfg = smoke_variant(ARCHS[SERVE[n][0]]).replace(dtype=jnp.float32,
                                                         **SERVE[n][1])
        params[n] = jax.tree.map(np.asarray,
                                 RefModel(rcfg).init(jax.random.key(0)))
    cases = {n: dict(cfg=_cfg(n), params=params[n], batch=refc[n]["batch"],
                     pad_to=_pad_to(n), steps=STEPS, meshes=SERVE[n][2],
                     fsdp=SERVE[n][3].get("fsdp"),
                     unpadded=SERVE[n][3].get("unpadded", False))
             for n in SERVE}
    with open(tmp / "serve.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    tcases = {n: dict(cfg=_cfg(n), params=params[n],
                      batch=trainc[n]["batch"], ocfg=OCFG, meshes=MESHES,
                      fsdp=trainc[n]["fsdp"] or None,
                      unpadded=trainc[n]["unpadded"],
                      state0=trainc[n]["state0"])
              for n in TRAIN}
    tcases["stacked_fsdp"]["meshes"] = ((2, 2),)
    with open(tmp / "train.pkl", "wb") as fh:
        pickle.dump(tcases, fh)
    serve_dir, train_dir = tmp / "serve", tmp / "train"
    serve_dir.mkdir()
    train_dir.mkdir()
    run_ranks(tp_ranks, 4, serve_dir, str(tmp / "serve.pkl"),
              str(serve_dir), timeout=300.0)
    run_ranks(train_ranks, 4, train_dir, str(tmp / "train.pkl"),
              str(train_dir), timeout=300.0)
    ref = wait()
    ranks, tranks = [], []
    for r in range(4):
        with open(serve_dir / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
        with open(train_dir / f"rank{r}.pkl", "rb") as fh:
            tranks.append(pickle.load(fh))
    return ref, cases, ranks, tcases, tranks


def _plans(name, mesh, kind="decode"):
    """(the parameter plan, the decode cache plan) the case runs under."""
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeSpec
    cfg, extra = _cfg(name), SERVE[name][3]
    sizes = {"data": mesh[0], "model": mesh[1]}
    plan, meta, _ = lower_cell(cfg, ShapeSpec("ovr", _pad_to(name), B, kind),
                               sizes, fsdp=extra.get("fsdp"))
    params = plan["params"]
    if extra.get("unpadded"):
        params = shr.param_pspecs(Model(cfg, device="meta"), sizes,
                                  fsdp=meta["fsdp"])
    return params, plan.get("cache")


SERVE_CASES = [pytest.param(n, m, id=f"{n}-{m[0]}x{m[1]}")
               for n in SERVE for m in SERVE[n][2]]


def test_each_override_reaches_its_placement():
    """The plans (the port's, and the reference's on the same tree)
    place each case as named: the embedding on d_model, a KV cache on
    head_dim, `in_x` split mid-head or the heads mid-group, a stack
    dimension on "data"."""
    from repro_torch.launch import sharding as shr
    for name in SERVE:
        cfg = _cfg(name)
        for mesh in SERVE[name][2]:
            params, cache = _plans(name, mesh)
            m = mesh[1]
            if name.startswith("embed_dmodel"):
                for leaf in ("['embed']",) + (
                        ("['lm_head']",) if not cfg.tie_embeddings else ()):
                    assert params[leaf].spec == ((), ("model",)), leaf
            elif name.startswith("kv_head_dim"):
                kv = [k for k, p in cache.items()
                      if k.split(".")[-1] in ("k", "v", "self_k", "self_v",
                                              "cross_k", "cross_v")]
                assert kv and all(cache[k].spec[-1] == ("model",)
                                  for k in kv), kv
            elif name == "ssd_head_cut":
                assert cfg.ssm_heads % m
                assert params["['slot0']['mixer']['in_x']"].spec[-1] == \
                    ("model",)
                assert params["['slot0']['mixer']['in_dt']"].spec[-1] == ()
            elif name == "ssd_group_cut":
                rep = cfg.ssm_heads // cfg.ssm_groups
                assert (cfg.ssm_heads // m) % rep
                assert params["['slot0']['mixer']['in_dt']"].spec[-1] == \
                    ("model",)
            else:
                assert params["['slot0']['mixer']['out_norm']"].spec[0] == \
                    ("data",)
            # the reference's own rules say the same of the same tree
            _same_as_reference(name, mesh, params, shr)


def _same_as_reference(name, mesh, params, shr):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCHS, smoke_variant
    from repro.launch import sharding as ref_shr
    from repro.models import Model as RefModel

    class Fake:
        shape = {"data": mesh[0], "model": mesh[1]}
        axis_names = ("data", "model")
    arch, over, _, extra = SERVE[name]
    rcfg = smoke_variant(ARCHS[arch]).replace(dtype=jnp.float32, **over)
    if not extra.get("unpadded"):
        rcfg = rcfg.replace(vocab_pad_to=256)
    tree = RefModel(rcfg).param_specs()
    specs = ref_shr.param_pspecs(tree, Fake(), fsdp=extra.get("fsdp",
                                                              False))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    for (path, sds), spec in zip(leaves, spec_leaves):
        parts = list(spec) + [None] * (len(sds.shape) - len(spec))
        want = tuple(() if a is None else ((a,) if isinstance(a, str)
                                           else tuple(a)) for a in parts)
        assert params[jax.tree_util.keystr(path)].spec == want, path


def _whole_logits(got, width):
    """A data shard's logits at one step from its "model" ranks: whole on
    each where the embedding is split over d_model, else the ranks'
    vocabulary shares put together."""
    if got[0].shape[-1] == width:
        for g in got[1:]:
            assert np.array_equal(g, got[0])
        return got[0]
    return np.concatenate(got, -1)


@pytest.mark.parametrize("name,mesh", SERVE_CASES)
def test_serving_matches_reference(runs, name, mesh):
    ref, cases, ranks, _, _ = runs
    cfg = cases[name]["cfg"]
    want = ref["tpjit"][name][mesh]
    d, m = mesh
    per = B // d
    worst = 0.0
    for j in range(d):
        members = [ranks[r][(name, mesh)] for r in range(j * m, (j + 1) * m)]
        assert len(members[0]["logits"]) == STEPS + 1
        for t in range(STEPS + 1):
            w = want[t][j * per:(j + 1) * per]
            logits = _whole_logits([g["logits"][t] for g in members],
                                   w.shape[-1])
            assert logits.shape == w.shape
            worst = max(worst, float(np.abs(logits - w).max()))
            for g in members:
                assert np.array_equal(g["tokens"][t], w.argmax(-1))
    assert worst <= TOL, worst
    for res in ranks:
        got = res[(name, mesh)]
        assert got["cache_shapes"] == got["plan_cache_shapes"]
        sizes = {"data": d, "model": m}
        fsdp = 0
        if cases[name].get("fsdp"):
            from torch_tp_plan import fsdp_leaves
            fsdp = fsdp_leaves(cfg, sizes, True)
        rows = cfg.padded_vocab if cases[name]["unpadded"] else None
        kw = dict(fsdp=fsdp, ctx=_pad_to(name), rows=rows)
        assert got["collectives"][0] == want_collectives(cfg, sizes, False,
                                                         **kw)
        for step in got["collectives"][1:]:
            assert step == want_collectives(cfg, sizes, True, **kw)


def test_stacked_fsdp_keeps_each_ranks_layers(runs):
    """Under (data 2, model 2) with FSDP mamba2's `out_norm` is stacked
    over its 2 layers and split over "data": each rank holds the layer of
    its data coordinate only, and both layers' modules gather theirs."""
    _, _, ranks, _, _ = runs
    for r, res in enumerate(ranks):
        got = res[("stacked_fsdp", (2, 2))]
        own = r // 2
        assert f"layers.{own}.mixer.out_norm" in got["gathered"]
        assert f"layers.{1 - own}.mixer.out_norm" in got["gathered"]
        assert got["local_shapes"].get("layers.0.mixer.out_norm") == (
            None if own else (_cfg("stacked_fsdp").d_inner // 2,))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) or 1.0
    return float(np.abs(a - b).max()) / scale


def _by_path(tree):
    import jax
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _train_plan(name, mesh):
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeSpec
    cfg = _cfg(name)
    plan, meta, _ = lower_cell(cfg, ShapeSpec("tp_train", S_TRAIN, B,
                                              "train"),
                               {"data": mesh[0], "model": mesh[1]},
                               fsdp=SERVE[name][3].get("fsdp"))
    if SERVE[name][3].get("unpadded"):
        model = Model(cfg, device="meta")
        plan = dict(plan, params=shr.param_pspecs(model, meta["mesh"],
                                                  fsdp=meta["fsdp"]),
                    opt=shr.opt_pspecs(model, meta["mesh"]))
    return plan


TRAIN_CASES = [pytest.param(n, m, id=f"{n}-{m[0]}x{m[1]}")
               for n in TRAIN for m in MESHES
               if n != "stacked_fsdp" or m == (2, 2)]


@pytest.mark.parametrize("name,mesh", TRAIN_CASES)
def test_train_step_matches_reference(runs, name, mesh):
    """Metrics, every rank's moments' and parameters' pieces, and the
    collectives of its gradients and of the whole step."""
    from repro_torch.launch import sharding as shr
    from repro_torch.models.bridge import params_from_jax
    ref, _, _, tcases, tranks = runs
    want = ref["train"][name]
    cfg, plan = tcases[name]["cfg"], _train_plan(name, mesh)
    sizes = {"data": mesh[0], "model": mesh[1]}
    new = params_from_jax(want["new_params"], cfg)
    wm, wv = _by_path(want["m"]), _by_path(want["v"])
    fsdp = 0
    if tcases[name].get("fsdp"):
        from torch_tp_plan import fsdp_leaves
        fsdp = fsdp_leaves(cfg, sizes, True)
    rows = cfg.padded_vocab if tcases[name]["unpadded"] else None
    want_vg = want_value_and_grad(cfg, sizes, B // mesh[0], S_TRAIN, fsdp,
                                  rows)
    want_step = want_train_step(cfg, sizes, plan, B // mesh[0], S_TRAIN,
                                fsdp, vocab_rows=rows)
    for r, res in enumerate(tranks):
        got = res[(name, mesh)]
        for k in ("loss", "ce", "aux"):
            assert abs(got["mets"][k] - want["mets"][k]) <= 1e-6 * max(
                abs(want["mets"][k]), 1.0), k
        for k in ("grad_norm", "lr"):
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
        assert got["grad_collectives"] == want_vg
        assert got["collectives"] == want_step


# -- the dry run's --overrides ------------------------------------------------

def _ref_bytes(arch, shape, overrides):
    """Per-device bytes on the 16 x 16 mesh from the reference's
    PartitionSpecs of the overridden config (`lower_cell`'s vocabulary
    padding and FSDP rule): parameters, the batch and the decode cache
    less its host-side counters."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config, input_specs
    from repro.launch import sharding as ref_shr
    from repro.models import Model as RefModel
    from repro.models.config import SHAPES
    sizes = {"data": 16, "model": 16}

    class Fake:
        shape = sizes
        axis_names = ("data", "model")
    cfg = get_config(arch).replace(**overrides).replace(vocab_pad_to=256)
    model, sp = RefModel(cfg), SHAPES[shape]
    fsdp = cfg.param_counts()["total"] * 2 >= 8e9

    def nbytes(tree, specs, skip=()):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))
        total = 0
        for (path, sds), spec in zip(leaves, spec_leaves):
            if jax.tree_util.keystr(path) in skip:
                continue
            n = sds.dtype.itemsize
            parts = list(spec) + [None] * (len(sds.shape) - len(spec))
            for s, a in zip(sds.shape, parts):
                axes = () if a is None else ((a,) if isinstance(a, str)
                                             else a)
                n *= s // int(np.prod([sizes[x] for x in axes]))
            total += n
        return total
    tree, batch = model.param_specs(), input_specs(cfg, sp)
    out = {"params": nbytes(tree, ref_shr.param_pspecs(tree, Fake(),
                                                       fsdp=fsdp)),
           "batch": nbytes(batch, ref_shr.batch_pspecs(batch, Fake()))}
    if sp.kind == "decode":
        cache = model.cache_specs(sp.global_batch, sp.seq_len)
        out["cache"] = nbytes(cache, ref_shr.cache_pspecs(
            cache, Fake(), sp.global_batch), ("['pos']", "['enc_len']"))
    return out


@pytest.mark.parametrize("arch,shape,overrides", [
    ("granite-3-2b", "decode_32k", {"vocab_pad_to": 1}),
    ("mamba2-1.3b", "prefill_32k", {"ssm_head_dim": 512}),
], ids=["granite-vocab_pad_to", "mamba2-ssd_head_cut"])
def test_dryrun_overrides_cell(tmp_path, monkeypatch, arch, shape,
                               overrides):
    """`--overrides` plans and steps the cell with the overridden config
    (mamba2's 8 SSD heads of 512 cut over 16 "model" ranks, which the
    executed step gathers), its per-device bytes the reference's, in the
    file `--tag` names."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RUNS", tmp_path)
    assert dryrun.main(["--arch", arch, "--shape", shape, "--overrides",
                        json.dumps(overrides), "--tag", "ovr"]) == 0
    rec = json.loads((tmp_path / f"{arch}__{shape}__16x16__ovr.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["bytes_per_device"] == _ref_bytes(arch, shape, overrides)
    assert rec["collectives"] and rec["flops_per_device"] > 0
    if arch == "mamba2-1.3b":
        plain = dryrun.main(["--arch", arch, "--shape", shape])
        base = json.loads((tmp_path / f"{arch}__{shape}__16x16.json")
                          .read_text())
        assert plain == 0
        # the cut heads gather x once a layer where the split heads did not
        assert rec["collectives"]["all_gather"]["count"] == \
            base["collectives"].get("all_gather", {"count": 0})["count"] \
            + 48


def test_dryrun_unknown_override_fails_as_the_reference(tmp_path,
                                                        monkeypatch):
    from repro.configs import get_config as ref_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun import fake_world, run_cell
    with pytest.raises(TypeError):
        ref_config("granite-3-2b").replace(no_such_field=1)
    with fake_world(256), pytest.raises(TypeError):
        run_cell("granite-3-2b", "decode_32k", False, {"no_such_field": 1})
    monkeypatch.setattr(dryrun, "RUNS", tmp_path)
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                        "--overrides", '{"no_such_field": 1}']) == 1
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__16x16.json")
                     .read_text())
    assert rec["status"] == "error" and "TypeError" in rec["traceback"]
