"""The model-distribution layer's plans against the reference's, on the
CPU, in one process (no collective runs):

  * parameter plans: six archs x both production meshes x FSDP off and
    on, and the optimizer's (ZeRO) plan: for every reference leaf the
    port's plan of its stacked group names the same mesh axes on every
    dimension, mamba2's stacked dimension 0 included;
  * cache plans of the reference's four (arch, shape) cells, leaf for
    leaf with the stack dimension removed, which the reference never
    shards;
  * `input_specs` over every (arch x shape): the reference's keys, shapes
    and dtypes, as meta tensors;
  * the dry run (`launch.dryrun.run_cell` over fake process groups of
    256 and 512 ranks): every cell skipped exactly where the reference
    skips it, and its per-device bytes of parameters, optimizer state,
    batch and cache equal to the bytes of the reference's
    PartitionSpecs over a `_FakeMesh` (the full grid is `slow`);
  * the meshes and `to_named`'s placements.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import input_specs as ref_input_specs
from repro.configs import skip_reason as ref_skip_reason
from repro.launch import sharding as ref_shr
from repro.models import Model as RefModel
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import (ARCHS, SHAPES, input_specs, list_archs,
                                 skip_reason)
from repro_torch.launch import sharding as shr
from repro_torch.models import Model

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
PLAN_ARCHS = ["granite-3-2b", "gemma3-27b", "mixtral-8x7b", "mamba2-1.3b",
              "recurrentgemma-2b", "whisper-tiny"]


class _FakeMesh:
    """The reference's mesh stand-in: .shape and .axis_names only."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _ref_plan(tree, specs):
    """{keystr: (shape, dtype name, per-dimension axes)} of a reference
    tree and its PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    out = {}
    for (path, sds), spec in zip(leaves, spec_leaves):
        parts = list(spec) + [None] * (len(sds.shape) - len(spec))
        out[jax.tree_util.keystr(path)] = (
            tuple(sds.shape), str(sds.dtype), tuple(_axes(a) for a in parts))
    return out


def _port_plan(plan):
    return {k: (p.shape, str(p.dtype).split(".")[-1], p.spec)
            for k, p in plan.items()}


_REF_TREES = {}


def _ref_model(arch):
    if arch not in _REF_TREES:
        m = RefModel(REF_ARCHS[arch].replace(vocab_pad_to=256))
        _REF_TREES[arch] = (m, m.param_specs())
    return _REF_TREES[arch]


def _port_model(arch):
    return Model(ARCHS[arch].replace(vocab_pad_to=256), device="meta")


@pytest.mark.parametrize("arch", PLAN_ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("which", ["params", "params_fsdp", "opt"])
def test_param_plans_match_reference(arch, multi_pod, which):
    _, tree = _ref_model(arch)
    fake, sizes = _FakeMesh(MESHES[multi_pod]), MESHES[multi_pod]
    model = _port_model(arch)
    if which == "opt":
        ref = ref_shr.opt_pspecs(tree, fake)
        want = _ref_plan(tree, ref["m"])
        want = {k: (s, "float32", a) for k, (s, _, a) in want.items()}
        got = shr.opt_pspecs(model, sizes)
        assert got["step"].spec == () and ref["step"] == P()
        assert _port_plan(got["v"]) == _port_plan(got["m"])
        got = got["m"]
    else:
        fsdp = which == "params_fsdp"
        want = _ref_plan(tree, ref_shr.param_pspecs(tree, fake, fsdp=fsdp))
        got = shr.param_pspecs(model, sizes, fsdp=fsdp)
    assert _port_plan(got) == want
    if arch == "mamba2-1.3b" and which != "params":
        # FSDP picks the stack dimension: whole layers on the data ranks
        assert got["['slot0']['mixer']['conv_x']['w']"].spec == (
            ("data",), (), ("model",))
        assert got["['slot0']['mixer']['out_norm']"].spec == (
            ("data",), ("model",))


def test_plans_group_exactly_the_stacked_leaves():
    """The plans' groups are `Model.stacked_leaves()`'s: every parameter
    in exactly one, a stacked group's leading size its layer count."""
    for arch in PLAN_ARCHS:
        model = _port_model(arch)
        params = dict(model.named_parameters())
        groups = {}
        for name in params:
            path, _ = shr.reference_path(model.cfg, name)
            groups.setdefault(path, []).append(name)
        assert sorted(map(tuple, groups.values())) == sorted(
            model.stacked_leaves())
        shapes = shr.stacked_shapes(model.cfg, params)
        for path, names in groups.items():
            if shr.reference_path(model.cfg, names[0])[1]:
                assert shapes[path][0] == (len(names),) + tuple(
                    params[names[0]].shape)


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "decode_32k"), ("mixtral-8x7b", "long_500k"),
    ("mamba2-1.3b", "long_500k"), ("whisper-tiny", "decode_32k")])
def test_cache_plans_match_reference(arch, shape):
    sizes = MESHES[False]
    model, _ = _ref_model(arch)
    sp = REF_SHAPES[shape]
    cache = model.cache_specs(sp.global_batch, sp.seq_len)
    want = _ref_plan(cache, ref_shr.cache_pspecs(cache, _FakeMesh(sizes),
                                                 sp.global_batch))
    port = _port_model(arch)
    got = shr.cache_pspecs(port.cache_specs(sp.global_batch, sp.seq_len),
                           sizes, sp.global_batch)
    seen = set()
    for name, p in got.items():
        path, stacked = shr.reference_path(port.cfg, name)
        shape_, dtype, axes = want[path]
        if stacked:
            assert axes[0] == ()          # the stack dimension: never
            shape_, axes = shape_[1:], axes[1:]
        assert (p.shape, str(p.dtype).split(".")[-1], p.spec) == (
            shape_, dtype, axes), name
        seen.add(path)
    # the host-side counters are Python integers in the port
    assert set(want) - seen <= {"['pos']", "['enc_len']"}
    assert "['pos']" in set(want) - seen


def test_input_specs_match_reference():
    for arch in list_archs():
        for sname, sp in SHAPES.items():
            want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[sname])
            got = input_specs(ARCHS[arch], sp)
            assert list(got) == list(want), (arch, sname)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


# -- the dry run ---------------------------------------------------------------

CELLS = [(a, s, mp) for mp in (False, True) for a in list_archs()
         for s in SHAPES]
# tier-1: one cell an arch, the shapes it runs and both meshes in turn
FAST = {(a, [s for s in SHAPES if not skip_reason(a, s)][i % 3], bool(i % 2))
        for i, a in enumerate(list_archs())}


@pytest.fixture(scope="module")
def dry():
    from repro_torch.launch.dryrun import fake_world, run_cell
    out = {}
    for mp in (False, True):
        with fake_world(512 if mp else 256):
            for a, s, m in CELLS:
                if m == mp:
                    out[(a, s, m)] = run_cell(a, s, m)
    return out


def _bytes(plan_tree, sizes):
    """One device's bytes of a `_ref_plan` tree on a mesh of `sizes`."""
    total = 0
    for shape, dtype, axes in plan_tree.values():
        n = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
        for s, ax in zip(shape, axes):
            k = int(np.prod([sizes[a] for a in ax]))
            assert s % k == 0
            n *= s // k
        total += n
    return total


def _ref_bytes(arch, shape, multi_pod):
    """Per-device bytes from the reference's PartitionSpecs: the
    parameters (FSDP by `lower_cell`'s rule), `opt.init`'s state, the
    batch and the cache less its host-side counters."""
    from repro.training import optimizer as ref_opt
    sizes = MESHES[multi_pod]
    fake = _FakeMesh(sizes)
    model, tree = _ref_model(arch)
    cfg, sp = model.cfg, REF_SHAPES[shape]
    fsdp = cfg.param_counts()["total"] * 2 >= 8e9
    batch = ref_input_specs(cfg, sp)
    out = {"params": _bytes(_ref_plan(
        tree, ref_shr.param_pspecs(tree, fake, fsdp=fsdp)), sizes),
           "batch": _bytes(_ref_plan(
               batch, ref_shr.batch_pspecs(batch, fake)), sizes)}
    if sp.kind == "train":
        state = jax.eval_shape(lambda: ref_opt.init(tree))
        spec = ref_shr.opt_pspecs(tree, fake)
        out["opt"] = _bytes(_ref_plan(state, {"m": spec["m"],
                                              "v": spec["v"], "step": P()}),
                            sizes)
    if sp.kind == "decode":
        cache = model.cache_specs(sp.global_batch, sp.seq_len)
        plan = _ref_plan(cache, ref_shr.cache_pspecs(cache, fake,
                                                     sp.global_batch))
        out["cache"] = _bytes({k: v for k, v in plan.items()
                               if k not in ("['pos']", "['enc_len']")},
                              sizes)
    return out


@pytest.mark.parametrize("cell", [
    pytest.param(c, marks=() if c in FAST else pytest.mark.slow,
                 id="-".join(map(str, c)))
    for c in CELLS if not skip_reason(c[0], c[1])])
def test_dryrun_bytes_match_reference(dry, cell):
    arch, shape, multi_pod = cell
    rec = dry[cell]
    assert rec["status"] == "ok" and rec["n_chips"] == (512 if multi_pod
                                                         else 256)
    assert rec["bytes_per_device"] == _ref_bytes(arch, shape, multi_pod)
    # a serving cell of an executed arch runs its step and counts; the
    # others keep the plan and say why
    assert ("flops_per_device" in rec) != ("plan_only" in rec)


def test_dryrun_skips_exactly_the_reference_cells(dry):
    skipped = {c for c, r in dry.items() if r["status"] == "skipped"}
    assert skipped == {c for c in CELLS if ref_skip_reason(c[0], c[1])}
    assert len(skipped) == 14
    assert all(r["status"] == "ok" for c, r in dry.items()
               if c not in skipped)
    for c in skipped:
        assert dry[c]["reason"] == skip_reason(c[0], c[1]) == \
            ref_skip_reason(c[0], c[1])


def test_dryrun_cli_writes_a_cell(tmp_path, monkeypatch):
    import json

    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RUNS", tmp_path)
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--both-meshes"]) == 0
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape",
                        "decode_32k"]) == 0
    rec = json.loads((tmp_path / "mamba2-1.3b__decode_32k__16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["meta"]["mesh"] == MESHES[False]
    assert json.loads((tmp_path / "qwen3-0.6b__long_500k__2x16x16.json")
                      .read_text())["status"] == "skipped"


def test_production_meshes_and_placements():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         make_production_mesh)
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh()
        assert tuple(make_host_mesh().shape) == (512, 1)
        placed = shr.to_named(
            {"x": shr.Placed((64, 32), torch.float32,
                             (("pod", "data"), ("model",)))}, mesh)
        assert placed["x"] == [Shard(0), Shard(0), Shard(1)]
        assert shr.to_named({"y": shr.Placed((3,), torch.float32, ((),))},
                            mesh)["y"] == [Replicate()] * 3
        assert make_mesh((16, 32), ("data", "model")).size() == 512
    assert not dist.is_initialized()
