"""The dry run's per-device counts (`launch.dryrun.step_costs`): each
serving cell's step run for rank 0 on meta tensors over a fake process
group.

  * a smoke cell (granite-3-2b's smoke variant, 4 x 64 tokens) on a
    (data 2, model 2) fake world: `flops_per_device` equals the closed
    form from the config and the plan exactly (2 x out x K of every
    projection, the attention's live blocks' two products, K3's two
    products over the cache, the vocabulary share's logits), at prefill
    and at decode, and its collectives equal the plan's count;
  * the smoke cells of granite-3-2b, granite-moe and mamba2 (prefill
    and decode, 4 x 64, (data 2, model 2)) against the reference's own
    dry-run walk (its `lower_cell` on 4 forced host devices, compiled,
    `benchmarks.hlo_cost.analyze`; `torch_mesh_reference`, mode
    ``walk``): `flops_per_device` within 10% (the reference's flash
    loop and the port's live-block count differ on the diagonal blocks:
    0.93-1.05 measured), the same collective kinds, and the same
    all-reduce count where no MoE layer runs (XLA combines the MoE's aux
    all-reduces);
  * every cell of the production meshes: 66 ok, 14 skipped, 0 errors;
    FLOPs, HBM bytes, collectives by kind and peak bytes on exactly the
    36 serving cells of the eight executed archs, the other 30 ok cells
    plan-only with a reason; each of the 36 makes the all-reduces and
    all-gathers its plan implies (`torch_tp_plan.want_collectives`, FSDP
    gathers counted from the plan), with link bytes at the ring factors.
"""
import pytest
import torch

from torch_tp_plan import fsdp_leaves, want_collectives

B, S = 4, 64


def _smoke_costs(kind):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.dryrun import fake_world, step_costs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.config import ShapeSpec
    cfg = smoke_variant(get_config("granite-3-2b"))
    shape = ShapeSpec(f"smoke_{kind}", S, B, kind)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        plan, _, step = lower_cell(cfg, shape, mesh)
        return cfg, step_costs(cfg, shape, plan, step, mesh)


def _closed_form_flops(cfg, kind, d=2, m=2):
    D, H, K, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    V = cfg.replace(vocab_pad_to=256).padded_vocab
    b = B // d
    T = b * S if kind == "prefill" else b
    proj = 2 * T * D * (H * hd // m) + 2 * 2 * T * D * (K * hd // m) \
        + 2 * T * (H * hd // m) * D
    mlp = 3 * 2 * T * D * (F // m)
    if kind == "prefill":
        bq = min(cfg.attn_chunk, S)
        nq = S // bq
        attn = 2 * 2 * b * (H // m) * bq * bq * hd * (nq * (nq + 1) // 2)
    else:
        attn = 2 * 2 * b * (H // m) * S * hd
    return cfg.n_layers * (proj + mlp + attn) + 2 * b * D * (V // m)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_cell_flops_equal_the_closed_form(kind):
    cfg, rec = _smoke_costs(kind)
    assert rec["flops_per_device"] == _closed_form_flops(cfg, kind)
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["peak_bytes_per_device"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_cell_collectives_are_the_plans(kind):
    cfg, rec = _smoke_costs(kind)
    got = {k: v["count"] for k, v in rec["collectives"].items()}
    want = want_collectives(cfg, {"data": 2, "model": 2},
                            decode=(kind == "decode"))
    assert got == {k: v for k, v in want.items() if v}
    for v in rec["collectives"].values():
        assert v["bytes"] > 0


WALK_ARCHS = ("granite-3-2b", "granite-moe-3b-a800m", "mamba2-1.3b")
WALK = [(a, (f"smoke_{k}", S, B, k), (2, 2)) for a in WALK_ARCHS
        for k in ("prefill", "decode")]


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    from torch_mesh_reference import run_reference
    return run_reference({"walk": WALK}, 4,
                         tmp_path_factory.mktemp("walk"))["walk"]


@pytest.mark.parametrize("cell", WALK, ids=[f"{c[0]}-{c[1][3]}"
                                            for c in WALK])
def test_smoke_cell_counts_hold_against_the_reference_walk(walk, cell):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.dryrun import fake_world, step_costs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.config import ShapeSpec
    arch, shape, mesh_shape = cell
    cfg, shape = smoke_variant(get_config(arch)), ShapeSpec(*shape)
    with fake_world(4):
        mesh = make_mesh(mesh_shape, ("data", "model"))
        plan, _, step = lower_cell(cfg, shape, mesh)
        rec = step_costs(cfg, shape, plan, step, mesh)
    ref = walk[cell]
    assert abs(rec["flops_per_device"] / ref["flops"] - 1) <= 0.10
    got = {k.replace("_", "-"): v["count"]
           for k, v in rec["collectives"].items()}
    assert set(got) == {k for k, v in ref["by_kind"].items() if v}
    if cfg.family != "moe":
        assert got["all-reduce"] == ref["by_kind"]["all-reduce"]["count"]


@pytest.fixture(scope="module")
def dry():
    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch.dryrun import fake_world, run_cell
    out = {}
    for mp in (False, True):
        with fake_world(512 if mp else 256):
            for a in list_archs():
                for s in SHAPES:
                    out[(a, s, mp)] = run_cell(a, s, mp)
    return out


EXECUTED = ("granite-3-2b", "qwen3-0.6b", "phi3-mini-3.8b", "gemma3-27b",
            "granite-moe-3b-a800m", "mixtral-8x7b", "phi-3-vision-4.2b",
            "mamba2-1.3b")
COUNTS = ("flops_per_device", "hbm_bytes_per_device", "collectives",
          "collective_link_bytes_per_device", "peak_bytes_per_device")


def test_dryrun_counts_exactly_the_36_serving_cells(dry):
    status = [r["status"] for r in dry.values()]
    assert (status.count("ok"), status.count("skipped"),
            status.count("error")) == (66, 14, 0)
    counted = {c for c, r in dry.items() if "flops_per_device" in r}
    want = {c for c, r in dry.items() if r["status"] == "ok"
            and c[0] in EXECUTED and c[1] != "train_4k"}
    assert counted == want and len(counted) == 36
    for c, r in dry.items():
        if r["status"] != "ok":
            continue
        if c in counted:
            assert all(k in r for k in COUNTS) and "plan_only" not in r
            assert r["flops_per_device"] > 0
            assert r["peak_bytes_per_device"] > sum(
                r["bytes_per_device"].values()) // 2
        else:
            assert r["plan_only"].startswith("plan only") and \
                "ROADMAP queue 1 item 10" in r["plan_only"]
            assert not any(k in r for k in COUNTS)


SERVING = [(a, s, mp) for a in EXECUTED
           for s in ("prefill_32k", "decode_32k", "long_500k")
           for mp in (False, True)
           if s != "long_500k" or a in ("mamba2-1.3b", "mixtral-8x7b")]


@pytest.mark.parametrize("cell", SERVING,
                         ids=["-".join(map(str, c)) for c in SERVING])
def test_serving_cell_collectives_are_the_plans(dry, cell):
    from repro_torch.configs import SHAPES, get_config
    arch, shape, mp = cell
    rec = dry[cell]
    sizes = rec["meta"]["mesh"]
    cfg = get_config(arch)
    want = want_collectives(cfg, sizes, decode=SHAPES[shape].kind ==
                            "decode", fsdp=fsdp_leaves(cfg, sizes,
                                                       rec["meta"]["fsdp"]))
    got = {k: v["count"] for k, v in rec["collectives"].items()}
    assert got == {k: v for k, v in want.items() if v}
    ring = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0}
    for k, v in rec["collectives"].items():
        assert v["link_bytes"] == v["bytes"] * ring[k]
    assert rec["collective_link_bytes_per_device"] == sum(
        v["link_bytes"] for v in rec["collectives"].values())


def test_train_step_refuses_the_collectives_autograd():
    """The collectives have no backward yet: a tensor that requires grad
    is refused under a split mesh (the train step under the plan is
    ROADMAP queue 1 item 10)."""
    from repro_torch.distributed import shardctx
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with shardctx.sharding_rules(mesh):
            x = torch.ones(3, requires_grad=True)
            with pytest.raises(NotImplementedError, match="item 10"):
                shardctx.all_reduce(x * 2, "model")
            shardctx.all_reduce(x.detach(), "model")
