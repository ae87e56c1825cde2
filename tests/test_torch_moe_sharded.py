"""The collectives inside the model, on the CPU: `moe_layer_sharded` and
`shardmap_allreduce` on spawned gloo ranks (`torch_mesh_ranks`) against
the reference's on forced host devices (`torch_mesh_reference`, a
subprocess).

  * `moe_layer_sharded` on 4 ranks, a (data 2, model 2) mesh, against
    the reference's on 4 devices, in float32 and bfloat16: this rank's
    rows with its d_ff slice of the experts, the whole batch as a
    DTensor (plain and DTensor experts), each data shard's kept (token,
    choice) pairs the reference's (capacity from the shard's own token
    count), and 2 all-reduces a call (out over "model", aux over
    "data"); out within 1e-5 of its scale and aux within 1e-6 in
    float32, 5e-2 in bfloat16;
  * its fallbacks: no mesh (`moe_layer` exactly) and a batch of 3 rows,
    which the data axis does not divide (`moe_layer` on the whole batch,
    no all-reduce, as the reference falls back);
  * `constrain` under the residual rule: a replicated DTensor comes
    back split over "data" by rows;
  * `shardmap_allreduce` on 2 ranks (data 2, model 1) and 4 ranks (data
    2, model 2) over ("data",) and ("data", "model"): bitwise the
    reference's on the same input, and bitwise the same arithmetic in
    one process when each rank brings its own input.

Each spawn is bounded as in `test_torch_span_dist.py`.
"""
import pickle

import numpy as np
import pytest
import torch

from torch_mesh_ranks import allreduce_ranks, moe_ranks
from torch_mesh_reference import run_reference
from torch_span_ranks import run_ranks

D, F, E, B, S = 64, 128, 4, 4, 16
MOE_KW = dict(top_k=2, capacity_factor=1.25, act="silu", glu=True)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (5e-2, 5e-2)}
AR_AXES = (("data",), ("data", "model"))


def _moe_cases():
    rng = np.random.default_rng(11)
    p = {"router": rng.normal(size=(D, E)) * 0.5,
         "up": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "gate": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "down": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    p["router"][:, 0] += 0.2       # expert 0 over capacity: pairs drop
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.normal(size=(B, S, D)) + 0.5).astype(np.float32)
    return {dt: dict(dtype=dt, x=x, p=p, kw=MOE_KW)
            for dt in ("float32", "bfloat16")}


def _ar_cases():
    rng = np.random.default_rng(12)
    out = {}
    for dt in ("float32", "bfloat16"):
        same = (rng.normal(size=(3, 257)) * 1e-2).astype(np.float32)
        per_rank = (rng.normal(size=(4, 3, 257))
                    * rng.uniform(1e-3, 1e-1, (4, 1, 1))).astype(np.float32)
        out[dt] = dict(dtype=dt, same=same, per_rank=per_rank, axes=AR_AXES)
    return out


def _load(tmp, world):
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_sharded")
    moe, ar = _moe_cases(), _ar_cases()
    for name, obj in (("moe.pkl", moe), ("ar.pkl", ar)):
        with open(tmp / name, "wb") as fh:
            pickle.dump(obj, fh)
    ref = run_reference({"moe": moe, "allreduce": ar}, 4, tmp)
    (tmp / "m4").mkdir()
    run_ranks(moe_ranks, 4, tmp / "m4", str(tmp / "moe.pkl"),
              str(tmp / "m4"))
    ranks = {}
    for world, model in ((2, 1), (4, 2)):
        d = tmp / f"ar{world}"
        d.mkdir()
        run_ranks(allreduce_ranks, world, d, str(tmp / "ar.pkl"), str(d),
                  model)
        ranks[world] = _load(d, world)
    return dict(ref=ref, moe=_load(tmp / "m4", 4), ar=ranks, moe_in=moe,
                ar_in=ar)


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_match_reference(runs, dtype):
    """This rank's rows and d_ff slice: the rank pair of each data shard
    holds that shard's rows of the reference's output, the same aux, the
    shard's kept pairs, and 2 all-reduces."""
    tol_out, tol_aux = TOL[dtype]
    ref = runs["ref"]["moe"][dtype]
    for rank, res in enumerate(runs["moe"]):
        got = res[dtype]["rows"]
        j = rank // 2
        half = B // 2
        _close(got["out"], ref["whole"]["out"][j * half:(j + 1) * half],
               tol_out)
        assert abs(got["aux"] - ref["whole"]["aux"]) <= tol_aux
        (cap, kept), = got["taps"]
        rcap, rkept = ref["kept"][j]
        assert cap == rcap and np.array_equal(kept, rkept)
        assert (~kept).sum() > 0             # the capacity drops pairs
        assert got["all_reduces"] == 2
    # both "model" ranks of a shard hold the same sum
    for j in range(2):
        a, b = (runs["moe"][2 * j + m][dtype]["rows"]["out"]
                for m in range(2))
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["whole", "dtensor_experts"])
def test_whole_batch_dtensor_matches_reference(runs, dtype, how):
    tol_out, tol_aux = TOL[dtype]
    ref = runs["ref"]["moe"][dtype]["whole"]
    for res in runs["moe"]:
        got = res[dtype][how]
        _close(got["out"], ref["out"], tol_out)
        assert abs(got["aux"] - ref["aux"]) <= tol_aux
        if how == "whole":
            assert got["all_reduces"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_indivisible_batch_falls_back(runs, dtype):
    """3 rows on 2 data ranks: `moe_layer` on the whole batch with the
    whole experts, no all-reduce, the reference's fallback and its kept
    pairs."""
    tol_out, tol_aux = TOL[dtype]
    ref = runs["ref"]["moe"][dtype]
    for res in runs["moe"]:
        got = res[dtype]["fallback"]
        _close(got["out"], ref["fallback"]["out"], tol_out)
        assert abs(got["aux"] - ref["fallback"]["aux"]) <= tol_aux
        assert got["all_reduces"] == 0
        (cap, kept), = got["taps"]
        rcap, rkept = ref["kept_fallback"]
        assert cap == rcap and np.array_equal(kept, rkept)


def test_constrain_redistributes_a_dtensor(runs):
    """Under a mesh and the residual rule, a replicated DTensor comes back
    split over "data" by rows: ranks 0-1 hold rows 0-1, ranks 2-3 rows
    2-3 (plain tensors pass through, `test_torch_mesh_model.py`)."""
    from torch.distributed.tensor import Replicate, Shard
    x = np.arange(24.0, dtype=np.float32).reshape(4, 3, 2)
    for rank, res in enumerate(runs["moe"]):
        placements, local = res["constrain"]
        assert placements == [Shard(0), Replicate()]
        j = rank // 2
        assert np.array_equal(local, x[2 * j:2 * j + 2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_without_a_mesh_is_moe_layer(dtype):
    """No mesh pinned: `moe_layer` bitwise, and the reference's
    `moe_layer_sharded` without a mesh within the zoo's tolerances."""
    import jax.numpy as jnp
    from repro.models.moe import moe_layer_sharded as ref_sharded

    from repro_torch.distributed import shardctx
    from repro_torch.models import moe
    case = _moe_cases()[dtype]
    dt = getattr(torch, dtype)
    x = torch.from_numpy(case["x"]).to(dt)
    p = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else dt)
         for k, v in case["p"].items()}
    shardctx.reset_collectives()
    out, aux = moe.moe_layer_sharded(x, p, **MOE_KW)
    want, want_aux = moe.moe_layer(x, p, **MOE_KW)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    assert shardctx.COLLECTIVES["all_reduce"]["count"] == 0
    jdt = jnp.dtype(dtype)
    r_out, r_aux = ref_sharded(
        jnp.asarray(case["x"]).astype(jdt),
        {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jdt)
         for k, v in case["p"].items()}, **MOE_KW)
    tol_out, tol_aux = TOL[dtype]
    _close(out.float().numpy(), np.asarray(r_out.astype(jnp.float32)),
           tol_out)
    assert abs(float(aux) - float(r_aux)) <= tol_aux


def _one_process(xs, dtype, groups):
    """`shardmap_allreduce`'s arithmetic in one process: every rank's
    scale, the group's MAX, the int8 levels summed as int32, the mean."""
    dt = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(dt) for x in xs]
    out = []
    for g in groups:
        scale = torch.stack([torch.clamp(xs[r].abs().max() / 127.0,
                                         min=1e-12).float()
                             for r in g]).max().to(dt)
        s = sum(torch.clamp(torch.round(xs[r] / scale), -127, 127)
                .to(torch.int8).to(torch.int32) for r in g)
        out.append((s.float() * scale / len(g)).to(dt))
    return out


def _groups(world, model, axes):
    """The rank groups of `axes` on a (world // model, model) mesh."""
    ranks = np.arange(world).reshape(world // model, model)
    if axes == ("data",):
        return [list(ranks[:, m]) for m in range(model)]
    return [list(ranks.reshape(-1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world,model", [(2, 1), (4, 2)])
@pytest.mark.parametrize("axes", AR_AXES)
def test_shardmap_allreduce_is_bitwise(runs, dtype, world, model, axes):
    case = runs["ar_in"][dtype]
    ref, ref_dtype = runs["ref"]["allreduce"][(dtype, (world // model,
                                                       model), axes)]
    groups = _groups(world, model, axes)
    want_own = _one_process(case["per_rank"][:world], dtype, groups)
    for rank, res in enumerate(runs["ar"][world]):
        got = res[(dtype, axes)]
        assert got["dtype"].split(".")[-1] == ref_dtype
        assert np.array_equal(got["same"].view(np.uint32),
                              ref.view(np.uint32))
        g = next(i for i, grp in enumerate(groups) if rank in grp)
        assert np.array_equal(got["own"].view(np.uint32),
                              want_own[g].float().numpy().view(np.uint32))
