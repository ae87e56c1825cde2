"""Rank programs of the mesh tests (not a test module): each runs in a
process of its own, spawned by `torch_span_ranks.run_ranks` with one
gloo rank per process on the CPU, and writes what it computed to
``rank{r}.pkl`` in the output directory. Nothing here imports jax or
the reference; the test modules hold the results against it.

Rank r of a (data, model) mesh sits at (r // model, r % model), the
`DeviceMesh` order: ranks 0 and 1 hold data shard 0 on a (2, 2) mesh.
"""
import pickle

from torch_span_ranks import join_group


def _mesh(world, model):
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    if model == 1:
        return make_host_mesh()
    return make_mesh((world // model, model), ("data", "model"))


def _dump(out_dir, rank, out):
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


def _np(t):
    import torch
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rows(x, mesh):
    """This rank's data shard of a (B, ...) array."""
    n, j = mesh.size(0), mesh.get_local_rank("data")
    b = x.shape[0] // n
    return x[j * b:(j + 1) * b]


def moe_ranks(rank, world, init_method, in_path, out_dir):
    """Every case of `in_path` through `moe_layer_sharded` on a (data 2,
    model 2) mesh: the SPMD path (this rank's rows, its d_ff slice), the
    whole batch as a DTensor, and a batch of 3 rows (the fallback); the
    tap's capacity and kept pairs and the all-reduces of each. Also a
    replicated DTensor through `constrain` under the residual rule."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.shardctx import constrain, sharding_rules
    from repro_torch.launch.sharding import residual_spec
    from repro_torch.models import moe
    join_group(rank, world, init_method)
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    mesh = _mesh(world, 2)
    # `constrain` redistributes a DTensor to the rule's placements
    xd = distribute_tensor(torch.arange(24.0).reshape(4, 3, 2), mesh,
                           [Replicate(), Replicate()])
    with sharding_rules(mesh, residual=residual_spec(mesh)):
        xc = constrain(xd, "residual")
    out = {"constrain": (list(xc.placements), _np(xc.to_local()))}
    seen = []
    moe.moe_layer.tap = lambda capacity, kept: seen.append(
        (capacity, kept.numpy().copy()))
    try:
        for name, case in cases.items():
            dt = getattr(torch, case["dtype"])
            x = torch.from_numpy(case["x"]).to(dt)
            p = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                           else dt)
                 for k, v in case["p"].items()}
            res = {}
            with sharding_rules(mesh):
                for how in ("rows", "whole", "fallback"):
                    seen.clear()
                    moe.moe_layer_sharded.all_reduces = 0
                    if how == "rows":
                        xo = _rows(x, mesh)
                        o, aux = moe.moe_layer_sharded(
                            xo, moe.expert_shard(p, mesh), **case["kw"])
                    else:
                        xs = x if how == "whole" else x[:3]
                        xd = distribute_tensor(xs, mesh,
                                               [Replicate(), Replicate()])
                        o, aux = moe.moe_layer_sharded(xd, p, **case["kw"])
                        o = o.full_tensor()
                    res[how] = dict(out=_np(o), aux=float(aux),
                                    taps=list(seen),
                                    all_reduces=(
                                        moe.moe_layer_sharded.all_reduces))
            # the same whole batch laid out by rows, the experts as
            # DTensors split over d_ff as the plan places them
            with sharding_rules(mesh):
                xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
                pd = {k: distribute_tensor(
                    v, mesh, [Replicate(), Replicate() if k == "router"
                              else Shard(moe._FF_DIM[k])])
                      for k, v in p.items()}
                o, aux = moe.moe_layer_sharded(xd, pd, **case["kw"])
                res["dtensor_experts"] = dict(out=_np(o.full_tensor()),
                                              aux=float(aux))
            out[name] = res
    finally:
        moe.moe_layer.tap = None
    _dump(out_dir, rank, out)


def allreduce_ranks(rank, world, init_method, in_path, out_dir, model):
    """`shardmap_allreduce` on a (world // model, model) mesh, for every
    case: the same input on every rank, and rank r's own input."""
    import torch

    from repro_torch.distributed.compression import shardmap_allreduce
    join_group(rank, world, init_method)
    with open(in_path, "rb") as fh:
        cases = pickle.load(fh)
    mesh = _mesh(world, model)
    out = {}
    for name, case in cases.items():
        dt = getattr(torch, case["dtype"])
        for axes in case["axes"]:
            if not set(axes) <= set(mesh.mesh_dim_names):
                continue
            same = shardmap_allreduce(torch.from_numpy(case["same"]).to(dt),
                                      mesh, axes)
            own = shardmap_allreduce(
                torch.from_numpy(case["per_rank"][rank]).to(dt), mesh, axes)
            out[(name, axes)] = dict(same=_np(same), own=_np(own),
                                     dtype=str(same.dtype))
    _dump(out_dir, rank, out)


def model_ranks(rank, world, init_method, in_path, out_dir):
    """The bridged smoke model on a (data 2, model 2) mesh: this rank's
    rows prefilled and decoded greedily, its experts cut to its d_ff
    slice, the residual rule pinned; every step's logits and the MoE
    all-reduces of each forward."""
    import torch

    from repro_torch.distributed.shardctx import sharding_rules
    from repro_torch.launch.sharding import residual_spec
    from repro_torch.models import Model, greedy_sample, moe
    from repro_torch.models.bridge import params_from_jax
    join_group(rank, world, init_method)
    with open(in_path, "rb") as fh:
        case = pickle.load(fh)
    mesh = _mesh(world, 2)
    cfg = case["cfg"]
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(case["params"], cfg))
    moe.shard_experts_(model, mesh)
    tokens = torch.from_numpy(_rows(case["tokens"], mesh))
    logits, reduces = [], []
    with sharding_rules(mesh, residual=residual_spec(mesh)):
        moe.moe_layer_sharded.all_reduces = 0
        lg, cache = model.prefill({"tokens": tokens}, pad_to=case["pad_to"])
        reduces.append(moe.moe_layer_sharded.all_reduces)
        logits.append(lg.numpy())
        for _ in range(case["steps"]):
            moe.moe_layer_sharded.all_reduces = 0
            lg, cache = model.decode(cache, greedy_sample(lg)[:, None])
            reduces.append(moe.moe_layer_sharded.all_reduces)
            logits.append(lg.numpy())
    _dump(out_dir, rank, dict(logits=logits, all_reduces=reduces,
                              up_shape=tuple(model.layers[0].mlp.up.shape)))
