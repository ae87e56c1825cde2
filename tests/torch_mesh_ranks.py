"""Rank programs of the mesh tests (not a test module): each runs in a
process of its own, spawned by `torch_span_ranks.run_ranks` with one
gloo rank per process on the CPU, and writes what it computed to
``rank{r}.pkl`` in the output directory. Nothing here imports jax or
the reference; the test modules hold the results against it.

Rank r of a (data, model) mesh sits at (r // model, r % model), the
`DeviceMesh` order: ranks 0 and 1 hold data shard 0 on a (2, 2) mesh.
"""
import pickle

from torch_span_ranks import rank_group


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

    from repro_torch.distributed import shardctx
    from repro_torch.distributed.shardctx import constrain, sharding_rules
    from repro_torch.launch.sharding import local_piece, residual_spec
    from repro_torch.models import moe
    with rank_group(rank, world, init_method):
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
                # this rank's d_ff slices, as the plan places the experts
                pieces = {k: local_piece(
                    v, tuple(("model",) if d == moe._FF_DIM.get(k) else ()
                             for d in range(v.dim())), mesh, rank)
                    for k, v in p.items()}
                res = {}
                with sharding_rules(mesh):
                    for how in ("rows", "whole", "fallback"):
                        seen.clear()
                        shardctx.reset_collectives()
                        if how == "rows":
                            xo = _rows(x, mesh)
                            o, aux = moe.moe_layer_sharded(
                                xo, pieces, **case["kw"])
                        else:
                            xs = x if how == "whole" else x[:3]
                            xd = distribute_tensor(xs, mesh,
                                                   [Replicate(), Replicate()])
                            o, aux = moe.moe_layer_sharded(xd, p, **case["kw"])
                            o = o.full_tensor()
                        res[how] = dict(out=_np(o), aux=float(aux),
                                        taps=list(seen),
                                        all_reduces=shardctx.COLLECTIVES[
                                            "all_reduce"]["count"])
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
    with rank_group(rank, world, init_method):
        with open(in_path, "rb") as fh:
            cases = pickle.load(fh)
        mesh = _mesh(world, model)
        out = {}
        for name, case in cases.items():
            dt = getattr(torch, case["dtype"])
            for axes in case["axes"]:
                if not set(axes) <= set(mesh.mesh_dim_names):
                    continue
                same = shardmap_allreduce(
                    torch.from_numpy(case["same"]).to(dt), mesh, axes)
                own = shardmap_allreduce(
                    torch.from_numpy(case["per_rank"][rank]).to(dt), mesh,
                    axes)
                out[(name, axes)] = dict(same=_np(same), own=_np(own),
                                         dtype=str(same.dtype))
        _dump(out_dir, rank, out)


def model_ranks(rank, world, init_method, in_path, out_dir):
    """The bridged smoke model on a (data 2, model 2) mesh through
    `lower_cell`'s prefill and decode steps on this rank's pieces
    (`tp_serve`: its rows, the attention's heads and the vocabulary
    split over "model", the experts' d_ff too), and the all-reduces of
    each forward's MoE layers, read off `shardctx.COLLECTIVES` around
    every `moe_layer_sharded` call."""
    from repro_torch.distributed import shardctx
    from repro_torch.models import blocks
    with rank_group(rank, world, init_method):
        with open(in_path, "rb") as fh:
            case = pickle.load(fh)
        mesh = _mesh(world, 2)
        calls, inner = [], blocks.moe_layer_sharded

        def counted(*args, **kw):
            before = shardctx.COLLECTIVES["all_reduce"]["count"]
            out = inner(*args, **kw)
            calls.append(shardctx.COLLECTIVES["all_reduce"]["count"]
                         - before)
            return out
        blocks.moe_layer_sharded = counted
        try:
            out = tp_serve(case, mesh, rank)
        finally:
            blocks.moe_layer_sharded = inner
        n = sum(b.mlp == "moe" for b in case["cfg"].layer_types)
        out["all_reduces"] = [sum(calls[i:i + n])
                              for i in range(0, len(calls), n)]
        _dump(out_dir, rank, out)


def _collective_counts():
    from repro_torch.distributed import shardctx
    return {k: v["count"] for k, v in shardctx.COLLECTIVES.items()}


def _local_shape(placed, mesh):
    """The shape one rank holds of a planned tensor."""
    from repro_torch.distributed.shardctx import axis_sizes
    sizes, shape = axis_sizes(mesh), list(placed.shape)
    for d, axes in enumerate(placed.spec):
        for a in axes:
            shape[d] //= sizes[a]
    return tuple(shape)


def tp_serve(case, mesh, rank):
    """One case through `lower_cell`'s prefill and decode steps on
    `mesh` (with the case's `fsdp`, the plan's FSDP rule forced on or
    off): the bridged one-process model cut to this rank's pieces, its
    rows; per step this rank's share of the logits, the tokens and the
    collectives by kind; the cache's shapes beside the plan's."""
    import torch

    from repro_torch.distributed import shardctx
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models import Model
    from repro_torch.models.api import flatten_tree
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.models.config import ShapeSpec
    cfg = case["cfg"]
    B = case["batch"]["tokens"].shape[0]
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(case["params"], cfg))
    fsdp = case.get("fsdp")
    plan, _, step = lower_cell(
        cfg, ShapeSpec("tp_prefill", case["pad_to"], B, "prefill"), mesh,
        fsdp=fsdp)
    dplan, _, dstep = lower_cell(
        cfg, ShapeSpec("tp_decode", case["pad_to"], B, "decode"), mesh,
        fsdp=fsdp)
    shr.shard_params(model, plan["params"], mesh, rank)
    batch = shr.shard_batch({k: torch.from_numpy(v)
                             for k, v in case["batch"].items()},
                            plan["batch"], mesh, rank)
    res = dict(logits=[], tokens=[], collectives=[])

    def record(tok, logits):
        res["tokens"].append(tok.numpy().reshape(-1))
        res["logits"].append(logits.numpy())
        res["collectives"].append(_collective_counts())
        shardctx.reset_collectives()
    shardctx.reset_collectives()
    tok, cache = step(model, batch)
    record(tok, step.last["logits"])
    res["cache_shapes"] = {k: tuple(t.shape) for k, t in flatten_tree(cache)
                           if isinstance(t, torch.Tensor)}
    res["plan_cache_shapes"] = {k: _local_shape(p, mesh)
                                for k, p in dplan["cache"].items()}
    tok = tok[:, None]
    for _ in range(case["steps"]):
        tok, cache = dstep(model, cache, tok)
        record(tok, dstep.last["logits"])
    res["local_shapes"] = {k: tuple(p.shape)
                           for k, p in model.named_parameters()
                           if k.startswith("layers.0.")}
    res["gathered"] = sorted(f"{n}.{leaf}" if n else leaf
                             for n, mod in model.named_modules()
                             for leaf in getattr(mod, "gathers", {}))
    return res


def tp_ranks(rank, world, init_method, in_path, out_dir):
    """Every case of `in_path` ({name: dict(cfg, params, batch, pad_to,
    steps, meshes)}) through `tp_serve` on each of its (data, model)
    meshes over the ranks; where a case sets `drop_norm_sum`, once more
    with the SSD gated norm's all-reduce left out (its tokens only)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks
    with rank_group(rank, world, init_method):
        with open(in_path, "rb") as fh:
            cases = pickle.load(fh)
        meshes, out = {}, {}
        for name, case in cases.items():
            for shape in case["meshes"]:
                if shape not in meshes:
                    meshes[shape] = make_mesh(shape, ("data", "model"))
                out[(name, shape)] = tp_serve(case, meshes[shape], rank)
                if case.get("drop_norm_sum") and shape[1] > 1:
                    keep = blocks._norm_sum
                    blocks._norm_sum = lambda t: t
                    try:
                        out[(name, shape, "no_norm_sum")] = tp_serve(
                            case, meshes[shape], rank)["tokens"]
                    finally:
                        blocks._norm_sum = keep
        out["collectives_api"] = _collectives_api(rank, meshes[(2, 2)])
        _dump(out_dir, rank, out)


def _collectives_api(rank, mesh):
    """`shardctx`'s counted collectives on known inputs under a (data 2,
    model 2) mesh: their results and the counts by kind."""
    import copy

    import torch

    from repro_torch.distributed import shardctx
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    with shardctx.sharding_rules(mesh):
        shardctx.reset_collectives()
        got = dict(
            sum=shardctx.all_reduce(x.clone(), "model").numpy(),
            max=shardctx.all_reduce(x.clone(), "data", op="max").numpy(),
            gather=shardctx.all_gather(x, "model", dim=1).numpy(),
            scatter=shardctx.reduce_scatter(
                torch.arange(8.0).reshape(2, 4) * (rank + 1), "model",
                dim=1).numpy())
        got["counts"] = copy.deepcopy(shardctx.COLLECTIVES)
    return got


def tp_train(case, mesh, rank):
    """One case's train step through `lower_cell`'s plan on `mesh`: the
    bridged one-process model cut to this rank's pieces, its rows, its
    ZeRO optimizer pieces (the case's `state0` moments, a reference
    tree, cut by `shard_opt_state`); then the step (`make_train_step(...,
    plan=, mesh=)`) with the case's AdamW config, microbatches and
    compression, in its two halves: the gradients of this rank's pieces
    before the data ranks' sum (and the collectives so far), then the
    rest: the metrics, the moments' pieces by reference path, the
    parameters' pieces and the collectives of the whole step by kind."""
    import torch

    from repro_torch.distributed import shardctx
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.steps import init_opt_state, lower_cell, \
        make_train_step
    from repro_torch.models import Model
    from repro_torch.models.bridge import opt_state_from_jax, \
        params_from_jax
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training.optimizer import AdamWConfig
    cfg = case["cfg"]
    B, S = case["batch"]["labels"].shape
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(case["params"], cfg)
                          if case.get("params") is not None else
                          {k: torch.from_numpy(v)
                           for k, v in case["state_dict"].items()})
    plan, meta, _ = lower_cell(cfg, ShapeSpec("tp_train", S, B, "train"),
                               mesh, fsdp=case.get("fsdp"))
    shr.shard_params(model, plan["params"], mesh, rank)
    whole = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    batch = shr.shard_batch(whole, shr.batch_pspecs(whole, mesh), mesh,
                            rank)
    comp = case.get("compression", False)
    state = init_opt_state(model, comp, plan=plan, mesh=mesh)
    if case.get("state0") is not None:      # the moments carried over
        full = opt_state_from_jax(dict(case["state0"], step=0), cfg)
        state = dict(state, **shr.shard_opt_state(full, plan["opt"], mesh,
                                                  rank, cfg))
    step = make_train_step(model, AdamWConfig(**case["ocfg"]),
                           microbatches=case.get("microbatches", 1),
                           grad_compression=comp, plan=plan, mesh=mesh)
    res = {}
    shardctx.reset_collectives()
    value, grads = step.grads(batch)
    res["grad_collectives"] = _collective_counts()
    res["grads"] = {k: _np(g).copy() for k, g in grads.items()}
    state, mets = step.apply(state, value, grads)
    res["collectives"] = _collective_counts()
    res["mets"] = {k: float(v) for k, v in mets.items()}
    res["m"] = {k: _np(v) for k, v in state["m"].items()}
    res["v"] = {k: _np(v) for k, v in state["v"].items()}
    res["params"] = {k: _np(p) for k, p in model.named_parameters()}
    res["meta"] = meta
    return res


def train_ranks(rank, world, init_method, in_path, out_dir):
    """Every case of `in_path` ({name: dict(cfg, params, batch, ocfg,
    meshes[, fsdp, microbatches, compression])}) through `tp_train` on
    each of its (data, model) meshes; also each backward rule of
    `shardctx` on known inputs (`_backward_rules`)."""
    from repro_torch.launch.mesh import make_mesh
    with rank_group(rank, world, init_method):
        with open(in_path, "rb") as fh:
            cases = pickle.load(fh)
        meshes, out = {}, {}
        for name, case in cases.items():
            for shape in case["meshes"]:
                if shape not in meshes:
                    meshes[shape] = make_mesh(shape, ("data", "model"))
                out[(name, shape)] = tp_train(case, meshes[shape], rank)
        out["rules"] = _backward_rules(rank, meshes[(2, 2)])
        _dump(out_dir, rank, out)


def _backward_rules(rank, mesh):
    """Each collective's backward on a (data 2, model 2) mesh: the
    gradient of sum(w * f(x)) with rank-dependent x and w, for f the
    all-reduce, `copy_to`, the all-gather with each rule, and the
    reduce-scatter; with the counts of the backward by kind."""
    import torch

    from repro_torch.distributed import shardctx
    out = {}
    with shardctx.sharding_rules(mesh):
        for name in ("all_reduce", "copy_to", "gather_scatter",
                     "gather_slice", "reduce_scatter", "all_reduce_max"):
            x = (torch.arange(4.0) + 10 * rank).requires_grad_()
            w = torch.arange(8.0 if name.startswith("gather") else 4.0) \
                + rank
            if name == "reduce_scatter":
                w = w[:2]
            f = {"all_reduce": lambda t: shardctx.all_reduce(t, "model"),
                 "copy_to": lambda t: shardctx.copy_to(t, "model"),
                 "gather_scatter": lambda t: shardctx.all_gather(
                     t, "model", 0, grad="scatter"),
                 "gather_slice": lambda t: shardctx.all_gather(
                     t, "model", 0, grad="slice"),
                 "reduce_scatter": lambda t: shardctx.reduce_scatter(
                     t, "model", 0),
                 "all_reduce_max": lambda t: shardctx.all_reduce(
                     t * 1.0, "model", op="max")}[name]
            y = f(x * 1.0)
            shardctx.reset_collectives()
            if y.requires_grad:
                (g,) = torch.autograd.grad((w * y).sum(), x)
                g = g.numpy()
            else:
                g = None
            out[name] = dict(y=y.detach().numpy(), grad=g,
                             counts=_collective_counts())
    return out
