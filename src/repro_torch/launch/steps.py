"""Train, prefill and decode steps, and each cell's placement plan.

Port of `repro.launch.steps`. The reference's steps take
the parameter tree as their first argument for `jax.jit`; the port's
`Model` holds its parameters, so the steps close over it and the train
step updates them in place.

`make_train_step(model, ocfg, microbatches=k, grad_compression=...)`
returns `train_step(opt_state, batch) -> (opt_state, metrics)`. With
k > 1 the batch's leading axis is cut into k consecutive microbatches,
their gradients summed in float32 and divided by k; the loss is the mean
of the microbatch losses and `aux` is reported as 0, as in the
reference. With compression the gradients pass through the int8
error-feedback codec before the update, one scale for each of the
reference's stacked leaves (`Model.stacked_leaves`), and the state
carries the error buffers as `ef` (`init_opt_state(model,
compression=True)`).

With `plan=` and `mesh=` the same step runs one rank's share under a
cell's plan (`_ZeroStep`: the collectives' backward, the data ranks'
gradients summed into the ZeRO moments' pieces, the parameters gathered
back).

`lower_cell(cfg, shape, mesh)` is the reference's plan for one (arch x
shape) cell on a mesh: the placement plans of every tree the cell's
step reads (`launch.sharding`), the reference's `meta` (the FSDP rule,
the residual rule, the mesh and the microbatch count) and the step that
runs one rank's shard under the plan, for every family and every kind
of cell (`sharded_step`: the counterpart of the reference's jitted
step, eager, on the pieces `sharding.shard_params` and
`shard_opt_state` cut; the dry run runs it on meta tensors). The
reference's `donate` has no counterpart: the port's train step updates
the parameters and its state in place, and decode writes its caches in
place, always.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.registry import input_specs
from ..distributed.compression import compress_decompress
from ..distributed.shardctx import all_gather, all_reduce, axis_rank, \
    axis_size, axis_sizes, batch_axes, data_axes, reduce_scatter, \
    sharding_rules
from ..models.api import Model
from ..models.model import greedy_tokens
from ..models.config import ModelConfig, ShapeSpec
from ..training import optimizer as opt
from . import sharding as shr


def make_train_step(model: Model, ocfg: opt.AdamWConfig,
                    microbatches: int = 1, grad_compression: bool = False,
                    plan=None, mesh=None):
    """`train_step(opt_state, batch) -> (opt_state, metrics)`. With
    `plan` (`lower_cell`'s) and `mesh` it runs one rank's share of the
    step under the plan (`_ZeroStep`): `model` holds the rank's pieces
    (`sharding.shard_params`), the batch its rows (`shard_batch`) and the
    state its ZeRO pieces (`init_opt_state(..., plan=, mesh=)` or
    `sharding.shard_opt_state`)."""
    if plan is not None:
        return _ZeroStep(model, ocfg, microbatches, grad_compression, plan,
                         mesh)
    params = dict(model.named_parameters())
    stacked = model.stacked_leaves()

    def train_step(opt_state, batch):
        _check_ef(opt_state, grad_compression)
        (loss, mets), grads = _grads(model, batch, microbatches)
        inner = {key: v for key, v in opt_state.items() if key != "ef"}
        if grad_compression:
            grads, ef, cmets = compress_decompress(grads, opt_state["ef"],
                                                   groups=stacked)
            mets = dict(mets, **cmets)
        inner, omets = opt.update(ocfg, grads, inner, params)
        opt_state = dict(inner, ef=ef) if grad_compression else inner
        return opt_state, dict(mets, loss=loss, **omets)
    return train_step


def _check_ef(opt_state, grad_compression: bool):
    if grad_compression and "ef" not in opt_state:
        raise ValueError("opt_state must carry 'ef' buffers; "
                         "use init_opt_state(..., compression=True)")


def _grads(model: Model, batch, microbatches: int):
    """((loss, metrics), {leaf: gradient}) of the batch, or, with k > 1
    microbatches (the batch's leading axis cut into k consecutive
    pieces), their gradients summed in float32 and divided by k, the
    loss the mean of the microbatch losses and `aux` reported as 0, as
    in the reference."""
    if microbatches == 1:
        return model.value_and_grad(batch)
    k = microbatches
    n = next(iter(batch.values())).shape[0] // k
    grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
             for name, p in model.named_parameters()}
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(k):
        (l, _), g = model.value_and_grad(
            {key: v[i * n:(i + 1) * n] for key, v in batch.items()})
        for name, gi in g.items():
            grads[name].add_(gi)
        lsum = lsum + l
        del g
    for gsum in grads.values():
        gsum.div_(k)
    loss = lsum / k
    return (loss, {"ce": loss, "aux": torch.zeros_like(loss)}), grads


class _ZeroStep:
    """One rank's train step under a cell's plan. Autograd runs the
    tensor-parallel model code on the rank's pieces and rows, the
    collectives carrying their backward (`distributed.shardctx`); the
    loss is the global token mean (`layers.chunked_ce_loss`), so the data
    ranks' gradients are summed. Then, per stacked group (the
    reference's leaf, `sharding.stacked_groups`):

      * the gradient is stacked as that leaf and summed over each data
        axis it is not FSDP-split on (an FSDP piece's gradient arrives
        summed over "data" from its gather's backward): reduce-scattered
        where the ZeRO plan (`opt_pspecs`) splits the moments on that
        axis, which leaves the rank the moments' piece, all-reduced
        otherwise;
      * with compression, the int8 codec runs on those pieces (one scale
        per leaf, the max over its pieces);
      * AdamW updates the moments' pieces and the parameter cut alike,
        the global norm taken over the pieces;
      * the parameter's new piece is all-gathered over the axes ZeRO
        added and written back into the rank's parameters.

    The microbatches cut the rank's rows into k consecutive pieces
    (`_grads`)."""

    def __init__(self, model, ocfg, microbatches, grad_compression, plan,
                 mesh):
        self.model, self.ocfg, self.mesh = model, ocfg, mesh
        self.k, self.compression = microbatches, grad_compression
        self.rules = dict(plan["rules"], batch=plan["batch"]["tokens"].spec)
        params = dict(model.named_parameters())
        self.groups = {}
        for path, (names, st) in shr.stacked_groups(model.cfg,
                                                    params).items():
            pspec, ospec = plan["params"][path].spec, \
                plan["opt"]["m"][path].spec
            extra = tuple(tuple(a for a in o if a not in p)
                          for p, o in zip(pspec, ospec))
            self.groups[path] = (names, st, pspec, ospec, extra)
        self.split = {path: tuple(a for axes in g[3] for a in axes)
                      for path, g in self.groups.items()}

    def __call__(self, opt_state, batch):
        return self.apply(opt_state, *self.grads(batch))

    def grads(self, batch):
        """((loss, metrics), {leaf: this rank's gradient}) of its rows,
        before the data ranks' sum (`_grads` under the plan)."""
        with sharding_rules(self.mesh, **self.rules):
            return _grads(self.model, batch, self.k)

    def apply(self, opt_state, value, grads):
        """The rest of the step, on the gradients of `grads` and the
        loss and metrics `value`."""
        _check_ef(opt_state, self.compression)
        loss, mets = value
        with sharding_rules(self.mesh, **self.rules):
            grads = self._data_sum(grads)
            inner = {key: v for key, v in opt_state.items() if key != "ef"}
            if self.compression:
                grads, ef, cmets = compress_decompress(
                    grads, opt_state["ef"], split=self.split)
                mets = dict(mets, **cmets)
            params = dict(self.model.named_parameters())
            pieces = {path: self._cut(shr.stack_group(params, g[0], g[1]),
                                      g[4])
                      for path, g in self.groups.items()}
            inner, omets = opt.update(self.ocfg, grads, inner, pieces,
                                      self.split)
            self._write_back(pieces, params)
        opt_state = dict(inner, ef=ef) if self.compression else inner
        return opt_state, dict(mets, loss=loss, **omets)

    def _data_sum(self, grads):
        out = {}
        for path, (names, st, pspec, ospec, _) in self.groups.items():
            g = shr.stack_group(grads, names, st).float()
            for a in data_axes():
                if any(a in axes for axes in pspec):
                    continue
                d = next((i for i, axes in enumerate(ospec) if a in axes),
                         None)
                g = all_reduce(g, a) if d is None else \
                    reduce_scatter(g, a, d)
            for n in names:              # the stacked copy holds them now
                grads[n] = None
            out[path] = g
        return out

    @staticmethod
    def _cut(t, extra):
        """This rank's share of `t` on the dimensions ZeRO adds axes to."""
        for d, axes in enumerate(extra):
            n, i = 1, 0
            for a in axes:
                n, i = n * axis_size(a), i * axis_size(a) + axis_rank(a)
            if n > 1:
                t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
        return t.clone()

    @torch.no_grad()
    def _write_back(self, pieces, params):
        for path, (names, st, _, _, extra) in self.groups.items():
            t = pieces[path]
            for d, axes in enumerate(extra):
                for a in reversed(axes):
                    t = all_gather(t, a, d)
            for n, layer in zip(names, t.unbind(0) if st else (t,)):
                params[n].copy_(layer)


def init_opt_state(model: Model, compression: bool = False, plan=None,
                   mesh=None):
    """AdamW's state for the model's parameters, plus zero float32 error
    buffers as `ef` with compression. With `plan` and `mesh` a rank's
    ZeRO pieces under `plan["opt"]` (`sharding.init_opt_pieces`)."""
    if plan is not None:
        return shr.init_opt_pieces(plan["opt"], mesh, model.device,
                                   compression)
    params = dict(model.named_parameters())
    state = opt.init(params)
    if compression:
        state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}
    return state


def make_prefill_step(model: Model, pad_to: int = 0):
    """`prefill_step(batch) -> (tokens (B,), cache)`; the logits of its
    last call stay in `prefill_step.last["logits"]` (this rank's
    vocabulary share under a tensor-parallel plan). A holder, not an
    attribute the function sets on itself: that would make a reference
    cycle through the closure, and the model would outlive the step
    until the garbage collector ran."""
    last = {}

    def prefill_step(batch):
        logits, cache = model.prefill(batch, pad_to=pad_to)
        last["logits"] = logits
        return greedy_tokens(logits, model.cfg), cache
    prefill_step.last = last
    return prefill_step


def make_decode_step(model: Model):
    """`decode_step(cache, tokens) -> (tokens (B, 1), cache)`; the logits
    of its last call stay in `decode_step.last["logits"]`."""
    last = {}

    def decode_step(cache, tokens):
        logits, cache = model.decode(cache, tokens)
        last["logits"] = logits
        return greedy_tokens(logits, model.cfg)[:, None], cache
    decode_step.last = last
    return decode_step


def sharded_step(cfg: ModelConfig, shape: ShapeSpec, mesh, plan,
                 meta=None):
    """The cell's step on this rank's shard, under `mesh` and the plan:
    train `step(model, opt_state, batch) -> (opt_state, metrics)` (AdamW
    at its defaults, `meta["microbatches"]`, `make_train_step` under the
    plan), prefill `step(model, batch) -> (tokens, cache)` (the
    encoder-decoder's batch holds `frames` and `tokens`), decode
    `step(model, cache, tokens) -> (tokens, cache)`, where `model` holds
    this rank's pieces (`sharding.shard_params`), the batch and cache its
    own (`shard_batch`, `shard_cache`) and the optimizer state its ZeRO
    pieces (`init_opt_state(..., plan=, mesh=)`); `step.last["logits"]`
    is a serving call's share of the logits."""
    last = {}
    rules = plan["rules"]
    k = (meta or {}).get("microbatches", 1)

    def step(model, *args):
        if shape.kind == "train":
            return make_train_step(model, opt.AdamWConfig(), k, plan=plan,
                                   mesh=mesh)(*args)
        with sharding_rules(mesh, **rules):
            if shape.kind == "prefill":
                fn = make_prefill_step(model, pad_to=shape.seq_len)
            else:
                fn = make_decode_step(model)
            out = fn(*args)
        last.update(fn.last)
        return out
    step.last = last
    step.microbatches = k
    return step


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               fsdp: Optional[bool] = None,
               seq_shard_resid: Optional[bool] = None):
    """(plan, meta, step) of one cell on `mesh` (a `DeviceMesh` or {axis:
    size}), built on the meta device. plan: {"params", "batch",
    "rules"} plus "opt" for a train cell and "cache" for a decode cell,
    each {name: `sharding.Placed`}; meta: the reference's dict; step:
    the step that runs this rank's shard under the plan (`sharded_step`,
    the counterpart of the reference's jitted step)."""
    cfg = cfg.replace(vocab_pad_to=256)
    model = Model(cfg, device="meta")
    big = cfg.param_counts()["total"] * 2 >= 8e9       # >= 8 GB of bf16
    fsdp = big if fsdp is None else fsdp
    # the residual stays replicated over "model" unless asked: a
    # sequence-parallel residual reshards inside the attention loops
    seq_shard_resid = bool(seq_shard_resid)
    sizes = axis_sizes(mesh)
    meta = {"arch": cfg.name, "shape": shape.name, "fsdp": fsdp,
            "seq_shard_resid": seq_shard_resid, "mesh": sizes}
    plan = {"params": shr.param_pspecs(model, mesh, fsdp=fsdp),
            "batch": shr.batch_pspecs(input_specs(cfg, shape), mesh),
            "rules": {"residual": shr.residual_spec(mesh, seq_shard_resid)}}
    if shape.kind == "train":
        plan["opt"] = shr.opt_pspecs(model, mesh)
        # microbatches: bound the per-device float32 saved residuals
        # (n_cycles x B / dp x S x D x 4 bytes); MoE under FSDP gets a
        # larger budget, since each microbatch gathers the experts again
        dp = 1
        for a in batch_axes(mesh):
            dp *= sizes[a]
        B = shape.global_batch
        resid = 4.0 * cfg.n_cycles * (B / dp) * shape.seq_len * cfg.d_model
        target = 8e9 if (fsdp and cfg.family == "moe") else 2e9
        k = 1
        while resid / k > target and k < max(B // dp, 1):
            k *= 2
        meta["microbatches"] = k
    elif shape.kind == "decode":
        plan["cache"] = shr.cache_pspecs(
            model.cache_specs(shape.global_batch, shape.seq_len), mesh,
            shape.global_batch)
    return plan, meta, sharded_step(cfg, shape, mesh, plan, meta)
