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

`lower_cell(cfg, shape, mesh)` is the reference's plan for one (arch x
shape) cell on a mesh: the placement plans of every tree the cell's
step reads (`launch.sharding`), the reference's `meta` (the FSDP rule,
the residual rule, the mesh and the microbatch count) and, for a
serving cell of the dense, MoE, vision and SSM families, the step that
runs one rank's shard under the plan (`sharded_step`: the counterpart
of the reference's jitted step, eager, on the pieces
`sharding.shard_params` cuts; the dry run runs it on meta tensors).
Train cells and the RG-LRU hybrid's and encoder-decoder's cells keep
the plan only (`plan_only` says why). The reference's `donate` has no
counterpart: the port's train step updates the parameters and its
state in place, and decode writes its caches in place, always.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.registry import input_specs
from ..distributed.compression import compress_decompress
from ..distributed.shardctx import axis_sizes, batch_axes, sharding_rules
from ..models.api import Model
from ..models.model import greedy_tokens
from ..models.config import ModelConfig, ShapeSpec
from ..training import optimizer as opt
from . import sharding as shr


def make_train_step(model: Model, ocfg: opt.AdamWConfig,
                    microbatches: int = 1, grad_compression: bool = False):
    params = dict(model.named_parameters())
    stacked = model.stacked_leaves()

    def train_step(opt_state, batch):
        if grad_compression and "ef" not in opt_state:
            raise ValueError("opt_state must carry 'ef' buffers; "
                             "use init_opt_state(..., compression=True)")
        if microbatches == 1:
            (loss, mets), grads = model.value_and_grad(batch)
        else:
            k = microbatches
            n = next(iter(batch.values())).shape[0] // k
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.items()}
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
            mets = {"ce": loss, "aux": torch.zeros_like(loss)}
        inner = {key: v for key, v in opt_state.items() if key != "ef"}
        if grad_compression:
            grads, ef, cmets = compress_decompress(grads, opt_state["ef"],
                                                   groups=stacked)
            mets = dict(mets, **cmets)
        inner, omets = opt.update(ocfg, grads, inner, params)
        opt_state = dict(inner, ef=ef) if grad_compression else inner
        return opt_state, dict(mets, loss=loss, **omets)
    return train_step


def init_opt_state(model: Model, compression: bool = False):
    """AdamW's state for the model's parameters, plus zero float32 error
    buffers as `ef` with compression."""
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


PLAN_ONLY = {
    "train": "plan only: the train step under the tensor-parallel plan "
             "(f/g autograd for the collectives) is ROADMAP queue 1 item 10",
    "hybrid": "plan only: the RG-LRU's splits (w_in, w_gate_branch, w_i, "
              "w_r, w_out, conv, lam) run in ROADMAP queue 1 item 10",
    "encdec": "plan only: whisper's splits run in ROADMAP queue 1 item 10"}


def plan_only(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Why a cell's step does not run under its plan, or None."""
    if shape.kind == "train":
        return PLAN_ONLY["train"]
    return PLAN_ONLY.get(cfg.family)


def sharded_step(cfg: ModelConfig, shape: ShapeSpec, mesh, rules):
    """The cell's serving step on this rank's shard, under `mesh` and the
    plan's rules: prefill `step(model, batch) -> (tokens, cache)`, decode
    `step(model, cache, tokens) -> (tokens, cache)`, where `model` holds
    this rank's pieces (`sharding.shard_params`) and the batch and cache
    its own (`shard_batch`, `shard_cache`); `step.last["logits"]` is the
    last call's share of the logits."""
    last = {}

    def step(model, *args):
        with sharding_rules(mesh, **rules):
            if shape.kind == "prefill":
                fn = make_prefill_step(model, pad_to=shape.seq_len)
            else:
                fn = make_decode_step(model)
            out = fn(*args)
        last.update(fn.last)
        return out
    step.last = last
    return step


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               fsdp: Optional[bool] = None,
               seq_shard_resid: Optional[bool] = None):
    """(plan, meta, step) of one cell on `mesh` (a `DeviceMesh` or {axis:
    size}), built on the meta device. plan: {"params", "batch",
    "rules"} plus "opt" for a train cell and "cache" for a decode cell,
    each {name: `sharding.Placed`}; meta: the reference's dict; step:
    the serving step that runs this rank's shard under the plan
    (`sharded_step`, the counterpart of the reference's jitted step), or
    None where the cell keeps the plan only (`plan_only`: train cells,
    the RG-LRU hybrid and the encoder-decoder)."""
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
    step = None if plan_only(cfg, shape) else \
        sharded_step(cfg, shape, mesh, plan["rules"])
    return plan, meta, step
