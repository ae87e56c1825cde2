"""Train, prefill and decode steps.

Port of `repro.launch.steps` (lines 22-99). The reference's steps take
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
"""
from __future__ import annotations

import torch

from ..distributed.compression import compress_decompress
from ..models.api import Model, greedy_sample
from ..training import optimizer as opt


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
    def prefill_step(batch):
        logits, cache = model.prefill(batch, pad_to=pad_to)
        return greedy_sample(logits), cache
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache, tokens):
        logits, cache = model.decode(cache, tokens)
        return greedy_sample(logits)[:, None], cache
    return decode_step
