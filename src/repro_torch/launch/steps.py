"""Serving steps: prefill then greedy decode.

Port of `repro.launch.steps.make_prefill_step` / `make_decode_step`
(lines 88-99). The reference's steps take the parameter tree as their
first argument for `jax.jit`; the port's `Model` holds its parameters,
so the steps close over it. The prefill step hands its whole batch to
`Model.prefill`: `tokens`, and `frontend_embeds` for a vision model or
`frames` for the encoder-decoder. Training steps wait for the training
slice.
"""
from __future__ import annotations

from ..models.api import Model, greedy_sample


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
