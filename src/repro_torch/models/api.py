"""The Model facade: one module per architecture config.

Port of `repro.models.api` (lines 18-63). `Model` is an `nn.Module`
that holds its parameter tree (the reference passes the tree to every
call instead), built on the card unless the caller asks for the CPU,
and dispatches on `cfg.is_encdec` as the reference's facade does:
`model` for the decoder-only families (dense, MoE, SSM, the RG-LRU
hybrid, the vision-language model), `encdec` for the encoder-decoder.

    model = Model(get_config("qwen2.5-3b"))        # device=None: cuda
    logits, cache = model.prefill({"tokens": tokens}, pad_to=1024)
    logits, cache = model.decode(cache, greedy_sample(logits)[:, None])
    (loss, mets), grads = model.value_and_grad({"tokens": t, "labels": l})

A batch holds `tokens` and, for a vision model, `frontend_embeds`
(B, F, frontend_dim); for the encoder-decoder, `frames` (B, S_enc,
frontend_dim) and the decoder `tokens`; a training batch adds `labels`
and optionally `loss_mask`. The parameters' leaves are named by their
dotted paths in the tree (`flatten_tree`, the state-dict keys); the
optimizer, the gradients and the checkpoints use those names;
`stacked_leaves` groups them as the reference stacks them into one
leaf. The parameters do not require gradients: `value_and_grad` turns that on
for its one call, so the serving path builds no autograd graph.

`param_specs()` and `cache_specs(batch, ctx)` are the reference's
`jax.eval_shape` trees: the same builders run with a generator that
reports the meta device, so every leaf is a meta tensor (shape and
dtype, no storage); `Model(cfg, device="meta")` builds a whole model
that way, which is how the dry run plans the full-width zoo.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.shardctx import all_gather
from . import encdec, model
from .config import ModelConfig


def flatten_tree(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) pairs of a nested dict/list tree: the
    state-dict keys of the `Params` built from it."""
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from flatten_tree(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class Params(nn.Module):
    """A nested dict/list of tensors as modules: `p[name]` reads a leaf
    or a subtree, and the state-dict keys are the tree's dotted paths.
    Parameters do not require gradients (serving). `gathers` {leaf:
    (dim, axis)} names the leaves that hold an FSDP share
    (`launch.sharding.shard_params`): reading one gathers it over the
    axis of the pinned mesh."""

    gathers: Dict[str, Tuple[int, str]] = {}

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(Params(t) for t in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self.gathers:
            dim, axis = self.gathers[name]
            return all_gather(getattr(self, name), axis, dim)
        return getattr(self, name)


def _family(cfg: ModelConfig):
    return encdec if cfg.is_encdec else model


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: the builders draw
    with `device=gen.device`, so under it every draw is a meta tensor and
    the generator's state never moves. The card's and the CPU's draws do
    not pass through here."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class Model(Params):
    """Zoo model of any family. `device=None` means the card (RuntimeError
    without one); weights are drawn from `torch.Generator(device)` seeded
    with `seed`, or carried over with `load_state_dict` (see
    `bridge.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(_family(cfg).init_params(
            cfg, self._generator(dev, seed)))
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        """Where the parameters are: inputs and caches go there too, so
        `.to(...)` moves the whole model."""
        return self.embed.device

    @staticmethod
    def _generator(dev, seed: int) -> torch.Generator:
        if dev.type == "meta":
            return _MetaGenerator()
        return torch.Generator(device=dev).manual_seed(seed)

    def param_specs(self) -> Dict[str, torch.Tensor]:
        """The parameters by leaf name as meta tensors (no allocation)."""
        tree = _family(self.cfg).init_params(self.cfg, _MetaGenerator())
        return dict(flatten_tree(tree))

    def cache_specs(self, batch: int, ctx: int):
        """`init_cache(batch, ctx)`'s tree with meta tensors."""
        return _family(self.cfg).init_cache(self.cfg, batch, ctx,
                                            torch.device("meta"))

    def init(self, seed: int) -> "Model":
        """Draw every parameter anew from `seed`, in place."""
        tree = _family(self.cfg).init_params(
            self.cfg, self._generator(self.device, seed))
        self.load_state_dict(dict(flatten_tree(tree)))
        return self

    def stacked_leaves(self) -> List[Tuple[str, ...]]:
        """The parameter names grouped as the reference stacks them into
        one leaf: pattern slot s's layers over the cycles (`slot{s}`), and
        the encoder's and the decoder's layers (`enc`, `dec`); the
        remainder layers and every other leaf stand alone. A statistic
        the reference takes per leaf (the int8 codec's scale) is taken
        over such a group."""
        cfg, n_pat = self.cfg, len(self.cfg.pattern)
        groups: Dict[object, List[str]] = {}
        for name, _ in self.named_parameters():
            head, _, rest = name.partition(".")
            idx, _, leaf = rest.partition(".")
            if cfg.is_encdec and head in ("enc", "dec"):
                key = (head, leaf)
            elif head == "layers" and int(idx) < cfg.n_cycles * n_pat:
                key = (head, int(idx) % n_pat, leaf)
            else:
                key = name
            groups.setdefault(key, []).append(name)
        return [tuple(g) for g in groups.values()]

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def loss(self, batch: Dict):
        """(ce + 0.01 aux, {"ce", "aux"}) of a training batch, float32
        scalars; the graph reaches the parameters only where they
        require gradients (see `value_and_grad`)."""
        b = {k: self._input(v) for k, v in batch.items()}
        return _family(self.cfg).loss_fn(self, self.cfg, b)

    def value_and_grad(self, batch: Dict):
        """`jax.value_and_grad(model.loss, has_aux=True)`: ((loss, {"ce",
        "aux"}), {leaf name: gradient}), each gradient in its parameter's
        dtype, zeros for a leaf the loss does not reach. Under a pinned
        plan the leaves are this rank's pieces and the batch its rows:
        each gradient is this rank's part of the data-parallel sum, but
        for an FSDP piece, whose gather's backward has summed it over
        "data" already (`launch.steps.make_train_step(..., plan=)` sums
        the rest)."""
        names, leaves = zip(*self.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, mets = self.loss(batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return ((loss.detach(), {k: v.detach() for k, v in mets.items()}),
                dict(zip(names, grads)))

    def prefill(self, batch: Dict, pad_to: int = 0):
        """batch["tokens"]: (B, S) integer, with `frontend_embeds` for a
        vision model or `frames` for the encoder-decoder. Returns (logits
        (B, V) float32, cache sized for max(pad_to, image + text tokens);
        the encoder-decoder's for `dec_max_len` and the frames)."""
        tokens = self._input(batch["tokens"])
        if self.cfg.is_encdec:
            return encdec.prefill(self, self.cfg,
                                  self._input(batch["frames"]), tokens)
        fe = batch.get("frontend_embeds")
        return model.prefill(self, self.cfg, tokens,
                             None if fe is None else self._input(fe),
                             pad_to=pad_to)

    def decode(self, cache, tokens):
        """tokens: (B, 1). Returns (logits (B, V) float32, new cache); the
        given cache's attention tensors are updated in place."""
        return _family(self.cfg).decode_step(self, self.cfg, cache,
                                             self._input(tokens))

    def init_cache(self, batch: int, ctx: int):
        """ctx: the context to size for; the encoder-decoder's `enc_len`."""
        return _family(self.cfg).init_cache(self.cfg, batch, ctx,
                                            self.device)


def greedy_sample(logits) -> torch.Tensor:
    """Temperature-0 decoding (the paper's determinism contract, §4.2)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
