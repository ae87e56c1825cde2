"""AdamW with global-norm clipping and cosine / constant LR schedules.

Port of `repro.training.optimizer`. Trees are flat dicts keyed by leaf
name (`Model.named_parameters()`, the dotted paths of the parameter
tree): the state is {"m": {name: float32}, "v": {name: float32},
"step": int32 scalar}. The update runs leaf by leaf in float32, in the
reference's order of operations, and casts each new parameter back to
its dtype. It writes the parameters, `m` and `v` in place: the port's
`Model` holds its parameters, and a second copy of every leaf would
cost 5 GB at granite-3-2b's width (the float32 temporaries of one leaf
are all that is added).

Weight decay skips the leaves whose name holds one of `_NO_DECAY`, the
reference's substrings, which select the same leaves under the port's
names. `global_norm` sums each leaf's squares and then adds the leaves
in the port's order, one layer at a time, where the reference adds a
pattern slot stacked over every cycle as one leaf: the norm, the clip
scale and the update agree with the reference's to a tolerance, not
bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..distributed.shardctx import piece_sum


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"      # cosine | constant


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), float32: linear
    warm-up, then cosine down to `min_lr_frac` of `lr` (or constant)."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Mapping[str, torch.Tensor],
                split: Optional[Mapping[str, Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, float32. With `split`
    {name: the mesh axes the leaf is cut over} the leaves are this
    rank's pieces: each leaf's squares are summed over the axes it is
    split on, and a replicated leaf is counted once
    (`shardctx.piece_sum`)."""
    return torch.sqrt(piece_sum([(g.float().square().sum(),
                                  () if split is None else split[k])
                                 for k, g in tree.items()]))


def init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Zero moments shaped like the parameters, step 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_NO_DECAY = ("norm", "scale", "bias", "lam", "A_log", "dt_bias", "D_skip",
             "positions", "pos_dec")


def decay_mask(name: str) -> bool:
    """Whether weight decay applies to the leaf `name`."""
    return not any(t in name for t in _NO_DECAY)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: Dict,
           params: Mapping[str, torch.Tensor],
           split: Optional[Mapping[str, Tuple[str, ...]]] = None
           ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One AdamW step: writes `params` and the state's `m` and `v` in
    place and returns (the state with step + 1, {"grad_norm", "lr"}).
    With `split` the trees are a rank's pieces under the ZeRO plan (the
    moments' pieces, the gradient and the parameter cut alike), and the
    global norm is taken over the pieces (`global_norm`)."""
    step = state["step"]
    gnorm = global_norm(grads, split)
    scale = (torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
             if cfg.clip_norm > 0 else torch.ones_like(gnorm))
    lr = schedule_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** (step.float() + 1.0)
    b2c = 1.0 - cfg.b2 ** (step.float() + 1.0)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and decay_mask(name):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return (dict(state, step=step + 1),
            {"grad_norm": gnorm, "lr": lr})
