"""Fault-tolerant training loop: the train step, periodic atomic
checkpoints and resume after a crash.

Port of `repro.training.train_loop`. `train` draws the model's weights
anew from `seed`, resumes from the newest checkpoint under
`tcfg.ckpt_dir` when there is one, and saves (parameters, optimizer
state) every `ckpt_every` steps through the port's `CheckpointManager`,
flattened by leaf name (`params/<leaf>`, `opt/m/<leaf>`, `opt/v/<leaf>`,
`opt/ef/<leaf>`, `opt/step`); bfloat16 leaves go through a 16-bit
integer view of the same bits, as `models.bridge` reads them. A run cut
after a checkpoint and resumed, fed the batches the cut run had not yet
consumed, repeats the uncut run's losses and parameters: bitwise on the
CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..distributed.checkpoint import CheckpointManager
from ..launch.steps import init_opt_state, make_train_step
from ..models.api import Model
from . import optimizer as opt
from .data import TokenStream


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 20
    grad_compression: bool = False
    microbatches: int = 1
    ocfg: opt.AdamWConfig = dataclasses.field(
        default_factory=lambda: opt.AdamWConfig(
            lr=1e-3, warmup_steps=20, total_steps=400))


def _leaves(params, opt_state) -> Dict[str, torch.Tensor]:
    """The checkpointed tensors by key."""
    out = {f"params/{k}": p for k, p in params.items()}
    for part in ("m", "v", "ef"):
        out.update({f"opt/{part}/{k}": t
                    for k, t in opt_state.get(part, {}).items()})
    out["opt/step"] = opt_state["step"]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _save(mgr: CheckpointManager, step: int, params, opt_state):
    return mgr.save(step, {k: _to_numpy(t)
                           for k, t in _leaves(params, opt_state).items()})


@torch.no_grad()
def _restore(mgr: CheckpointManager, params, opt_state) -> int:
    """Load the newest checkpoint into `params` and `opt_state` in place;
    returns its step."""
    leaves = _leaves(params, opt_state)
    like = {k: _to_numpy(t.reshape(-1)[:0]) for k, t in leaves.items()}
    flat, step = mgr.restore(like)
    for k, t in leaves.items():
        src = torch.from_numpy(flat[k])
        if t.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)
        t.copy_(src)
    return step


def train(model: Model, data: TokenStream, tcfg: TrainConfig,
          seed: int = 0, log: Callable[[str], None] = print) -> Dict:
    """Returns {"params" (by leaf name), "opt_state", "losses",
    "final_loss", "first_loss"} of the steps this call ran."""
    model.init(seed)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(model, compression=tcfg.grad_compression)
    start_step = 0
    mgr = None
    if tcfg.ckpt_dir:
        mgr = CheckpointManager(tcfg.ckpt_dir)
        if mgr.latest_step() is not None:
            start_step = _restore(mgr, params, opt_state)
            log(f"resumed from checkpoint step {start_step}")
    step_fn = make_train_step(model, tcfg.ocfg,
                              microbatches=tcfg.microbatches,
                              grad_compression=tcfg.grad_compression)
    losses = []
    it = data.batches()
    t0 = time.time()
    for step in range(start_step, tcfg.n_steps):
        opt_state, mets = step_fn(opt_state, next(it))
        losses.append(float(mets["loss"]))
        if step % tcfg.log_every == 0 or step == tcfg.n_steps - 1:
            log(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(mets['grad_norm']):.3f} "
                f"({time.time() - t0:.0f}s)")
        if mgr and (step + 1) % tcfg.ckpt_every == 0:
            _save(mgr, step + 1, params, opt_state)
    return {"params": params, "opt_state": opt_state,
            "losses": np.asarray(losses),
            "final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan")}
