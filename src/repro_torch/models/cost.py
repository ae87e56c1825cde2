"""FLOP and HBM-byte counts of one step run on meta tensors (the dry run).

`Counter` is a dispatch mode: inside it every matrix product (`mm`,
`bmm`, `addmm`, `baddbmm`, einsum's included, since einsum reaches them)
adds 2 x output elements x K FLOPs and reads its operands once and
writes its result once. The fused calls whose loops do not run on meta
tensors (flash attention, kernel K3's decode attention, kernel K4's
scan) report their own counts from their shapes through `fused`. This
is the model of the reference's dry-run walk (`benchmarks/hlo_cost.py`:
2 x out x K for every dot, a fusion or dot reads its operands and writes
its result); elementwise work outside those calls is not counted. The
collectives count their bytes themselves (`distributed.shardctx`).
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_MATMULS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
            aten.baddbmm: (1, 2)}
_ACTIVE: List["Counter"] = []


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Counter(TorchDispatchMode):
    """`flops` and `hbm_bytes` of what runs inside the block."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ab = _MATMULS.get(func.overloadpacket)
        if ab is not None:
            a = args[ab[0]]
            self.flops += 2 * out.numel() * a.shape[-1]
            self.hbm_bytes += nbytes(*(t for t in args
                                       if isinstance(t, torch.Tensor)), out)
        return out


def fused(flops: int, inputs, outputs):
    """Count a fused call: `flops`, its inputs read once and its outputs
    written once."""
    for c in _ACTIVE:
        c.flops += int(flops)
        c.hbm_bytes += nbytes(*inputs) + nbytes(*outputs)
