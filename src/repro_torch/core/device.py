"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
`device=None` means "cuda", and a missing card is an error, never a
silent CPU fallback. They also switch TF32 off for float32 matmuls and
convolutions, so every float32 product keeps full float32 precision.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda (RuntimeError without a card); otherwise as given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev
