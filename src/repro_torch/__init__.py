"""RouteBalance in PyTorch, with every Pallas kernel of the reference as
a hand-written CUDA kernel for Hopper.

The port of the JAX/Pallas package `repro`, module for module (the
layout mirrors it: `core/`, `estimators/`, `serving/`, the model zoo's
`models/`, `configs/` and `launch/`, `kernels/`, and `csrc/` for the
CUDA sources). It imports torch, numpy and the standard
library, never jax and nothing of `repro`. Entry points run on the card
unless the caller passes `device="cpu"`.
"""
