"""RouteBalance in PyTorch, with the per-batch decision as a hand-written
CUDA kernel for Hopper.

The port of the JAX/Pallas package `repro`, module for module (the
layout mirrors it: `core/`, `estimators/`, `serving/`, `kernels/`, and
`csrc/` for the CUDA sources). It imports torch, numpy and the standard
library, never jax and nothing of `repro`. Entry points run on the card
unless the caller passes `device="cpu"`.
"""
