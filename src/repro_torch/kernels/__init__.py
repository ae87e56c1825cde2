"""Hand-written Hopper kernels (sources in `repro_torch/csrc/`), each
beside its plain PyTorch version, and the build that compiles them at
first CUDA use."""
