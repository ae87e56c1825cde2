"""Config module for --arch mamba2-1.3b (port of `repro.configs.mamba2_1_3b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["mamba2-1.3b"]
SMOKE = smoke_variant(CONFIG)
