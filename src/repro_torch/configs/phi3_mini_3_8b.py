"""Config module for --arch phi3-mini-3.8b (port of `repro.configs.phi3_mini_3_8b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["phi3-mini-3.8b"]
SMOKE = smoke_variant(CONFIG)
