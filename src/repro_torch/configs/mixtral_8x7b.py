"""Config module for --arch mixtral-8x7b (port of `repro.configs.mixtral_8x7b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["mixtral-8x7b"]
SMOKE = smoke_variant(CONFIG)
