"""Config module for --arch gemma3-27b (port of `repro.configs.gemma3_27b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["gemma3-27b"]
SMOKE = smoke_variant(CONFIG)
