"""Config module for --arch qwen3-0.6b (port of `repro.configs.qwen3_0_6b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["qwen3-0.6b"]
SMOKE = smoke_variant(CONFIG)
