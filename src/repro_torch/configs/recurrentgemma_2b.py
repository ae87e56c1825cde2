"""Config module for --arch recurrentgemma-2b (port of `repro.configs.recurrentgemma_2b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["recurrentgemma-2b"]
SMOKE = smoke_variant(CONFIG)
