"""Config module for --arch granite-3-2b (port of `repro.configs.granite_3_2b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["granite-3-2b"]
SMOKE = smoke_variant(CONFIG)
