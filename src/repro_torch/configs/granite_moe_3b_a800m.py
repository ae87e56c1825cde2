"""Config module for --arch granite-moe-3b-a800m (port of `repro.configs.granite_moe_3b_a800m`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["granite-moe-3b-a800m"]
SMOKE = smoke_variant(CONFIG)
