"""Config module for --arch phi-3-vision-4.2b (port of `repro.configs.phi_3_vision_4_2b`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["phi-3-vision-4.2b"]
SMOKE = smoke_variant(CONFIG)
