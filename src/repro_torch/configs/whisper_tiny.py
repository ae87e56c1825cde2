"""Config module for --arch whisper-tiny (port of `repro.configs.whisper_tiny`);
the binding definition is in registry.py."""
from .registry import ARCHS, smoke_variant

CONFIG = ARCHS["whisper-tiny"]
SMOKE = smoke_variant(CONFIG)
