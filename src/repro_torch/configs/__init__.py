"""The zoo's architecture registry (port of `repro.configs`)."""
from .registry import (ARCHS, QWEN25_POOL, get_config, list_archs,
                       smoke_variant)

__all__ = ["ARCHS", "QWEN25_POOL", "get_config", "list_archs",
           "smoke_variant"]
