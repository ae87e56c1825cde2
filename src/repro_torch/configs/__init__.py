"""The zoo's architecture registry (port of `repro.configs`)."""
from ..models.config import SHAPES, ShapeSpec
from .registry import (ARCHS, LONG_CONTEXT_OK, QWEN25_POOL, get_config,
                       input_specs, list_archs, shape_applicable,
                       skip_reason, smoke_variant)

__all__ = ["ARCHS", "LONG_CONTEXT_OK", "QWEN25_POOL", "get_config",
           "input_specs", "list_archs", "shape_applicable", "skip_reason",
           "smoke_variant", "SHAPES", "ShapeSpec"]
