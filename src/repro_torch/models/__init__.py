"""The model zoo's serving path: configs, layers, attention and SSD
blocks, the decoder-only model and its `Model` facade (port of
`repro.models`)."""
from .api import Model, greedy_sample
from .config import BlockCfg, ModelConfig, SHAPES, ShapeSpec, smoke_shape

__all__ = ["Model", "greedy_sample", "BlockCfg", "ModelConfig", "SHAPES",
           "ShapeSpec", "smoke_shape"]
