from repro_torch.configs.base import ModelConfig, ShapeCell, LM_SHAPES, shape_cells_for
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config, arch_names

__all__ = ["ModelConfig", "ShapeCell", "LM_SHAPES", "shape_cells_for",
           "ARCHS", "get_config", "get_smoke_config", "arch_names"]
