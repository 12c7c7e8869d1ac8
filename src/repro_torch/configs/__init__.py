from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
