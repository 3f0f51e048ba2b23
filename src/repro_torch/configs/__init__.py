from repro_torch.configs.base import ModelConfig, get_config, list_archs  # noqa: F401
from repro_torch.configs.shapes import SHAPES, Shape, applicable, get_shape  # noqa: F401
