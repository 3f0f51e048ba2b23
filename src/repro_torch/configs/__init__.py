from repro_torch.configs.base import ModelConfig, get_config, list_archs  # noqa: F401
