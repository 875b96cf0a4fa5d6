from .base import ModelConfig, get_config, get_reduced_config  # noqa: F401
