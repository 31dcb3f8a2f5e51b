"""Model definitions of the port: config registry (a copy of the
reference's), layer primitives, int8 quantization, the llama decoder,
sampling, and the numpy weight bridge."""

from .configs import CONFIGS, ModelConfig, RopeScaling, get_config

__all__ = ["CONFIGS", "ModelConfig", "RopeScaling", "get_config"]
