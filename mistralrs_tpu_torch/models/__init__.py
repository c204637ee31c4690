"""Model library: the dense llama-family decoder."""

from .config import ModelConfig, config_from_gguf, config_from_hf
from .llama import forward_paged, fuse_projections, init_random_weights

__all__ = [
    "ModelConfig", "config_from_gguf", "config_from_hf",
    "forward_paged", "fuse_projections", "init_random_weights",
]
