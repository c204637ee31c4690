"""Model library: the llama-family decoder (dense MLP or Mixtral-style
experts); DeepSeek V2/V3 lives in :mod:`.deepseek`."""

from .config import ModelConfig, config_from_gguf, config_from_hf
from .llama import forward_paged, fuse_projections, init_random_weights

__all__ = [
    "ModelConfig", "config_from_gguf", "config_from_hf",
    "forward_paged", "fuse_projections", "init_random_weights",
]
