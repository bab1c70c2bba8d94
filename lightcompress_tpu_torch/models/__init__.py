from .arch import ArchSpec, init_params, model_forward
from .base import Llama, Qwen3Moe, resolve
from .hf_config import arch_from_hf_config

__all__ = ["ArchSpec", "Llama", "Qwen3Moe", "arch_from_hf_config",
           "init_params", "model_forward", "resolve"]
