from .arch import ArchSpec, init_params, model_forward
from .base import (BaseModel, Llama, Mistral, Qwen2, Qwen3, Qwen3Moe, Subset,
                   resolve)
from .hf_config import arch_from_hf_config

__all__ = ["ArchSpec", "BaseModel", "Llama", "Mistral", "Qwen2", "Qwen3",
           "Qwen3Moe", "Subset", "arch_from_hf_config", "init_params",
           "model_forward", "resolve"]
