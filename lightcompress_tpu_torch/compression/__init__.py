from . import quantization  # noqa: F401  (registers the algorithms)
from .blockwise import BlockwiseOpt

__all__ = ["BlockwiseOpt"]
