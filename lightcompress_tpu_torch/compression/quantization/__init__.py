from .auto_clip import AutoClipper
from .awq import Awq
from .base import BaseBlockwiseQuantization
from .gptq import GPTQ
from .hqq import HQQ
from .rtn import RTN
from .smoothquant import SmoothQuant

__all__ = ["AutoClipper", "Awq", "BaseBlockwiseQuantization", "GPTQ", "HQQ",
           "RTN", "SmoothQuant"]
