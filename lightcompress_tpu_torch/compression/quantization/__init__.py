from .auto_clip import AutoClipper
from .awq import Awq
from .base import BaseBlockwiseQuantization
from .rtn import RTN

__all__ = ["AutoClipper", "Awq", "BaseBlockwiseQuantization", "RTN"]
