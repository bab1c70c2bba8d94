from . import kvquant  # noqa: F401  (registers the KV-cache modules)
from .adadim import AdaDim
from .auto_clip import AutoClipper
from .awq import Awq
from .base import BaseBlockwiseQuantization
from .dgq import DGQ
from .gptq import GPTQ
from .hqq import HQQ
from .llmint8 import LlmInt8
from .osplus import OsPlus
from .quarot import Quarot
from .quik import QUIK
from .rtn import RTN
from .smoothquant import SmoothQuant
from .spqr import SpQR

__all__ = ["AdaDim", "AutoClipper", "Awq", "BaseBlockwiseQuantization",
           "DGQ", "GPTQ", "HQQ", "LlmInt8", "OsPlus", "QUIK", "Quarot", "RTN",
           "SmoothQuant", "SpQR"]
