from .quantizer import (QParams, dequantize, fake_quant_weight_dynamic,
                        get_tensor_qparams, minmax_range, qparams_from_range,
                        quantize, real_quant_weight, reshape_tensor,
                        restore_tensor)
from .spec import QuantSpec, spec_from_config

__all__ = [
    "QParams", "QuantSpec", "dequantize", "fake_quant_weight_dynamic",
    "get_tensor_qparams", "minmax_range", "qparams_from_range", "quantize",
    "real_quant_weight", "reshape_tensor", "restore_tensor",
    "spec_from_config",
]
