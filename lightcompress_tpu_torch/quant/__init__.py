from .quantizer import (QParams, dequantize, fake_quant_act_dynamic,
                        fake_quant_act_static, fake_quant_weight_dynamic,
                        fake_quant_weight_static, fake_quant_weight_w48,
                        float_round, get_tensor_qparams, hqq_optimize,
                        minmax_range, mse_range, qparams_from_range,
                        quant_dequant, quantize, real_quant_weight,
                        reshape_tensor, restore_tensor, static_act_qparams,
                        weight_cast_to_bf16, weight_cast_to_fp8)
from .spec import FLOAT_FORMATS, QuantSpec, spec_from_config

__all__ = [
    "FLOAT_FORMATS", "QParams", "QuantSpec", "dequantize",
    "fake_quant_act_dynamic", "fake_quant_act_static",
    "fake_quant_weight_dynamic", "fake_quant_weight_static",
    "fake_quant_weight_w48", "float_round", "get_tensor_qparams",
    "hqq_optimize", "minmax_range", "mse_range", "qparams_from_range",
    "quant_dequant", "quantize", "real_quant_weight", "reshape_tensor",
    "restore_tensor", "spec_from_config", "static_act_qparams",
    "weight_cast_to_bf16", "weight_cast_to_fp8",
]
