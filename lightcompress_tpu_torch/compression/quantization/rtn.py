"""RTN, round to nearest (port of lightcompress_tpu/compression/
quantization/rtn.py): no transform; the weights are quantized at deploy
time by the base class's ``w_qdq``.  The block loop still runs: it
collects the acts whose static qparams ``block_opt`` registers."""

from __future__ import annotations

from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class RTN(BaseBlockwiseQuantization):
    def block_transform(self, block_idx, input_feat):
        pass

    def subset_transform(self, *args, **kwargs):
        pass
