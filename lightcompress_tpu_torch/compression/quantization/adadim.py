"""AdaDim, the per-linear choice of the quantization dim (port of
lightcompress_tpu/compression/quantization/adadim.py).

For every linear, the calibration inputs' reconstruction MSE of the
weight quantized along its output channels and along its input channels
(``dim_ic``); the better one is kept for the deployment.
"""

from __future__ import annotations

import torch

from ...models.base import resolve
from ...quant import fake_quant_weight_dynamic
from ...quant.quantizer import mean_xla
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class AdaDim(BaseBlockwiseQuantization):
    def block_transform(self, block_idx, input_feat) -> None:
        bp = self.model.blocks[block_idx]
        for name in self.model.get_block_linear_names(block_idx):
            if name not in input_feat or self.is_ignored(block_idx, name):
                continue
            w = resolve(bp, name)["weight"].float()
            x = torch.cat([f.reshape(-1, f.shape[-1])
                           for f in input_feat[name]]).float()
            org = x @ w.T
            losses = {}
            for dim_ic in (False, True):
                qw = fake_quant_weight_dynamic(w, self.wspec, dim_ic=dim_ic)
                losses[dim_ic] = float(mean_xla((x @ qw.T - org) ** 2))
            self.state(block_idx, name)["dim_ic"] = \
                losses[True] < losses[False]

    def w_qdq(self, w, block_idx, name):
        st = self.layer_state[block_idx].get(name, {})
        return fake_quant_weight_dynamic(w, self.wspec_for(block_idx, name),
                                         dim_ic=st.get("dim_ic", False))
