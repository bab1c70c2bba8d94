"""SmoothQuant, the act-scale migration (port of
lightcompress_tpu/compression/quantization/smoothquant.py).

For each norm -> linears subset: s = max|x|^alpha / max|W|^(1 - alpha)
per input channel (clamped at 1e-5), folded into the norm and the
linears; the cached inputs are divided by s when the act quant is static,
so that the static qparams see the smoothed acts.
"""

from __future__ import annotations

import torch

from ...models.base import Subset, resolve
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class SmoothQuant(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        self.alpha = self.special_config.get("alpha", 0.5)

    def get_weight_scale(self, bp, layer_names) -> torch.Tensor:
        """Column-wise max |W| over the subset's linears."""
        maxes = [resolve(bp, n)["weight"].float().abs().amax(dim=0)
                 for n in layer_names]
        return torch.stack(maxes).amax(dim=0).clamp_min(1e-5)

    @staticmethod
    def get_act_scale(batches) -> torch.Tensor:
        """Per-channel max |x| over every batch, in f32."""
        m = None
        for x in batches:
            cur = x.reshape(-1, x.shape[-1]).abs().amax(dim=0).float()
            m = cur if m is None else torch.maximum(m, cur)
        return m

    def subset_transform(self, block_idx, bp, subset: Subset, input_feat):
        if subset.prev_type != "norm":  # norm -> linears subsets only
            return
        w_max = self.get_weight_scale(bp, subset.layers)
        x_max = self.get_act_scale(input_feat[subset.input])
        scale = (x_max ** self.alpha
                 / w_max ** (1.0 - self.alpha)).clamp_min(1e-5)
        self.apply_scale(bp, subset, scale)
        if self.act_static:
            self.update_input_feat(input_feat, subset, scale)
