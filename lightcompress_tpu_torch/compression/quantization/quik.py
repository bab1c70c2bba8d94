"""QUIK, static float outlier columns (port of
lightcompress_tpu/compression/quantization/quik.py).

Per linear, the calibration inputs' max |x| per channel picks the
``fp_features`` largest columns (``fp_relative``: that many per hidden
width of input), which stay in float in both the weight and the act; the
rest are quantized.  ``last_fc_bit`` gives the down projection its own
width (and doubles its threshold).  The column order is numpy's argsort of
the same f32 maxima, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ...quant import fake_quant_act_dynamic, fake_quant_weight_dynamic
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class QUIK(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        sp = self.special_config
        self.fp_relative = sp.get("fp_relative", False)
        self.fp_features = sp.get("fp_features", 0)
        self.fp_threshold = sp.get("fp_threshold", 0.0)
        self.last_fc_bit = sp.get("last_fc_bit", None)

    def block_transform(self, block_idx, input_feat) -> None:
        hidden = self.model.arch.hidden_size
        for name in self.model.get_block_linear_names(block_idx):
            if name not in input_feat:
                continue
            scales = np.max([x.reshape(-1, x.shape[-1]).float().abs()
                             .amax(dim=0).cpu().numpy()
                             for x in input_feat[name]], axis=0)
            n_in = scales.shape[0]
            outlier_num = int(n_in / hidden) * self.fp_features \
                if self.fp_relative else self.fp_features
            fp_threshold = self.fp_threshold
            st = self.state(block_idx, name)
            if self.last_fc_bit is not None and name in ("mlp.down",
                                                         "mlp.fc2"):
                fp_threshold = self.fp_threshold * 2
                st["current_bit"] = self.last_fc_bit
            if outlier_num > 0 and scales.max() <= fp_threshold:
                outlier_num = 0
            order = np.argsort(scales)
            if outlier_num > 0:
                st["int_ids"] = order[:-outlier_num].copy()
                st["fp_ids"] = order[-outlier_num:].copy()
            else:
                st["int_ids"] = order.copy()
                st["fp_ids"] = np.array([], dtype=np.int64)

    @staticmethod
    def _spec_with_bit(spec, st):
        return spec.with_(bit=st["current_bit"]) if "current_bit" in st \
            else spec

    def w_qdq(self, w, block_idx, name):
        st = self.layer_state[block_idx].get(name, {})
        if "int_ids" not in st or len(st["fp_ids"]) == 0:
            return super().w_qdq(w, block_idx, name)
        spec = self._spec_with_bit(self.wspec_for(block_idx, name), st)
        return fake_quant_weight_dynamic(w, spec, int_indices=st["int_ids"],
                                         fp_indices=st["fp_ids"])

    def a_qdq(self, x, block_idx, name):
        if self.w_only:
            return x
        st = self.layer_state[block_idx].get(name, {})
        if "int_ids" not in st or len(st["fp_ids"]) == 0:
            return super().a_qdq(x, block_idx, name)
        return fake_quant_act_dynamic(x, self._spec_with_bit(self.aspec, st),
                                      int_indices=st["int_ids"],
                                      fp_indices=st["fp_ids"])
