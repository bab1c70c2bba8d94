"""HQQ, data-free half-quadratic weight quantization (port of
lightcompress_tpu/compression/quantization/hqq.py).

Per linear: minmax qparams, then the proximal zero-point optimization
(``quant.hqq_optimize``); the searched qparams are stored and applied
statically at deploy.  ``axis: 0`` quantizes along the input channels
(the weight transposed, ``dim_ic``).
"""

from __future__ import annotations

from ...models.base import resolve
from ...quant import fake_quant_weight_static, get_tensor_qparams
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class HQQ(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        sp = self.special_config
        self.axis = sp.get("axis", 1)
        self.hqq_spec = self.wspec.with_(
            calib_algo="hqq", lp_norm=sp.get("lp_norm", 0.7),
            beta=sp.get("beta", 10.0), kappa=sp.get("kappa", 1.01),
            iters=sp.get("iters", 20))

    def block_transform(self, block_idx, input_feat):
        bp = self.model.blocks[block_idx]
        for name in self.model.get_block_linear_names(block_idx):
            if self.is_ignored(block_idx, name):
                continue
            w = resolve(bp, name)["weight"].float()
            if self.axis == 0:
                w = w.t()
            _, qp = get_tensor_qparams(w, self.hqq_spec)
            st = self.state(block_idx, name)
            st["qparams"] = qp
            st["dim_ic"] = self.axis == 0

    def subset_transform(self, *args, **kwargs):
        pass

    def w_qdq(self, w, block_idx, name):
        st = self.layer_state[block_idx].get(name, {})
        if "qparams" not in st:
            return super().w_qdq(w, block_idx, name)
        return fake_quant_weight_static(w, self.wspec, st["qparams"],
                                        dim_ic=st.get("dim_ic", False))
