"""Outlier Suppression+ (port of
lightcompress_tpu/compression/quantization/osplus.py).

For each norm -> linears subset: a channel shift (cmax + cmin) / 2 folded
into the biases (models whose norms carry a bias; none of the llama family)
and a grid search over a symmetric clipping range [-st, st]: the channels
beyond it get the scale c / st migrated into the weights, and the loss is
the quantized subset output's MSE.  The grid is the JAX package's exactly
(``_grid``: a data-dependent number of points walked by repeated float
subtraction).  The JAX package compiles the search (``jax.jit`` over
``lax.map``), so the port takes its arithmetic: the qdq's divisions by the
format's range as products with the reciprocal (``act_qdq_compiled``) and
the loss's mean as a sum times 1/n (``mean_xla``).
"""

from __future__ import annotations

import math

import torch

from ...models.base import Subset, resolve
from ...quant.quantizer import act_qdq_compiled, mean_xla
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization, _struct_copy


@ALGO_REGISTRY
class OsPlus(BaseBlockwiseQuantization):
    def subset_transform(self, block_idx, bp, subset: Subset, input_feat):
        if subset.prev_type != "norm":  # norm -> linears only
            return
        x = torch.cat(input_feat[subset.input], dim=0)
        scale, shift = self.search_scale_shift_subset(block_idx, bp, subset,
                                                      x)
        self.apply_shift(bp, subset, shift)
        self.apply_scale(bp, subset, scale)
        if self.act_static:
            self.update_input_feat(input_feat, subset, scale)

    @staticmethod
    def _grid(bound_hi: float) -> list:
        """The clipping-range grid: max(100, int(bound / 0.5)) steps walked
        down from the bound by repeated float64 subtraction, every point
        >= 1.0 kept (then taken as f32)."""
        num = max(100, int(bound_hi / 0.5)) if math.isfinite(bound_hi) \
            else 100
        step = (bound_hi - 1.0) / num
        if step <= 0:
            return [1.0]
        sts, st = [], float(bound_hi)
        while st >= 1.0:
            sts.append(st)
            st -= step
        return sts

    def search_scale_shift_subset(self, block_idx, bp, subset: Subset,
                                  x: torch.Tensor):
        """(scale, None): the best clipping range's per-channel scale (the
        llama family has no shift)."""
        model, layers = self.model, subset.layers
        xf = x.float().reshape(-1, x.shape[-1])
        cmx, cmn = xf.amax(dim=0), xf.amin(dim=0)
        bound = max(-min(float(cmn.min()), 0.0), max(float(cmx.max()), 0.0))
        sts = torch.tensor(self._grid(bound), dtype=torch.float32,
                           device=x.device)
        org_out = model.inspect_forward(block_idx, subset, x,
                                        block_params=bp).float()
        one = torch.ones((), device=x.device)

        def scale_for(st):
            return torch.maximum(torch.where(cmx > st, cmx / st, one),
                                 torch.where(cmn < -st, cmn / -st, one))

        losses = []
        for i in range(sts.shape[0]):
            cur = scale_for(sts[i])
            bp_s = _struct_copy(bp)
            for name in layers:
                node = resolve(bp_s, name)
                w = node["weight"].float() * cur[None, :]
                node["weight"] = act_qdq_compiled(w, self.wspec).to(
                    node["weight"].dtype)
            x_q = x.float() / cur
            if not self.w_only and self.aspec is not None:
                x_q = act_qdq_compiled(x_q, self.aspec)
            out = model.inspect_forward(block_idx, subset, x_q.to(x.dtype),
                                        block_params=bp_s).float()
            losses.append(mean_xla(((org_out - out) ** 2).sum(dim=-1)))
        best = int(torch.argmin(torch.stack(losses)))
        return scale_for(sts[best]), None
