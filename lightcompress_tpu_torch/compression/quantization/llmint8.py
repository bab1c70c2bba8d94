"""LLM.int8, the outlier-column decomposition (port of
lightcompress_tpu/compression/quantization/llmint8.py).

No transform: at run time the act columns whose |x| reaches ``threshold``
in any token stay in float and the others are quantized per row, with
qparams over the non-outlier entries only (a mask, as the JAX package
takes it).  The last act mask also masks the weight's fake quant of the
same width (``_col_mask``); a weight baked before any act quant ran takes
the plain ``w_qdq``.
"""

from __future__ import annotations

import torch

from ...device import div
from ...quant import QuantSpec
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


def _masked_qdq_rows(t: torch.Tensor, keep_fp_col: torch.Tensor,
                     spec: QuantSpec) -> torch.Tensor:
    """qdq along the last dim with per-row qparams over the kept columns;
    the ``keep_fp_col`` columns returned unchanged."""
    tf = t.float()
    if spec.symmetric:
        amax = torch.where(keep_fp_col, 0.0, tf).abs().amax(
            dim=-1, keepdim=True).clamp_min(1e-5)
        scales = div(amax, spec.qmax)
        zeros = torch.zeros((), device=t.device)
    else:
        mx = torch.where(keep_fp_col, -torch.inf, tf).amax(dim=-1,
                                                           keepdim=True)
        mn = torch.where(keep_fp_col, torch.inf, tf).amin(dim=-1,
                                                          keepdim=True)
        scales = div((mx - mn).clamp_min(1e-5), spec.qmax - spec.qmin)
        zeros = (spec.qmin - torch.round(mn / scales)).clamp(spec.qmin,
                                                              spec.qmax)
    q = (torch.round(tf / scales) + zeros).clamp(spec.qmin, spec.qmax)
    return torch.where(keep_fp_col, tf, (q - zeros) * scales).to(t.dtype)


@ALGO_REGISTRY
class LlmInt8(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        self.threshold = self.special_config.get("threshold", 6.0)
        self._col_mask = None

    def block_transform(self, block_idx, input_feat) -> None:
        pass  # the decomposition is at run time

    def a_qdq(self, x: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        if self.w_only or self.is_ignored(block_idx, name):
            return x
        x2 = x.reshape(-1, x.shape[-1])
        keep_fp = (x2.abs().amax(dim=0) >= self.threshold)[None, :]
        self._col_mask = keep_fp
        return _masked_qdq_rows(x2, keep_fp, self.aspec).reshape(x.shape)

    def w_qdq(self, w: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        if self.is_ignored(block_idx, name):
            return w
        keep_fp = self._col_mask
        if keep_fp is None or keep_fp.shape[-1] != w.shape[-1]:
            return super().w_qdq(w, block_idx, name)
        return _masked_qdq_rows(w, keep_fp.to(w.device), self.wspec)
