"""KV-cache fake quant (port of
lightcompress_tpu/compression/quantization/kvquant.py).

A KV module makes one hook a block, ``(k, v) -> (k, v)`` on the (B, Hkv,
T, D) keys and values that enter the attention (``models.arch``'s
``kv_hook``):

- ``Naive``: qdq of the whole K/V, per token, per group or per tensor;
  dynamic, or static from qparams the block loop calibrates on each
  block's last K/V.
- ``Kivi``: the last ``residual_length`` positions stay in float, the
  earlier ones are quantized (dynamic only).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...quant import (QParams, fake_quant_act_dynamic, fake_quant_act_static,
                      spec_from_config, static_act_qparams)
from ...registry import KV_REGISTRY


@KV_REGISTRY.register("Naive")
class NaiveQuantKVCache:
    def __init__(self, quant_type: str, kvquant_cfg: Dict, num_layers: int):
        gran = kvquant_cfg.get("granularity", "per_token")
        if gran not in ("per_token", "per_tensor", "per_group"):
            raise ValueError(f"unsupported KV granularity {gran}")
        self.spec = spec_from_config(dict(kvquant_cfg))
        self.static = kvquant_cfg.get("static", False)
        self.num_layers = num_layers
        self.k_qparams: List[Optional[QParams]] = [None] * num_layers
        self.v_qparams: List[Optional[QParams]] = [None] * num_layers

    def calibrate(self, layer_idx: int, k_batches: List[torch.Tensor],
                  v_batches: List[torch.Tensor]) -> None:
        """The static qparams of a block from its calibration K/V."""
        spec = self.spec.with_(calib_algo="static_minmax")
        self.k_qparams[layer_idx] = static_act_qparams(k_batches, spec)
        self.v_qparams[layer_idx] = static_act_qparams(v_batches, spec)

    def _qdq(self, t: torch.Tensor, qp: Optional[QParams]) -> torch.Tensor:
        if self.static and qp is not None:
            return fake_quant_act_static(t, self.spec, qp)
        return fake_quant_act_dynamic(t, self.spec)

    def make_hook(self, layer_idx: int):
        def hook(k: torch.Tensor, v: torch.Tensor):
            return (self._qdq(k, self.k_qparams[layer_idx]),
                    self._qdq(v, self.v_qparams[layer_idx]))

        return hook


@KV_REGISTRY.register("Kivi")
class KiviQuantKVCache(NaiveQuantKVCache):
    def __init__(self, quant_type: str, kvquant_cfg: Dict, num_layers: int):
        super().__init__(quant_type, kvquant_cfg, num_layers)
        if self.static:
            raise ValueError("KIVI supports dynamic quantization only")
        self.residual_length = kvquant_cfg.get("residual_length", 128)

    def make_hook(self, layer_idx: int):
        r = self.residual_length

        def hook(k: torch.Tensor, v: torch.Tensor):
            T = k.shape[2]
            if T <= r:
                return k, v
            return tuple(
                torch.cat([fake_quant_act_dynamic(t[:, :, :T - r],
                                                  self.spec),
                           t[:, :, T - r:]], dim=2)
                for t in (k, v))

        return hook
