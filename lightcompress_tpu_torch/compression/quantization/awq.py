"""AWQ, activation-aware weight quantization (port of
lightcompress_tpu/compression/quantization/awq.py).

For each subset the per-input-channel scale is searched on a grid of
``n_grid`` (20) ratios: scales = mean|x|^ratio (``trans_version`` v2), or
mean|x|^ratio / w_max^(1 - ratio) (v1), normalised by sqrt(max * min); the
subset's weights times the scales are fake-quantized, its sub-forward is
re-run on x / scales (fake-quantized in a w-a config), and the ratio with
the least output MSE (the first on ties, as ``argmin``) wins.  JAX maps
the ratios in one jitted ``lax.map``; the port loops over them one at a
time, so one scaled copy of the subset's weights exists at a time (20
would not fit at full width).

The per-expert MoE down search (``_transform_moe_down``) raises
``NotImplementedError`` naming ROADMAP A9.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...device import div
from ...models.base import Subset, resolve
from ...quant import fake_quant_weight_dynamic, reshape_tensor
from ...quant.quantizer import act_qdq_compiled
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization, _struct_copy


@ALGO_REGISTRY
class Awq(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        special = self.special_config
        self.trans = special.get("trans", True)
        self.trans_version = special.get("trans_version", "v2")
        if self.trans_version not in ("v1", "v2"):
            raise ValueError(f"trans_version {self.trans_version!r}")
        self.n_grid = int(special.get("n_grid", 20))
        # (block, subset input) -> the losses of every ratio and the
        # index chosen, for inspection
        self.search_log: Dict = {}

    def get_weight_scale(self, bp: Dict, layer_names) -> torch.Tensor:
        """Mean of the per-group-normalised |W| over the subset's layers
        and their output rows; (in_features,)."""
        total = None
        for name in layer_names:
            w = resolve(bp, name)["weight"].float()
            r = reshape_tensor(w, self.wspec).abs()
            scale = r / r.amax(dim=-1, keepdim=True).clamp_min(1e-12)
            scale = scale.reshape(-1, w.shape[-1]).mean(dim=0)
            total = scale if total is None else total + scale
        return div(total, len(layer_names))

    @staticmethod
    def get_act_scale(x: torch.Tensor) -> torch.Tensor:
        """Mean |x| per channel over all tokens, in x's dtype."""
        return x.reshape(-1, x.shape[-1]).abs().mean(dim=0)

    def _ratio_scales(self, ratio: torch.Tensor, x_mean: torch.Tensor,
                      w_max: torch.Tensor) -> torch.Tensor:
        if self.trans_version == "v1":
            s = (x_mean.float() ** ratio
                 / w_max.clamp_min(1e-12) ** (1.0 - ratio))
        else:
            s = x_mean.float() ** ratio
        s = s.clamp_min(1e-4)
        return s / torch.sqrt(s.max() * s.min())

    def search_scale_subset(self, block_idx: int, bp: Dict, subset: Subset,
                            x: torch.Tensor) -> torch.Tensor:
        """The per-channel scale minimising the subset's output MSE."""
        model, layers = self.model, subset.layers
        w_max = self.get_weight_scale(bp, layers)
        x_mean = self.get_act_scale(x)
        org_out = model.inspect_forward(block_idx, subset, x,
                                        block_params=bp).float()
        ratios = div(torch.arange(self.n_grid, dtype=torch.float32,
                                  device=x.device), self.n_grid)
        losses, scales_all = [], []
        for i in range(self.n_grid):
            scales = self._ratio_scales(ratios[i], x_mean, w_max)
            bp_s = _struct_copy(bp)
            for name in layers:
                node = resolve(bp_s, name)
                w = node["weight"].float() * scales[None, :]
                node["weight"] = fake_quant_weight_dynamic(
                    w, self.wspec).to(node["weight"].dtype)
            x_s = x / scales
            if not self.w_only and self.aspec is not None:
                x_s = act_qdq_compiled(x_s, self.aspec)
            out = model.inspect_forward(block_idx, subset, x_s,
                                        block_params=bp_s)
            losses.append(((org_out - out.float()) ** 2).mean())
            scales_all.append(scales)
            del bp_s, out
        losses = torch.stack(losses)
        best = int(torch.argmin(losses))
        self.search_log[(block_idx, subset.input)] = (losses.cpu(), best)
        return scales_all[best]

    def subset_transform(self, block_idx: int, bp: Dict, subset: Subset,
                         input_feat: Dict[str, List[torch.Tensor]]) -> None:
        if subset.prev_op is None:
            return
        if subset.prev_type == "linear":
            fc1 = resolve(bp, subset.prev_op)
            fc2 = resolve(bp, subset.layers[0])
            if fc1["weight"].dim() == 3 or fc2["weight"].dim() == 3:
                if self.trans and fc1["weight"].dim() == 3 \
                        == fc2["weight"].dim():
                    self._transform_moe_down(block_idx, bp, subset,
                                             input_feat)
                return
            if fc1["weight"].shape[0] != fc2["weight"].shape[1]:
                # GQA: o's inputs are not v's outputs
                if self.has_gqa and self.do_gqa_trans:
                    raise NotImplementedError(
                        "AWQ with do_gqa_trans on a GQA model: JAX's search "
                        "gives o's hidden-wide scales to v's kv_dim rows and "
                        "fails (TypeError, incompatible shapes); a reference "
                        "fault, ROADMAP C")
                return
        if not self.trans:
            return
        x = torch.cat(input_feat[subset.input], dim=0)
        scales = self.search_scale_subset(block_idx, bp, subset, x)
        del x
        self.apply_scale(bp, subset, scales)
        self.update_input_feat(input_feat, subset, scales)
        if self.save_scale:
            for name in subset.layers:
                self.act_scales[f"block.{block_idx}.{name}"] = scales

    def _transform_moe_down(self, block_idx, bp, subset, input_feat):
        raise NotImplementedError("AWQ's per-expert MoE down search is not "
                                  "ported: ROADMAP A9")

    def block_transform(self, block_idx: int,
                        input_feat: Dict[str, List[torch.Tensor]]) -> None:
        if self.trans:
            super().block_transform(block_idx, input_feat)
        if self.weight_clip:
            n_sample_token = None
            if self.config and "calib" in self.config:
                n_sample_token = self.config.calib.get("seq_len", None)
            self.auto_clipper.run(self, block_idx,
                                  self.model.blocks[block_idx], input_feat,
                                  n_sample_token)
