"""AutoClipper, the per-group weight-clip grid search of AWQ's
``weight_clip`` (port of
lightcompress_tpu/compression/quantization/auto_clip.py).

For each linear of a block but q and k, each output group's range is
shrunk by 1 - i/n_grid for i < max_shrink * n_grid; the fake-quantized
clipped weight's output on a token subsample (its act fake-quantized in a
w-a config) is compared with the float output, and each group keeps the
shrink of least MSE (a later one only where strictly better, as the JAX
``err < best_err``).  v1 clamps the weights to the range found; v2 stores
the range as sigmoid clip factors (``upbound_factor``,
``lowbound_factor`` in the algorithm's layer state), which ``w_qdq`` reads
through the learnable range; with ``save_clip`` it also records them in
the algorithm's ``weight_clips`` under JAX's keys (``blockwise.py`` writes
them to ``clips.pkl``).  Stacked MoE experts raise
``NotImplementedError`` naming ROADMAP A9.

The output comparison holds (out channels, tokens, groups) in f32: about
0.94 GB for Llama-3-8B's down projection at 512 tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...device import div
from ...models.base import resolve
from ...quant import (QuantSpec, fake_quant_weight_dynamic, minmax_range,
                      reshape_tensor)
from ...quant.quantizer import act_qdq_compiled, compiled_qdq, \
    learnable_range


def _logit(x: torch.Tensor) -> torch.Tensor:
    # clamped away from {0, 1}: the grid includes shrink 1.0, whose ratio
    # is exactly 1 and whose plain logit is +inf
    x = x.clamp(1e-6, 1.0 - 1e-6)
    return torch.log(x / (1.0 - x))


class AutoClipper:
    def __init__(self, wspec: QuantSpec, clip_version: str, clip_sym: bool,
                 n_grid: int = 20, max_shrink: float = 0.5,
                 w_only: bool = True, aspec: Optional[QuantSpec] = None,
                 save_clip: bool = False):
        if clip_version not in ("v1", "v2"):
            raise ValueError(f"clip_version {clip_version!r}")
        self.wspec = wspec
        self.clip_version = clip_version
        self.clip_sym = clip_sym
        self.n_grid = n_grid
        self.max_shrink = max_shrink
        self.w_only = w_only
        self.aspec = aspec
        self.save_clip = save_clip

    def run(self, algo, block_idx: int, bp: Dict,
            input_feat: Dict[str, List[torch.Tensor]],
            n_sample_token: Optional[int]) -> None:
        """Clip every linear of the block except q and k."""
        for name in algo.model.get_block_linear_names(block_idx):
            if name in ("attn.q", "attn.k") or name not in input_feat:
                continue
            node = resolve(bp, name)
            w = node["weight"]
            if w.dim() == 3:
                raise NotImplementedError("the clip search of stacked MoE "
                                          "experts is not ported: ROADMAP "
                                          "A9")
            xs = torch.cat([x.reshape(-1, x.shape[-1])
                            for x in input_feat[name]], dim=0)
            max_val, min_val = self.auto_clip_layer(w, xs, n_sample_token)
            del xs
            self.apply_clip(algo, block_idx, name, node, min_val, max_val)

    def _group_size(self, w: torch.Tensor) -> int:
        if self.wspec.granularity == "per_group":
            return self.wspec.group_size
        return w.shape[1]

    def auto_clip_layer(self, w: torch.Tensor, x: torch.Tensor,
                        n_sample_token: Optional[int]):
        """(best_max, best_min), each (oc, n_group, 1)."""
        gs = self._group_size(w)
        oc = w.shape[0]
        w4 = w.float().reshape(oc, 1, -1, gs)
        if n_sample_token is None:
            n_sample_token = min(x.shape[0], 512)
        x = x[::max(1, x.shape[0] // n_sample_token)]
        x4 = x.float().reshape(1, x.shape[0], -1, gs)
        return self._clip_search(w4, x4)

    def _clip_search(self, w4: torch.Tensor, x4: torch.Tensor):
        """w4 (oc, 1, G, gs), x4 (1, N, G, gs) -> (best_max, best_min)."""
        if self.clip_sym:
            org_max = w4.abs().amax(dim=-1, keepdim=True)
        else:
            org_max = w4.amax(dim=-1, keepdim=True)
        org_min = w4.amin(dim=-1, keepdim=True)
        org_out = torch.einsum("onjg,injg->oij", w4, x4)  # (oc, N, G)
        if not self.w_only and self.aspec is not None:
            x4 = act_qdq_compiled(x4, self.aspec)
        best_err = torch.full((w4.shape[0], w4.shape[2], 1), float("inf"),
                              device=w4.device)
        best_max, best_min = org_max[:, 0], org_min[:, 0]
        for i in range(int(self.max_shrink * self.n_grid)):
            # 1 - i/n_grid in f32 arithmetic, as JAX's; a 0-d CPU tensor
            shrink = 1.0 - div(torch.tensor(float(i)), self.n_grid)
            max_val = org_max * shrink
            min_val = -max_val if self.clip_sym else org_min * shrink
            q_w = self._q_weight(w4, min_val, max_val, org_min, org_max)
            cur = torch.einsum("onjg,injg->oij", q_w, x4)
            err = ((cur - org_out) ** 2).mean(dim=1)[:, :, None]
            del q_w, cur
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_max = torch.where(better, max_val[:, 0], best_max)
            best_min = torch.where(better, min_val[:, 0], best_min)
        return best_max, best_min

    def _q_weight(self, w4, min_val, max_val, org_min, org_max):
        """A candidate range's fake-quantized weight: v1 clamps then
        quantizes dynamically; v2 quantizes through the learnable range of
        the candidate's clip factors (as JAX's compiled search does)."""
        if self.clip_version == "v1":
            return fake_quant_weight_dynamic(
                torch.clamp(w4, min_val, max_val), self.wspec)
        rng = learnable_range(w4, self.wspec, _logit(min_val / org_min),
                              _logit(max_val / org_max))
        return compiled_qdq(w4, rng, self.wspec)

    def apply_clip(self, algo, block_idx: int, name: str, node: Dict,
                   min_val: torch.Tensor, max_val: torch.Tensor) -> None:
        """v1: clamp each group of the weight to its best range; v2: store
        the range as clip factors in the algorithm's layer state."""
        w = node["weight"]
        if self.clip_version == "v2":
            up, low = self._v2_factors(w, min_val, max_val)
            st = algo.state(block_idx, name)
            st["upbound_factor"], st["lowbound_factor"] = up, low
            if self.save_clip:
                algo.weight_clips.setdefault(block_idx, {}).update({
                    f"{name}.upbound_factor": up,
                    f"{name}.lowbound_factor": low})
            return
        gs = self._group_size(w)
        w4 = w.float().reshape(w.shape[0], 1, -1, gs)
        mn = -max_val if self.clip_sym else min_val
        clipped = torch.clamp(w4, mn[:, None], max_val[:, None])
        node["weight"] = clipped.reshape(w.shape).to(w.dtype)

    def _v2_factors(self, w: torch.Tensor, min_val: torch.Tensor,
                    max_val: torch.Tensor):
        """The sigmoid clip factors of one weight, shaped as the learnable
        range reads them (the rows of ``reshape_tensor``)."""
        org_mn, org_mx = minmax_range(reshape_tensor(w.float(), self.wspec),
                                      self.wspec)
        shape = org_mx.shape
        if self.clip_sym:
            amax = torch.maximum(org_mx.abs(), org_mn.abs()).clamp_min(1e-5)
            return _logit(max_val.reshape(shape) / amax), None
        return (_logit(max_val.reshape(shape) / org_mx),
                _logit(min_val.reshape(shape) / org_mn))
