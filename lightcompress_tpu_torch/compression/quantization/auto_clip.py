"""AutoClipper, the per-group weight-clip grid search of AWQ's
``weight_clip`` (port of clip version v1 of
lightcompress_tpu/compression/quantization/auto_clip.py).

For each linear of a block but q and k, each output group's range is
shrunk by 1 - i/n_grid for i < max_shrink * n_grid; the fake-quantized
clipped weight's output on a token subsample is compared with the float
output, and each group keeps the shrink of least MSE (a later one only
where strictly better, as the JAX ``err < best_err``).  v1 clamps the
weights to the range found.  v2 (learnable sigmoid clip factors) raises
``NotImplementedError`` naming ROADMAP A2, and stacked MoE experts naming
ROADMAP A9.

The output comparison holds (out channels, tokens, groups) in f32: about
0.94 GB for Llama-3-8B's down projection at 512 tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...device import div
from ...models.base import resolve
from ...quant import QuantSpec, fake_quant_weight_dynamic


class AutoClipper:
    def __init__(self, wspec: QuantSpec, clip_version: str, clip_sym: bool,
                 n_grid: int = 20, max_shrink: float = 0.5):
        if clip_version != "v1":
            raise NotImplementedError(
                f"clip_version {clip_version!r} (learnable clip factors) "
                f"is not ported: ROADMAP A2")
        self.wspec = wspec
        self.clip_sym = clip_sym
        self.n_grid = n_grid
        self.max_shrink = max_shrink

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
            self.apply_clip(node, min_val, max_val)

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
        best_err = torch.full((w4.shape[0], w4.shape[2], 1), float("inf"),
                              device=w4.device)
        best_max, best_min = org_max[:, 0], org_min[:, 0]
        for i in range(int(self.max_shrink * self.n_grid)):
            # 1 - i/n_grid in f32 arithmetic, as JAX's; a 0-d CPU tensor
            shrink = 1.0 - div(torch.tensor(float(i)), self.n_grid)
            max_val = org_max * shrink
            min_val = -max_val if self.clip_sym else org_min * shrink
            q_w = fake_quant_weight_dynamic(
                torch.clamp(w4, min_val, max_val), self.wspec)
            cur = torch.einsum("onjg,injg->oij", q_w, x4)
            err = ((cur - org_out) ** 2).mean(dim=1)[:, :, None]
            del q_w, cur
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_max = torch.where(better, max_val[:, 0], best_max)
            best_min = torch.where(better, min_val[:, 0], best_min)
        return best_max, best_min

    def apply_clip(self, node: Dict, min_val: torch.Tensor,
                   max_val: torch.Tensor) -> None:
        """v1: clamp each group of the weight to its best range."""
        w = node["weight"]
        gs = self._group_size(w)
        w4 = w.float().reshape(w.shape[0], 1, -1, gs)
        mn = -max_val if self.clip_sym else min_val
        clipped = torch.clamp(w4, mn[:, None], max_val[:, None])
        node["weight"] = clipped.reshape(w.shape).to(w.dtype)
