"""The blockwise quantization base (port of the weight-only part of
lightcompress_tpu/compression/quantization/base.py): the config's weight
spec and special flags, the fake-quant callbacks (``w_qdq``,
``fq_linear_fn``), the equivalent-transform primitives on the parameter
tree (``scale_ln_fcs``, ``scale_fc_fc``, ``apply_scale``), the block loop
step and the deployments.

Act quant (``quant.act``: dynamic or static), KV-cache quant
(``quant.kvcache``), attention quant, the W48 and mixed-bit specs, the
ignored (float) layers, the online rotation, the GQA transform of v and o
and token reduction raise ``NotImplementedError`` naming ROADMAP A2 or
A8.
"""

from __future__ import annotations

import gc
import os
from typing import Dict, List

import torch

from ...models import arch as A
from ...models.base import Subset, resolve
from ...quant import QuantSpec, fake_quant_weight_dynamic, spec_from_config
from ..blockwise import BlockwiseOpt


class BaseBlockwiseQuantization(BlockwiseOpt):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        self.set_quant_config()

    # ------------------------------------------------------------------
    def set_quant_config(self) -> None:
        qc = self.quant_config
        self.quant_out = qc.get("quant_out", False)
        wcfg = qc.get("weight", {"bit": 8, "symmetric": True,
                                 "granularity": "per_channel"})
        self.wspec: QuantSpec = spec_from_config(wcfg)
        for key, what in (("w_1", "mixed-bit weight specs"),
                          ("w_2", "mixed-bit weight specs"),
                          ("act", "act quant"), ("kvcache", "KV-cache quant"),
                          ("token_reduction", "token reduction")):
            if qc.get(key) is not None:
                raise NotImplementedError(f"quant.{key} ({what}) is not "
                                          f"ported: ROADMAP A2, A8")

        special = qc.get("special", {})
        self.special_config = special
        for key in ("online_rotate", "search_clip_init", "do_gqa_trans"):
            if special.get(key, False):
                raise NotImplementedError(f"special.{key} is not ported: "
                                          f"ROADMAP A8")
        if self.config and self.config.get("ignored_layers"):
            raise NotImplementedError("ignored_layers (float layers among "
                                      "the quantized) is not ported: "
                                      "ROADMAP A2")
        self.true_sequential = special.get("true_sequential", False)
        self.weight_clip = special.get("weight_clip", False)
        self.save_scale = special.get("save_scale", False)
        if self.weight_clip:
            from .auto_clip import AutoClipper

            self.auto_clipper = AutoClipper(
                self.wspec, special.get("clip_version", "v1"),
                special.get("clip_sym", self.wspec.symmetric))

    # ------------------------------------------------------------------
    def w_qdq(self, w: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        """The weight's dynamic minmax fake quant (the FakeQuantLinear
        callback)."""
        return fake_quant_weight_dynamic(w, self.wspec)

    def fq_linear_fn(self, block_idx: int) -> A.LinearFn:
        """The fake-quant linear: weight qdq per call (weight only)."""

        def lf(name, w, b, x):
            return A.default_linear(name, self.w_qdq(w, block_idx, name), b,
                                    x)

        return lf

    # ------------------------------------------------------------------
    # equivalent-transform primitives on the params tree
    # ------------------------------------------------------------------
    def scale_ln_fcs(self, bp: Dict, ln_name: str, fc_names: List[str],
                     scales: torch.Tensor) -> None:
        """ln /= s, each fc's input columns *= s (in f32, back to each
        tensor's dtype)."""
        ln = resolve(bp, ln_name)
        s = scales.float()
        for key in ("weight", "bias"):
            if ln.get(key) is not None:
                ln[key] = (ln[key].float() / s).to(ln[key].dtype)
        for fn in fc_names:
            fc = resolve(bp, fn)
            fc["weight"] = (fc["weight"].float() * s[None, :]).to(
                fc["weight"].dtype)
        self._assert_finite(bp, [ln_name] + fc_names)

    def scale_fc_fc(self, bp: Dict, fc1_name: str, fc2_name: str,
                    scales: torch.Tensor) -> None:
        """fc1's output rows /= s, fc2's input columns *= s."""
        fc1, fc2 = resolve(bp, fc1_name), resolve(bp, fc2_name)
        s = scales.float()
        out1, in2 = fc1["weight"].shape[0], fc2["weight"].shape[1]
        if out1 != in2:
            raise ValueError(f"cannot scale fc-fc: {fc1_name}({out1}) -> "
                             f"{fc2_name}({in2})")
        fc1["weight"] = (fc1["weight"].float() / s[:, None]).to(
            fc1["weight"].dtype)
        if fc1.get("bias") is not None:
            fc1["bias"] = (fc1["bias"].float() / s).to(fc1["bias"].dtype)
        fc2["weight"] = (fc2["weight"].float() * s[None, :]).to(
            fc2["weight"].dtype)
        self._assert_finite(bp, [fc1_name, fc2_name])

    def apply_scale(self, bp: Dict, subset: Subset,
                    scales: torch.Tensor) -> None:
        if subset.prev_type == "linear":
            if len(subset.layers) != 1:
                raise ValueError("an fc-fc subset has one layer")
            self.scale_fc_fc(bp, subset.prev_op, subset.layers[0], scales)
        elif subset.prev_type == "norm":
            self.scale_ln_fcs(bp, subset.prev_op, list(subset.layers),
                              scales)
        else:
            raise NotImplementedError(f"prev_type {subset.prev_type}")

    def _assert_finite(self, bp: Dict, names: List[str]) -> None:
        """NaN guards after the equivalent transforms; LCTPU_NAN_CHECKS=0
        turns off their host syncs, as in the JAX package."""
        if os.environ.get("LCTPU_NAN_CHECKS", "1") == "0":
            return
        for n in names:
            node = resolve(bp, n)
            for key in ("weight", "bias"):
                t = node.get(key)
                if t is not None and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite values in {n}.{key} after an "
                        f"equivalent transform")

    def update_input_feat(self, feats: Dict[str, List[torch.Tensor]],
                          subset: Subset, scales: torch.Tensor) -> None:
        """Divide the cached inputs of the subset's layers by the applied
        scale."""
        for lname in subset.layers:
            if lname in feats:
                feats[lname] = [x / scales for x in feats[lname]]

    # ------------------------------------------------------------------
    def block_opt(self, block_idx: int) -> None:
        feats, outs = self.collect_block_io(block_idx)
        if not self.quant_out:
            # the float (pre-transform) outputs feed the next block
            self.input_batches = outs
        self.block_transform(block_idx, feats)
        if self.quant_out:
            self.input_batches = self.block_forward_batches(
                block_idx, linear_fn=self.fq_linear_fn(block_idx))
        del feats, outs
        gc.collect()

    def block_transform(self, block_idx: int,
                        input_feat: Dict[str, List[torch.Tensor]]) -> None:
        bp = self.model.blocks[block_idx]
        for subset in self.model.get_subsets_in_block(block_idx):
            self.subset_transform(block_idx, bp, subset, input_feat)
            if self.true_sequential:
                input_feat.update(self.collect_block_io(block_idx)[0])

    def subset_transform(self, block_idx: int, bp: Dict, subset: Subset,
                         input_feat) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # deployments
    # ------------------------------------------------------------------
    def deploy(self, mode: str = "fake_quant") -> None:
        """'origin_float' / 'transformed': the float forward of the
        current (transformed) params; 'fake_quant' / 'fake_quant_wo_kv'
        (one deployment here, no KV quant being ported): ``w_qdq`` baked
        into a copy of every block's linears, the float blocks kept for
        ``restore_float``."""
        model = self.model
        if mode in ("origin_float", "transformed"):
            model.deploy_float()
            return
        if mode not in ("fake_quant", "fake_quant_wo_kv"):
            raise ValueError(mode)
        if not hasattr(model, "_fp_blocks"):
            model._fp_blocks = model.get_param_blocks()
        new_blocks = []
        for idx, bp in enumerate(model._fp_blocks):
            nbp = _struct_copy(bp)
            for name in model.get_block_linear_names(idx):
                node = resolve(nbp, name)
                node["weight"] = self.w_qdq(node["weight"], idx, name)
            new_blocks.append(nbp)
        model.set_param_blocks(new_blocks)
        model.linear_fns = None

    def restore_float(self) -> None:
        model = self.model
        if hasattr(model, "_fp_blocks"):
            model.set_param_blocks(model._fp_blocks)
            del model._fp_blocks
        model.deploy_float()

    def save_model(self, save_dir: str) -> None:
        from ...models.hf_loader import save_params

        save_params(self.model, save_dir,
                    hf_config=getattr(self.model, "config", None))


def _struct_copy(tree):
    """Copy the dict structure, share the leaf tensors."""
    if isinstance(tree, dict):
        return {k: _struct_copy(v) for k, v in tree.items()}
    return tree
