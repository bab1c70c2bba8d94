"""The blockwise quantization base (port of
lightcompress_tpu/compression/quantization/base.py): the config's weight
and act specs (W48, the ``w_1``/``w_2`` mixed-bit specs, dynamic or static
per-tensor act quant with its flags, the ignored layers), the per-layer
state (``layer_state``: searched qparams, clip factors, act qparams), the
fake-quant callbacks (``w_qdq``, ``a_qdq``, ``fq_linear_fn``, each
linear's input first through QuaRot's online rotation), the
equivalent-transform primitives on the parameter tree (``scale_*``,
``shift_*``; ``special.do_gqa_trans`` scales v's rows and o's repeated
columns under GQA), the static act calibration, the KV-cache fake quant
(``quant.kvcache``: a ``KV_REGISTRY`` module, static qparams from each
block's last K/V), the block loop step and the deployments.

Token reduction (``token_reduction``: ROADMAP A12) raises
``NotImplementedError``.  One process: the JAX package's cross-rank mean of
the act qparams is the identity here (A14).
"""

from __future__ import annotations

import gc
import os
import re
from typing import Any, Dict, List, Optional

import torch

from ...models import arch as A
from ...models.base import Subset, resolve
from ...quant import (QuantSpec, fake_quant_act_dynamic,
                      fake_quant_act_static, fake_quant_weight_dynamic,
                      fake_quant_weight_static, fake_quant_weight_w48,
                      spec_from_config, static_act_qparams)
from ..blockwise import BlockwiseOpt

# config key -> (what it is, the ROADMAP item that ports it)
UNPORTED = {"token_reduction": ("token reduction", "A12")}


class BaseBlockwiseQuantization(BlockwiseOpt):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        self.layer_state: List[Dict[str, Dict[str, Any]]] = [
            {} for _ in range(model.num_blocks)]
        self.set_quant_config()

    # ------------------------------------------------------------------
    def set_quant_config(self) -> None:
        qc = self.quant_config
        self.quant_out = qc.get("quant_out", False)
        for key, (what, item) in UNPORTED.items():
            if qc.get(key):
                raise NotImplementedError(f"quant.{key} ({what}) is not "
                                          f"ported: ROADMAP {item}")
        wcfg = qc.get("weight", {"bit": 8, "symmetric": True,
                                 "granularity": "per_channel"})
        self.w48 = wcfg.get("bit") == 48
        if self.w48:
            self.wspec8 = spec_from_config(wcfg.get("w_2",
                                                    wcfg.get("bit8", {})))
            self.wspec = spec_from_config(wcfg.get("w_1",
                                                   wcfg.get("bit4", {})))
        else:
            self.wspec = spec_from_config(wcfg)
        # mixed bits: quant.w_1 / quant.w_2, each with its layer_names
        self.mix_bits_specs: Dict[str, QuantSpec] = {}
        for sub_key in ("w_1", "w_2"):
            if not self.w48 and sub_key in qc:
                sub = qc[sub_key]
                spec = spec_from_config(sub)
                for lname in sub.get("layer_names", []):
                    self.mix_bits_specs[_canon_name(lname)] = spec

        act = qc.get("act")
        self.w_only = act is None
        self.aspec: Optional[QuantSpec] = None if act is None else \
            spec_from_config(act)
        act = act or {}
        self.act_static = act.get("static", False)
        if self.act_static and self.aspec.granularity != "per_tensor":
            raise ValueError("only per_tensor static act quant supported")
        self.quant_attn = act.get("quant_attn", False)
        self.quant_softmax = act.get("quant_softmax", False)
        self.quant_act_fn = act.get("quant_act_fn", False)

        kvc = qc.get("kvcache")
        self.quant_kvcache = bool(kvc)
        self.kv_module = None
        if kvc:
            from ...registry import KV_REGISTRY

            kvc = dict(kvc)
            kvc["static"] = self.act_static
            self.kv_module = KV_REGISTRY[kvc["method"]](
                kvc.get("quant_type", "int-quant"), kvc,
                self.model.num_blocks)

        special = qc.get("special", {})
        self.special_config = special
        self.online_rotate = special.get("online_rotate", False)
        self.do_gqa_trans = special.get("do_gqa_trans", False)
        arch = self.model.arch
        self.has_gqa = arch.num_kv_heads < arch.num_heads
        self.true_sequential = special.get("true_sequential", False)
        self.weight_clip = special.get("weight_clip", False)
        self.save_scale = special.get("save_scale", False)
        if self.weight_clip or special.get("search_clip_init", False):
            from .auto_clip import AutoClipper

            self.save_clip = special.get("save_clip", False)
            if self.save_clip:
                self.clip_path = special["clip_path"]
            self.auto_clipper = AutoClipper(
                self.wspec, special.get("clip_version", "v1"),
                special.get("clip_sym", self.wspec.symmetric),
                w_only=self.w_only, aspec=self.aspec,
                save_clip=self.save_clip)

        # float layers among the quantized ones
        ig = self.config.get("ignored_layers", None) if self.config else None
        ig = ig or {}
        self.ignored_block_ids = list(ig.get("block_ids", []))
        self.ignored_layer_names = [_canon_name(n)
                                    for n in ig.get("layer_names", [])]
        # per-instance names ("blocks.3.mlp.down"); the reference spells
        # the key 'speical_names', the corrected spelling is read too
        self.ignored_special_names = [
            _canon_name(n) for n in (list(ig.get("speical_names", []))
                                     + list(ig.get("special_names", [])))]

    # ------------------------------------------------------------------
    # per-layer state
    # ------------------------------------------------------------------
    def state(self, block_idx: int, name: str) -> Dict[str, Any]:
        return self.layer_state[block_idx].setdefault(name, {})

    def wspec_for(self, block_idx: int, name: str) -> QuantSpec:
        return self.mix_bits_specs.get(name, self.wspec)

    def is_ignored(self, block_idx: int, name: str) -> bool:
        return (block_idx in self.ignored_block_ids
                or name in self.ignored_layer_names
                or f"blocks.{block_idx}.{name}" in self.ignored_special_names)

    # ------------------------------------------------------------------
    # the fake-quant callbacks
    # ------------------------------------------------------------------
    def w_qdq(self, w: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        """The weight's fake quant: none for an ignored layer; W48; the
        searched static ``qparams``; the learnable range of clip factors;
        else the dynamic range of the layer's spec."""
        if self.is_ignored(block_idx, name):
            return w
        st = self.layer_state[block_idx].get(name, {})
        spec = self.wspec_for(block_idx, name)
        if self.w48:
            return fake_quant_weight_w48(w, self.wspec8, spec)
        if "qparams" in st:
            return fake_quant_weight_static(w, spec, st["qparams"])
        if st.get("upbound_factor") is not None:
            args = {"upbound_factor": st["upbound_factor"],
                    "lowbound_factor": st.get("lowbound_factor")}
            return fake_quant_weight_dynamic(
                w, spec.with_(calib_algo="learnable"), args=args)
        return fake_quant_weight_dynamic(w, spec)

    def a_qdq(self, x: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        if self.w_only or self.is_ignored(block_idx, name):
            return x
        st = self.layer_state[block_idx].get(name, {})
        if self.act_static and "act_qparams" in st:
            return fake_quant_act_static(x, self.aspec, st["act_qparams"])
        return fake_quant_act_dynamic(x, self.aspec)

    def fq_linear_fn(self, block_idx: int) -> A.LinearFn:
        """The fake-quant linear: online rotation, act qdq, then weight
        qdq per call."""

        def lf(name, w, b, x):
            x = self.a_qdq(self.model.apply_online_rotate(name, x),
                           block_idx, name)
            return A.default_linear(name, self.w_qdq(w, block_idx, name), b,
                                    x)

        return lf

    # ------------------------------------------------------------------
    # equivalent-transform primitives on the params tree
    # ------------------------------------------------------------------
    def repeat_gqa_scales(self, scales: torch.Tensor) -> torch.Tensor:
        """Per-KV-head scales (kv_dim) repeated over each head's group of
        query heads (hidden)."""
        arch = self.model.arch
        return scales.reshape(arch.num_kv_heads, arch.head_dim) \
            .repeat_interleave(arch.num_heads // arch.num_kv_heads,
                               dim=0).reshape(-1)

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
        """fc1's output rows /= s, fc2's input columns *= s; under GQA
        with ``do_gqa_trans``, v's rows by the kv_dim s and o's columns by
        s repeated over each KV head's query heads."""
        fc1, fc2 = resolve(bp, fc1_name), resolve(bp, fc2_name)
        s = scales.float()
        out1, in2 = fc1["weight"].shape[0], fc2["weight"].shape[1]
        s2 = s
        if out1 != in2:
            if not (self.has_gqa and self.do_gqa_trans):
                raise ValueError(f"cannot scale fc-fc: {fc1_name}({out1}) "
                                 f"-> {fc2_name}({in2})")
            s2 = self.repeat_gqa_scales(scales).float()
        fc1["weight"] = (fc1["weight"].float() / s[:, None]).to(
            fc1["weight"].dtype)
        if fc1.get("bias") is not None:
            fc1["bias"] = (fc1["bias"].float() / s).to(fc1["bias"].dtype)
        fc2["weight"] = (fc2["weight"].float() * s2[None, :]).to(
            fc2["weight"].dtype)
        self._assert_finite(bp, [fc1_name, fc2_name])

    def shift_ln_fcs(self, bp: Dict, ln_name: str, fc_names: List[str],
                     shifts: torch.Tensor) -> None:
        """ln's bias -= shift; each fc's bias += W @ shift."""
        ln = resolve(bp, ln_name)
        sh = shifts.float()
        if ln.get("bias") is not None:
            ln["bias"] = (ln["bias"].float() - sh).to(ln["bias"].dtype)
        for fn in fc_names:
            self._add_bias(resolve(bp, fn), sh)

    def shift_fc_fc(self, bp: Dict, fc1_name: str, fc2_name: str,
                    shifts: torch.Tensor) -> None:
        """fc1's bias -= shift; fc2's bias += W2 @ shift."""
        fc1 = resolve(bp, fc1_name)
        sh = shifts.float()
        if fc1.get("bias") is not None:
            fc1["bias"] = (fc1["bias"].float() - sh).to(fc1["bias"].dtype)
        self._add_bias(resolve(bp, fc2_name), sh)

    @staticmethod
    def _add_bias(fc: Dict, sh: torch.Tensor) -> None:
        delta = fc["weight"].float() @ sh
        if fc.get("bias") is not None:
            fc["bias"] = (fc["bias"].float() + delta).to(fc["bias"].dtype)
        else:
            fc["bias"] = delta.to(fc["weight"].dtype)

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

    def apply_shift(self, bp: Dict, subset: Subset,
                    shifts: Optional[torch.Tensor]) -> None:
        if shifts is None:
            return
        if subset.prev_type == "linear":
            self.shift_fc_fc(bp, subset.prev_op, subset.layers[0], shifts)
        elif subset.prev_type == "norm":
            self.shift_ln_fcs(bp, subset.prev_op, list(subset.layers),
                              shifts)

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
                          subset: Subset, scales: torch.Tensor,
                          is_gqa: bool = False) -> None:
        """Divide the cached inputs of the subset's layers by the applied
        scale (repeated over the query heads where ``is_gqa``)."""
        if is_gqa:
            scales = self.repeat_gqa_scales(scales)
        for lname in subset.layers:
            if lname in feats:
                feats[lname] = [x / scales for x in feats[lname]]

    # ------------------------------------------------------------------
    # static act calibration
    # ------------------------------------------------------------------
    def register_act_qparams(self, block_idx: int,
                             feats: Dict[str, List[torch.Tensor]]) -> None:
        """Each linear's static act qparams from its collected inputs."""
        if not (self.act_static and self.aspec is not None):
            return
        for name in self.model.get_block_linear_names(block_idx):
            if name in feats:
                self.state(block_idx, name)["act_qparams"] = \
                    static_act_qparams(feats[name], self.aspec)

    # ------------------------------------------------------------------
    def block_opt(self, block_idx: int) -> None:
        feats, outs = self.collect_block_io(block_idx)
        if not self.quant_out:
            # the float (pre-transform) outputs feed the next block
            self.input_batches = outs
        self.block_transform(block_idx, feats)
        self.register_act_qparams(block_idx, feats)
        kvs = getattr(self, "_last_kv_states", None)
        if self.quant_kvcache and self.kv_module.static and kvs:
            self.kv_module.calibrate(block_idx, [kv[0] for kv in kvs],
                                     [kv[1] for kv in kvs])
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
        current (transformed) params; 'fake_quant': ``w_qdq`` baked into a
        copy of every block's linears (the float blocks kept for
        ``restore_float``), the online rotation and act quant as each
        block's linear function, the KV-cache fake quant as each block's
        KV hook, and the attention's quant hooks under ``quant_attn``;
        'fake_quant_wo_kv': the same without the KV hooks."""
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
        model.linear_fns = None if self.w_only else [
            self._act_linear_fn(idx) for idx in range(model.num_blocks)]
        model.kv_hooks = [self.kv_module.make_hook(idx)
                          for idx in range(model.num_blocks)] \
            if self.quant_kvcache and mode == "fake_quant" else None
        if self.quant_attn and self.aspec is not None:
            aspec = self.aspec

            def matmul_hook(which, a, b):
                return (fake_quant_act_dynamic(a, aspec),
                        fake_quant_act_dynamic(b, aspec))

            model.attn_matmul_hook = matmul_hook
            if self.quant_softmax:
                # softmax outputs lie in [0, 1]: asymmetric
                sspec = aspec.with_(symmetric=False)
                model.attn_softmax_hook = \
                    lambda p: fake_quant_act_dynamic(p, sspec)

    def _act_linear_fn(self, block_idx: int) -> A.LinearFn:
        def lf(name, w, b, x):
            x = self.model.apply_online_rotate(name, x)
            return A.default_linear(name, w, b,
                                    self.a_qdq(x, block_idx, name))

        return lf

    def restore_float(self) -> None:
        model = self.model
        if hasattr(model, "_fp_blocks"):
            model.set_param_blocks(model._fp_blocks)
            del model._fp_blocks
        model.attn_matmul_hook = None
        model.attn_softmax_hook = None
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


_NAME_TABLE = {
    "q_proj": "attn.q", "k_proj": "attn.k", "v_proj": "attn.v",
    "o_proj": "attn.o", "out_proj": "attn.o",
    "gate_proj": "mlp.gate", "up_proj": "mlp.up", "down_proj": "mlp.down",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def _canon_name(name: str) -> str:
    """A reference or HF layer name as a canonical short name; a
    per-instance name keeps its block: 'model.layers.3.self_attn.q_proj'
    -> 'blocks.3.attn.q'."""
    m = re.search(r"(?:layers|blocks|h)\.(\d+)\.", name)
    prefix = f"blocks.{m.group(1)}." if m else ""
    for k, v in _NAME_TABLE.items():
        if k in name:
            return prefix + v
    return name
