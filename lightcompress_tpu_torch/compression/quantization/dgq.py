"""DGQ, dual-grain quantization (port of
lightcompress_tpu/compression/quantization/dgq.py).

SmoothQuant's act-scale migration (alpha 0.5) into each norm -> linears
subset and the up -> down outlier smoothing (``_smooth_mlp``), then, for
every linear of every subset, on its first calibration batch
(``dgq_search_scale_zero``): per group of ``w_1``'s group size, the
asymmetric int4 qparams over 20 cumulative clamp ratios with the least
output MSE per row; then the symmetric per-channel int8 outer scale over
80 clamp ratios, the int4 scales snapped to integer multiples of it.  The
deployment (``dgq_fake_quant``) clips the int4 codes so that (q - z) *
multiplier fits int8.

The config's ``quant.weight`` holds ``w_1`` (the int4 inner spec) and
``w_2`` (the int8 outer one), as the JAX package reads it.  The JAX
package compiles the search (``jax.jit`` with ``lax.scan`` and
``lax.fori_loop``); the port takes XLA's arithmetic (divisions by
constants as products with the reciprocal, means as sums times 1/n) and
runs the groups of a layer together.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.base import Subset, resolve
from ...quant import fake_quant_weight_w48, spec_from_config
from ...quant.quantizer import mean_xla, recip
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


def _aq_sym(x: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    """Per-token symmetric int fake quant (compiled)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-5) * recip(qmax)
    return (torch.round(x / s)).clamp(qmin, qmax) * s


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    return t.double().sqrt().float()


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as one IEEE division (PyTorch takes a Python number over a
    tensor as t's reciprocal times c)."""
    return t.new_tensor(c) / t


def _ratio(i: int, n: int, span: float) -> float:
    """1.02 - (i + 1) / n * span in f32 as XLA compiles it: 1/n * span
    folded into one f32 constant c, then 1.02 - (i + 1) * c as one fused
    multiply-add."""
    f = np.float32
    c = f(f(recip(n)) * f(span))
    return float(f(np.float64(f(1.02)) - np.float64(f(i + 1.0)) * c))


def dgq_search_scale_zero(W: torch.Tensor, X: torch.Tensor, gs: int,
                          w_only: bool = True):
    """(integer multipliers (O, n_g), zeros (O, n_g), scale8 (O,)) of one
    layer W (O, IN) from calibration rows X (L, IN)."""
    O, IN = W.shape
    n_g = IN // gs
    W, X = W.float(), X.float()
    dev = W.device
    # stage 1: every group's int4 qparams, the groups side by side
    Wg = W.reshape(O, n_g, gs).transpose(0, 1)  # (n_g, O, gs)
    Xg = X.reshape(-1, n_g, gs).transpose(0, 1)  # (n_g, L, gs)
    org = Xg @ Wg.transpose(1, 2)  # (n_g, L, O)
    w_max = Wg.amax(dim=-1, keepdim=True)
    w_min = Wg.amin(dim=-1, keepdim=True)
    Xq = Xg if w_only else _aq_sym(Xg, -128.0, 127.0)
    Wc = Wg
    best_loss = torch.full((n_g, O), torch.inf, device=dev)
    bs = torch.ones((n_g, O, 1), device=dev)
    bz = torch.ones((n_g, O, 1), device=dev)
    for i in range(20):
        r = _ratio(i, 20, 0.22)
        Wc = torch.minimum(torch.maximum(Wc, w_min * r), w_max * r)
        mx = Wc.amax(dim=-1, keepdim=True)
        mn = Wc.amin(dim=-1, keepdim=True)
        s = (mx - mn).clamp_min(1e-5) * recip(15.0)
        z = (-torch.round(mn / s)).clamp(0.0, 15.0)
        q = (torch.round(Wc / s) + z).clamp(0.0, 15.0)
        out = Xq @ ((q - z) * s).transpose(1, 2)
        loss = mean_xla((org - out) ** 2, 1)  # (n_g, O)
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        bs = torch.where(better[..., None], s, bs)
        bz = torch.where(better[..., None], z, bz)
    best_scales = bs[..., 0].T  # (O, n_g)
    best_zeros = bz[..., 0].T
    # stage 2: the int8 outer scale
    org_full = X @ W.T
    Xq_full = X if w_only else _aq_sym(X, -128.0, 127.0)
    w_amax = W.abs().amax(dim=-1, keepdim=True)
    Wr = W.reshape(O, n_g, gs)
    best_loss = torch.full((O,), torch.inf, device=dev)
    best_s8 = torch.zeros((O, 1), device=dev)
    for i in range(80):
        r = _ratio(i, 80, 0.82)
        clamped = torch.minimum(torch.maximum(W, -w_amax * r), w_amax * r)
        s8 = clamped.abs().amax(dim=-1, keepdim=True).clamp_min(1e-5) \
            * recip(127.0)
        mult = torch.round(best_scales / s8).clamp_min(1.0)
        int_max = torch.round(_over(127.0, s8))
        upper = (best_zeros + int_max).clamp(max=15.0)
        lower = (best_zeros - int_max).clamp(min=0.0)
        s4 = (mult * s8)[:, :, None]
        z = best_zeros[:, :, None]
        q = torch.minimum(torch.maximum(torch.round(Wr / s4) + z,
                                        lower[:, :, None]),
                          upper[:, :, None])
        out = Xq_full @ ((q - z) * s4).reshape(O, IN).T
        loss = mean_xla((org_full - out) ** 2, 0)
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best_s8 = torch.where(better[:, None], s8, best_s8)
    scales = torch.round(best_scales / best_s8).clamp_min(1.0)
    return scales, best_zeros, best_s8[:, 0]


def dgq_fake_quant(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                   scale8: torch.Tensor) -> torch.Tensor:
    """The static W48 fake quant of the searched (multiplier, zero, s8):
    int4 codes clipped to zeros +- round(127 / multiplier) and [0, 15]."""
    O, IN = w.shape
    n_g = scales.shape[1]
    s4 = (scales * scale8[:, None])[:, :, None]
    int_max = torch.round(_over(127.0, scales))
    upper = torch.clamp(zeros + int_max, max=15.0)[:, :, None]
    lower = torch.clamp(zeros - int_max, min=0.0)[:, :, None]
    z = zeros[:, :, None]
    wg = w.float().reshape(O, n_g, IN // n_g)
    q = torch.minimum(torch.maximum(torch.round(wg / s4) + z, lower), upper)
    return ((q - z) * s4).reshape(O, IN).to(w.dtype)


@ALGO_REGISTRY
class DGQ(BaseBlockwiseQuantization):
    def set_quant_config(self) -> None:
        qc = self.quant_config
        w = qc["weight"]
        if "w_1" not in w or "w_2" not in w:
            raise ValueError(
                "DGQ reads quant.weight.w_1 (int4 inner) and w_2 (int8 "
                "outer); a flat weight section fails in the JAX package "
                "with KeyError: 'w_1' (a reference fault, ROADMAP C)")
        self.wspec = spec_from_config(w["w_1"])
        self.wspec8 = spec_from_config(w["w_2"])
        act = qc.get("act")
        self.w_only = act is None
        self.aspec = None if act is None else spec_from_config(act)
        # no static act quant, attention quant, KV quant, true-sequential
        # pass or GQA transform, as in the JAX package's DGQ
        self.act_static = self.quant_attn = self.quant_softmax = False
        self.kv_module = None
        self.quant_kvcache = self.true_sequential = self.do_gqa_trans = False
        self.special_config = qc.get("special", {})
        self.quant_out = qc.get("quant_out", False)
        self.ignored_block_ids = []
        self.ignored_layer_names = []
        self.ignored_special_names = []
        arch = self.model.arch
        self.has_gqa = arch.num_kv_heads < arch.num_heads

    def subset_transform(self, block_idx, bp, subset: Subset, input_feat):
        if subset.prev_type == "norm":
            from .smoothquant import SmoothQuant

            w_max = SmoothQuant.get_weight_scale(self, bp, subset.layers)
            x_max = SmoothQuant.get_act_scale(input_feat[subset.input])
            # the roots rounded once from f64, as on every device (JAX's
            # eager f32 pow differs from them in ~0.08% of inputs)
            scale = (_sqrt(x_max) / _sqrt(w_max)).clamp_min(1e-5)
            self.apply_scale(bp, subset, scale)
            self.update_input_feat(input_feat, subset, scale)
        elif subset.layers == ("mlp.down",):
            from .smoothquant import SmoothQuant

            self._smooth_mlp(bp, SmoothQuant.get_act_scale(
                input_feat[subset.input]))
        gs = self.wspec.group_size
        for name in subset.layers:
            if self.is_ignored(block_idx, name):
                continue
            feats = input_feat.get(name) or input_feat.get(subset.input)
            if not feats:
                continue
            W = resolve(bp, name)["weight"].float()
            scales, zeros, scale8 = dgq_search_scale_zero(
                W, feats[0].reshape(-1, W.shape[1]), min(gs, W.shape[1]),
                self.w_only)
            self.state(block_idx, name)["dgq"] = {
                "scales": scales, "zeros": zeros, "scale8": scale8}

    def _smooth_mlp(self, bp, act_scales: torch.Tensor) -> None:
        """up's rows / s, down's columns * s, s = max|x| / the 0.5%
        quantile's baseline beyond it (numpy f64, as the JAX package)."""
        sc = act_scales.cpu().numpy().astype(np.float64)
        order = np.argsort(sc)
        baseline = sc[order[-int(len(sc) * 0.005 + 1.5)]]
        if baseline < 1e-4:
            return
        scales = sc / baseline
        scales[sc <= baseline] = 1.0
        s = torch.tensor(scales, dtype=torch.float32,
                         device=act_scales.device)
        up, down = resolve(bp, "mlp.up"), resolve(bp, "mlp.down")
        up["weight"] = (up["weight"].float() / s[:, None]).to(
            up["weight"].dtype)
        if up.get("bias") is not None:
            up["bias"] = (up["bias"].float() / s).to(up["bias"].dtype)
        down["weight"] = (down["weight"].float() * s[None, :]).to(
            down["weight"].dtype)

    def w_qdq(self, w, block_idx, name):
        if self.is_ignored(block_idx, name):
            return w
        d = self.layer_state[block_idx].get(name, {}).get("dgq")
        if d is not None:
            return dgq_fake_quant(w, d["scales"], d["zeros"], d["scale8"])
        # a layer without calibration input: the minmax W48
        return fake_quant_weight_w48(w, self.wspec8, self.wspec)
