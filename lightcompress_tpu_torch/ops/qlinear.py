"""Quantized linear layers (port of lightcompress_tpu/ops/qlinear.py).

Storage (QLinearParams), int4 only, in one of two layouts
(``ops.w4_matmul``):

* ``planes``: codes plane-packed (N, K/8) int32, per-group scales and
  premultiplied zero corrections zs = z*s, (N, G).  Where the JAX package
  builds its pre-tiled serving layout (per-group, (K/8) % g == 0 and
  N % 128 == 0; ``tiled``) they are bf16, rounded from the f32 products
  exactly as there; elsewhere f32;
* ``s4``: group-pair bytes (N, K/2) int8 of c' = u - 8, bf16 scales and
  zs = (z - 8)*s, (N, G).  JAX takes it only at groups of 128 with
  K % 512 == 0 and N % 128 == 0 and falls back to planes elsewhere.

Symmetric codes are offset by +8 with z = 8.

A third layout, ``planes_ks``, is the JAX bench's K-split down projection
(``bench.py`` with ``BENCH_KSPLIT=1``): the same planes arrays (bf16 s and
zs), applied by #5 in two K halves (``w4_matmul.w4a8_matmul_ks``).
``quantize_linear`` does not build it; ``convert`` reads the JAX tiles.

A fourth, ``masked``, is the bench's ``BENCH_MASKED`` linear: masked
planes with pre-divided scales and zero corrections (``w4_matmul``'s
``pack_int4_planes_masked``), f32 or bf16, applied by #4 through the
bench's own dispatch, as the root bench applies it.

Stacked MoE experts (``serving.quantized_model.quantize_linear_stacked``)
use the same class with a leading expert dim: ``stacked_planes`` (4-bit
planes per expert) or ``stacked`` (the int8 per-channel fallback, ``bits``
8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant import QuantSpec, real_quant_weight
from .w4_matmul import (GROUP, pack_int4_planes, pack_s4_pairs,
                        s4_matmul_available, unpack_int4_planes,
                        unpack_s4_pairs, w4a8_matmul, w4a8_matmul_ks,
                        w4a8_prefill_available, w4a8_s4_matmul, w4a16_matmul,
                        w4a16_matmul_available)

LAYOUTS = ("planes", "s4")


@dataclasses.dataclass
class QLinearParams:
    codes: torch.Tensor  # planes, planes_ks (N, K/8) int32 | s4 (N, K/2)
    scales: torch.Tensor  # (N, G)
    zeros: torch.Tensor  # (N, G) premultiplied: z*s (planes), (z-8)*s (s4)
    bias: Optional[torch.Tensor]
    group_size: int = 0  # 0 = per channel (G = 1)
    layout: str = "planes"
    # the JAX package holds this linear in its pre-tiled serving layout
    # (planes: the condition above; s4: always), which its kernels and
    # the fused decode linears take
    tiled: bool = False
    # the codes' bit width: 4, or 8 for the stacked int8 fallback
    bits: int = 4


def quantize_linear(w: torch.Tensor, spec: QuantSpec,
                    bias: Optional[torch.Tensor] = None,
                    layout: str = "planes") -> QLinearParams:
    if spec.bit != 4:
        raise ValueError(f"{spec.bit}-bit serving linears are not ported")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not ported; {LAYOUTS}")
    codes, scales, zeros = real_quant_weight(w.float(), spec)
    gs = spec.group_size if spec.granularity == "per_group" else 0
    s4 = scales.float()
    if zeros is None:
        # symmetric codes are signed; the packings hold unsigned nibbles
        codes = codes.to(torch.int32) + 8
        z4 = torch.full_like(s4, 8.0)
    else:
        z4 = zeros.float()
    N, K = codes.shape
    if layout == "s4":
        if gs == GROUP and K % (4 * gs) == 0 and N % 128 == 0:
            # the stored code is c' = u - 8, so w = c'*s - (z - 8)*s
            # (exactly 0 for symmetric weights)
            return QLinearParams(
                pack_s4_pairs(codes), s4.to(torch.bfloat16),
                ((z4 - 8.0) * s4).to(torch.bfloat16), bias, gs, "s4", True)
        layout = "planes"  # the JAX fallback where the shapes don't fit
    packed = pack_int4_planes(codes)
    zs = z4 * s4
    tiled = bool(gs) and packed.shape[1] % gs == 0 and N % 128 == 0
    if tiled:
        s4, zs = s4.to(torch.bfloat16), zs.to(torch.bfloat16)
    return QLinearParams(packed, s4, zs, bias, gs, "planes", tiled)


def dequant_weight(qp: QLinearParams,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Materialize the (N, K) weight: c*s - zs per group."""
    if qp.layout == "s4":
        c = unpack_s4_pairs(qp.codes).float()
    else:
        c = unpack_int4_planes(qp.codes, qp.codes.shape[1] * 8).float()
    N, K = c.shape
    c = c.reshape(N, qp.scales.shape[1], -1)
    w = c * qp.scales.float()[..., None] - qp.zeros.float()[..., None]
    return w.reshape(N, K).to(dtype)


def qlinear_plain(x: torch.Tensor, qp: QLinearParams) -> torch.Tensor:
    """Dequant-then-matmul (the JAX ``qlinear_xla``): bf16 operands, f32
    accumulation, result in ``x.dtype``."""
    w = dequant_weight(qp, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    if x.dtype == torch.bfloat16:
        y = torch.matmul(xb, w.t())  # f32 accumulation, one bf16 rounding
    else:
        y = torch.matmul(xb.float(), w.float().t()).to(x.dtype)
    if qp.bias is not None:
        y = y + qp.bias
    return y


def qlinear_apply(x: torch.Tensor, qp: QLinearParams,
                  act_bits: int = 16) -> torch.Tensor:
    """Route a W4 linear as the JAX ``qlinear_apply`` does on a TPU: at
    ``act_bits=8`` the s4 kernel (#12, M <= 256) or the planes W4A8
    kernels (#2 decode, #3 prefill); the W4A16 kernel (#1) at decode;
    dequant-then-matmul otherwise.  On the CPU the kernels' plain versions
    run.  ``planes_ks`` takes #5 at ``act_bits=8`` (any M) and raises at
    16, where the JAX dispatch sends it to ``qlinear_xla``, whose dequant
    cannot read that layout."""
    if act_bits == 8 and s4_matmul_available(x, qp):
        return w4a8_s4_matmul(x, qp, qp.bias)
    if qp.layout == "planes_ks":
        if act_bits != 8:
            raise NotImplementedError(
                "planes_ks at act_bits=16: the JAX dispatch sends it to "
                "qlinear_xla, whose dequant cannot read the K-split tiles")
        return w4a8_matmul_ks(x, qp, qp.bias)
    if act_bits == 8 and w4a8_prefill_available(x, qp):
        return w4a8_matmul(x, qp, qp.bias)
    if w4a16_matmul_available(x, qp):
        if act_bits == 8:
            return w4a8_matmul(x, qp, qp.bias)
        lead = x.shape[:-1]
        y = w4a16_matmul(x.reshape(-1, x.shape[-1]), qp.codes, qp.scales,
                         qp.zeros)
        if qp.bias is not None:
            y = y + qp.bias
        return y.reshape(*lead, -1)
    return qlinear_plain(x, qp)
