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

A fifth, ``rows``, holds JAX's other serving weights, with raw zero
points (JAX's dequant ``(u - z) * s``):

* 4 bits: the vLLM-order nibbles of ``w4_matmul.pack_int4`` (N, K/8) int32,
  f32 scales and zeros (N, G), applied dequant-then-matmul;
* 8 bits (``bits`` 8, what JAX labels every integer width but 4): the
  codes (int8 at 8 bits, int32 below) with f32 scales (N, 1) or (1,),
  symmetric, applied by ``scaled_matmul.int8_matmul_dynamic``;
* float (``is_float``, e4m3 or e5m2): the codes with f32 scales (N, G),
  applied dequant-then-matmul (``qlinear_plain``, JAX's ``qlinear_xla``).

JAX builds three more ``rows`` weights that its serving path then fails
on; ``quantize_linear`` raises ``NotImplementedError`` naming each
(``REFERENCE_FAULTS``): asymmetric integer codes below 4 or above it
(fault 1: their zeros are dropped), grouped integer codes other than 4
bits (fault 2: a broadcast error) and per-block or per-tensor float codes
(fault 3: the dequant's reshape fails).

Stacked MoE experts (``serving.quantized_model.quantize_linear_stacked``)
use the same class with a leading expert dim: ``stacked_planes`` (4-bit
planes per expert) or ``stacked`` (JAX's ``rows`` per expert: the int8
per-channel fallback of planes-ineligible W4 experts, ``bits`` 8; the
int4 ``rows`` storage; other widths and floats).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant import QuantSpec, real_quant_weight
from .w4_matmul import (GROUP, pack_int4, pack_int4_planes, pack_s4_pairs,
                        s4_matmul_available, unpack_int4, unpack_int4_planes,
                        unpack_s4_pairs, w4a8_matmul, w4a8_matmul_ks,
                        w4a8_prefill_available, w4a8_s4_matmul, w4a16_matmul,
                        w4a16_matmul_available)

LAYOUTS = ("planes", "s4", "rows")

# the JAX serving builds its own serving path then fails on (ROADMAP C)
REFERENCE_FAULTS = {
    1: "asymmetric integer codes other than 4 bits go to "
       "int8_matmul_dynamic with their zeros dropped (a wrong output)",
    2: "grouped integer codes other than 4 bits are labelled bits=8 and "
       "fail in int8_matmul_dynamic's w_scales.reshape(-1) (ValueError: "
       "Incompatible shapes for broadcasting)",
    3: "per-block and per-tensor float codes fail in dequant_weight's "
       "reshape (TypeError: cannot reshape array)",
}


def reference_fault(n: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: reference fault {n} (ROADMAP C): the JAX serving path "
        f"fails here: {REFERENCE_FAULTS[n]}; no fix is guessed")


@dataclasses.dataclass
class QLinearParams:
    codes: torch.Tensor  # planes, planes_ks (N, K/8) int32 | s4 (N, K/2)
    scales: torch.Tensor  # (N, G)
    # (N, G) premultiplied: z*s (planes), (z-8)*s (s4); raw z (rows) or None
    zeros: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    group_size: int = 0  # 0 = per channel (G = 1)
    layout: str = "planes"
    # the JAX package holds this linear in its pre-tiled serving layout
    # (planes: the condition above; s4: always), which its kernels and
    # the fused decode linears take
    tiled: bool = False
    # the codes' bit width: 4, or 8 for JAX's every other integer width
    bits: int = 4
    # float codes (e4m3, e5m2), ``bits`` 8
    is_float: bool = False


def _rows_8(codes: torch.Tensor, scales: torch.Tensor,
            zeros: Optional[torch.Tensor], bias, spec: QuantSpec
            ) -> QLinearParams:
    """JAX's weights of every width but 4 (``rows``, ``bits`` 8), refused
    where its serving path fails on them."""
    gs = spec.group_size if spec.granularity == "per_group" else 0
    if spec.is_float:
        if spec.granularity in ("per_block", "per_tensor"):
            raise reference_fault(
                3, f"{spec.bit} {spec.granularity} serving weights")
        return QLinearParams(codes, scales.float(), None, bias, 0, "rows",
                             False, 8, True)
    if gs:
        raise reference_fault(
            2, f"{spec.bit}-bit per-group serving weights (group {gs})")
    if zeros is not None:
        raise reference_fault(
            1, f"asymmetric {spec.bit}-bit serving weights")
    return QLinearParams(codes, scales.float(), None, bias, 0, "rows", False,
                         8)


def quantize_linear(w: torch.Tensor, spec: QuantSpec,
                    bias: Optional[torch.Tensor] = None,
                    layout: str = "planes") -> QLinearParams:
    """RTN real quant of one serving linear.  4 bits: ``layout`` "planes",
    "s4" (with JAX's fallback to planes where its shapes do not fit) or
    "rows"; any other width or float format is stored ``rows`` whatever
    ``layout`` says, as in JAX."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not ported; {LAYOUTS}")
    codes, scales, zeros = real_quant_weight(w.float(), spec)
    if spec.is_float or spec.bit != 4:
        return _rows_8(codes, scales, zeros, bias, spec)
    gs = spec.group_size if spec.granularity == "per_group" else 0
    s4 = scales.float()
    if zeros is None:
        # symmetric codes are signed; the packings hold unsigned nibbles
        codes = codes.to(torch.int32) + 8
        z4 = torch.full_like(s4, 8.0)
    else:
        z4 = zeros.float()
    N, K = codes.shape
    if layout == "rows":
        return QLinearParams(pack_int4(codes), s4, z4, bias, gs, "rows",
                             False)
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
    """Materialize the (N, K) weight: c*s - zs per group (planes, s4),
    (u - z)*s (rows), codes times their scales (8 bits, float)."""
    if qp.bits == 8:
        c = qp.codes.float()
        N, K = c.shape
        # one scale a row (N, 1), a float's per group (N, G), or one a
        # tensor (1,)
        s = qp.scales.float()
        s = s.expand(N, 1) if s.numel() == 1 else s.reshape(N, -1)
        w = c.reshape(N, s.shape[1], -1) * s[..., None]
        return w.reshape(N, K).to(dtype)
    if qp.layout == "rows":
        u = unpack_int4(qp.codes).float()
        N, K = u.shape
        G = qp.scales.shape[1]
        w = ((u.reshape(N, G, -1) - qp.zeros.float()[..., None])
             * qp.scales.float()[..., None])
        return w.reshape(N, K).to(dtype)
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
