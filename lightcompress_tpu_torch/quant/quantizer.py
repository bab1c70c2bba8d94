"""The quantizer core (port of lightcompress_tpu/quant/quantizer.py).

- Granularities (``reshape_tensor`` / ``restore_tensor``): per_tensor,
  per_channel, per_group (padded on request), per_head, per_block.
- Ranges: minmax, mse (the shrink grid), learnable (sigmoid clip
  factors), hqq (proximal zero points); the static act ranges over
  calibration batches (minmax, moving minmax, the histogram search).
- Integer formats and the float formats (``float_round``: round to
  nearest even on an (e, m) grid with saturation and subnormals, in exact
  power-of-two arithmetic; the ``ref_manual`` per-element scale).
- Fake quant of weights (dynamic, static, W48) and acts (dynamic,
  static); real quant to storage codes; the block-FP8 weight round trip.

Rounding is ``torch.round`` (half to even), as ``jnp.round`` is.  Every
division by a number goes through ``device.div``, with one exception:
where the JAX package's code is compiled (the mse grid, hqq's loop,
GPTQ's group qparams, the clip and scale searches), XLA divides by a
constant as a product with its f32 reciprocal, takes ``jnp.mean`` as a sum
times 1/n and fuses multiply-adds on the CPU; the port mirrors that
arithmetic only here (``recip``, ``fma``, ``mean_xla``, and
``compiled_qparams``/``compiled_qdq``, which the searches call).  The JAX package's
``lax`` loops are plain loops here, with no host read inside: the mse
grid keeps its best range on the device; hqq's early stop is a device
flag that freezes the state, so the loop always runs ``iters`` times.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import div
from .spec import QuantSpec


class QParams(NamedTuple):
    """Quantization parameters for one tensor in its grouped view."""

    scales: torch.Tensor
    zeros: torch.Tensor  # 0-d 0.0 when symmetric


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def recip(d: float) -> float:
    """The f32 reciprocal of d.  XLA compiles a division by a constant as
    a product with this reciprocal (inside a jitted function or a ``lax``
    loop, and in ``jnp.mean``); the port takes the same product where the
    JAX package's code is compiled so, and ``device.div`` elsewhere."""
    return float(np.float32(1.0) / np.float32(d))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32 (through f64, where a product of two
    f32s is exact), as XLA's CPU code fuses a multiply and an add."""
    return (a.double() * b.double() + c.double()).float()


def mean_xla(t: torch.Tensor, dim=None, keepdim: bool = False
             ) -> torch.Tensor:
    """``jnp.mean``'s arithmetic: the sum times the f32 reciprocal of the
    count."""
    if dim is None:
        return t.sum() * recip(t.numel())
    return t.sum(dim=dim, keepdim=keepdim) * recip(t.shape[dim])


# ---------------------------------------------------------------------------
# granularity
# ---------------------------------------------------------------------------

def reshape_tensor(t: torch.Tensor, spec: QuantSpec,
                   allow_padding: bool = False) -> torch.Tensor:
    """Reshape to the view whose rows are the quantization groups (per
    block: (M/bs, bs, N/bs, bs), zero-padded)."""
    if spec.granularity == "per_group":
        gs = spec.group_size
        if t.shape[-1] >= gs:
            if t.shape[-1] % gs == 0:
                return t.reshape(-1, gs)
            if allow_padding:
                pad = gs - t.shape[-1] % gs
                return torch.nn.functional.pad(t, (0, pad)).reshape(-1, gs)
            raise ValueError(f"dim {t.shape[-1]} not divisible by group "
                             f"size {gs}")
        return t
    if spec.granularity == "per_head":
        return t.reshape(spec.head_num, -1)
    if spec.granularity == "per_block":
        m, n = t.shape
        bs = spec.block_size
        mp, np_ = _cdiv(m, bs) * bs, _cdiv(n, bs) * bs
        tp = t.new_zeros((mp, np_))
        tp[:m, :n] = t
        return tp.reshape(mp // bs, bs, np_ // bs, bs)
    return t


def restore_tensor(t: torch.Tensor, shape: Tuple[int, ...],
                   spec: QuantSpec) -> torch.Tensor:
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    if spec.granularity == "per_block":
        mp = t.shape[0] * t.shape[1]
        return t.reshape(mp, -1)[:shape[0], :shape[1]]
    if t.numel() == math.prod(shape):
        return t.reshape(shape)
    # the padded per-group view
    return t.reshape(*shape[:-1], -1)[..., :shape[-1]]


# ---------------------------------------------------------------------------
# ranges
# ---------------------------------------------------------------------------

def minmax_range(t: torch.Tensor, spec: QuantSpec):
    """Per row (per block: of |t|, by design)."""
    if spec.granularity == "per_tensor":
        return t.min(), t.max()
    if spec.granularity == "per_block":
        a = t.abs().float()
        return (a.amin(dim=(1, 3), keepdim=True),
                a.amax(dim=(1, 3), keepdim=True))
    return t.amin(dim=-1, keepdim=True), t.amax(dim=-1, keepdim=True)


def mse_range(t: torch.Tensor, spec: QuantSpec, norm: float = 2.4):
    """The shrink-grid search: for p = 1 - i / mse_grid, i < maxshrink *
    mse_grid, the range p * (min, max) whose qdq error sum |q - t|^norm per
    row is least (a later p only where strictly less)."""
    t = t.float()
    mn, mx = minmax_range(t, spec)
    best_err = torch.full(() if spec.granularity == "per_tensor"
                          else mn.shape, float("inf"), device=t.device)
    best_mn, best_mx = mn, mx
    for i in range(int(spec.maxshrink * spec.mse_grid)):
        # 1 - i / mse_grid as JAX's compiled loop takes it: one fused
        # multiply-add by the reciprocal, rounded once to f32
        p = float(np.float32(1.0 - i * recip(spec.mse_grid)))
        xmin, xmax = p * mn, p * mx
        q = compiled_qdq(t, (xmin, xmax), spec)
        err = ((q - t).abs() ** norm).sum(dim=-1, keepdim=True)
        if spec.granularity == "per_tensor":
            err = err.sum()
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_mn = torch.where(better, xmin, best_mn)
        best_mx = torch.where(better, xmax, best_mx)
    return best_mn, best_mx


def learnable_range(t: torch.Tensor, spec: QuantSpec,
                    lowbound_factor: Optional[torch.Tensor] = None,
                    upbound_factor: Optional[torch.Tensor] = None):
    """The minmax range scaled by sigmoid clip factors (AWQ's clip v2,
    OmniQuant's learnable clipping)."""
    mn, mx = minmax_range(t, spec)
    if spec.symmetric:
        if upbound_factor is not None:
            amax = torch.maximum(mx.abs(), mn.abs()).clamp_min(1e-5) \
                * torch.sigmoid(upbound_factor)
            return -amax, amax
        return mn, mx
    if upbound_factor is not None and lowbound_factor is not None:
        return (torch.sigmoid(lowbound_factor) * mn,
                torch.sigmoid(upbound_factor) * mx)
    return mn, mx


def get_tensor_range(t: torch.Tensor, spec: QuantSpec,
                     args: Optional[dict] = None):
    args = args or {}
    if spec.calib_algo == "mse":
        return mse_range(t, spec)
    if spec.calib_algo == "learnable":
        return learnable_range(t, spec, args.get("lowbound_factor"),
                               args.get("upbound_factor"))
    return minmax_range(t, spec)


# ---------------------------------------------------------------------------
# qparams
# ---------------------------------------------------------------------------

def qparams_from_range(tensor_range, spec: QuantSpec) -> QParams:
    """Scales and zero points from a (min, max) range."""
    return _qparams(tensor_range, spec, div)


def compiled_qparams(tensor_range, spec: QuantSpec) -> QParams:
    """``qparams_from_range`` as XLA compiles it inside the JAX package's
    loops and jitted searches: the division by the format's range a
    product with its reciprocal."""
    return _qparams(tensor_range, spec, lambda t, d: t * recip(d))


def compiled_qdq(t: torch.Tensor, tensor_range,
                 spec: QuantSpec) -> torch.Tensor:
    """t's fake quant with ``compiled_qparams`` of the range: a search's
    candidate, as the JAX package's compiled search takes it."""
    return quant_dequant(t, compiled_qparams(tensor_range, spec), spec)


def _qparams(tensor_range, spec: QuantSpec, by) -> QParams:
    mn, mx = tensor_range
    qmin, qmax = spec.qmin, spec.qmax
    if spec.symmetric or spec.is_float:
        amax = torch.maximum(mx.abs(), mn.abs()).clamp_min(1e-5)
        return QParams(by(amax, qmax),
                       torch.zeros((), dtype=torch.float32, device=mn.device))
    scales = by((mx - mn).clamp_min(1e-5), qmax - qmin)
    if spec.round_zp:
        zeros = (qmin - torch.round(mn / scales)).clamp(qmin, qmax)
    else:
        zeros = qmin - mn / scales
    return QParams(scales, zeros)


# ---------------------------------------------------------------------------
# float rounding
# ---------------------------------------------------------------------------

def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 for integer e in the normal range, built from its bits
    (exact on every device)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def float_round(x: torch.Tensor, e_bits: int, m_bits: int,
                qmax: float) -> torch.Tensor:
    """Round to nearest even into an (e_bits, m_bits) float format with
    saturation at qmax; subnormals keep the least normal exponent's
    quantum.  The quantum 2^(floor(log2|x|) - m_bits) comes from frexp and
    the exponent's bits, so the result is exact arithmetic."""
    dtype = x.dtype
    x = x.float().clamp(-qmax, qmax)
    bias = 2 ** (e_bits - 1) - 1
    ax = x.abs()
    _, exp = torch.frexp(ax)  # ax = mant * 2^exp, mant in [0.5, 1)
    e = (exp - 1).clamp_min(1 - bias)
    quantum = _pow2(e - m_bits)
    q = (torch.round(x / quantum) * quantum).clamp(-qmax, qmax)
    return torch.where(ax == 0, torch.zeros_like(q), q).to(dtype)


# ---------------------------------------------------------------------------
# quant / dequant
# ---------------------------------------------------------------------------

def quantize(t: torch.Tensor, qp: QParams, spec: QuantSpec,
             rounding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """To integer codes held in float, or float-format values.
    ``rounding``: an additive mask in [0, 1] that replaces round() by
    floor() + mask (TesseraQ)."""
    scales, zeros = qp
    if spec.is_float:
        safe = torch.where(scales == 0, torch.ones_like(scales), scales)
        return float_round(t / safe + zeros, spec.e_bits, spec.m_bits,
                           spec.qmax)
    if rounding is not None:
        q = torch.floor(t / scales) + rounding
        return (q + zeros).clamp(spec.qmin, spec.qmax)
    if spec.round_zp:
        q = torch.round(t / scales) + zeros
    else:
        q = torch.round(t / scales.clamp_min(1e-9) + zeros)
    return q.clamp(spec.qmin, spec.qmax)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    scales, zeros = qp
    return (q - zeros) * scales


def quant_dequant(t: torch.Tensor, qp: QParams, spec: QuantSpec,
                  output_scale_factor: float = 1.0,
                  rounding: Optional[torch.Tensor] = None) -> torch.Tensor:
    q = quantize(t, qp, spec, rounding=rounding)
    if output_scale_factor != 1.0:
        qp = QParams(qp.scales * output_scale_factor, qp.zeros)
    return dequantize(q, qp)


# ---------------------------------------------------------------------------
# hqq
# ---------------------------------------------------------------------------

def _shrink(x: torch.Tensor, beta: torch.Tensor,
            lp_norm: float) -> torch.Tensor:
    if lp_norm == 1:
        return torch.sign(x) * torch.relu(x.abs() - 1.0 / beta)
    # the power in f64, rounded once to f32: the card's and the CPU's f32
    # pow differ by ulps
    p = (x.abs().double() ** (lp_norm - 1)).float()
    return torch.sign(x) * torch.relu(fma(-(1.0 / beta), p, x.abs()))


def hqq_optimize(t: torch.Tensor, qp: QParams, spec: QuantSpec) -> QParams:
    """Half-quadratic proximal zero-point optimization.  Each step takes
    the new zeros; the first step whose mean |t - qdq(t)| is not below the
    best so far is the last (its zeros kept).  The stop is a device flag:
    the loop runs ``iters`` times and the state freezes once it is set.
    Its multiply-adds are single-rounded (``fma``), as JAX's compiled loop
    takes them on the CPU.  The stop test reads one mean over the whole
    tensor, which the steps near the stop move by about an f32 ulp: so
    every step is the same bits on the card and the CPU (the power and the
    row sums rounded once from f64, the stop test's mean in f64), since an
    ulp in one row's zero, from another device's pow or summation order,
    can flip that test."""
    inv_scales = 1.0 / qp.scales
    qmin, qmax = spec.qmin, spec.qmax
    zeros = qp.zeros * torch.ones_like(qp.scales)
    dev = t.device
    beta = torch.tensor(spec.beta, dtype=torch.float32, device=dev)
    best_err = torch.tensor(1e4, dtype=torch.float64, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(spec.iters):
        w_q = torch.round(fma(t, inv_scales, zeros)).clamp(qmin, qmax)
        w_r = (w_q - zeros) * qp.scales
        d = t - w_r
        w_e = _shrink(d, beta, spec.lp_norm)
        # jnp.mean's sum times 1/n, the sum rounded once from f64
        new_zeros = fma(-(t - w_e), inv_scales, w_q).double().sum(
            dim=-1, keepdim=True).float() * recip(t.shape[-1])
        err = d.abs().double().mean()
        improved = err < best_err
        zeros = torch.where(active, new_zeros, zeros)
        best_err = torch.where(active & improved, err, best_err)
        beta = beta * spec.kappa
        active = active & improved
    return QParams(qp.scales, zeros)


# ---------------------------------------------------------------------------
# qparams of a tensor
# ---------------------------------------------------------------------------

def _log2(x: torch.Tensor) -> torch.Tensor:
    """log(x) / log(2), as ``jnp.log2`` computes it."""
    return div(torch.log(x), math.log(2.0))


def _ref_manual_float_qdq(t2: torch.Tensor, spec: QuantSpec,
                          rng) -> torch.Tensor:
    """The manual float fake quant: a power-of-two scale from each
    element's exponent, biased so that the row's max maps to the top of a
    (2 - 2^-m) * 2^(2^e - 1) grid, then round().  The scale's non-integer
    power of two is taken in f64 and rounded once to f32 (XLA's f32 pow
    agrees with that in all but about 1e-3 of values)."""
    mn, mx = rng
    maxval = torch.maximum(mx, -mn)
    e, m = float(spec.e_bits), float(spec.m_bits)
    bias = (2.0 ** e) - _log2(maxval) + math.log2(2.0 - 2.0 ** (-m)) - 1.0
    xc = torch.minimum(torch.maximum(t2, -maxval), maxval)
    log_scales = torch.floor(_log2(xc.abs()) + bias).clamp_min(1.0)
    scales = torch.pow(2.0, (log_scales - m - bias).double()).float()
    return torch.round(xc / scales) * scales


def get_tensor_qparams(t: torch.Tensor, spec: QuantSpec,
                       args: Optional[dict] = None):
    """Returns (reshaped tensor, QParams)."""
    t2 = reshape_tensor(t, spec)
    if spec.calib_algo == "hqq":
        t2 = t2.float()
        qp = qparams_from_range(minmax_range(t2, spec), spec)
        return t2, hqq_optimize(t2, qp, spec)
    return t2, qparams_from_range(get_tensor_range(t2, spec, args), spec)


# ---------------------------------------------------------------------------
# fake quant: weights
# ---------------------------------------------------------------------------

def _split_columns(x: torch.Tensor, int_indices, fp_indices, quant):
    """``quant`` on the ``int_indices`` columns, the ``fp_indices`` ones
    kept in float (LLM.int8, QUIK)."""
    ii = torch.as_tensor(list(int_indices), device=x.device)
    fi = torch.as_tensor(list(fp_indices), device=x.device)
    out = torch.zeros_like(x)
    out[..., ii] = quant(x[..., ii])
    out[..., fi] = x[..., fi]
    return out


def fake_quant_weight_dynamic(w: torch.Tensor, spec: QuantSpec,
                              dim_ic: bool = False,
                              int_indices: Optional[Sequence[int]] = None,
                              fp_indices: Optional[Sequence[int]] = None,
                              args: Optional[dict] = None) -> torch.Tensor:
    """qparams from w itself, then qdq.  ``dim_ic`` quantizes along the
    input channels; ``int_indices`` / ``fp_indices`` keep outlier columns
    in float."""
    if int_indices is not None:
        return _split_columns(w, int_indices, fp_indices,
                              lambda c: fake_quant_weight_dynamic(
                                  c, spec, args=args))
    qw = w.t() if dim_ic else w
    shape, dtype = qw.shape, qw.dtype
    if spec.is_float and spec.float_mode == "ref_manual":
        t2 = reshape_tensor(qw, spec)
        q = _ref_manual_float_qdq(t2, spec, get_tensor_range(t2, spec, args))
    else:
        t2, qp = get_tensor_qparams(qw, spec, args)
        q = quant_dequant(t2, qp, spec)
    q = restore_tensor(q, shape, spec).to(dtype)
    return q.t() if dim_ic else q


def fake_quant_weight_static(w: torch.Tensor, spec: QuantSpec, qp: QParams,
                             dim_ic: bool = False,
                             output_scale_factor: float = 1.0,
                             rounding: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    qw = w.t() if dim_ic else w
    shape, dtype = qw.shape, qw.dtype
    t2 = reshape_tensor(qw, spec)
    q = quant_dequant(t2, qp, spec, output_scale_factor, rounding=rounding)
    q = restore_tensor(q, shape, spec).to(dtype)
    return q.t() if dim_ic else q


# ---------------------------------------------------------------------------
# fake quant: activations
# ---------------------------------------------------------------------------

def fake_quant_act_dynamic(x: torch.Tensor, spec: QuantSpec,
                           int_indices: Optional[Sequence[int]] = None,
                           fp_indices: Optional[Sequence[int]] = None,
                           args: Optional[dict] = None) -> torch.Tensor:
    if int_indices is not None:
        return _split_columns(x, int_indices, fp_indices,
                              lambda c: fake_quant_act_dynamic(
                                  c, spec, args=args))
    shape, dtype = x.shape, x.dtype
    if spec.is_float and spec.float_mode == "ref_manual":
        t2 = reshape_tensor(x, spec)
        q = _ref_manual_float_qdq(t2, spec, get_tensor_range(t2, spec, args))
    else:
        t2, qp = get_tensor_qparams(x, spec, args)
        q = quant_dequant(t2, qp, spec)
    return restore_tensor(q, shape, spec).to(dtype)


def act_qdq_compiled(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """The dynamic act fake quant as the JAX package's searches compile it
    (AWQ's scale search, the clip search): the division by the format's
    range a product with the reciprocal."""
    t2 = reshape_tensor(x, spec)
    return restore_tensor(compiled_qdq(t2, get_tensor_range(t2, spec), spec),
                          x.shape, spec).to(x.dtype)


def fake_quant_act_static(x: torch.Tensor, spec: QuantSpec,
                          qp: QParams) -> torch.Tensor:
    shape, dtype = x.shape, x.dtype
    q = quant_dequant(reshape_tensor(x, spec), qp, spec)
    return restore_tensor(q, shape, spec).to(dtype)


# ---------------------------------------------------------------------------
# real quant
# ---------------------------------------------------------------------------

def _store_dtype(spec: QuantSpec) -> torch.dtype:
    if spec.is_float:
        return (torch.float8_e4m3fn if spec.bit == "e4m3"
                else torch.float8_e5m2)
    if spec.bit == 8:
        return torch.int8 if spec.qmin != 0 else torch.uint8
    if spec.bit == 4:
        return torch.int8  # nibble-packed later by the serving layout
    return torch.int32


def real_quant_weight(w: torch.Tensor, spec: QuantSpec,
                      qp: Optional[QParams] = None,
                      output_scale_factor: float = 1.0):
    """Quantize to storage codes: (codes, scales, zeros | None) with the
    qparams viewed per output row (per block: (M/bs, N/bs))."""
    if spec.is_float and spec.bit not in ("e4m3", "e5m2"):
        raise ValueError("only e4m3 and e5m2 have a real-quant store")
    shape = w.shape
    if qp is None:
        t2, qp = get_tensor_qparams(w, spec)
    else:
        t2 = reshape_tensor(w, spec)
    store = _store_dtype(spec)
    q = restore_tensor(quantize(t2, qp, spec), shape, spec).to(store)
    scales = qp.scales * output_scale_factor
    zeros = qp.zeros
    if spec.symmetric or spec.is_float:
        zeros = None
    elif spec.round_zp:
        zeros = zeros.to(store)
    if spec.granularity == "per_tensor":
        qshape = (1,)
    elif spec.granularity == "per_block":
        qshape = (scales.shape[0], scales.shape[2])
    else:
        qshape = (shape[0], -1)
    scales = scales.reshape(qshape)
    if zeros is not None:
        zeros = zeros.reshape(qshape)
    return q, scales, zeros


# ---------------------------------------------------------------------------
# static act ranges over calibration batches
# ---------------------------------------------------------------------------

def static_minmax_range(batches: Sequence[torch.Tensor], spec: QuantSpec):
    """The mean over batches of each batch's min and max."""
    mins, maxs = [], []
    for b in batches:
        mn, mx = minmax_range(reshape_tensor(b, spec), spec)
        mins.append(mn.min())
        maxs.append(mx.max())
    return mean_xla(torch.stack(mins)), mean_xla(torch.stack(maxs))


def static_moving_minmax_range(batches: Sequence[torch.Tensor],
                               spec: QuantSpec, alpha: float = 0.01):
    """An exponential moving average of each batch's range."""
    mmn = mmx = None
    for b in batches:
        mn, mx = minmax_range(reshape_tensor(b, spec), spec)
        if mmn is None:
            mmn, mmx = mn, mx
        else:
            mmn = mmn + alpha * (mn - mmn)
            mmx = mmx + alpha * (mx - mmx)
    return mmn, mmx


def static_act_qparams(batches: Sequence[torch.Tensor], spec: QuantSpec,
                       alpha: float = 0.01) -> QParams:
    """Static act qparams over the calibration batches."""
    algo = spec.calib_algo
    if algo in ("static_minmax", "minmax", "mse"):
        rng = static_minmax_range(batches, spec)
    elif algo == "static_moving_minmax":
        rng = static_moving_minmax_range(batches, spec, alpha)
    elif algo == "static_hist":
        from .hist import static_hist_range

        dev = batches[0].device
        rng = tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in static_hist_range(batches, spec))
    else:
        raise ValueError(f"unsupported static act calib {algo!r}")
    return qparams_from_range(rng, spec)


# ---------------------------------------------------------------------------
# W48: int8 per channel outside, int4 per group inside (DGQ)
# ---------------------------------------------------------------------------

def fake_quant_weight_w48(w: torch.Tensor, spec8: QuantSpec,
                          spec4: QuantSpec) -> torch.Tensor:
    shape16, dtype16 = w.shape, w.dtype
    t8 = reshape_tensor(w, spec8)
    qp8 = qparams_from_range(minmax_range(t8, spec8), spec8)
    q8 = quantize(t8, qp8, spec8)
    shape8 = q8.shape
    t4 = reshape_tensor(q8, spec4)
    qp4 = qparams_from_range(minmax_range(t4, spec4), spec4)
    d8 = restore_tensor(dequantize(quantize(t4, qp4, spec4), qp4), shape8,
                        spec4)
    return restore_tensor(dequantize(d8, qp8), shape16, spec8).to(dtype16)


# ---------------------------------------------------------------------------
# block-FP8 weights
# ---------------------------------------------------------------------------

FP8_BLOCK_SPEC = QuantSpec(bit="e4m3", symmetric=True,
                           granularity="per_block", block_size=128)


def weight_cast_to_fp8(w: torch.Tensor, block_size: int = 128):
    """128 x 128-block e4m3 quantization: (fp8 codes, f32 scales)."""
    spec = FP8_BLOCK_SPEC.with_(block_size=block_size)
    q, scales, _ = real_quant_weight(w.float(), spec)
    return q, scales.float()


def weight_cast_to_bf16(q: torch.Tensor, scales: torch.Tensor,
                        block_size: int = 128) -> torch.Tensor:
    """Block-FP8 weights back to bf16."""
    m, n = q.shape
    spec = FP8_BLOCK_SPEC.with_(block_size=block_size)
    t2 = reshape_tensor(q.float(), spec)
    d = t2 * scales.reshape(scales.shape[0], 1, scales.shape[1], 1)
    return restore_tensor(d, (m, n), spec).to(torch.bfloat16)
