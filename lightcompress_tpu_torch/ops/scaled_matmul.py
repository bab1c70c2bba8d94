"""Scaled quantized matmuls, the W8A8 and FP8 serving products (port of
lightcompress_tpu/ops/scaled_matmul.py).

The JAX package runs these under XLA, outside any Pallas kernel, so the
port computes them with torch ops:

* the int8 products accumulate in int32, which is exact in any order:
  ``torch._int_mm`` for the linears (on the card it takes more than 16
  rows and K, N multiples of 8, so ``int8_mm`` pads with zero rows and
  columns, which add nothing), and an f64 batched product for the two
  dots of ``int8_decode_attention`` (every partial sum an integer below
  2^53).  Their results equal the JAX package's bit for bit on the CPU and
  on the card.  No f32 or bf16 product of int8 values is taken: at K 4096
  its sums pass 2^24 and round;
* the f32 rescales keep JAX's operand order (``acc * xs * ws``);
* the act quant divides by a number through ``device.div``.

``fp8_matmul`` takes JAX's native-fp8 branch where the card has fp8 tensor
cores (``has_fp8``: sm_89 and later, JAX's ``tpu_capability().has_fp8_mxu``),
else the dequantize-to-bf16 branch; the CPU takes the latter, as JAX's
CPU backend does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import div
from ..quant import weight_cast_to_bf16

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0  # finfo(float8_e4m3fn).max


def has_fp8(device: torch.device) -> bool:
    """fp8 tensor cores: a CUDA card of compute capability 8.9 or later."""
    if device.type != "cuda":
        return False
    return torch.cuda.get_device_capability(device) >= (8, 9)


def quantize_act_int8(x: torch.Tensor):
    """Per-token symmetric int8: (q, scales (..., 1) f32); amax clamped at
    1e-5, codes in [-128, 127]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-5)
    scales = div(amax, 127.0)
    q = torch.round(xf / scales).clamp(-128, 127).to(torch.int8)
    return q, scales


def quantize_act_fp8_block(x: torch.Tensor, block: int = 128):
    """Per-``block`` dynamic e4m3 act quant: each block of the feature dim
    gets scale amax/448 (amax clamped at 1e-6).  Returns (q (..., K) e4m3,
    scales (..., K/block) f32)."""
    *lead, K = x.shape
    if K % block:
        raise ValueError(f"K {K} is not a multiple of the block {block}")
    xb = x.float().reshape(*lead, K // block, block)
    s = div(xb.abs().amax(dim=-1).clamp_min(1e-6), E4M3_MAX)
    q = (xb / s[..., None]).to(E4M3)
    return q.reshape(*lead, K), s


def _bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` of bf16-valued operands with f32 accumulation and an f32
    result (JAX's einsum with ``preferred_element_type=f32``)."""
    return torch.matmul(x.to(torch.bfloat16).float(),
                        w.to(torch.bfloat16).float().t())


def fp8_matmul_block_dynamic(x: torch.Tensor, w_fp8: torch.Tensor,
                             w_scales: torch.Tensor, block: int = 128,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """W8A8-FP8 with per-block scales on both operands: the act quantized
    per block dynamically, both operands dequantized into the bf16 product
    (JAX's branch for a unit without fp8 dots, which it always takes)."""
    xq, xs = quantize_act_fp8_block(x, block)
    *lead, K = x.shape
    xd = (xq.float().reshape(*lead, K // block, block) * xs[..., None])
    xd = xd.reshape(*lead, K).to(torch.bfloat16)
    w = weight_cast_to_bf16(w_fp8, w_scales, block)
    y = _bf16_matmul_f32(xd, w)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact.  On the card
    ``torch._int_mm`` wants M > 16 and K, N multiples of 8: the operands are
    padded with zero rows and columns there, which add nothing."""
    M, K = a.shape
    N = b.shape[0]
    a, b = a.to(torch.int8), b.to(torch.int8)
    if a.device.type != "cuda":
        return torch._int_mm(a, b.t())
    Mp, Kp, Np = max(-(-M // 8) * 8, 32), -(-K // 8) * 8, -(-N // 8) * 8
    ap = _pad_to(_pad_to(a, 0, Mp), 1, Kp).contiguous()
    bp = _pad_to(_pad_to(b, 0, Np), 1, Kp).contiguous()
    return torch._int_mm(ap, bp.t())[:M, :N]


def _int8_linear(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    lead = xq.shape[:-1]
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), w_q)
    return acc.reshape(*lead, -1)


def int8_matmul_dynamic(x: torch.Tensor, w_q: torch.Tensor,
                        w_scales: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = (int8(x) @ w_q^T) * x_scale * w_scale, int32 accumulation;
    ``w_scales`` (N,), (N, 1) or one per tensor."""
    xq, xs = quantize_act_int8(x)
    acc = _int8_linear(xq, w_q)
    ws = w_scales.reshape(-1).float()
    y = acc.float() * xs * ws
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def int8_matmul_static(x: torch.Tensor, w_q: torch.Tensor,
                       w_scales: torch.Tensor, x_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The static act scale variant (``x_scale`` a scalar tensor)."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32,
                              device=x.device)
    xq = torch.round(x.float() / x_scale).clamp(-128, 127).to(torch.int8)
    acc = _int8_linear(xq, w_q)
    ws = w_scales.reshape(-1).float()
    y = acc.float() * x_scale * ws
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def fp8_matmul(x: torch.Tensor, w_fp8: torch.Tensor, w_scales: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               block_size: int = 0) -> torch.Tensor:
    """e4m3 weights times the act, per-channel (N,) or per-block scales.
    With fp8 tensor cores and per-channel scales (JAX's native branch) the
    act is cast to e4m3 and the product taken over the e4m3 values (exact
    in bf16) with f32 accumulation, the scales applied to the f32 result;
    otherwise the weight is dequantized to bf16 and multiplied by the bf16
    act."""
    if not block_size and has_fp8(x.device):
        xf = x.to(w_fp8.dtype)
        acc = _bf16_matmul_f32(xf.to(torch.bfloat16),
                               w_fp8.to(torch.bfloat16))
        y = acc * w_scales.reshape(-1).float()
    else:
        if block_size:
            w = weight_cast_to_bf16(w_fp8, w_scales, block_size)
        else:
            w = (w_fp8.float() * w_scales.reshape(-1, 1).float()).to(
                torch.bfloat16)
        y = _bf16_matmul_f32(x, w)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _exact_int_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b of integer-valued tensors in f64 (every partial sum an
    integer far below 2^53, so exact in any order) -> int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_decode_attention(q: torch.Tensor, k8: torch.Tensor,
                          k_scales: torch.Tensor, v8: torch.Tensor,
                          v_scales: torch.Tensor) -> torch.Tensor:
    """Fully-int8 decode attention: q (B, K, G, D) quantized per (b, k, g)
    to int8, the q.k and p.v products exact in int32; the probabilities
    scaled by the per-position V scales before their own int8 quant.
    k8, v8 (B, K, S, D) int8; k_scales, v_scales (B, K, S) f32.  Returns
    (B, K, G, D) f32."""
    D = q.shape[-1]
    qf = q.float()
    qs = div(qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    q8 = torch.round(qf / qs).clamp(-127, 127)
    scores = _exact_int_bmm(q8, k8.transpose(-1, -2))  # (B, K, G, S)
    scores = (scores.float() * qs * k_scales[:, :, None, :].float()
              * (D ** -0.5))
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scales[:, :, None, :].float()
    ps = div(pv.amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    p8 = torch.round(pv / ps).clamp(0, 127)
    ctx = _exact_int_bmm(p8, v8)  # (B, K, G, D)
    return ctx.float() * ps
