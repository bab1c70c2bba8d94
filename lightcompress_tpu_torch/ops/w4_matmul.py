"""Grouped-W4 matmuls: plane and byte packing, per-token act quant, and the
nine Hopper kernels of the serving path and the bench with their plain
PyTorch versions (port of lightcompress_tpu/ops/pallas_matmul.py, kernels
#1-#5, #11 and #12-#14).

Two weight layouts, both untiled; ``s`` and ``zs`` are (N, G) bf16
per-group scales and premultiplied zero corrections, G = K/128:

* planes: ``wp`` (N, K/8) int32 holds in nibble j of word kw the code u of
  weight k = j*K/8 + kw (bit-identical to the JAX ``pack_int4_planes``);
  zs = z*s;
* s4 byte pairs: ``wb`` (N, K/2) int8, byte p*128 + t holds c' = u - 8 of
  weight (2p)*128 + t in its low nibble and of (2p+1)*128 + t in its high
  one (the JAX ``pack_s4_pairs`` without its tiling); zs = (z - 8)*s.

Every entry point computes, with c the layout's code (u or c'),

    y[m, n] = sum_g s[n, g] * (x_g . c_g) - zs[n, g] * sum(x_g)

The fused linears (#13, #14) take the unquantized activations and run the
JAX kernels' prologue first: an optional RMSNorm whose gamma is folded into
the weights, then the per-token int8 quantization (``fused_act_quant``).
Each then keeps its TPU kernel's float order on an int8 tensor-core decode
tile that equals it bit for bit on the tile's own act codes: #13
``w4a8_matmul_pairs_tpu_order`` (four accumulators by g % 4, the zero
correction summed in order; ``csrc/w4_bytes.cu``), #14
``w4a8_rows_phase_dot`` (``_phase_dot``'s order: the four accumulators,
then each plane's zero correction in plane order; ``csrc/w4_matmul.cu``).
#12 keeps the one accumulator of ``_grouped``.

#2 (``w4a8_matmul_decode``), #3 (``w4a8_matmul_prefill``) and #5
(``w4a8_matmul_planes_ksplit``) keep the TPU kernels' float order
(``w4a8_rows_tpu_order``: four accumulators by plane j % 4 over (gi, j),
then the zero correction) and equal their plain versions bit for bit.  #2
has two bodies, chosen by M alone (``planes_body``): the planes decode tile
below ``PLANES_TILE_MIN_M`` rows, #3's planes tile from there on; both give
the same bits.  #5 runs the planes layout in two K halves, each over the
word columns [h*K/16, (h+1)*K/16) of every plane (the JAX ``planes_ks``
tiles, untiled, are these planes words), and adds them.

Two more layouts, each with its kernel:

* masked planes (#4, ``w4a16_matmul_planes_masked``, the bench's
  ``BENCH_MASKED``): the planes words with plane 7's nibbles stored XOR
  0x8 (``pack_int4_planes_masked``), scales pre-divided by 16^j
  (``masked_scales``) and zero corrections (z - 8*[j = 7])*s
  (``masked_zero_scales``), f32 or bf16;
* natural s4 bytes (#11, ``w4a8_matmul_s4_bytes``): ``wb`` (N, K/2) int8,
  byte b holding c' = u - 8 of weight 2b in its low nibble and of 2b+1 in
  its high one (``pack_s4_bytes``), with zs' = (z - 8)*s, f32 or bf16.

Both add their scaled group dots in four accumulators, (a0 + a1) +
(a2 + a3), before the correction, as the TPU kernels do; #11 sums its
correction in ascending g (``_s4_tpu_order``, #13's order) on an int8
tensor-core decode tile (``csrc/w4_bytes.cu``) and equals its plain
version bit for bit.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel (``csrc/w4_matmul.cu``, ``csrc/w4a16_tile.cu``, ``csrc/w4_bytes.cu``,
``csrc/w4_ksplit.cu``) or raises.  #1 and #4 run on one bf16 tensor-core
tile (``csrc/w4a16_tile.cu``) in the TPU kernels' order
(``_w4a16_tpu_order``, their plain versions), within summation-order noise
of it.  #12 has two bodies, chosen by M alone (``bytes_body``): the
decode block below ``BYTES_TILE_MIN_M`` rows, the int8 tensor-core tile of
``csrc/w4_mma.cuh`` from there on.  #3 runs on the planes tile it shares
with #9 (``csrc/w4_planes_wgmma.cuh``), #5 on the planes decode tile of
``csrc/w4_mma.cuh``, #2 and #14 on its unsplit sibling in
``csrc/w4_matmul.cu``.  Each wrapper counts its kernel launches in its
``launches`` attribute.

The plain versions' f32 matmuls are exact whether TF32 is on or off:
nibble codes, int8 codes and bf16 activations are exact in TF32 and their
products exact in f32.  The on-card comparisons (``chip_smoke.py``, the
``cuda`` tests) set ``torch.backends.cuda.matmul.allow_tf32 = False``
all the same.  The group dots are per-group matmuls summed in f32, the
kernels' order of operations.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..device import div
from . import _build

GROUP = 128
# decode-regime M cap (the JAX route's whole-M-in-VMEM limit, kept so both
# packages route the same shapes the same way)
DECODE_M_MAX = 256
# #12's tile takes M >= this many rows, its decode block fewer (the
# crossover measured on the H100 by chip_smoke.py's fused_kernels phase)
BYTES_TILE_MIN_M = 8
# the planes tile of #3 and #9 (csrc/w4_planes_wgmma.cuh): 128 channels a
# block; beside its stages, shared memory holds 128 bytes of row sums a
# group up to this K, above it the wrapper hands the kernel a global int16
# scratch of the row sums (``rowsum_scratch``)
TILE_N = 128
ROWSUM_SMEM_K_MAX = 49152
# #2 takes #3's planes tile from this many rows on, its planes decode tile
# below (the crossover over a Llama-3-8B block and Mixtral-8x7B's and
# Qwen3-30B-A3B's attention linears together, measured on the H100 by
# chip_smoke.py's planes_crossover line); both give the same bits
PLANES_TILE_MIN_M = 128
# #2's decode tile takes 16 channels a block up to this N (more blocks to
# fill the SMs), 32 above (chip_smoke.py's planes_crossover line)
DECODE_CHAN16_MAX_N = 2048


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """(..., 8) nibbles -> (...) int32 words, nibble i at bits 4i."""
    shifts = torch.arange(8, dtype=torch.int64, device=u.device) * 4
    # the sum of disjoint nibbles is their bitwise or; summed in int64,
    # then words >= 2^31 are mapped to their two's-complement int32 value
    words = ((u.to(torch.int64) & 0xF) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) int4 codes (0..15 or -8..7) -> (N, K/8) int32 in the vLLM
    order (JAX's ``export.pack_int4``): 8 consecutive codes a word, code i
    at bits 4i.  The ``rows`` serving layout and the real-quant exports."""
    n, k = codes.shape
    if k % 8:
        raise ValueError(f"K={k} is not a multiple of 8")
    return pack_nibbles(codes.reshape(n, k // 8, 8))


def unpack_int4(packed: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """Inverse of ``pack_int4``: (N, K/8) -> (N, K) int32 in [0, 15], or
    [-8, 7] with ``signed``."""
    n, words = packed.shape
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device) * 4
    u = ((packed.to(torch.int32)[:, :, None] >> shifts) & 0xF).reshape(
        n, words * 8)
    return torch.where(u >= 8, u - 16, u) if signed else u


def pack_int4_planes(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) codes in [0, 15] -> (N, K/8) int32, plane layout."""
    n, k = codes.shape
    if k % 8:
        raise ValueError(f"K={k} is not a multiple of 8")
    u = codes.to(torch.int32) & 0xF
    planes = u.reshape(n, 8, k // 8)
    shifts = (torch.arange(8, dtype=torch.int32, device=codes.device)
              * 4)[None, :, None]
    # the sum of disjoint nibbles is their bitwise or; summed in int64,
    # then words >= 2^31 are mapped to their two's-complement int32 value
    words = (planes.to(torch.int64) << shifts).sum(dim=1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_int4_planes(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(N, K/8) int32 -> (N, K) int32 codes in [0, 15]."""
    n, kp = packed.shape
    if kp * 8 != k:
        raise ValueError(f"K mismatch: {k} vs packed {kp}")
    shifts = (torch.arange(8, dtype=torch.int32, device=packed.device)
              * 4)[None, :, None]
    return ((packed[:, None, :] >> shifts) & 0xF).reshape(n, k)


def pack_s4_pairs(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) codes u in [0, 15] -> (N, K/2) int8 byte pairs of c' = u - 8
    (bit-identical to the JAX ``pack_s4_pairs`` reshaped to (N, K/2))."""
    n, k = codes.shape
    if k % (2 * GROUP):
        raise ValueError(f"K={k} is not a multiple of {2 * GROUP}")
    c = ((codes.to(torch.int32) & 0xF) - 8).reshape(n, k // (2 * GROUP), 2,
                                                    GROUP)
    b = (c[:, :, 0] & 0xF) | ((c[:, :, 1] & 0xF) << 4)
    return torch.where(b > 127, b - 256, b).to(torch.int8).reshape(n, k // 2)


def unpack_s4_pairs(wb: torch.Tensor) -> torch.Tensor:
    """(N, K/2) int8 byte pairs -> (N, K) int32 signed codes c' in [-8, 7]."""
    n, kh = wb.shape
    b = wb.to(torch.int32).reshape(n, kh // GROUP, 1, GROUP)
    c = torch.cat([((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8], dim=2)
    return c.reshape(n, kh * 2)


# plane j's scale factor of the masked kernel: JAX's f32 ``exp2(-4j)`` as XLA
# computes it, one ulp below 16^-j from j = 4 on; the pre-divided scales
# then equal the JAX package's bit for bit
MASKED_FACTORS = (1.0, 2.0 ** -4, 2.0 ** -8, 2.0 ** -12,
                  (1 - 2.0 ** -24) * 2.0 ** -16, (1 - 2.0 ** -24) * 2.0 ** -20,
                  (1 - 2.0 ** -24) * 2.0 ** -24, (1 - 2.0 ** -24) * 2.0 ** -28)


def pack_int4_planes_masked(codes: torch.Tensor) -> torch.Tensor:
    """``pack_int4_planes`` with plane 7's nibbles stored XOR 0x8 (the JAX
    ``pack_int4_planes_masked``): masked, plane 7 reads (c - 8) * 2^28."""
    n, k = codes.shape
    u = codes.to(torch.int32) & 0xF
    u = torch.cat([u[:, :7 * k // 8], u[:, 7 * k // 8:] ^ 0x8], dim=1)
    return pack_int4_planes(u)


def unpack_int4_planes_masked(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(N, K/8) masked planes -> (N, K) int32 codes u in [0, 15]."""
    u = unpack_int4_planes(packed, k)
    return torch.cat([u[:, :7 * k // 8], u[:, 7 * k // 8:] ^ 0x8], dim=1)


def _plane_of_group(G: int, device) -> torch.Tensor:
    if G % 8:
        raise ValueError(f"G={G} groups are not 8 planes")
    return torch.arange(G, device=device) // (G // 8)


def masked_scales(s: torch.Tensor) -> torch.Tensor:
    """(N, G) scales -> f32 pre-divided by 16^j for group g = j*gpp + gi
    (the JAX ``tile_scales_masked`` before its tiling)."""
    fac = torch.tensor(MASKED_FACTORS, dtype=torch.float32,
                       device=s.device)[_plane_of_group(s.shape[1],
                                                        s.device)]
    return s.float() * fac[None, :]


def masked_zero_scales(zeros: torch.Tensor, scales: torch.Tensor
                       ) -> torch.Tensor:
    """(z - 8*[j = 7]) * s in f32 (the JAX ``masked_zero_scales``): plane 7
    stores c ^ 8, whose masked value is (c - 8) * 2^28."""
    j = _plane_of_group(zeros.shape[1], zeros.device)
    off = torch.where(j == 7, 8.0, 0.0).to(zeros.device)
    return (zeros.float() - off[None, :]) * scales.float()


def pack_s4_bytes(codes: torch.Tensor) -> torch.Tensor:
    """(N, K) codes u in [0, 15] -> (N, K/2) int8 natural-order bytes of
    c' = u - 8, the low nibble the even weight (the JAX ``pack_s4_bytes``
    without its (N/NT, NT) tiling)."""
    n, k = codes.shape
    if k % 2:
        raise ValueError(f"K={k} is odd")
    c = ((codes.to(torch.int32) & 0xF) - 8) & 0xF
    pairs = c.reshape(n, k // 2, 2)
    b = pairs[..., 0] | (pairs[..., 1] << 4)
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def unpack_s4_bytes(wb: torch.Tensor) -> torch.Tensor:
    """(N, K/2) natural s4 bytes -> (N, K) int32 signed codes c'."""
    b = wb.to(torch.int32)
    c = torch.stack([((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8],
                    dim=-1)
    return c.reshape(wb.shape[0], -1)


def quantize_act_per_token(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> ((M, K) int8, (M, 1) f32 scale): amax/127, clamped
    at 1e-8, rounded half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = div(amax.clamp_min(1e-8), 127.0)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def fused_act_quant(x: torch.Tensor, rms: bool, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue of the fused linears (#13, #14) in the JAX kernels'
    order: f32 x, with ``rms`` times rsqrt(sum(x*x)/K + eps) (the RMSNorm
    whose gamma is folded into the weights; unlike ``rmsnorm`` the result
    is not rounded to x's dtype), then ``quantize_act_per_token``.  The
    reciprocal square root is taken in f64 and rounded once, as the
    kernels' correctly rounded ``__frsqrt_rn``; the sum runs in another
    order than the kernels' and the JAX kernels', which can move the
    rsqrt by an ulp and flip an act code now and then."""
    xf = x.float()
    if rms:
        ms = div(torch.sum(xf * xf, dim=-1, keepdim=True), xf.shape[-1])
        xf = xf * torch.rsqrt((ms + eps).double()).float()
    return quantize_act_per_token(xf)


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card reference)
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, codes: torch.Tensor, s: torch.Tensor,
             zs: torch.Tensor) -> torch.Tensor:
    """sum_g s*(x_g . c_g) - zs*sum(x_g) in f32; x is f32 holding exact
    bf16 or int8 values, ``codes`` the (N, K) unpacked codes."""
    M, K = x.shape
    N, G = s.shape
    g = K // G
    u = codes.float().reshape(N, G, g)
    xg = x.reshape(M, G, g)
    xsum = xg.sum(dim=-1)  # (M, G)
    sf, zf = s.float(), zs.float()
    y = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for gi in range(G):
        part = torch.matmul(xg[:, gi], u[:, gi].t())  # (M, N)
        y += part * sf[:, gi] - xsum[:, gi, None] * zf[:, gi]
    return y


def w4a8_matmul_decode_plain(xq, x_scale, wp, s, zs,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain #2 in its TPU kernels' order (``w4a8_rows_tpu_order``),
    stored in ``out_dtype``."""
    return w4a8_rows_tpu_order(xq, x_scale, wp, s, zs).to(out_dtype)


def w4a8_matmul_bytes_plain(xq, x_scale, wb, s, zs) -> torch.Tensor:
    """Plain #12: #2's arithmetic on the byte-pair codes c'; (M, N) f32."""
    return _grouped(xq.float(), unpack_s4_pairs(wb), s, zs) \
        * x_scale.float()


def w4a8_linear_planes_fused_plain(x, wp, s, zs, rms=False, eps=1e-6):
    """Plain #14: ``fused_act_quant``, then its TPU kernel's order
    (``w4a8_rows_phase_dot``) on those codes and scales; returns (y in
    ``x.dtype``, int8 codes, act scales)."""
    xq, xs = fused_act_quant(x, rms, eps)
    return w4a8_rows_phase_dot(xq, xs, wp, s, zs).to(x.dtype), xq, xs


def _s4_tpu_order(xq, x_scale, c, s, zs) -> torch.Tensor:
    """(M, K) int8 x with (M, 1) f32 scales against signed codes c' ((N,
    K) int32) with (N, G) s and zs -> (M, N) f32 in the order of the TPU
    kernels _w4a8_kernel_s4 and _w4a8_kernel_pairs_fused
    (_pairs_group_loop): for g ascending, acc[g % 4] += f32(x_g . c'_g) *
    s_g and corr += xsum_g * zs_g, each product and sum rounded; then
    ((a0 + a1) + (a2 + a3) - corr) * x_scale.  The group dots are f32
    matmuls of integers whose sums stay below 2^24, so they are exact; with
    bf16 zs, xsum * zs is exact too (at most 14 + 8 significant bits), with
    f32 zs it is rounded once."""
    M, K = xq.shape
    G = s.shape[1]
    x = xq.float().reshape(M, G, GROUP)
    c = c.float().reshape(-1, G, GROUP)
    xsum = x.sum(dim=-1)
    zf = zs.float()
    parts = [torch.matmul(x[:, g], c[:, g].t()) for g in range(G)]
    corr = torch.zeros((M, c.shape[0]), dtype=torch.float32,
                       device=xq.device)
    for g in range(G):
        corr = corr + xsum[:, g, None] * zf[:, g]
    acc = _four_accumulators(parts, s, [(g, g % 4) for g in range(G)])
    return (acc - corr) * x_scale.float()


def w4a8_matmul_pairs_tpu_order(xq, x_scale, wb, s, zs) -> torch.Tensor:
    """(M, K) int8 x with (M, 1) f32 scales against a byte-pair weight
    ((N, K/2) int8, (N, G) s and zs) -> (M, N) f32 in the TPU kernel
    _w4a8_kernel_pairs_fused's order (``_s4_tpu_order``).  #13's tile
    keeps it bit for bit."""
    return _s4_tpu_order(xq, x_scale, unpack_s4_pairs(wb), s, zs)


def w4a8_linear_bytes_fused_plain(x, wb, s, zs, rms=False, eps=1e-6):
    """Plain #13: ``fused_act_quant`` then the TPU kernel's order
    (``w4a8_matmul_pairs_tpu_order``); returns (y in ``x.dtype``, int8
    codes, act scales)."""
    xq, xs = fused_act_quant(x, rms, eps)
    return (w4a8_matmul_pairs_tpu_order(xq, xs, wb, s, zs).to(x.dtype), xq,
            xs)


def _check_ksplit(K: int, splits: int) -> None:
    if splits != 2:
        raise ValueError(f"#5 takes two K halves, got splits={splits}")
    if K % (16 * GROUP):
        raise ValueError(f"#5 needs K % {16 * GROUP} == 0, got K={K}")


def _tpu_order_part(xq, wp, s, zs, gis, per_plane: bool = False
                    ) -> torch.Tensor:
    """The planes kernels' float order over the group blocks ``gis``: for
    gi in ``gis``, then plane j (group g = j*gpp + gi), the exact integer
    group dot times s[g] added to accumulator j % 4 and xsum[g]*zs[g] to
    the zero correction; returns ((a0 + a1) + (a2 + a3)) - corr, (M, N)
    f32, every op rounded on its own.  With ``per_plane`` (the fused layer
    tail's ``_phase_dot``), each plane's correction sum_gi xsum*zs is
    subtracted on its own, in plane order.  The group dots are f32 matmuls
    of integers whose sums stay below 2^24, so they are exact."""
    M, K = xq.shape
    N, G = s.shape
    gpp = G // 8
    g = K // G
    xg = xq.float().reshape(M, G, g)
    ug = unpack_int4_planes(wp, K).float().reshape(N, G, g)
    xsum = xg.sum(dim=-1)
    sf, zf = s.float(), zs.float()

    def zeros():
        return torch.zeros((M, N), dtype=torch.float32, device=xq.device)

    acc = [zeros() for _ in range(4)]
    corr = [zeros() for _ in range(8 if per_plane else 1)]
    for gi in gis:
        for j in range(8):
            gg = j * gpp + gi
            dot = torch.matmul(xg[:, gg], ug[:, gg].t())
            acc[j % 4] = acc[j % 4] + dot * sf[:, gg]
            c = j if per_plane else 0
            corr[c] = corr[c] + xsum[:, gg, None] * zf[:, gg]
    out = (acc[0] + acc[1]) + (acc[2] + acc[3])
    for c in corr:
        out = out - c
    return out


def w4a8_rows_tpu_order(xq, x_scale, wp, s, zs) -> torch.Tensor:
    """(M, K) int8 x with (M, 1) f32 scales against a planes weight
    ((N, K/8) codes, (N, G) s and zs) -> (M, N) f32 in the TPU kernels'
    order (_w4a8_kernel_mtiled, _w4a8_kernel_grouped): for gi, then plane
    j, acc[j % 4] += dot * s and corr += xsum * zs; then ((a0 + a1) +
    (a2 + a3) - corr) * x_scale.  The planes tile (#3, #9) keeps it bit
    for bit."""
    gpp = s.shape[1] // 8
    return _tpu_order_part(xq, wp, s, zs, range(gpp)) * x_scale.float()


def w4a8_rows_phase_dot(xq, x_scale, wp, s, zs) -> torch.Tensor:
    """(M, K) int8 x with (M, 1) f32 scales against a planes weight ->
    (M, N) f32 in the order of the fused layer tail's ``_phase_dot``
    (#15, #16): for gi, then plane j, acc[j % 4] += dot * s; then (a0 +
    a1) + (a2 + a3); then minus each plane's correction sum_gi xsum * zs,
    in plane order; times x_scale."""
    gpp = s.shape[1] // 8
    return _tpu_order_part(xq, wp, s, zs, range(gpp), per_plane=True) \
        * x_scale.float()


def w4a8_matmul_planes_ksplit_plain(xq, x_scale, wp, s, zs,
                                    splits: int = 2) -> torch.Tensor:
    """Plain #5 in the TPU kernel's order: each K half h (the group blocks
    gi in [h*gpp/2, (h+1)*gpp/2) of every plane) gives part_h, the four
    accumulators and the correction over its groups; then (0 + part_0) +
    part_1, times x_scale; (M, N) f32."""
    K = xq.shape[1]
    _check_ksplit(K, splits)
    gpp2 = K // (16 * GROUP)
    out = torch.zeros((xq.shape[0], wp.shape[0]), dtype=torch.float32,
                      device=xq.device)
    for h in range(splits):
        out = out + _tpu_order_part(xq, wp, s, zs,
                                    range(h * gpp2, (h + 1) * gpp2))
    return out * x_scale.float()


def w4a8_matmul_prefill_plain(xq, x_scale, wp, s, zs,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain #3: ``w4a8_rows_tpu_order``, stored in ``out_dtype``."""
    return w4a8_rows_tpu_order(xq, x_scale, wp, s, zs).to(out_dtype)


def _four_accumulators(parts, s: torch.Tensor, groups) -> torch.Tensor:
    """The TPU kernels' a_r: sum over ``groups`` (group indices, in order)
    of parts[i] * s[:, g], added into accumulator ``r(i)``; each entry of
    ``groups`` is (g, r).  Returns (a0 + a1) + (a2 + a3)."""
    acc = [None] * 4
    for part, (g, r) in zip(parts, groups):
        term = part * s[:, g].float()
        acc[r] = term if acc[r] is None else acc[r] + term
    acc = [a if a is not None else torch.zeros_like(parts[0]) for a in acc]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _w4a16_tpu_order(x, wp, s, zs, masked: bool) -> torch.Tensor:
    """The W4A16 planes kernels' order (_w4a16_kernel_fullk and, with
    ``masked``, _w4a16_kernel_fullk_masked): for gi, then plane j, the bf16
    x group dotted with the plane's codes as f32 (masked: the words under
    the plane's mask, c * 16^j, or (c - 8) * 2^28 on plane 7) into
    accumulator j % 4 times the scale (masked: pre-divided by 16^j), then
    (a0 + a1) + (a2 + a3) minus the zero correction; (M, N) f32."""
    M, K = x.shape
    N, G = s.shape
    kp, gpp = K // 8, G // 8
    xb = x.to(torch.bfloat16).float()
    w = wp.reshape(N, gpp, GROUP)
    parts, groups = [], []
    for gi in range(gpp):
        for j in range(8):
            if masked:
                mask = (0xF << (4 * j)) - (1 << 32 if j == 7 else 0)
                d = (w[:, gi] & mask).float()
            else:
                d = ((w[:, gi] >> (4 * j)) & 0xF).float()
            k0 = j * kp + gi * GROUP
            parts.append(torch.matmul(xb[:, k0:k0 + GROUP], d.t()))
            groups.append((j * gpp + gi, j % 4))
    xsum = xb.reshape(M, G, GROUP).sum(dim=-1)
    return _four_accumulators(parts, s, groups) - torch.matmul(
        xsum, zs.float().t())


def w4a16_matmul_plain(x, wp, s, zs) -> torch.Tensor:
    """Plain #1 in the TPU kernel's order (``_w4a16_tpu_order``):
    bf16-rounded x, f32 group dots; returns (M, N) f32."""
    return _w4a16_tpu_order(x, wp, s, zs, masked=False)


def w4a16_matmul_planes_masked_plain(x, wp, s, zs) -> torch.Tensor:
    """Plain #4 in the TPU kernel's order (``_w4a16_tpu_order`` on the
    masked words and pre-divided scales); returns (M, N) f32."""
    return _w4a16_tpu_order(x, wp, s, zs, masked=True)


def w4a8_matmul_s4_plain(xq, x_scale, wb, s, zs) -> torch.Tensor:
    """Plain #11 in the TPU kernel's order (``_s4_tpu_order``: exact
    integer group dots of the natural s4 codes, f32(dot) * s into
    accumulator g % 4, the zero correction summed in ascending g); (M, N)
    f32.  #11's tile keeps it bit for bit."""
    return _s4_tpu_order(xq, x_scale, unpack_s4_bytes(wb), s, zs)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, x_f32, w, s, zs, out, act_out, scale_out, M, N, K, rms, eps, stream
_FUSED_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
               ctypes.c_float, _P]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("w4_matmul")
    lib.lc_w4a8_decode.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P]
    lib.lc_w4a8_prefill.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _P]
    lib.lc_w4a8_planes_fused.argtypes = _FUSED_ARGS
    for fn in (lib.lc_w4a8_decode, lib.lc_w4a8_prefill,
               lib.lc_w4a8_planes_fused):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tile_lib() -> ctypes.CDLL:
    lib = _build.load("w4a16_tile")
    lib.lc_w4a16_tile.argtypes = [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                                  _P]
    lib.lc_w4a16_tile.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _ksplit_lib() -> ctypes.CDLL:
    lib = _build.load("w4_ksplit")
    lib.lc_w4a8_ksplit.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.lc_w4a8_ksplit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bytes_lib() -> ctypes.CDLL:
    lib = _build.load("w4_bytes")
    lib.lc_w4a8_bytes.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.lc_w4a8_bytes_tile.argtypes = lib.lc_w4a8_bytes.argtypes
    lib.lc_w4a8_bytes_fused.argtypes = _FUSED_ARGS
    lib.lc_w4a8_s4.argtypes = [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P]
    for fn in (lib.lc_w4a8_bytes, lib.lc_w4a8_bytes_tile,
               lib.lc_w4a8_bytes_fused, lib.lc_w4a8_s4):
        fn.restype = ctypes.c_int
    return lib


def _check_weights(K: int, wp: torch.Tensor, s: torch.Tensor,
                   zs: torch.Tensor, device: torch.device,
                   layout: str = "planes") -> int:
    """Checks a planes (``wp`` (N, K/8) int32) or byte-pair (``wb``
    (N, K/2) int8) weight; returns N."""
    per, dtype, k_mult, n_mult = ((8, torch.int32, 8 * GROUP, 64)
                                  if layout == "planes"
                                  else (2, torch.int8, 4 * GROUP, 32))
    if wp.dtype != dtype or wp.dim() != 2 or wp.shape[1] * per != K:
        raise ValueError(f"the weight must be (N, {K // per}) {dtype}, got "
                         f"{tuple(wp.shape)} {wp.dtype}")
    N = wp.shape[0]
    G = K // GROUP
    for name, t in (("s", s), ("zs", zs)):
        if t.shape != (N, G):
            raise ValueError(f"{name} must be ({N}, {G}), got "
                             f"{tuple(t.shape)}")
    for t in (wp, s, zs):
        if t.device != device:
            raise ValueError("all operands must be on one device")
    if device.type == "cuda":
        if K % k_mult or N % n_mult:
            raise ValueError(f"the {layout} kernels need K % {k_mult} == 0 "
                             f"and N % {n_mult} == 0, got N={N} K={K}")
        for t in (s, zs):
            if t.dtype != torch.bfloat16:
                raise ValueError("the kernels take bf16 s and zs")
        for t in (wp, s, zs):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the kernels take contiguous, 16-byte "
                                 "aligned weights")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return N


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with the 16-byte alignment the kernels' vector loads
    need (a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def rowsum_scratch(M: int, K: int, device: torch.device
                   ) -> Optional[torch.Tensor]:
    """The planes tile's row sums (#3, #9) for K > ROWSUM_SMEM_K_MAX: an
    int16 (ceil(M / 64) * 64, K / 128) scratch the kernel fills and reads
    back; None below, where they stay in shared memory."""
    if K <= ROWSUM_SMEM_K_MAX:
        return None
    return torch.empty((-(-M // 64) * 64, K // GROUP), dtype=torch.int16,
                       device=device)


def _w4a16_tile(x, wp, s, zs, s_bf16: int, masked: bool,
                out: torch.Tensor) -> None:
    """One launch of the bf16 tensor-core tile of #1 and #4
    (``csrc/w4a16_tile.cu``) into ``out`` (bf16 or f32)."""
    M, K = x.shape
    with torch.cuda.device(x.device):
        _launch(_tile_lib().lc_w4a16_tile, x.data_ptr(), wp.data_ptr(),
                s.data_ptr(), zs.data_ptr(), s_bf16, int(masked),
                out.data_ptr(), int(out.dtype == torch.float32), M,
                out.shape[1], K, _stream(x.device))


def w4a16_matmul(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                 zs: torch.Tensor) -> torch.Tensor:
    """#1: (M, K) float x (rounded to bf16) times W4 planes -> (M, N) in
    ``x.dtype``, stored by the kernel for bf16 and f32 x."""
    M, K = x.shape
    N = _check_weights(K, wp, s, zs, x.device)
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, wp, s, zs).to(x.dtype)
    xb = _aligned(x.to(torch.bfloat16))
    out = torch.empty((M, N), dtype=x.dtype if x.dtype in (
        torch.bfloat16, torch.float32) else torch.float32, device=x.device)
    _w4a16_tile(xb, wp, s, zs, 1, False, out)
    w4a16_matmul.launches += 1
    return out if out.dtype == x.dtype else out.to(x.dtype)


def _check_act(xq: torch.Tensor, x_scale: torch.Tensor) -> Tuple[int, int]:
    if xq.dtype != torch.int8 or xq.dim() != 2:
        raise ValueError("xq must be (M, K) int8")
    M, K = xq.shape
    if x_scale.shape != (M, 1) or x_scale.device != xq.device:
        raise ValueError(f"x_scale must be ({M}, 1) on xq's device")
    return M, K


def planes_body(M: int) -> str:
    """The body of #2 that takes M rows: ``"tile"`` (#3's planes tile) from
    PLANES_TILE_MIN_M rows on, else ``"decode"`` (the planes decode tile).
    By M alone."""
    return "tile" if M >= PLANES_TILE_MIN_M else "decode"


def decode_chan(N: int) -> int:
    """Channels a block of #2's planes decode tile: 16 up to
    DECODE_CHAN16_MAX_N, 32 above."""
    return 16 if N <= DECODE_CHAN16_MAX_N else 32


def _planes_tile(xq, xs, wp, s, zs, out: torch.Tensor) -> None:
    """One launch of the planes tile of #3 (and #2 from PLANES_TILE_MIN_M
    rows) into ``out`` (bf16 or f32), with the row-sum scratch past
    ROWSUM_SMEM_K_MAX; on the card N % 128 == 0."""
    M, K = xq.shape
    N = wp.shape[0]
    if N % TILE_N:
        raise ValueError(f"the planes tile needs N % {TILE_N} == 0, got "
                         f"N={N}")
    scratch = rowsum_scratch(M, K, xq.device)
    with torch.cuda.device(xq.device):
        _launch(_lib().lc_w4a8_prefill, xq.data_ptr(), xs.data_ptr(),
                wp.data_ptr(), s.data_ptr(), zs.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), int(out.dtype == torch.float32), M, N, K,
                _stream(xq.device))


def _w4a8_matmul_decode(xq, x_scale, wp, s, zs, out_dtype, body: str,
                        chan: Optional[int] = None) -> torch.Tensor:
    """#2 on the named body (``planes_body``; the decode tile with ``chan``
    channels a block, by default ``decode_chan(N)``); one launch, counted
    on ``w4a8_matmul_decode``."""
    M, K = _check_act(xq, x_scale)
    N = _check_weights(K, wp, s, zs, xq.device)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("#2 stores bf16 or f32")
    if xq.device.type == "cpu":
        return w4a8_matmul_decode_plain(xq, x_scale, wp, s, zs, out_dtype)
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if body == "tile":
        _planes_tile(xq, xs, wp, s, zs, out)
    else:
        with torch.cuda.device(xq.device):
            _launch(_lib().lc_w4a8_decode, xq.data_ptr(), xs.data_ptr(),
                    wp.data_ptr(), s.data_ptr(), zs.data_ptr(),
                    out.data_ptr(), int(out_dtype == torch.float32),
                    chan or decode_chan(N), M, N, K, _stream(xq.device))
    w4a8_matmul_decode.launches += 1
    return out


def w4a8_matmul_decode(xq: torch.Tensor, x_scale: torch.Tensor,
                       wp: torch.Tensor, s: torch.Tensor, zs: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """#2: (M, K) int8 x with (M, 1) f32 scale -> (M, N) in ``out_dtype``
    (f32 or bf16, stored by the kernel), in its TPU kernels' order
    (``w4a8_rows_tpu_order``) on the body ``planes_body(M)`` names."""
    return _w4a8_matmul_decode(xq, x_scale, wp, s, zs, out_dtype,
                               planes_body(xq.shape[0]))


def w4a8_matmul_prefill(xq: torch.Tensor, x_scale: torch.Tensor,
                        wp: torch.Tensor, s: torch.Tensor, zs: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """#3: any M; the act scale and the store in ``out_dtype`` (bf16 or
    f32) happen in the kernel, on the planes tile (on the card N % 128 ==
    0, any K % 1024 == 0); equal to ``w4a8_matmul_prefill_plain`` bit for
    bit."""
    M, K = _check_act(xq, x_scale)
    N = _check_weights(K, wp, s, zs, xq.device)
    if xq.device.type == "cpu":
        return w4a8_matmul_prefill_plain(xq, x_scale, wp, s, zs, out_dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the prefill kernel stores bf16 or f32")
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    _planes_tile(xq, xs, wp, s, zs, out)
    w4a8_matmul_prefill.launches += 1
    return out


def w4a8_matmul_planes_ksplit(xq: torch.Tensor, x_scale: torch.Tensor,
                              wp: torch.Tensor, s: torch.Tensor,
                              zs: torch.Tensor, splits: int = 2
                              ) -> torch.Tensor:
    """#5: #2's contract in two K halves, (part_0 + part_1) * x_scale;
    (M, N) f32.  K % 2048 == 0 and ``splits`` 2, as the JAX layout."""
    M, K = _check_act(xq, x_scale)
    N = _check_weights(K, wp, s, zs, xq.device)
    _check_ksplit(K, splits)
    if xq.device.type == "cpu":
        return w4a8_matmul_planes_ksplit_plain(xq, x_scale, wp, s, zs,
                                               splits)
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        _launch(_ksplit_lib().lc_w4a8_ksplit, xq.data_ptr(), xs.data_ptr(),
                wp.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
                M, N, K, _stream(xq.device))
    w4a8_matmul_planes_ksplit.launches += 1
    return out


def _fused_linear(kernel, x: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor, zs: torch.Tensor, rms: bool, eps: float,
                  export: bool):
    """#13 (``kernel`` is ``w4a8_linear_bytes_fused``) or #14: (y, int8
    codes, (M, 1) act scales); on the card the codes and scales only with
    ``export``, else None."""
    if x.dim() != 2:
        raise ValueError("x must be (M, K)")
    s4 = kernel is w4a8_linear_bytes_fused
    N = _check_weights(x.shape[1], w, s, zs, x.device,
                       "s4" if s4 else "planes")
    if x.device.type == "cpu":
        plain = (w4a8_linear_bytes_fused_plain if s4
                 else w4a8_linear_planes_fused_plain)
        return plain(x, w, s, zs, rms, eps)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the fused kernels take bf16 or f32 x")
    M, K = x.shape
    xc = _aligned(x)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    xq = xs = None
    if M == 0:
        return out, xq, xs
    if export:
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    fn = _bytes_lib().lc_w4a8_bytes_fused if s4 else \
        _lib().lc_w4a8_planes_fused
    with torch.cuda.device(x.device):
        _launch(fn, xc.data_ptr(), int(x.dtype == torch.float32),
                w.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
                None if xq is None else xq.data_ptr(),
                None if xs is None else xs.data_ptr(), M, N, K, int(rms),
                float(eps), _stream(x.device))
    kernel.launches += 1
    return out, xq, xs


def _fused_with_act(kernel, x: torch.Tensor, w: torch.Tensor,
                   s: torch.Tensor, zs: torch.Tensor, rms: bool = False,
                   eps: float = 1e-6):
    """``kernel`` (``w4a8_linear_bytes_fused`` or
    ``w4a8_linear_planes_fused``) returning also the int8 act codes and
    (M, 1) scales its prologue made: (y, codes, scales).  For counting
    act-code flips against the plain version; the engine never asks."""
    return _fused_linear(kernel, x, w, s, zs, rms, eps, True)


def w4a8_linear_planes_fused(x: torch.Tensor, wp: torch.Tensor,
                             s: torch.Tensor, zs: torch.Tensor,
                             rms: bool = False, eps: float = 1e-6
                             ) -> torch.Tensor:
    """#14: (M, K) unquantized x (the RMSNorm's input with ``rms``, its
    gamma folded into the planes weight) -> (M, N) in ``x.dtype``; the
    prologue (``fused_act_quant``) runs in the kernel."""
    return _fused_linear(w4a8_linear_planes_fused, x, wp, s, zs, rms, eps,
                         False)[0]


def bytes_body(M: int) -> str:
    """The body of #12 that takes M rows: ``"tile"`` (the int8
    tensor-core tile) from BYTES_TILE_MIN_M rows on, else ``"decode"`` (the
    decode block, a lane per channel).  By M alone."""
    return "tile" if M >= BYTES_TILE_MIN_M else "decode"


def _w4a8_matmul_bytes(xq, x_scale, wb, s, zs, body: str) -> torch.Tensor:
    """#12 on the named body (``bytes_body``); one launch, counted on
    ``w4a8_matmul_bytes``."""
    M, K = _check_act(xq, x_scale)
    N = _check_weights(K, wb, s, zs, xq.device, "s4")
    if xq.device.type == "cpu":
        return w4a8_matmul_bytes_plain(xq, x_scale, wb, s, zs)
    fn = {"tile": _bytes_lib().lc_w4a8_bytes_tile,
          "decode": _bytes_lib().lc_w4a8_bytes}[body]
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        _launch(fn, xq.data_ptr(), xs.data_ptr(), wb.data_ptr(),
                s.data_ptr(), zs.data_ptr(), out.data_ptr(), M, N, K,
                _stream(xq.device))
    w4a8_matmul_bytes.launches += 1
    return out


def w4a8_matmul_bytes(xq: torch.Tensor, x_scale: torch.Tensor,
                      wb: torch.Tensor, s: torch.Tensor,
                      zs: torch.Tensor) -> torch.Tensor:
    """#12: (M, K) int8 x with (M, 1) f32 scale times the byte-pair
    weight -> (M, N) f32, on the body ``bytes_body(M)`` names."""
    return _w4a8_matmul_bytes(xq, x_scale, wb, s, zs,
                              bytes_body(xq.shape[0]))


def w4a8_linear_bytes_fused(x: torch.Tensor, wb: torch.Tensor,
                            s: torch.Tensor, zs: torch.Tensor,
                            rms: bool = False, eps: float = 1e-6
                            ) -> torch.Tensor:
    """#13: #14's contract on the byte-pair weight, in its TPU kernel's
    float order (``w4a8_matmul_pairs_tpu_order`` on the act codes the
    prologue makes), on the int8 tensor-core decode tile."""
    return _fused_linear(w4a8_linear_bytes_fused, x, wb, s, zs, rms, eps,
                         False)[0]


def _check_f32_or_bf16_scales(N: int, G: int, s: torch.Tensor,
                              zs: torch.Tensor, device: torch.device) -> int:
    """(N, G) s and zs of one dtype, f32 or bf16, on ``device``; returns
    1 for bf16."""
    for name, t in (("s", s), ("zs", zs)):
        if t.shape != (N, G) or t.device != device:
            raise ValueError(f"{name} must be ({N}, {G}) on the "
                             f"activations' device, got {tuple(t.shape)}")
    if s.dtype != zs.dtype or s.dtype not in (torch.float32,
                                              torch.bfloat16):
        raise ValueError("s and zs are both f32 or both bf16")
    return int(s.dtype == torch.bfloat16)


def w4a16_matmul_planes_masked(x: torch.Tensor, wp: torch.Tensor,
                               s: torch.Tensor, zs: torch.Tensor
                               ) -> torch.Tensor:
    """#4: (M, K) x (rounded to bf16) times the masked planes ``wp``
    (N, K/8) int32 with pre-divided (N, G) ``s`` (``masked_scales``) and
    ``zs`` (``masked_zero_scales``), f32 or bf16 -> (M, N) f32.  K % 1024
    == 0; on the card N % 32 == 0."""
    if x.dim() != 2 or wp.dim() != 2 or wp.dtype != torch.int32:
        raise ValueError("x must be (M, K) and wp (N, K/8) int32")
    M, K = x.shape
    if K % (8 * GROUP) or wp.shape[1] * 8 != K:
        raise ValueError(f"#4 needs K % {8 * GROUP} == 0 and wp (N, K/8), "
                         f"got K={K}, wp {tuple(wp.shape)}")
    N = wp.shape[0]
    s_bf16 = _check_f32_or_bf16_scales(N, K // GROUP, s, zs, x.device)
    if wp.device != x.device:
        raise ValueError("all operands must be on one device")
    if x.device.type == "cpu":
        return w4a16_matmul_planes_masked_plain(x, wp, s, zs)
    if N % 32:
        raise ValueError(f"the masked kernel needs N % 32 == 0, got N={N}")
    xb = _aligned(x.to(torch.bfloat16))
    wp, s, zs = _aligned(wp), _aligned(s), _aligned(zs)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _w4a16_tile(xb, wp, s, zs, s_bf16, True, out)
    w4a16_matmul_planes_masked.launches += 1
    return out


def w4a8_matmul_s4_bytes(xq: torch.Tensor, x_scale: torch.Tensor,
                         wb: torch.Tensor, s: torch.Tensor,
                         zs: torch.Tensor) -> torch.Tensor:
    """#11: (M, K) int8 x with (M, 1) f32 scale times the natural s4 bytes
    ``wb`` (N, K/2) int8 (``pack_s4_bytes``), (N, G) ``s`` and ``zs`` =
    (z - 8)*s, f32 or bf16 -> (M, N) f32.  K % 128 == 0; on the card
    N % 32 == 0."""
    M, K = _check_act(xq, x_scale)
    if K % GROUP or wb.dim() != 2 or wb.dtype != torch.int8 \
            or wb.shape[1] * 2 != K:
        raise ValueError(f"#11 needs K % {GROUP} == 0 and wb (N, K/2) "
                         f"int8, got K={K}, wb {tuple(wb.shape)}")
    N = wb.shape[0]
    s_bf16 = _check_f32_or_bf16_scales(N, K // GROUP, s, zs, xq.device)
    if wb.device != xq.device:
        raise ValueError("all operands must be on one device")
    if xq.device.type == "cpu":
        return w4a8_matmul_s4_plain(xq, x_scale, wb, s, zs)
    if N % 32:
        raise ValueError(f"the s4 kernel needs N % 32 == 0, got N={N}")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    xq, wb, s, zs = _aligned(xq), _aligned(wb), _aligned(s), _aligned(zs)
    xs = x_scale.float().contiguous()
    with torch.cuda.device(xq.device):
        _launch(_bytes_lib().lc_w4a8_s4, xq.data_ptr(), xs.data_ptr(),
                wb.data_ptr(), s.data_ptr(), zs.data_ptr(), s_bf16,
                out.data_ptr(), M, N, K, _stream(xq.device))
    w4a8_matmul_s4_bytes.launches += 1
    return out


KERNELS = (w4a16_matmul, w4a8_matmul_decode, w4a8_matmul_prefill,
           w4a8_matmul_bytes, w4a8_linear_bytes_fused,
           w4a8_linear_planes_fused, w4a8_matmul_planes_ksplit,
           w4a16_matmul_planes_masked, w4a8_matmul_s4_bytes)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# routing (the JAX w4a8_matmul / *_available)
# ---------------------------------------------------------------------------

def _planes_ok(x: torch.Tensor, qp) -> bool:
    """The planes kernels take what JAX holds in its tiled serving layout
    (K % 1024, N % 128, bf16 scales) at groups of 128."""
    return qp.layout == "planes" and qp.tiled and qp.group_size == GROUP


def w4a16_matmul_available(x: torch.Tensor, qp) -> bool:
    """Decode regime (M <= 256) on the planes layout."""
    return _planes_ok(x, qp) and math.prod(x.shape[:-1]) <= DECODE_M_MAX


def w4a8_prefill_available(x: torch.Tensor, qp) -> bool:
    """Prefill regime (M > 256) on the planes layout."""
    return _planes_ok(x, qp) and math.prod(x.shape[:-1]) > DECODE_M_MAX


def s4_matmul_available(x: torch.Tensor, qp) -> bool:
    """Decode regime (M <= 256) on the s4 byte-pair layout, K % 512 == 0
    (the JAX ``s4_matmul_available``)."""
    return (qp.layout == "s4" and qp.group_size == GROUP
            and math.prod(x.shape[:-1]) <= DECODE_M_MAX
            and x.shape[-1] % (4 * GROUP) == 0)


def w4a8_s4_matmul(x: torch.Tensor, qp,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 apply on the s4 layout: per-token int8 act quant, then #12.
    Returns ``x.dtype``."""
    lead = x.shape[:-1]
    xq, xs = quantize_act_per_token(x.reshape(-1, x.shape[-1]))
    y = w4a8_matmul_bytes(xq, xs, qp.codes, qp.scales, qp.zeros).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1)


def w4a8_matmul_ks(x: torch.Tensor, qp,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 apply on the ``planes_ks`` layout (the JAX ``w4a8_matmul_ks``):
    per-token int8 act quant, then #5 at any M.  Returns ``x.dtype``."""
    lead = x.shape[:-1]
    xq, xs = quantize_act_per_token(x.reshape(-1, x.shape[-1]))
    y = w4a8_matmul_planes_ksplit(xq, xs, qp.codes, qp.scales,
                                  qp.zeros).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1)


def w4a8_matmul(x: torch.Tensor, qp,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 apply: per-token int8 act quant, then #2 at M <= 256 or #3
    above.  Returns ``x.dtype``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, xs = quantize_act_per_token(x2)
    # both kernels store bf16 and f32 themselves
    store = x.dtype if x.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    if x2.shape[0] > DECODE_M_MAX:
        y = w4a8_matmul_prefill(xq, xs, qp.codes, qp.scales, qp.zeros,
                                out_dtype=store)
    else:
        y = w4a8_matmul_decode(xq, xs, qp.codes, qp.scales, qp.zeros,
                               out_dtype=store)
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1)
