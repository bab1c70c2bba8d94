"""The fused layer tail: the post-attention half of a llama block in one
launch (#15 ``w4a8_attn_tail_fused``), and the same plus the next block's
merged q|k|v projection (#16 ``w4a8_layer_fused``), with their plain
PyTorch versions (port of lightcompress_tpu/ops/pallas_matmul.py kernels
#15 and #16).

Inputs: the attention context ``ctx`` and the residual stream ``x``, both
(B, H); the o (H, H), gate|up (2I, H) and down (H, I) weights, and for #16
the next block's q|k|v (Nq, H), each as untiled planes ``wp`` (N, K/8)
int32 with (N, G) bf16 ``s`` and ``zs`` (``ops.w4_matmul``; the gammas of
the two RMSNorms are folded into gate|up and q|k|v).  With q8 the
per-token int8 act quant (``w4_matmul.fused_act_quant``, the JAX kernels'
``_qdq_prologue``) and W the grouped W4A8 dot times the act scale:

    h   = f32(x) + W_o(q8(ctx))
    gu  = W_gateup(q8(rms(h)))                      (f32)
    mid = (g * logistic(g)) * u, g|u the halves     (f32, no bf16 rounding)
    y   = h + W_down(q8(mid))                       (returned in x.dtype)
    qkv = W_qkv(q8(rms(y)))  from the f32 y, #16    (returned in x.dtype)

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel (``csrc/layer_fused.cu``: one cooperative launch with grid-wide
barriers between the phases) or raises, also when the card refuses the
cooperative launch.  Each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .w4_matmul import (_aligned, _check_weights, _launch, _stream,
                        fused_act_quant, w4a8_matmul_decode_plain)

Linear = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Acts = List[Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card reference)
# ---------------------------------------------------------------------------

def _plain(ctx, x, o: Linear, gu: Linear, down: Linear,
           qkv: Optional[Linear], eps: float,
           srcs: Optional[List[torch.Tensor]] = None):
    """(y, qkv or None, the prologues' (codes, scales)), composed from
    ``fused_act_quant`` and the plain #2; ``srcs``, if given, receives each
    prologue's input (ctx, h, mid, y)."""
    acts: Acts = []

    def lin(t, w, rms):
        if srcs is not None:
            srcs.append(t)
        xq, xs = fused_act_quant(t, rms, eps)
        acts.append((xq, xs))
        return w4a8_matmul_decode_plain(xq, xs, *w)

    h = x.float() + lin(ctx, o, False)
    g, u = lin(h, gu, True).chunk(2, dim=-1)
    y = h + lin((g * torch.sigmoid(g)) * u, down, False)
    q = lin(y, qkv, True).to(x.dtype) if qkv is not None else None
    return y.to(x.dtype), q, acts


def w4a8_attn_tail_fused_plain(ctx, x, wo, so, zso, wg, sg, zsg, wd, sd,
                               zsd, eps: float = 1e-6) -> torch.Tensor:
    """Plain #15: y (B, H) in ``x.dtype``."""
    return _plain(ctx, x, (wo, so, zso), (wg, sg, zsg), (wd, sd, zsd), None,
                  eps)[0]


def w4a8_layer_fused_plain(ctx, x, wo, so, zso, wg, sg, zsg, wd, sd, zsd,
                           wq, sq, zsq, eps: float = 1e-6
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain #16: (y (B, H), qkv (B, Nq)), both in ``x.dtype``."""
    y, q, _ = _plain(ctx, x, (wo, so, zso), (wg, sg, zsg), (wd, sd, zsd),
                     (wq, sq, zsq), eps)
    return y, q


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_fused")
    lib.lc_layer_fused.argtypes = [_P] * 18 + [_I] * 5 + [ctypes.c_float,
                                                          _I, _P]
    lib.lc_layer_fused.restype = ctypes.c_int
    lib.lc_layer_fused_grid.argtypes = [_I] * 6
    lib.lc_layer_fused_grid.restype = ctypes.c_int
    return lib


def grid_blocks(B: int, H: int, I: int, Nq: int, nxt: bool,
                max_blocks: int = 0) -> int:
    """The blocks of the cooperative grid a launch at these shapes takes on
    the current card: the co-resident count (or ``max_blocks`` if smaller),
    at most the largest phase's tile count; 0 if the card refuses."""
    return _lib().lc_layer_fused_grid(B, H, I, Nq, int(nxt), max_blocks)


def _check(ctx, x, o: Linear, gu: Linear, down: Linear,
           qkv: Optional[Linear]) -> Tuple[int, int, int]:
    """Shapes of the activations and weights, and on the card the
    kernel's types and layout; returns (H, I, Nq)."""
    if ctx.dim() != 2 or ctx.shape != x.shape or ctx.device != x.device:
        raise ValueError("ctx and x must be (B, H) on one device")
    H = x.shape[1]
    if _check_weights(H, *o, x.device) != H:
        raise ValueError(f"o must be ({H}, {H // 8}) planes")
    I2 = _check_weights(H, *gu, x.device)
    if I2 % 2:
        raise ValueError("gate|up must have an even number of rows")
    I = I2 // 2
    if _check_weights(I, *down, x.device) != H:
        raise ValueError(f"down must be ({H}, {I // 8}) planes")
    Nq = 0 if qkv is None else _check_weights(H, *qkv, x.device)
    if x.device.type == "cuda":
        if ctx.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
            raise ValueError("the kernel takes bf16 ctx and x")
        if H % 1024 or I % 1024:
            raise ValueError(f"the kernel needs H % 1024 == 0 and "
                             f"I % 1024 == 0, got H={H} I={I}")
    return H, I, Nq


def _run(kernel, ctx, x, o: Linear, gu: Linear, down: Linear,
         qkv: Optional[Linear], eps: float, max_blocks: int, export: bool):
    """(y, qkv or None, the prologues' (codes, scales) or None)."""
    H, I, Nq = _check(ctx, x, o, gu, down, qkv)
    if x.device.type == "cpu":
        return _plain(ctx, x, o, gu, down, qkv, eps)
    B, dev = x.shape[0], x.device
    ctx, x = _aligned(ctx), _aligned(x)
    y = torch.empty((B, H), dtype=x.dtype, device=dev)
    q = (torch.empty((B, Nq), dtype=x.dtype, device=dev)
         if qkv is not None else None)
    # f32: h (B, H), gate|up (B, 2I), y (B, H), the four act scales (B);
    # int8: the four prologues' codes (B, H), (B, H), (B, I), (B, H)
    wf = torch.empty(B * (2 * H + 2 * I + 4), dtype=torch.float32,
                     device=dev)
    wi = torch.empty(B * (3 * H + I), dtype=torch.int8, device=dev)
    qa = qkv if qkv is not None else (None, None, None)
    ptr = [None if t is None else t.data_ptr()
           for t in (ctx, x, *o, *gu, *down, *qa, y, q, wf, wi)]
    with torch.cuda.device(dev):
        _launch(_lib().lc_layer_fused, *ptr, B, H, I, Nq,
                int(qkv is not None), float(eps), max_blocks, _stream(dev))
    kernel.launches += 1
    acts = None
    if export:
        xs0 = B * (2 * H + 2 * I)
        offs, ks = [0, B * H, 2 * B * H, 2 * B * H + B * I], [H, H, I, H]
        n = 4 if qkv is not None else 3
        acts = [(wi[offs[k]:offs[k] + B * ks[k]].view(B, ks[k]),
                 wf[xs0 + k * B:xs0 + (k + 1) * B].view(B, 1))
                for k in range(n)]
    return y, q, acts


def w4a8_attn_tail_fused(ctx: torch.Tensor, x: torch.Tensor,
                         wo, so, zso, wg, sg, zsg, wd, sd, zsd,
                         eps: float = 1e-6) -> torch.Tensor:
    """#15: ctx, x (B, H) -> y (B, H) in ``x.dtype``."""
    return _run(w4a8_attn_tail_fused, ctx, x, (wo, so, zso), (wg, sg, zsg),
                (wd, sd, zsd), None, eps, 0, False)[0]


def w4a8_layer_fused(ctx: torch.Tensor, x: torch.Tensor,
                     wo, so, zso, wg, sg, zsg, wd, sd, zsd, wq, sq, zsq,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """#16: ctx, x (B, H) -> (y (B, H), qkv (B, Nq)) in ``x.dtype``, the
    next block's q|k|v projection of rms(y) from the f32 y."""
    y, q, _ = _run(w4a8_layer_fused, ctx, x, (wo, so, zso), (wg, sg, zsg),
                   (wd, sd, zsd), (wq, sq, zsq), eps, 0, False)
    return y, q


def _with_act(kernel, ctx, x, *weights, eps: float = 1e-6,
              max_blocks: int = 0):
    """``kernel`` (#15 or #16) returning (y, qkv or None, [(codes,
    scales)] of each prologue: ctx, rms(h), mid and, for #16, rms(y)).
    For counting act-code flips against the plain version, and, with
    ``max_blocks`` > 0, on a grid capped below the co-resident count; the
    bench never asks."""
    lins = [tuple(weights[i:i + 3]) for i in range(0, len(weights), 3)]
    qkv = lins[3] if kernel is w4a8_layer_fused else None
    return _run(kernel, ctx, x, *lins[:3], qkv, eps, max_blocks, True)


KERNELS = (w4a8_attn_tail_fused, w4a8_layer_fused)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
