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
kernel (``csrc/layer_fused.cu``: one persistent cooperative launch, the
products on int8 tensor cores, grid-wide barriers between the phases) or
raises, also when the card refuses the cooperative launch.  Each wrapper
counts its launches in ``launches``; ``_with_act`` can also return the
prologues' codes and the launch's phase stamps (``phase_times``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .w4_matmul import (_aligned, _check_weights, _launch, _stream,
                        fused_act_quant, w4a8_rows_phase_dot)

Linear = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Acts = List[Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card reference)
# ---------------------------------------------------------------------------

def _plain(ctx, x, o: Linear, gu: Linear, down: Linear,
           qkv: Optional[Linear], eps: float,
           srcs: Optional[List[torch.Tensor]] = None):
    """(y, qkv or None, the prologues' (codes, scales)), composed from
    ``fused_act_quant`` and ``w4a8_rows_phase_dot`` (each matmul phase in
    the order of the TPU kernels' ``_phase_dot``); ``srcs``, if given,
    receives each prologue's input (ctx, h, mid, y)."""
    acts: Acts = []

    def lin(t, w, rms):
        if srcs is not None:
            srcs.append(t)
        xq, xs = fused_act_quant(t, rms, eps)
        acts.append((xq, xs))
        return w4a8_rows_phase_dot(xq, xs, *w)

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
# the kernel's segments, a prologue (act quant) and the products of each
# phase, in launch order
SEGMENTS = ("act_o", "o", "act_gateup", "gateup", "act_down", "down",
            "act_qkv", "qkv")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_fused")
    lib.lc_layer_fused.argtypes = [_P] * 20 + [_I] * 5 + [ctypes.c_float,
                                                          _I, _P]
    lib.lc_layer_fused.restype = ctypes.c_int
    lib.lc_layer_fused_plan.argtypes = [_I] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.lc_layer_fused_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, I: int, Nq: int, nxt: bool, max_blocks: int,
          device: int) -> Optional[dict]:
    out = (ctypes.c_longlong * 9)()
    with torch.cuda.device(device):
        rc = _lib().lc_layer_fused_plan(B, H, I, Nq, int(nxt), max_blocks,
                                        out)
    if rc != 0:
        return None
    return dict(grid=out[0], smem_bytes=out[1],
                splits=dict(zip(("o", "gateup", "down", "qkv"), out[2:6])),
                f32=out[6], i32=out[7], stamps=out[8])


def plan(B: int, H: int, I: int, Nq: int, nxt: bool,
         max_blocks: int = 0) -> Optional[dict]:
    """The launch at these shapes on the current card: its cooperative
    grid (the co-resident count, or ``max_blocks`` if smaller, at most the
    finest work of a phase), the shared memory of a block, the splits of
    each phase's group range, the workspaces; None if the card refuses."""
    return _plan(B, H, I, Nq, bool(nxt), max_blocks,
                 torch.cuda.current_device())


def grid_blocks(B: int, H: int, I: int, Nq: int, nxt: bool,
                max_blocks: int = 0) -> int:
    """The blocks of the cooperative grid a launch at these shapes takes on
    the current card (``plan``); 0 if the card refuses."""
    pl = plan(B, H, I, Nq, nxt, max_blocks)
    return 0 if pl is None else pl["grid"]


def phase_times(stamps: torch.Tensor, nxt: bool) -> dict:
    """The µs of each segment of a launch from its stamps (``_with_act``):
    ``<segment>_us`` from block 0 past the previous barrier (or the start)
    to the last block's arrival, ``<segment>_block0_us`` to block 0's own
    arrival, ``<segment>_barrier_us`` from the last arrival to block 0 past
    the barrier that follows, and ``total_us``."""
    st = [int(v) for v in stamps.tolist()]
    out = {}
    begin = st[0]
    segs = SEGMENTS[:8 if nxt else 6]
    for s, name in enumerate(segs):
        block0, last, past = st[1 + 3 * s:4 + 3 * s]
        out[f"{name}_us"] = (last - begin) / 1e3
        out[f"{name}_block0_us"] = (block0 - begin) / 1e3
        if s + 1 < len(segs):
            out[f"{name}_barrier_us"] = (past - last) / 1e3
            begin = past
    out["total_us"] = (st[3 * len(segs) - 1] - st[0]) / 1e3
    return out


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
         qkv: Optional[Linear], eps: float, max_blocks: int, export: bool,
         stamps: Optional[list] = None):
    """(y, qkv or None, the prologues' (codes, scales) or None); with
    ``stamps`` a list, the launch's stamps tensor is appended to it."""
    H, I, Nq = _check(ctx, x, o, gu, down, qkv)
    if x.device.type == "cpu":
        return _plain(ctx, x, o, gu, down, qkv, eps)
    B, dev = x.shape[0], x.device
    nxt = qkv is not None
    with torch.cuda.device(dev):
        pl = plan(B, H, I, Nq, nxt, max_blocks)
    if pl is None:
        raise RuntimeError("the card refuses the cooperative launch of "
                           f"{kernel.__name__} at B={B} H={H} I={I}")
    ctx, x = _aligned(ctx), _aligned(x)
    y = torch.empty((B, H), dtype=x.dtype, device=dev)
    q = torch.empty((B, Nq), dtype=x.dtype, device=dev) if nxt else None
    # f32: h (B, H), mid (B, I), y (B, H), the four act scales (B), the
    # rows' statistics and the splits' parts; int8: the four prologues'
    # codes (B, H), (B, H), (B, I), (B, H); int32: the meet counters and
    # the prologues' row amax
    wf = torch.empty(pl["f32"], dtype=torch.float32, device=dev)
    wi = torch.empty(B * (3 * H + I), dtype=torch.int8, device=dev)
    wc = torch.empty(pl["i32"], dtype=torch.int32, device=dev)
    st = None
    if stamps is not None:
        st = torch.zeros(pl["stamps"], dtype=torch.int64, device=dev)
        stamps.append(st)
    qa = qkv if nxt else (None, None, None)
    ptr = [None if t is None else t.data_ptr()
           for t in (ctx, x, *o, *gu, *down, *qa, y, q, wf, wi, wc, st)]
    with torch.cuda.device(dev):
        _launch(_lib().lc_layer_fused, *ptr, B, H, I, Nq, int(nxt),
                float(eps), max_blocks, _stream(dev))
    kernel.launches += 1
    acts = None
    if export:
        xs0 = B * (2 * H + I)
        offs, ks = [0, B * H, 2 * B * H, 2 * B * H + B * I], [H, H, I, H]
        acts = [(wi[offs[k]:offs[k] + B * ks[k]].view(B, ks[k]),
                 wf[xs0 + k * B:xs0 + (k + 1) * B].view(B, 1))
                for k in range(4 if nxt else 3)]
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
              max_blocks: int = 0, stamps: Optional[list] = None):
    """``kernel`` (#15 or #16) returning (y, qkv or None, [(codes,
    scales)] of each prologue: ctx, rms(h), mid and, for #16, rms(y)).
    For counting act-code flips against the plain version; with
    ``max_blocks`` > 0 on a grid capped below the co-resident count; with
    ``stamps`` a list, the launch's segment stamps are appended to it
    (``phase_times``).  The bench never asks."""
    lins = [tuple(weights[i:i + 3]) for i in range(0, len(weights), 3)]
    qkv = lins[3] if kernel is w4a8_layer_fused else None
    return _run(kernel, ctx, x, *lins[:3], qkv, eps, max_blocks, True,
                stamps)


KERNELS = (w4a8_attn_tail_fused, w4a8_layer_fused)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
