"""Stacked-expert matmuls of the MoE serving path: the five Hopper kernels
with their plain PyTorch versions (port of
lightcompress_tpu/ops/pallas_matmul.py, kernels #6 ``w4a8_stacked_matmul``,
#7 ``w4a8_stacked_matmul_smallm``, #8 ``w4a8_gathered_matmul``, #9
``w4a8_grouped_matmul`` and #10 ``w8a8_grouped_matmul``).

Weights are E experts of the untiled planes layout of ``ops.w4_matmul``,
stacked: ``wp`` (E, N, K/8) int32, ``s`` and ``zs`` (E, N, G) per-group
scales and premultiplied zero corrections.  Activations are int8 per token
in natural K order with (rows, 1) f32 scales.  Every entry point computes,
per row and expert, in the float order of the TPU kernels: for gi in
0..gpp-1 (gpp = G/8) and then plane j in 0..7, group g = j*gpp + gi, the
exact integer group dot times s[g] added to accumulator j % 4; the zero
correction sum of xsum[g]*zs[g] over the same order; then
((a0 + a1) + (a2 + a3) - corr) * xscale, every op rounded on its own.  The
plain versions run that sequence of f32 ops, so the kernels
(``csrc/w4_moe.cu``) equal them bit for bit.

#7 takes #6's inputs and computes the same function in the order of the
TPU's small-M kernel: per group-block gi one dot, in f32, of x's int8
values as bf16 with the weights u * s rounded to bf16, added to one
accumulator; then minus the f32 zero correction and times xscale.  Its
kernel runs on #1's bf16 tensor-core tile (the weights bf16(u * s) made
in registers, one rounded bf16x2 product), whose dots sum inside the
tensor core, so it agrees with its plain version to f32 rounding, not bit
for bit.

#8 runs on #2's planes decode tile (int8 tensor cores) with gathered
rows: a block leads the tile of up to ``GATHER_TILE_ROWS`` selections of
one expert, so each distinct expert's weight streams once a call; the
indices stay on the device.

#6 has two bodies, chosen by B alone (``stacked_body``): below
``STACKED_TILE_MIN_B`` rows the decode block (a lane per channel), from
there on the planes tile it shares with #3 and #9 (64 rows of one expert
a block); both keep the TPU order, bit for bit.

#10 is the grouped route's int8 per-channel expert (the ``stacked``
fallback of ``quantize_linear_stacked``): codes (E, N, K) int8 and f32
scales (E, N, 1); y = (f32(x . w) * scale) * xscale with an exact integer
dot (``csrc/w8_grouped.cu``: persistent blocks over 128 x 128 tiles, a TMA
ring feeding int8 wgmma), equal to its plain version bit for bit.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .w4_matmul import (GROUP, _aligned, _launch, _stream, rowsum_scratch,
                        unpack_int4_planes, w4a8_rows_tpu_order)

# rows of one expert segment of the grouped layout (moe_group_selections);
# the kernel takes multiples of its 64-row tile
M_TILE = 128
# #6 runs on the planes tile from this many rows on, on its decode block
# below (the crossover measured on the H100 by chip_smoke.py's
# moe_kernels phase at Mixtral-8x7B's and Qwen3-30B-A3B's shapes)
STACKED_TILE_MIN_B = 16
# #8: the selections of one expert a block's tile takes (one m16 tile of
# the planes decode tile; the kernel's blocks are 32 channels wide)
GATHER_TILE_ROWS = 16


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card reference)
# ---------------------------------------------------------------------------

# one expert's rows: (M, K) int8 x with (M, 1) f32 scales against its
# planes weight ((N, K/8) codes, (N, G) s and zs) -> (M, N) f32 in the TPU
# kernels' order (module docstring), the order of plain #3 as well
expert_rows_plain = w4a8_rows_tpu_order


def expert_rows_smallm_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                             wp: torch.Tensor, s: torch.Tensor,
                             zs: torch.Tensor) -> torch.Tensor:
    """#7's function for one expert: (M, K) int8 x -> (M, N) f32.  For
    each group-block gi, the 8 groups j*gpp + gi of x (int8, exact in
    bf16 and f32) against the weights bf16(u * s) (the product of two bf16
    values is exact in f32, then rounded to bf16), one f32 matmul added to
    the accumulator; then minus xsum . zs (an f32 matmul) and times
    xscale."""
    M, K = xq.shape
    N, G = s.shape
    gpp = G // 8
    g = K // G
    xg = xq.float().reshape(M, G, g)
    u = unpack_int4_planes(wp, K).float().reshape(N, G, g)
    w = (u * s.float()[..., None]).to(torch.bfloat16).float()
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for gi in range(gpp):
        gg = list(range(gi, G, gpp))  # planes j = 0..7 of group-block gi
        acc = acc + torch.matmul(xg[:, gg].reshape(M, 8 * g),
                                 w[:, gg].reshape(N, 8 * g).t())
    corr = torch.matmul(xg.sum(dim=-1), zs.float().t())
    return (acc - corr) * x_scale.float()


def w4a8_stacked_matmul_plain(xq, x_scale, wp, s, zs, pair=False):
    """Plain #6: (E, B, N) f32 for every expert, on the shared (B, K) x
    or, with ``pair``, on each expert's own rows of (E, B, K) x."""
    return torch.stack([
        expert_rows_plain(xq[e] if pair else xq,
                          x_scale[e] if pair else x_scale, wp[e], s[e],
                          zs[e]) for e in range(wp.shape[0])])


def w4a8_stacked_matmul_smallm_plain(xq, x_scale, wp, s, zs, pair=False):
    """Plain #7: #6's inputs and output, #7's order of operations."""
    return torch.stack([
        expert_rows_smallm_plain(xq[e] if pair else xq,
                                 x_scale[e] if pair else x_scale, wp[e],
                                 s[e], zs[e]) for e in range(wp.shape[0])])


def w4a8_gathered_matmul_plain(xq, x_scale, wp, s, zs, e_idx, t_idx):
    """Plain #8: out[s] = x[t_idx[s]] . W[e_idx[s]]^T, (n_sel, N) f32; a
    selection with an index out of range is a NaN row, as the kernel
    writes it."""
    out = torch.full((e_idx.shape[0], wp.shape[1]), float("nan"),
                     dtype=torch.float32, device=xq.device)
    e_idx, t_idx = e_idx.long(), t_idx.long()
    ok = (e_idx >= 0) & (e_idx < wp.shape[0]) & (t_idx >= 0) & \
        (t_idx < xq.shape[0])
    for e in torch.unique(e_idx[ok]).tolist():
        sel = torch.nonzero((e_idx == e) & ok)[:, 0]
        rows = t_idx[sel]
        out[sel] = expert_rows_plain(xq[rows], x_scale[rows], wp[e], s[e],
                                     zs[e])
    return out


def w4a8_grouped_matmul_plain(xq, x_scale, wp, s, zs, block_eid,
                              m_tile=M_TILE):
    """Plain #9: out[r] = x[r] . W[block_eid[r // m_tile]]^T, (Mp, N)
    f32; rows of an expert id out of range are NaN, as the kernel writes
    them."""
    row_e = block_eid.long().repeat_interleave(m_tile)
    out = torch.full((xq.shape[0], wp.shape[1]), float("nan"),
                     dtype=torch.float32, device=xq.device)
    for e in torch.unique(row_e).tolist():
        if not 0 <= e < wp.shape[0]:
            continue
        rows = torch.nonzero(row_e == e)[:, 0]
        out[rows] = expert_rows_plain(xq[rows], x_scale[rows], wp[e], s[e],
                                      zs[e])
    return out


def w8a8_grouped_matmul_plain(xq, x_scale, codes, scales, block_eid,
                              m_tile=M_TILE):
    """Plain #10: out[r] = (f32(x[r] . w_e) * scale_e) * xscale[r] with e =
    block_eid[r // m_tile], (Mp, N) f32.  The integer dots are float64
    matmuls of integers, exact at any K a model has; rows of an expert id
    out of range are NaN, as the kernel writes them."""
    E, N, _ = codes.shape
    row_e = block_eid.long().repeat_interleave(m_tile)
    out = torch.full((xq.shape[0], N), float("nan"), dtype=torch.float32,
                     device=xq.device)
    for e in torch.unique(row_e).tolist():
        if not 0 <= e < E:
            continue
        rows = torch.nonzero(row_e == e)[:, 0]
        acc = torch.matmul(xq[rows].double(), codes[e].double().t())
        out[rows] = (acc.float() * scales[e].float().reshape(1, N)
                     ) * x_scale[rows].float()
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("w4_moe")
    lib.lc_w4a8_stacked.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _P]
    lib.lc_w4a8_gathered.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _P]
    lib.lc_w4a8_grouped.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _P]
    lib.lc_w4a8_stacked_smallm.argtypes = lib.lc_w4a8_stacked.argtypes
    lib.lc_w4a8_stacked_tile.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _P]
    for fn in (lib.lc_w4a8_stacked, lib.lc_w4a8_gathered,
               lib.lc_w4a8_grouped, lib.lc_w4a8_stacked_smallm,
               lib.lc_w4a8_stacked_tile):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _w8_lib() -> ctypes.CDLL:
    lib = _build.load("w8_grouped")
    lib.lc_w8a8_grouped.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _P]
    lib.lc_w8a8_grouped.restype = ctypes.c_int
    return lib


def _check_experts(K: int, wp: torch.Tensor, s: torch.Tensor,
                   zs: torch.Tensor, device: torch.device):
    """Checks a stacked planes weight; returns (E, N)."""
    if wp.dtype != torch.int32 or wp.dim() != 3 or wp.shape[2] * 8 != K:
        raise ValueError(f"the weight must be (E, N, {K // 8}) int32, got "
                         f"{tuple(wp.shape)} {wp.dtype}")
    E, N = wp.shape[:2]
    G = s.shape[-1]
    if s.dim() != 3 or s.shape[:2] != (E, N) or zs.shape != s.shape \
            or G == 0 or K % G or (K // 8) % (K // G):
        raise ValueError(f"s and zs must be ({E}, {N}, G), K/8 a multiple "
                         f"of the group K/G, got {tuple(s.shape)} and "
                         f"{tuple(zs.shape)}")
    for t in (wp, s, zs):
        if t.device != device:
            raise ValueError("all operands must be on one device")
    if device.type == "cuda":
        if K % (8 * GROUP) or N % 128 or s.shape[2] != K // GROUP:
            raise ValueError(f"the MoE kernels need groups of {GROUP}, "
                             f"K % {8 * GROUP} == 0 and N % 128 == 0, got "
                             f"N={N} K={K} G={s.shape[2]}")
        for t in (s, zs):
            if t.dtype != torch.bfloat16:
                raise ValueError("the kernels take bf16 s and zs")
        for t in (wp, s, zs):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("the kernels take contiguous, 16-byte "
                                 "aligned weights")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return E, N


def _check_rows(xq: torch.Tensor, x_scale: torch.Tensor, lead: tuple):
    if xq.dtype != torch.int8 or xq.shape[:-1] != lead:
        raise ValueError(f"xq must be {lead + ('K',)} int8, got "
                         f"{tuple(xq.shape)} {xq.dtype}")
    if x_scale.shape != (*lead, 1) or x_scale.device != xq.device:
        raise ValueError(f"x_scale must be {(*lead, 1)} on xq's device, got "
                         f"{tuple(x_scale.shape)}")


def _index(t: torch.Tensor, n: int, name: str, device) -> torch.Tensor:
    if t.dim() != 1 or t.shape[0] != n or t.device != device:
        raise ValueError(f"{name} must be ({n},) on the operands' device")
    return t.to(torch.int32).contiguous()


def _stacked(kernel, plain, entry: str, xq, x_scale, wp, s, zs, pair):
    """#6 or #7: the shared checks, the CPU's plain version, the launch
    (``entry``: the C function; #6's tile also takes the row-sum
    scratch)."""
    K = xq.shape[-1]
    E, N = _check_experts(K, wp, s, zs, xq.device)
    B = xq.shape[-2]
    _check_rows(xq, x_scale, (E, B) if pair else (B,))
    if xq.device.type == "cpu":
        return plain(xq, x_scale, wp, s, zs, pair)
    out = torch.empty((E, B, N), dtype=torch.float32, device=xq.device)
    if B == 0:
        return out
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    scratch = ()
    if entry == "lc_w4a8_stacked_tile":
        t = rowsum_scratch(E * (-(-B // 64)) * 64, K, xq.device)
        scratch = (None if t is None else t.data_ptr(),)
    with torch.cuda.device(xq.device):
        _launch(getattr(_lib(), entry), xq.data_ptr(), xs.data_ptr(),
                wp.data_ptr(), s.data_ptr(), zs.data_ptr(), *scratch,
                out.data_ptr(), int(pair), B, N, K, E, _stream(xq.device))
    kernel.launches += 1
    return out


def stacked_body(B: int) -> str:
    """The body of #6 that takes B rows: ``"tile"`` (the planes tile) from
    STACKED_TILE_MIN_B rows on, else ``"decode"`` (the decode block, a lane
    per channel).  By B alone."""
    return "tile" if B >= STACKED_TILE_MIN_B else "decode"


def _w4a8_stacked_matmul(xq, x_scale, wp, s, zs, pair: bool, body: str
                         ) -> torch.Tensor:
    """#6 on the named body (``stacked_body``); one launch, counted on
    ``w4a8_stacked_matmul``."""
    entry = {"tile": "lc_w4a8_stacked_tile",
             "decode": "lc_w4a8_stacked"}[body]
    return _stacked(w4a8_stacked_matmul, w4a8_stacked_matmul_plain, entry,
                    xq, x_scale, wp, s, zs, pair)


def w4a8_stacked_matmul(xq: torch.Tensor, x_scale: torch.Tensor,
                        wp: torch.Tensor, s: torch.Tensor, zs: torch.Tensor,
                        pair: bool = False) -> torch.Tensor:
    """#6: (B, K) int8 x shared by every expert, or with ``pair`` (E, B, K)
    x whose slice e expert e reads -> (E, B, N) f32, on the body
    ``stacked_body(B)`` names."""
    return _w4a8_stacked_matmul(xq, x_scale, wp, s, zs, pair,
                                stacked_body(xq.shape[-2]))


def w4a8_stacked_matmul_smallm(xq: torch.Tensor, x_scale: torch.Tensor,
                               wp: torch.Tensor, s: torch.Tensor,
                               zs: torch.Tensor, pair: bool = False
                               ) -> torch.Tensor:
    """#7: #6's function in the order of the TPU's small-M kernel (bf16
    weights with their scales folded in; module docstring)."""
    return _stacked(w4a8_stacked_matmul_smallm,
                    w4a8_stacked_matmul_smallm_plain,
                    "lc_w4a8_stacked_smallm", xq, x_scale, wp, s, zs, pair)


def w4a8_gathered_matmul(xq: torch.Tensor, x_scale: torch.Tensor,
                         wp: torch.Tensor, s: torch.Tensor, zs: torch.Tensor,
                         e_idx: torch.Tensor, t_idx: torch.Tensor
                         ) -> torch.Tensor:
    """#8: out[s] = x[t_idx[s]] . W[e_idx[s]]^T -> (n_sel, N) f32, for
    (n, K) int8 x; each distinct selected expert's weight is read once, a
    selection with an index out of range is a NaN row.  The indices stay
    on the device (no host sync)."""
    n, K = xq.shape
    E, N = _check_experts(K, wp, s, zs, xq.device)
    _check_rows(xq, x_scale, (n,))
    n_sel = e_idx.shape[0]
    e_idx = _index(e_idx, n_sel, "e_idx", xq.device)
    t_idx = _index(t_idx, n_sel, "t_idx", xq.device)
    if xq.device.type == "cpu":
        return w4a8_gathered_matmul_plain(xq, x_scale, wp, s, zs, e_idx,
                                          t_idx)
    out = torch.empty((n_sel, N), dtype=torch.float32, device=xq.device)
    if n_sel == 0:
        return out
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    with torch.cuda.device(xq.device):
        _launch(_lib().lc_w4a8_gathered, xq.data_ptr(), xs.data_ptr(),
                wp.data_ptr(), s.data_ptr(), zs.data_ptr(), e_idx.data_ptr(),
                t_idx.data_ptr(), out.data_ptr(), n, n_sel, N, K, E,
                _stream(xq.device))
    w4a8_gathered_matmul.launches += 1
    return out


def w4a8_grouped_matmul(xq: torch.Tensor, x_scale: torch.Tensor,
                        wp: torch.Tensor, s: torch.Tensor, zs: torch.Tensor,
                        block_eid: torch.Tensor, m_tile: int = M_TILE
                        ) -> torch.Tensor:
    """#9: out[r] = x[r] . W[block_eid[r // m_tile]]^T -> (Mp, N) f32, for
    (Mp, K) int8 rows sorted by expert into m_tile segments."""
    Mp, K = xq.shape
    E, N = _check_experts(K, wp, s, zs, xq.device)
    _check_rows(xq, x_scale, (Mp,))
    if m_tile <= 0 or Mp % m_tile:
        raise ValueError(f"Mp={Mp} is not a multiple of m_tile={m_tile}")
    block_eid = _index(block_eid, Mp // m_tile, "block_eid", xq.device)
    if xq.device.type == "cpu":
        return w4a8_grouped_matmul_plain(xq, x_scale, wp, s, zs, block_eid,
                                         m_tile)
    if m_tile % 64:
        raise ValueError(f"the grouped kernel takes m_tile % 64 == 0, got "
                         f"m_tile={m_tile}")
    out = torch.empty((Mp, N), dtype=torch.float32, device=xq.device)
    if Mp == 0:
        return out
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    scratch = rowsum_scratch(Mp, K, xq.device)
    with torch.cuda.device(xq.device):
        _launch(_lib().lc_w4a8_grouped, xq.data_ptr(), xs.data_ptr(),
                wp.data_ptr(), s.data_ptr(), zs.data_ptr(),
                block_eid.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), Mp, N, K, E, m_tile, _stream(xq.device))
    w4a8_grouped_matmul.launches += 1
    return out


def w8a8_grouped_matmul(xq: torch.Tensor, x_scale: torch.Tensor,
                        codes: torch.Tensor, scales: torch.Tensor,
                        block_eid: torch.Tensor, m_tile: int = M_TILE
                        ) -> torch.Tensor:
    """#10: out[r] = (f32(x[r] . w_e) * scale_e) * xscale[r], e =
    block_eid[r // m_tile] -> (Mp, N) f32, for (Mp, K) int8 rows sorted by
    expert into m_tile segments and int8 per-channel experts: codes (E, N,
    K) int8, scales (E, N, 1).  Any N: the kernel masks the ragged edge of
    its last 128-channel tile.  On the card, persistent blocks (one an SM)
    walk the 128-row (64-row where m_tile % 128 != 0) by 128-channel tiles
    on TMA-fed int8 wgmma."""
    Mp, K = xq.shape
    if codes.dtype != torch.int8 or codes.dim() != 3 \
            or codes.shape[2] != K:
        raise ValueError(f"codes must be (E, N, {K}) int8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    E, N, _ = codes.shape
    if scales.shape != (E, N, 1) or not scales.is_floating_point():
        raise ValueError(f"scales must be ({E}, {N}, 1) float, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    _check_rows(xq, x_scale, (Mp,))
    if m_tile <= 0 or Mp % m_tile:
        raise ValueError(f"Mp={Mp} is not a multiple of m_tile={m_tile}")
    block_eid = _index(block_eid, Mp // m_tile, "block_eid", xq.device)
    for t in (codes, scales):
        if t.device != xq.device:
            raise ValueError("all operands must be on one device")
    if xq.device.type == "cpu":
        return w8a8_grouped_matmul_plain(xq, x_scale, codes, scales,
                                         block_eid, m_tile)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    if K % 16 or m_tile % 64:
        raise ValueError(f"the int8 grouped kernel takes K % 16 == 0 and "
                         f"m_tile % 64 == 0, got K={K} m_tile={m_tile}")
    if not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("the kernel takes contiguous, 16-byte aligned "
                         "codes")
    out = torch.empty((Mp, N), dtype=torch.float32, device=xq.device)
    if Mp == 0 or N == 0:
        return out
    xq = _aligned(xq)
    xs = x_scale.float().contiguous()
    sc = scales.float().contiguous()
    with torch.cuda.device(xq.device):
        _launch(_w8_lib().lc_w8a8_grouped, xq.data_ptr(), xs.data_ptr(),
                codes.data_ptr(), sc.data_ptr(), block_eid.data_ptr(),
                out.data_ptr(), Mp, N, K, E, m_tile, _stream(xq.device))
    w8a8_grouped_matmul.launches += 1
    return out


KERNELS = (w4a8_stacked_matmul, w4a8_gathered_matmul, w4a8_grouped_matmul,
           w4a8_stacked_matmul_smallm, w8a8_grouped_matmul)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
