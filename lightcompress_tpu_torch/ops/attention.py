"""Decode attention over the quantized caches: the six Hopper kernels of
the serving path and the bench with their plain PyTorch versions (port of
lightcompress_tpu/ops/pallas_attention.py, kernels #17-#22).

* ``decode_attention_bd`` (#18) and ``decode_attention_bd_flash`` (#19):
  one-token GQA decode over the kv8 block-diagonal ``bd`` slabs (K
  feature-major (B, H*D, S) int8, V time-major (B, S, H*D) int8, bf16
  scales (B, H, S)); #18's kernel splits S over a cluster of CTAs
  (``split_parts``) and meets the cluster three times (the row max, the
  max of pv with the sums of e, the int32 PV sums), so its context and m
  are the same bits at every split;
* ``decode_attention_bd4`` (#20) and ``decode_attention_bd4_flash`` (#21):
  the same over the nibble-packed kv4 ``bd4`` slabs (K (B, H*D/2, S), V
  (B, S, H*D/2)); #20's kernel is #18's split (one template, the nibble
  mode: ``split_parts(..., mode="bd4")``), so its context and m are the
  same bits at every split too.
  These four return the *unnormalized* context (B, H, G, D) f32 with the
  softmax max ``m`` and denominator ``d`` (B, H, G), for
  ``bd_merge_new_token`` to fold the fresh token in.  The flash forms
  split S into ``s_block`` columns and carry (o, m, d) across the blocks;
  each block requantizes its probabilities with its own scale.  Their
  kernel splits the blocks over ranks (``bd_flash_parts``) and merges the
  ranks' (o, m, d) in rank order; ``parts`` of the plain versions renders
  that schedule.
* ``decode_attention_i8`` (#17): the same over the int8 ``hhd`` cache
  (B, H, S, D) with the fresh token as an extra softmax column; returns
  the normalized context.  Its kernel is #18's split (one template).

* ``decode_attention_kv8`` (#22): bf16 q over the int8 cache (B, H, S, D)
  with per-token scales (B, H, S), every column (no length mask: the bench
  appends the fresh token first); f32 dots, a softmax normalized before
  PV, ``pv = bf16(p * vs)``; returns the normalized context.  The kernel
  splits S over a cluster of CTAs (``kv8_parts``);
  ``decode_attention_kv8_parts_plain`` renders that schedule.

Arithmetic of #17-#21 (the JAX kernels', in this order): q is quantized
per (b, h, g) to int8 (``quantize_q``); scores are int32 dots, then
``(f32(s) * (qs * D**-0.5)) * ks``; columns at or past a slot's length are
masked; the max is floored at -1e30 (#18-#21); ``pv = exp(s - m) * vs``;
``ps = max(max(pv), 1e-20) / 127``; ``p8 = round_half_even(pv / ps)``; the
PV dot is an int32 sum times ``ps``.  Masked columns contribute exactly 0,
so the kernels skip them.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel (``csrc/decode_attention.cu``) or raises.  Each wrapper counts its
kernel launches in its ``launches`` attribute.  The plain versions take
the integer dots in f64, exact like the kernels' int32 sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..device import div
from . import _build
from .w4_matmul import quantize_act_per_token

# the kernels' supported shapes (Llama-3 GQA): head_dim and group sizes
KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = (1, 2, 4, 8)
# the engine's column block of #19 and #21
S_BLOCK = 512
# the JAX wrappers' default column block of #19 (``decode_attention_bd_flash``)
FLASH_BLOCK = 256
# the dynamic shared memory a block may have on an H100 (227 KB), and an
# SM's (228 KB; each resident block also takes 1 KB of it)
SMEM_MAX = 232448
SMEM_SM = 233472
# #19/#21: the most ring slots a warp keeps in flight (the kernel takes
# 1-3; three were no faster on the H100 scan in PERF.md), the most
# ranks a (slot, kv head), and a CTA's fixed time (its first copies'
# latency, the merge, a wave's tail) in blocks of its streaming time
BD_FLASH_SLOTS = 2
BD_FLASH_PARTS_MAX = 16
BD_FLASH_FIXED_BLOCKS = 1
# the CTAs a wave of #19/#21 counts, in co-resident CTAs: the ranks past a
# slot's length leave at once, so a grid of twice the card's CTAs runs
# about as one wave (the H100 scan in PERF.md)
BD_FLASH_WAVE = 2
# #17, #18 and #22's cluster sizes (CTAs splitting S per (slot, kv head)),
# and the bytes of #22's ring of TMA chunks (four chunks of 128 rows of
# 128 code bytes)
CLUSTER_PARTS = (1, 2, 4, 8)
KV8_RING_BYTES = 4 * 128 * 128
# a #22 CTA's fixed time (its first copy's latency, the cluster's meetings,
# the partials' sum, a wave's tail) in columns of its streaming time: the
# value for which ``kv8_parts`` picks the fastest split at every B (1, 4,
# 8, 32) and S (2049, 4097) of the H100 scan in PERF.md
KV8_FIXED_COLUMNS = 600
# #17/#18's most ring slots a warp keeps, and a CTA's fixed time (its first
# copies' latency, the cluster's four meetings, a wave's tail) in columns
# of its streaming time: the chooser's pick is the fastest forced split at
# chip_smoke's S 4096 and within 5% of it at S 512 on the H100 (PERF.md,
# PR 18)
SPLIT_SLOTS = 2
SPLIT_FIXED_COLUMNS = 256

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def quantize_q(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, h, g) symmetric int8 of the decode query (..., D) ->
    (int8 codes, f32 scale (...)): the per-token act quant (amax/127
    clamped at 1e-8) over each query row."""
    q8, qs = quantize_act_per_token(q.reshape(-1, q.shape[-1]))
    return q8.reshape(q.shape), qs.reshape(q.shape[:-1])


def _lengths(lengths: Optional[torch.Tensor], B: int, S: int,
             device: torch.device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return lengths.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card reference)
# ---------------------------------------------------------------------------

def _bd_planes(kt: torch.Tensor, vt: torch.Tensor, H: int, nib: bool):
    """f64 code planes of the block-diagonal slabs: K planes (B, H, R, S)
    and V planes (B, H, S, R).  kv8: one plane, the int8 codes (R = D);
    kv4: the sign-extended low and high nibbles (R = D/2)."""
    B, HR, S = kt.shape
    k = kt.to(torch.int32).reshape(B, H, HR // H, S)
    v = vt.to(torch.int32).reshape(B, S, H, HR // H).transpose(1, 2)
    if not nib:
        return (k.double(),), (v.double(),)

    def planes(p):
        return (((p & 0xF) ^ 8) - 8).double(), \
            ((((p >> 4) & 0xF) ^ 8) - 8).double()

    return planes(k), planes(v)


def _block_partials(q8, qsc, kp, ks, vp, vs, valid, m_floor):
    """One column range of a block-diagonal kernel over the code planes
    ``kp``/``vp`` (q's features split evenly over the planes): returns
    (m_new, e, ctx) with m_new = max(m_floor, max(s), -1e30),
    e = exp(s - m_new) and ctx the range's requantized PV; m_floor is the
    running max (-1e30 at first)."""
    R = kp[0].shape[2]
    qd = q8.double()
    sc = sum(torch.matmul(qd[..., i * R:(i + 1) * R], k)
             for i, k in enumerate(kp))
    scf = (sc.float() * qsc[..., None]) * ks.float()[:, :, None, :]
    scf = scf.masked_fill(~valid, float("-inf"))
    blk = torch.clamp(scf.amax(dim=-1), min=-1e30)
    m_new = torch.maximum(m_floor, blk)
    e = torch.exp(scf - m_new[..., None])
    pv = e * vs.float()[:, :, None, :]
    ps = div(torch.clamp(pv.amax(dim=-1, keepdim=True), min=1e-20), 127.0)
    p8 = torch.round(pv / ps).double()
    return m_new, e, torch.cat([torch.matmul(p8, v).float() * ps
                                for v in vp], dim=-1)


def flash_block(S: int, s_block: int) -> int:
    """The column block of the flash kernels: ``s_block``, halved until it
    divides S (the JAX wrappers' rule)."""
    s_block = min(s_block, S)
    while S % s_block:
        s_block //= 2
    return s_block


def flash_ranks(blocks: int, parts: int):
    """#19/#21's split of ``blocks`` column blocks over ``parts`` ranks:
    (first, end) block of each rank that has one; a rank takes
    ceil(blocks / parts) blocks."""
    per = -(-blocks // parts)
    return [(r * per, min(blocks, (r + 1) * per)) for r in range(parts)
            if r * per < blocks]


def _bd_partials_plain(q, kt, ks, vt, vs, lengths, nib: bool,
                       s_block: Optional[int] = None,
                       parts: int = 1) -> Partials:
    """Plain #18-#21: the column blocks in order (one block of S without
    ``s_block``), (o, m, d) carried as ``m' = max(m, max(s_blk));
    a = exp(m - m'); d' = d*a + sum(e); o' = o*a + ctx_blk`` from
    m = -1e30.  A single block gives the whole-row kernels' result
    exactly: a is 0, or 1 with o and d still 0.  With ``parts`` > 1 the
    blocks split over ranks (``flash_ranks``), each carried from
    m = -1e30, merged in rank order as the flash kernel merges them:
    m = max(m_r), o = sum_r o_r * exp(m_r - m), d likewise.  A rank with no
    valid column adds exactly 0; ``parts`` = 1 is the sequence itself."""
    B, H, G, D = q.shape
    S = kt.shape[2]
    sb = S if s_block is None else flash_block(S, s_block)
    q8, qs = quantize_q(q)
    qsc = qs * D ** -0.5
    kp, vp = _bd_planes(kt, vt, H, nib)
    L = _lengths(lengths, B, S, q.device)
    col = torch.arange(S, device=q.device)
    ranks = []
    for first, end in flash_ranks(S // sb, parts):
        o = torch.zeros((B, H, G, D), device=q.device)
        m = torch.full((B, H, G), -1e30, device=q.device)
        d = torch.zeros((B, H, G), device=q.device)
        for s0 in range(first * sb, end * sb, sb):
            sl = slice(s0, s0 + sb)
            valid = (col[sl][None, :] < L[:, None])[:, None, None, :]
            m_new, e, ctx = _block_partials(
                q8, qsc, [k[..., sl] for k in kp], ks[..., sl],
                [v[:, :, sl] for v in vp], vs[..., sl], valid, m)
            alpha = torch.exp(m - m_new)
            o = o * alpha[..., None] + ctx
            d = d * alpha + e.sum(dim=-1)
            m = m_new
        ranks.append((o, m, d))
    if len(ranks) == 1:
        return ranks[0]
    m = ranks[0][1]
    for _, mr, _ in ranks[1:]:
        m = torch.maximum(m, mr)
    o = d = None
    for orr, mr, dr in ranks:
        w = torch.exp(mr - m)
        ov, dv = orr * w[..., None], dr * w
        o, d = (ov, dv) if o is None else (o + ov, d + dv)
    return o, m, d


def decode_attention_bd_plain(q, kt, ks, vt, vs, lengths=None) -> Partials:
    """Plain #18: (ctx unnormalized, m, d) over the whole kv8 buffer."""
    return _bd_partials_plain(q, kt, ks, vt, vs, lengths, False)


def decode_attention_bd_flash_plain(q, kt, ks, vt, vs, lengths=None,
                                    s_block: int = FLASH_BLOCK,
                                    parts: int = 1) -> Partials:
    """Plain #19: #18 in ``s_block`` column blocks (over ``parts`` ranks:
    the kernel's split)."""
    return _bd_partials_plain(q, kt, ks, vt, vs, lengths, False, s_block,
                              parts)


def decode_attention_bd4_plain(q, kt4, ks, vt4, vs, lengths=None
                               ) -> Partials:
    """Plain #20: (ctx unnormalized, m, d) over the whole kv4 buffer."""
    return _bd_partials_plain(q, kt4, ks, vt4, vs, lengths, True)


def decode_attention_bd4_flash_plain(q, kt4, ks, vt4, vs, lengths=None,
                                     s_block: int = S_BLOCK,
                                     parts: int = 1) -> Partials:
    """Plain #21: #20 in ``s_block`` column blocks (over ``parts`` ranks:
    the kernel's split)."""
    return _bd_partials_plain(q, kt4, ks, vt4, vs, lengths, True, s_block,
                              parts)


def decode_attention_i8_plain(q, kq, ks, vq, vs, k_new, kns, v_new, vns,
                              lengths=None) -> torch.Tensor:
    """Plain #17: masked int8 attention over the read-only cache plus the
    fresh token as one more column (not requantized); normalized."""
    B, H, G, D = q.shape
    S = kq.shape[2]
    q8, qs = quantize_q(q)
    qsc = qs * D ** -0.5
    qd = q8.double()
    sc = torch.matmul(qd, kq.double().transpose(-1, -2))
    scf = (sc.float() * qsc[..., None]) * ks.float()[:, :, None, :]
    L = _lengths(lengths, B, S, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < L[:, None]
    scf = scf.masked_fill(~valid[:, None, None, :], float("-inf"))
    scn = torch.matmul(qd, k_new.double()[..., None])[..., 0]
    scnf = (scn.float() * qsc) * kns.float()[..., None]
    m = torch.maximum(scf.amax(dim=-1), scnf)
    e = torch.exp(scf - m[..., None])
    en = torch.exp(scnf - m)
    denom = e.sum(dim=-1) + en
    pv = e * vs.float()[:, :, None, :]
    pvn = en * vns.float()[..., None]
    ps = div(torch.clamp(pv.amax(dim=-1, keepdim=True), min=1e-20), 127.0)
    p8 = torch.round(pv / ps).double()
    ctx = torch.matmul(p8, vq.double()).float() * ps
    ctx = ctx + pvn[..., None] * v_new.float()[:, :, None, :]
    return ctx / denom[..., None]


def decode_attention_kv8_plain(q, kq, ks, vq, vs) -> torch.Tensor:
    """Plain #22: ``scores = (f32 dot(bf16 q, k)) * ks * D**-0.5`` over every
    column, ``p = e / sum(e)``, ``pv = bf16(p * vs)``, the f32 PV dot;
    normalized (B, H, G, D) f32.  The dots' products are exact in f32."""
    D = q.shape[-1]
    sc = torch.matmul(q.to(torch.bfloat16).float(),
                      kq.float().transpose(-1, -2))
    sc = sc * ks.float()[:, :, None, :] * D ** -0.5
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pv = (p * vs.float()[:, :, None, :]).to(torch.bfloat16)
    return torch.matmul(pv.float(), vq.float())


def kv8_columns(S: int, parts: int) -> int:
    """Columns of one part of #22's split of S over ``parts`` CTAs: a
    multiple of 16; the last parts may be short or empty."""
    per = -(-S // parts)
    return -(-per // 16) * 16


def decode_attention_kv8_parts_plain(q, kq, ks, vq, vs,
                                     parts: int) -> torch.Tensor:
    """#22's function in its kernel's split schedule: S cut into runs of
    ``kv8_columns(S, parts)`` columns, one a CTA of the cluster; each part's
    max m_r and sum s_r of exp(s - m_r), merged in part order into the
    row's (the larger max, the sums rescaled to it), ``pv = bf16((exp(s -
    max) / sum) * vs)``, and the parts' PV dots added in part order.  An
    empty part adds exactly 0."""
    D, S = q.shape[-1], kq.shape[2]
    per = kv8_columns(S, parts)
    spans = [(r * per, min(S, (r + 1) * per)) for r in range(parts)
             if r * per < S]
    sc = torch.matmul(q.to(torch.bfloat16).float(),
                      kq.float().transpose(-1, -2))
    sc = sc * ks.float()[:, :, None, :] * D ** -0.5
    m = total = None
    for a, b in spans:
        mr = sc[..., a:b].amax(dim=-1)
        sr = torch.exp(sc[..., a:b] - mr[..., None]).sum(dim=-1)
        if m is None:
            m, total = mr, sr
            continue
        mm = torch.maximum(m, mr)
        total = total * torch.exp(m - mm) + sr * torch.exp(mr - mm)
        m = mm
    e = torch.exp(sc - m[..., None])
    pv = (e / total[..., None] * vs.float()[:, :, None, :]).to(torch.bfloat16)
    ctx = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for a, b in spans:
        ctx = ctx + torch.matmul(pv[..., a:b].float(), vq[:, :, a:b].float())
    return ctx


def bd_merge_new_token(q, qctx: Partials, k_new, v_new, kns, vns,
                       scale: float) -> torch.Tensor:
    """Fold the fresh token (int8 k_new/v_new (B, H, D), scales (B, H))
    into a bd4 kernel's partials; returns the normalized (B, H, G, D) f32.
    Plain torch (XLA in the JAX package): no S dimension."""
    ctx, m, denom = qctx
    qf = q.float()
    s_new = torch.matmul(qf, k_new.float()[..., None])[..., 0]
    s_new = s_new * kns.float()[:, :, None] * scale
    m_all = torch.maximum(m, s_new)
    w_old = torch.exp(m - m_all)
    w_new = torch.exp(s_new - m_all)
    d_all = denom * w_old + w_new
    vn = v_new.float() * vns.float()[..., None]
    out = ctx * w_old[..., None] + w_new[..., None] * vn[:, :, None, :]
    return out / d_all[..., None]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.lc_attn_bd.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    lib.lc_attn_bd_flash.argtypes = [_P] * 12 + [_I] * 8 + [_P]
    lib.lc_attn_bd_flash_ctas.argtypes = [_I] * 4
    lib.lc_attn_i8.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    lib.lc_attn_split_clusters.argtypes = [_I] * 5
    lib.lc_attn_kv8.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.lc_attn_kv8_clusters.argtypes = [_I] * 4
    for fn in (lib.lc_attn_bd, lib.lc_attn_bd_flash,
               lib.lc_attn_bd_flash_ctas, lib.lc_attn_i8, lib.lc_attn_kv8,
               lib.lc_attn_kv8_clusters, lib.lc_attn_split_clusters):
        fn.restype = ctypes.c_int
    return lib


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def _check(q: torch.Tensor, S: int, tensors, scales) -> None:
    """Device, type and layout checks of the card route."""
    B, H, G, D = q.shape
    for t in tensors + scales:
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D != KERNEL_HEAD_DIM or G not in KERNEL_GROUPS:
        raise ValueError(f"the kernels take head_dim {KERNEL_HEAD_DIM} and "
                         f"groups {KERNEL_GROUPS}, got D={D} G={G}")
    if S % 16:
        raise ValueError(f"the kernels need S % 16 == 0, got {S}")
    for t in tensors:
        if t.dtype != torch.int8 or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("the kernels take contiguous, 16-byte aligned "
                             "int8 codes")
    for t in scales:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("the kernels take contiguous bf16 scales")


def _check_bd(q, kt, ks, vt, vs, nib: bool) -> int:
    """Shapes of the block-diagonal slabs (``nib``: kv4, else kv8), and on
    the card the kernels' device, type and layout checks; returns S."""
    B, H, G, D = q.shape
    R = D // 2 if nib else D
    S = kt.shape[-1]
    if kt.shape != (B, H * R, S) or vt.shape != (B, S, H * R) \
            or ks.shape != (B, H, S) or vs.shape != (B, H, S):
        raise ValueError(f"{'bd4' if nib else 'bd'} slabs must be "
                         f"(B, H*{R}, S), (B, S, H*{R}) and scales (B, H, S);"
                         f" got {tuple(kt.shape)}, {tuple(vt.shape)}, "
                         f"{tuple(ks.shape)}")
    if q.device.type == "cuda":
        _check(q, S, [kt, vt], [ks, vs])
    return S


def _flash_block_checked(S: int, s_block: int) -> int:
    sb = flash_block(S, s_block)
    if sb % 16:
        raise ValueError(f"the flash kernels need s_block % 16 == 0, got "
                         f"{sb}")
    return sb


def bd_flash_smem_bytes(G: int, sb: int, nib: bool, slots: int,
                        vsb: Optional[bool] = None) -> int:
    """Dynamic shared memory of one #19/#21 CTA (the kernel's
    ``flash_smem``): alignment slack, the ring (4 warps x ``slots`` chunks
    of 64 columns of K, with their K and V scales, or 64 time steps of V,
    and their mbarriers), the int32 PV sums (rows of 132 words), the
    exchanges, the block's V scales (``vsb``; None: where they fit beside a
    one-slot ring, as the kernel decides) and f32 scores (rows padded
    against bank conflicts)."""
    D = KERNEL_HEAD_DIM
    if vsb is None:
        vsb = bd_flash_smem_bytes(G, sb, nib, 1, True) <= SMEM_MAX
    ring = 4 * slots * ((D // 2 if nib else D) * 64 + 256 + 8)
    stride = (sb + 31) // 32 * 32 + 1
    return (1024 + ring + G * 132 * 4 + 3 * 4 * 8 * 4 + 16
            + (2 * sb if vsb else 0) + G * stride * 4)


def bd_flash_slots(G: int, sb: int, nib: bool) -> int:
    """The ring slots a warp of #19/#21 keeps: the most, up to
    BD_FLASH_SLOTS, with which three CTAs share an SM (the registers allow
    three), else two, else one CTA; raises where none fits (the block's
    scores take 4 * G bytes a column)."""
    for budget in (SMEM_SM // 3 - 1024, SMEM_SM // 2 - 1024, SMEM_MAX):
        for n in range(BD_FLASH_SLOTS, 0, -1):
            if bd_flash_smem_bytes(G, sb, nib, n) <= budget:
                return n
    raise ValueError(f"the flash kernel holds a block's scores in shared "
                     f"memory: s_block={sb} at G={G} needs "
                     f"{bd_flash_smem_bytes(G, sb, nib, 1)} bytes, above "
                     f"{SMEM_MAX}")


def bd_flash_parts(pairs: int, blocks: int, ctas: int) -> int:
    """#19/#21's ranks a (slot, kv head) for ``pairs`` pairs over ``blocks``
    column blocks of the buffer, where the card holds ``ctas`` CTAs at
    once: among the splits into at most BD_FLASH_PARTS_MAX ranks (never
    more than the blocks), the one with the least waves * (blocks a rank +
    BD_FLASH_FIXED_BLOCKS), a wave being BD_FLASH_WAVE x ``ctas`` CTAs (a
    rank past its slot's length leaves at once); ties go to fewer ranks.
    The slots' lengths take no part: they live on the device, and a host
    read would stall the stream."""
    best = None
    for p in range(1, min(blocks, BD_FLASH_PARTS_MAX) + 1):
        per = -(-blocks // p)
        if -(-blocks // per) != p:  # the same split as fewer ranks
            continue
        waves = -(-pairs * p // (BD_FLASH_WAVE * ctas))
        cost = waves * (per + BD_FLASH_FIXED_BLOCKS)
        if best is None or cost < best[0]:
            best = (cost, p)
    return best[1]


@functools.lru_cache(maxsize=None)
def bd_flash_ctas(index: int, G: int, sb: int, slots: int, nib: bool) -> int:
    """The #19/#21 CTAs card ``index`` holds at once (CUDA's occupancy
    query times the SMs)."""
    with torch.cuda.device(index):
        n = _lib().lc_attn_bd_flash_ctas(G, sb, slots, int(nib))
    if n < 0:
        raise RuntimeError(f"lc_attn_bd_flash_ctas failed: CUDA error {-n}")
    return n * torch.cuda.get_device_properties(index).multi_processor_count


def bd_flash_card_parts(pairs: int, G: int, S: int, sb: int, nib: bool,
                        device: torch.device) -> Tuple[int, int]:
    """(ranks, ring slots) of #19/#21 on ``device``'s card: ``bd_flash_slots``
    and ``bd_flash_parts`` with the card's occupancy."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    slots = bd_flash_slots(G, sb, nib)
    return bd_flash_parts(pairs, S // sb,
                          bd_flash_ctas(index, G, sb, slots, nib)), slots


@functools.lru_cache(maxsize=None)
def _flash_counters(device: torch.device, size: int) -> torch.Tensor:
    """#19/#21's meet counters on ``device``, one a (slot, kv head) for up to
    ``size`` pairs: zero between calls (the last rank of a pair sets its
    counter back), so one tensor of each size serves every call.  Calls
    that share it must not overlap: the port issues them on one stream."""
    return torch.zeros(size, dtype=torch.int32, device=device)


def _bd_flash_launch(q8, qs, kt, ks, vt, vs, L, outs, sb: int, parts: int,
                     slots: int, nib: bool) -> None:
    """One launch of #19 (``nib`` False) or #21 on prepared operands: the
    int8 query and its scales (``quantize_q``), the slabs, int32 lengths,
    the outputs (ctx, m, d); ``parts`` ranks a (slot, kv head), ``slots``
    ring slots a warp (``bd_flash_card_parts``; ``kernel_ab.py`` forces
    others)."""
    B, H, G, D = q8.shape
    S = kt.shape[-1]
    part = cnt = None
    if parts > 1:
        part = torch.empty(B * H * parts * G * (D + 2), dtype=torch.float32,
                           device=q8.device)
        size = 1 << max(10, (B * H - 1).bit_length())  # a power of two
        cnt = _flash_counters(q8.device, size)
    with torch.cuda.device(q8.device):
        _launch(_lib().lc_attn_bd_flash, q8.data_ptr(), qs.data_ptr(),
                kt.data_ptr(), ks.data_ptr(), vt.data_ptr(), vs.data_ptr(),
                L.data_ptr(), *(t.data_ptr() for t in outs),
                None if part is None else part.data_ptr(),
                None if cnt is None else cnt.data_ptr(), B, H, G, S, sb,
                parts, slots, int(nib), _stream(q8.device))


def _bd_flash(q, kt, ks, vt, vs, lengths, S: int, s_block: int,
              nib: bool) -> Partials:
    """#19/#21 on the card: the query's quantization, the kernel's split,
    one launch."""
    B, H, G, D = q.shape
    sb = _flash_block_checked(S, s_block)
    parts, slots = bd_flash_card_parts(B * H, G, S, sb, nib, q.device)
    # the kernel's bulk copies of the scales start on 16-byte boundaries
    ks, vs = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (ks, vs))
    q8, qs = quantize_q(q)
    L = _lengths(lengths, B, S, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = (torch.empty((B, H, G, D), **f32), torch.empty((B, H, G), **f32),
            torch.empty((B, H, G), **f32))
    _bd_flash_launch(q8, qs, kt, ks, vt, vs, L, outs, sb, parts, slots, nib)
    return outs


# the split kernel's operand modes, its kMode (lc_attn_bd's and
# lc_attn_split_clusters' ``mode``): #18 over the kv8 bd slabs, #17 over
# the int8 hhd cache and the fresh token, #20 over the kv4 bd4 slabs
SPLIT_MODES = {"bd": 0, "i8": 1, "bd4": 2}


def split_smem_bytes(G: int, per: int, slots: int, mode: str = "bd") -> int:
    """Dynamic shared memory of one #17/#18/#20 CTA (``mode``, as
    SPLIT_MODES) over a rank's ``per`` columns (the kernel's
    ``split_smem``): alignment slack, the ring (4 warps x ``slots`` chunks
    of 64 columns' codes (R x 64 bytes: R = D/2 for #20's nibbles, else D)
    and their K and V scales, or 64 time steps of V, and their mbarriers),
    the int32 PV sums (rows of 132 words), q8, the exchanges, the rank's V
    scales and f32 scores (rows padded against bank conflicts)."""
    D = KERNEL_HEAD_DIM
    R = D // 2 if mode == "bd4" else D
    stride = (per + 31) // 32 * 32 + 9
    return (1024 + 4 * slots * (R * 64 + 256 + 8) + G * 132 * 4 + G * D
            + 1024 + 2 * per + G * stride * 4)


def split_slots(G: int, per: int, mode: str = "bd") -> int:
    """The ring slots a warp of the split kernel in ``mode`` keeps over
    ``per`` columns a rank: the most, up to SPLIT_SLOTS, with which three CTAs
    share an SM, else two, else one CTA; raises where none fits (a rank's
    scores take 4 * G bytes a column)."""
    for budget in (SMEM_SM // 3 - 1024, SMEM_SM // 2 - 1024, SMEM_MAX):
        for n in range(SPLIT_SLOTS, 0, -1):
            if split_smem_bytes(G, per, n, mode) <= budget:
                return n
    raise ValueError(f"a rank of #17/#18/#20 holds its scores in shared "
                     f"memory: {per} columns at G={G} need "
                     f"{split_smem_bytes(G, per, 1, mode)} bytes, above "
                     f"{SMEM_MAX}")


def split_fits(G: int, S: int, mode: str = "bd") -> bool:
    """Whether the split kernel in ``mode`` takes S columns at G queries a
    kv head: a rank's share at the largest split fits a CTA's shared
    memory (S <= 86016 at G = 4, 44800 at G = 8; "bd4" 93184 and 48640)."""
    return split_smem_bytes(G, kv8_columns(S, CLUSTER_PARTS[-1]), 1,
                            mode) <= SMEM_MAX


def cluster_parts(pairs: int, S: int, fits, clusters, fixed: int):
    """The cluster size of #17, #18 or #22 for ``pairs`` (slot, kv head)
    pairs over S columns: among the sizes of CLUSTER_PARTS for which
    ``fits(parts)``, the one with the least waves * (columns of a part +
    ``fixed``), where a wave is ``clusters(parts)`` clusters (the card's
    co-resident ones); ties go to fewer parts; None where none fits.  The
    slots' lengths take no part: they live on the device, and a host read
    would stall the stream."""
    best = None
    for p in CLUSTER_PARTS:
        if not fits(p):
            continue
        c = clusters(p)
        if c < 1:
            continue
        cost = -(-pairs // c) * (kv8_columns(S, p) + fixed)
        if best is None or cost < best[0]:
            best = (cost, p)
    return None if best is None else best[1]


def split_parts(pairs: int, S: int, G: int, clusters,
                mode: str = "bd") -> int:
    """The split kernel's cluster size in ``mode``: ``cluster_parts`` over
    the sizes whose share of S fits a CTA's shared memory,
    SPLIT_FIXED_COLUMNS."""
    p = cluster_parts(
        pairs, S, lambda x: split_smem_bytes(G, kv8_columns(S, x), 1, mode)
        <= SMEM_MAX, clusters, SPLIT_FIXED_COLUMNS)
    if p is None:
        _split_too_long("#17/#18/#20", G, S, mode=mode)
    return p


def _split_too_long(name: str, G: int, S: int, hint: str = "",
                    mode: str = "bd") -> None:
    """Raises: S does not fit the split kernel's shared memory in ``mode``
    at the largest split."""
    need = split_smem_bytes(G, kv8_columns(S, CLUSTER_PARTS[-1]), 1, mode)
    raise ValueError(
        f"{name} holds a rank's score columns in shared memory: S={S} at "
        f"G={G} needs {need} bytes a CTA at {CLUSTER_PARTS[-1]} parts, "
        f"above {SMEM_MAX}{hint}")


@functools.lru_cache(maxsize=None)
def split_clusters(index: int, G: int, per: int, slots: int, mode: str,
                   parts: int) -> int:
    """The clusters of ``parts`` CTAs of the split kernel in ``mode``
    (``SPLIT_MODES``: #18 "bd", #17 "i8", #20 "bd4") over ``per`` columns
    a rank with ``slots`` ring slots a warp that card ``index`` holds at
    once (CUDA's occupancy query)."""
    with torch.cuda.device(index):
        n = _lib().lc_attn_split_clusters(G, per, slots, SPLIT_MODES[mode],
                                          parts)
    if n < 0:
        raise RuntimeError(f"lc_attn_split_clusters failed: CUDA error {-n}")
    return n


def split_card_parts(pairs: int, S: int, G: int, mode: str,
                     device: torch.device) -> Tuple[int, int]:
    """(cluster size, ring slots) of the split kernel in ``mode`` (#18
    "bd", #17 "i8", #20 "bd4") on ``device``'s card: ``split_parts`` with
    the card's co-resident clusters, and ``split_slots`` at that size."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()

    def clusters(p):
        per = kv8_columns(S, p)
        return split_clusters(index, G, per, split_slots(G, per, mode), mode,
                              p)

    parts = split_parts(pairs, S, G, clusters, mode)
    return parts, split_slots(G, kv8_columns(S, parts), mode)


def _split_launch(q8, qs, cache, L, outs, parts: int, slots: int, mode: str,
                  fresh=None) -> None:
    """One launch of the split kernel in ``mode``: #18 ("bd": ``cache`` the
    kv8 slabs (kt, ks, vt, vs), ``outs`` (ctx, m, d)), #20 ("bd4": the kv4
    slabs, likewise) or #17 ("i8": ``cache`` (kq, ks, vq, vs), ``fresh``
    (k_new, kns, v_new, vns), ``outs`` (out,)) on prepared operands: the
    int8 query and its scales (``quantize_q``), int32 lengths; a cluster
    of ``parts`` CTAs a (slot, kv head), ``slots`` ring slots a warp
    (``split_card_parts``; ``kernel_ab.py`` and the card tests force
    others)."""
    B, H, G, D = q8.shape
    k, ks, v, vs = cache
    S = k.shape[-1] if mode != "i8" else k.shape[2]
    ptrs = [t.data_ptr() for t in (q8, qs, k, ks, v, vs)]
    with torch.cuda.device(q8.device):
        if mode != "i8":
            _launch(_lib().lc_attn_bd, *ptrs, L.data_ptr(),
                    *(t.data_ptr() for t in outs), B, H, G, S, parts, slots,
                    SPLIT_MODES[mode], _stream(q8.device))
        else:
            _launch(_lib().lc_attn_i8, *ptrs,
                    *(t.data_ptr() for t in fresh), L.data_ptr(),
                    outs[0].data_ptr(), B, H, G, S, parts, slots,
                    _stream(q8.device))


def _split(q, cache, lengths, S: int, mode: str, fresh=None):
    """The split kernel in ``mode`` (#18 "bd", #20 "bd4", #17 "i8" with
    ``fresh``) on the card: the query's quantization, the cluster size,
    one launch."""
    B, H, G, D = q.shape
    parts, slots = split_card_parts(B * H, S, G, mode, q.device)
    k, ks, v, vs = cache
    # the kernel's bulk copies of the scales start on 16-byte boundaries
    ks, vs = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (ks, vs))
    q8, qs = quantize_q(q)
    L = _lengths(lengths, B, S, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    if mode != "i8":
        outs = (torch.empty((B, H, G, D), **f32),
                torch.empty((B, H, G), **f32), torch.empty((B, H, G), **f32))
    else:
        outs = (torch.empty((B, H, G, D), **f32),)
    _split_launch(q8, qs, (k, ks, v, vs), L, outs, parts, slots, mode, fresh)
    return outs


def decode_attention_bd(q: torch.Tensor, kt: torch.Tensor, ks: torch.Tensor,
                        vt: torch.Tensor, vs: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> Partials:
    """#18: q (B, H, G, D) over the kv8 ``bd`` slabs of one layer; columns
    ``< lengths`` (all when None).  Returns (ctx unnormalized, m, d).  On
    the card S splits over a cluster of ``split_card_parts`` CTAs per (slot,
    kv head), each holding its share's scores in shared memory: S is
    bounded by ``split_fits`` (S <= 86016 at G = 4); above it this raises
    and the flash kernel (``attn_impl="bds"``) takes the buffer."""
    S = _check_bd(q, kt, ks, vt, vs, nib=False)
    if q.device.type == "cpu":
        return decode_attention_bd_plain(q, kt, ks, vt, vs, lengths)
    G = q.shape[2]
    if not split_fits(G, S):
        _split_too_long("decode_attention_bd", G, S, "; use "
                        "decode_attention_bd_flash (attn_impl='bds')")
    out = _split(q, (kt, ks, vt, vs), lengths, S, "bd")
    decode_attention_bd.launches += 1
    return out


def decode_attention_bd_flash(q: torch.Tensor, kt: torch.Tensor,
                              ks: torch.Tensor, vt: torch.Tensor,
                              vs: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None,
                              s_block: int = FLASH_BLOCK) -> Partials:
    """#19: #18's contract, S split into ``s_block`` column blocks (halved
    until it divides S).  On the card the blocks split over
    ``bd_flash_card_parts`` ranks a (slot, kv head); the CPU runs them in
    one sequence (``parts`` 1)."""
    S = _check_bd(q, kt, ks, vt, vs, nib=False)
    if q.device.type == "cpu":
        return decode_attention_bd_flash_plain(q, kt, ks, vt, vs, lengths,
                                               s_block)
    out = _bd_flash(q, kt, ks, vt, vs, lengths, S, s_block, nib=False)
    decode_attention_bd_flash.launches += 1
    return out


def decode_attention_bd4(q: torch.Tensor, kt4: torch.Tensor,
                         ks: torch.Tensor, vt4: torch.Tensor,
                         vs: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None) -> Partials:
    """#20: q (B, H, G, D) over the bd4 slabs of one layer; columns
    ``< lengths`` (all when None).  Returns (ctx unnormalized, m, d).  On
    the card #18's split kernel in its nibble mode (S over a cluster of
    ``split_card_parts(..., "bd4", ...)`` CTAs), bounded by
    ``split_fits(G, S, "bd4")``; above it this raises and the flash
    kernel (``decode_attention_bd4_flash``) takes the buffer."""
    S = _check_bd(q, kt4, ks, vt4, vs, nib=True)
    if q.device.type == "cpu":
        return decode_attention_bd4_plain(q, kt4, ks, vt4, vs, lengths)
    G = q.shape[2]
    if not split_fits(G, S, "bd4"):
        _split_too_long("decode_attention_bd4", G, S, "; use "
                        "decode_attention_bd4_flash", mode="bd4")
    out = _split(q, (kt4, ks, vt4, vs), lengths, S, "bd4")
    decode_attention_bd4.launches += 1
    return out


def decode_attention_bd4_flash(q: torch.Tensor, kt4: torch.Tensor,
                               ks: torch.Tensor, vt4: torch.Tensor,
                               vs: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None,
                               s_block: int = S_BLOCK) -> Partials:
    """#21: #20's contract, S split into ``s_block`` column blocks (halved
    until it divides S), split over ranks on the card as #19."""
    S = _check_bd(q, kt4, ks, vt4, vs, nib=True)
    if q.device.type == "cpu":
        return decode_attention_bd4_flash_plain(q, kt4, ks, vt4, vs, lengths,
                                                s_block)
    out = _bd_flash(q, kt4, ks, vt4, vs, lengths, S, s_block, nib=True)
    decode_attention_bd4_flash.launches += 1
    return out


def decode_attention_i8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                        vq: torch.Tensor, vs: torch.Tensor,
                        k_new: Optional[torch.Tensor] = None,
                        kns: Optional[torch.Tensor] = None,
                        v_new: Optional[torch.Tensor] = None,
                        vns: Optional[torch.Tensor] = None,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """#17: q (B, H, G, D) over the int8 cache (B, H, S, D) with bf16
    per-token scales (B, H, S), plus the fresh token k_new/v_new (B, H, D)
    int8 with scales (B, H); columns ``< lengths`` of the cache (all when
    None).  Returns the normalized (B, H, G, D) f32.  Only the engine's
    append form is ported: the fresh token is required.  On the card #18's
    split kernel runs it, bounded alike (``split_fits``)."""
    if k_new is None or kns is None or v_new is None or vns is None:
        raise NotImplementedError("decode_attention_i8 without the fresh "
                                  "token (the no-append form) is not ported")
    B, H, G, D = q.shape
    S = kq.shape[2]
    if kq.shape != (B, H, S, D) or vq.shape != kq.shape or \
            ks.shape != (B, H, S) or vs.shape != (B, H, S) or \
            k_new.shape != (B, H, D) or v_new.shape != (B, H, D) or \
            kns.shape != (B, H) or vns.shape != (B, H):
        raise ValueError("decode_attention_i8 takes q (B, H, G, D), cache "
                         "(B, H, S, D) with scales (B, H, S) and the fresh "
                         "token (B, H, D) with scales (B, H)")
    if q.device.type == "cpu":
        return decode_attention_i8_plain(q, kq, ks, vq, vs, k_new, kns,
                                         v_new, vns, lengths)
    k_new, v_new, kns, vns = (t.contiguous() for t in (k_new, v_new, kns,
                                                        vns))
    _check(q, S, [kq, vq, k_new, v_new], [ks, vs, kns, vns])
    if not split_fits(G, S, "i8"):
        _split_too_long("decode_attention_i8", G, S, mode="i8")
    out, = _split(q, (kq, ks, vq, vs), lengths, S, "i8",
                  fresh=(k_new, kns, v_new, vns))
    decode_attention_i8.launches += 1
    return out


def kv8_smem_bytes(G: int, S: int, parts: int = CLUSTER_PARTS[-1]) -> int:
    """Dynamic shared memory of one #22 CTA when S is split over ``parts``
    (the kernel's ``kv8_smem``): alignment slack, the ring of TMA chunks,
    the f32 scores of the part's columns (rows padded against bank
    conflicts), the PV partial, the scratch.  At the largest split it
    bounds S: S <= 81280 at G = 4."""
    per = kv8_columns(S, parts)
    return (1024 + KV8_RING_BYTES + G * (per + 4) * 4
            + G * KERNEL_HEAD_DIM * 4 + 1024)


def kv8_parts(pairs: int, S: int, G: int, clusters) -> int:
    """#22's cluster size: ``cluster_parts`` over the sizes whose share of
    S fits a CTA's shared memory, KV8_FIXED_COLUMNS."""
    p = cluster_parts(pairs, S,
                      lambda x: kv8_smem_bytes(G, S, x) <= SMEM_MAX,
                      clusters, KV8_FIXED_COLUMNS)
    if p is None:
        raise ValueError(f"decode_attention_kv8 holds a part's scores in "
                         f"shared memory: S={S} at G={G} needs "
                         f"{kv8_smem_bytes(G, S)} bytes a CTA at "
                         f"{CLUSTER_PARTS[-1]} parts, above {SMEM_MAX}")
    return p


@functools.lru_cache(maxsize=None)
def kv8_clusters(index: int, G: int, per: int, f32: bool, parts: int) -> int:
    """The clusters of ``parts`` #22 CTAs over ``per`` columns a rank that
    card ``index`` holds at once (CUDA's occupancy query)."""
    with torch.cuda.device(index):
        n = _lib().lc_attn_kv8_clusters(G, per, int(f32), parts)
    if n < 0:
        raise RuntimeError(f"lc_attn_kv8_clusters failed: CUDA error {-n}")
    return n


def kv8_card_parts(pairs: int, S: int, G: int, f32: bool,
                   device: torch.device) -> int:
    """``kv8_parts`` with the co-resident clusters of ``device``'s card."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return kv8_parts(pairs, S, G, lambda p: kv8_clusters(
        index, G, kv8_columns(S, p), f32, p))


def decode_attention_kv8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """#22: q (B, H, G, D) (taken as bf16) over the int8 cache K, V (B, H, S,
    D) with f32 or bf16 per-token scales (B, H, S), every column.  Returns
    the normalized (B, H, G, D) f32.  On the card S is split over a
    cluster of ``kv8_parts`` CTAs per (slot, kv head), each holding its
    part's scores in shared memory: ``kv8_smem_bytes(G, S) <= SMEM_MAX``
    (S <= 81280 at G = 4); above it this raises."""
    B, H, G, D = q.shape
    S = kq.shape[2]
    if kq.shape != (B, H, S, D) or vq.shape != kq.shape or \
            ks.shape != (B, H, S) or vs.shape != (B, H, S) or S < 1:
        raise ValueError("decode_attention_kv8 takes q (B, H, G, D), K and V "
                         "(B, H, S, D) and scales (B, H, S), S >= 1; got "
                         f"{tuple(q.shape)}, {tuple(kq.shape)}, "
                         f"{tuple(ks.shape)}")
    if q.device.type == "cpu":
        return decode_attention_kv8_plain(q, kq, ks, vq, vs)
    for t in (kq, ks, vq, vs):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D != KERNEL_HEAD_DIM or G not in KERNEL_GROUPS:
        raise ValueError(f"the kernel takes head_dim {KERNEL_HEAD_DIM} and "
                         f"groups {KERNEL_GROUPS}, got D={D} G={G}")
    for t in (kq, vq):
        if t.dtype != torch.int8 or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous, 16-byte aligned "
                             "int8 K and V")
    if ks.dtype != vs.dtype or ks.dtype not in (torch.bfloat16,
                                                torch.float32):
        raise ValueError("the kernel takes bf16 or f32 scales, both alike")
    parts = kv8_card_parts(B * H, S, G, ks.dtype == torch.float32, q.device)
    return _kv8_launch(q, kq, ks, vq, vs, parts)


def _kv8_launch(q, kq, ks, vq, vs, parts: int) -> torch.Tensor:
    """#22's launch on a cluster of ``parts`` CTAs (the wrapper's checks
    done; ``kernel_ab.py`` calls it to time other splits)."""
    B, H, G, D = q.shape
    S = kq.shape[2]
    if kv8_smem_bytes(G, S, parts) > SMEM_MAX:
        raise ValueError(f"decode_attention_kv8: S={S} at G={G} over "
                         f"{parts} parts needs {kv8_smem_bytes(G, S, parts)} "
                         f"bytes a CTA, above {SMEM_MAX}")
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:
        qb = qb.clone()
    ks, vs = ks.contiguous(), vs.contiguous()
    out = torch.empty((B, H, G, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_lib().lc_attn_kv8, qb.data_ptr(), kq.data_ptr(),
                ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), out.data_ptr(),
                B, H, G, S, int(ks.dtype == torch.float32), parts,
                _stream(q.device))
    decode_attention_kv8.launches += 1
    return out


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


KERNELS = (decode_attention_i8, decode_attention_bd4,
           decode_attention_bd4_flash, decode_attention_bd,
           decode_attention_bd_flash, decode_attention_kv8)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
