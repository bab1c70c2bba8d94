"""Serving engine: continuous batching over W4 weights and a quantized
slot KV cache (port of lightcompress_tpu/serving/engine.py, dense Llama).

Slots share one batched decode step; new requests are admitted into free
slots between steps, one batched prefill per length bucket; finished
sequences retire at once.  Prefill attention is plain torch ops.  The cache
is updated in place.  Decode attention takes one of these routes
(``attn_impl``, picked as the JAX engine picks on a TPU; ``ROUTES`` maps
each served (kv_bits, attn_impl) to its decode body):

* ``xla`` (kv8, the default) or its explicit name ``xla8a``: append-first
  masked attention, plain torch: the fresh token is quantized and written
  into the cache first, then one attention runs over the buffer where
  ``col <= length``;
* ``xla8`` (kv8): JAX's concat variant: the int8 cache and the quantized
  fresh token concatenated, one attention where ``col < length`` or at the
  fresh column, then the token is written;
* ``bd4`` (kv4): the nibble-packed ``bd4`` cache stays read-only while
  kernel #20 (buffer < 8192) or #21 (from 8192) attends over
  ``col < length``; the fresh token, quantized to int8, is merged in by
  ``bd_merge_new_token``, then written to the cache as int4;
* ``bd`` and ``bds`` (kv8, probe-only in the JAX engine): the same over
  the int8 block-diagonal ``bd`` cache through kernel #18 (the whole row)
  or #19 (512-column blocks); the int8 token is merged, then cached;
* ``pallas`` (kv8, probe-only in the JAX engine): kernel #17 over the
  read-only int8 cache with the fresh token as an in-register column, then
  the token is written;
* the generic path (JAX's ``read_kv`` + ``_block_apply`` + ``append_kv``)
  for every other ``attn_impl`` on the kv4 ``hhd`` cache (nibble-packed
  half planes: ``xla``, which every MoE engine takes at ``kv_bits="auto"``
  from ``max_len`` 4096, ``xla4r`` without a chunk, and the kv8 names) and
  on the kv16 cache (every ``attn_impl``): the layer's cache dequantized to
  bf16, the unquantized fresh K/V concatenated at column T, one attention
  under the ``j < length | j == T`` mask, then the token quantized into
  the cache.

``decode_chunk`` n > 1 runs the decode in chunks of up to n steps, each
step's tokens sampled on the device and fed to the next, the host reading
the tokens once per chunk (JAX's ``_decode_chunk``).  A chunked kv8
``xla`` engine (``xla8r``) and a chunked kv4 ``xla4r`` engine keep the
cache read-only through the chunk: every layer's fresh token goes to a
ring of the chunk's width (int8, or packed int4 for ``xla4r``), attention
merges the cache (``col <`` the chunk-entry length), the ring's earlier
columns and the fresh token flash-style, and ``flush_ring_to_cache``
writes the ring once per chunk.  Every other route (a chunked kv4 ``xla``
engine and every kv16 engine among them) loops its per-step decode inside
the chunk.

On every route but the generic path, weights built with ``fused_rms`` at
``act_bits=8`` take the fused decode linears where JAX does
(``fused_ok``): q/k/v (or the merged qkv) and gate/up (or gateup) run
RMSNorm and the int8 act quant inside kernel #14 (planes) or #13 (s4),
``attn.o`` and ``mlp.down`` the act quant alone.  Prefill and the generic
path take the plain linears: the folded ln weights are ones.

A MoE model (``arch.moe``) serves on ``xla`` (as the JAX engine forces
it): kv8 on the append-first route, on the ring when chunked; kv4 (from
``max_len`` 4096 at ``kv_bits="auto"``) and kv16 on the generic path.
Its blocks' MLP
(``_moe_mlp``) picks one of four expert routes by the token count n of
the call, as the JAX engine does on a TPU (``pick_moe_route``): ``gathered`` (kernel #8, only the selected
experts read), ``grouped`` (kernel #9 over expert-sorted rows; an int8
per-channel down projection through kernel #10), ``dense`` (kernel #6
over every expert at n <= 256, or #7 at n <= ``moe_smallm``; dequantized
experts above, and for an int8 down) and ``gathered_plain`` (dequantized
selected experts, where #8 does not apply).  The expert activations are
int8 per token on every kernel route whatever ``act_bits`` is.

A ``qk_norm`` model (Qwen3) normalizes each q and k head with its own
gammas before rope, in prefill and decode.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import arch as A
from ..ops.attention import (S_BLOCK, bd_merge_new_token,
                             decode_attention_bd, decode_attention_bd4,
                             decode_attention_bd4_flash,
                             decode_attention_bd_flash, decode_attention_i8)
from ..ops.moe_matmul import w4a8_gathered_matmul
from ..ops.qlinear import QLinearParams
from ..ops.w4_matmul import (quantize_act_per_token,
                             w4a8_linear_bytes_fused,
                             w4a8_linear_planes_fused)
from .kv_cache import (KVCache, Ring, append_kv, append_kv_bd,
                       append_kv_quantized, append_slots, flush_ring_to_cache,
                       kv4_planes, quantize_kv, quantize_kv4, read_kv,
                       unpack_kv4)
from .quantized_model import (ServingWeights, apply_qlinear,
                              apply_qlinear_gathered, apply_qlinear_stacked,
                              head_logits, moe_mlp_grouped)
from .sampler import SamplingParams, sample

# rows per batched prefill: a bucket's prompts are split so that
# n_prompts * T stays within this (the JAX engine's default cap)
PREFILL_ROWS = 4096
# bd and bd4 buffers are a multiple of the flash kernels' column block;
# from this length on the bd4 route takes the flash kernel (#21)
BD4_ALIGN = 512
BD4_FLASH_MIN = 8192
# (kv_bits, attn_impl) after the JAX engine's fallbacks -> the per-step
# decode body its gate picks (lightcompress_tpu/serving/engine.py:
# 1735-1753) on the cache layout the engine makes: the kv8 names on the
# int8 hhd cache (bd/bds on bd slabs), bd4 on the nibble slabs, and the
# generic path on the kv4 hhd and kv16 caches.  xla8r and xla4r are the
# rings of chunked engines; each falls back to xla elsewhere, as in JAX.
ROUTES = {
    (8, "xla"): "xla8a", (8, "xla8a"): "xla8a", (8, "xla8r"): "xla8a",
    (8, "xla8"): "xla8", (8, "pallas"): "pallas", (8, "bd"): "bd",
    (8, "bds"): "bds", (4, "bd4"): "bd4",
    **{(4, a): "generic" for a in ("xla", "xla4r", "xla8", "xla8a",
                                   "pallas", "bd", "bds")},
    **{(16, a): "generic" for a in ("xla", "xla8", "xla8a", "pallas", "bd",
                                    "bds", "bd4")},
}
PROBE_ONLY = ("pallas", "bd", "bds")
# token rows per dense all-expert block above the #6 regime (bounds the
# (E, rows, I) f32 transients)
MOE_DENSE_BLOCK = 2048


def pick_attn_impl(kv_bits: Union[int, str], chunked: bool = False) -> str:
    """The JAX engine's ``pick_attn_impl`` for a dense engine on a TPU, at
    any ``max_len``: kv4 -> the bd4 kernels per step, the kv4 ring
    ``xla4r`` when chunked; everything else -> ``xla`` ("auto" is resolved
    by the engine first)."""
    if kv_bits == 4:
        return "xla4r" if chunked else "bd4"
    return "xla"


def _unported(kv_bits, attn_impl: str) -> str:
    """Why the port refuses a (kv_bits, attn_impl) the JAX engine takes."""
    if kv_bits == 8 and attn_impl == "bd4":
        return ("ROADMAP C, reference faults: JAX hands the int8 hhd cache "
                "to the bd4 kernel, whose block shapes fail at the first "
                "decode step")
    return "ROADMAP A6: JAX's other attn_impl names"


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)


def _qkv_sizes(arch):
    kv = arch.num_kv_heads * arch.head_dim
    return arch.num_heads * arch.head_dim, kv, kv


def _qkv_proj(entry, h1, arch, ab):
    """q/k/v through the merged ``attn.qkv`` (fuse_qkv) or three linears."""
    if "attn.qkv" in entry:
        return torch.split(apply_qlinear(entry["attn.qkv"], h1, act_bits=ab),
                           _qkv_sizes(arch), dim=-1)
    return (apply_qlinear(entry["attn.q"], h1, act_bits=ab),
            apply_qlinear(entry["attn.k"], h1, act_bits=ab),
            apply_qlinear(entry["attn.v"], h1, act_bits=ab))


def _gateup_proj(entry, h2, ab):
    if "mlp.gateup" in entry:
        gu = apply_qlinear(entry["mlp.gateup"], h2, act_bits=ab)
        return torch.split(gu, gu.shape[-1] // 2, dim=-1)
    return (apply_qlinear(entry["mlp.gate"], h2, act_bits=ab),
            apply_qlinear(entry["mlp.up"], h2, act_bits=ab))


@dataclasses.dataclass(frozen=True)
class MoEOptions:
    """The expert-route knobs of the JAX engine's environment
    (``LCTPU_MOE_GATHER_MAX``, ``LCTPU_MOE_GROUPED``,
    ``LCTPU_MOE_GROUPED_MIN``, ``LCTPU_MOE_SMALLM``) as arguments, with
    JAX's defaults: ``gather_max`` None means E // top_k; ``grouped`` is
    "auto" (from ``grouped_min`` tokens on), True (always where the
    layouts allow), "interpret" (as True, and on the CPU the int8 down
    takes the card's act quant and #10's plain version, as JAX's
    interpret mode runs its kernel) or False (never); ``smallm`` is the
    largest n whose stacked planes linears take #7 instead of #6 (0:
    never)."""

    gather_max: Optional[int] = None
    grouped: Union[str, bool] = "auto"
    grouped_min: int = 257
    smallm: int = 0

    def __post_init__(self):
        if self.grouped not in ("auto", True, False, "interpret"):
            raise ValueError("moe_grouped is 'auto', True, False or "
                             "'interpret'")


def _is_layout(qp, layout: str) -> bool:
    return isinstance(qp, QLinearParams) and qp.layout == layout


def pick_moe_route(entry, n: int, moe: A.MoESpec,
                   opts: MoEOptions = MoEOptions()) -> str:
    """The expert route of a MoE MLP call on n tokens, by the JAX
    engine's conditions on a TPU, unsharded
    (``lightcompress_tpu/serving/engine.py:81-163``):
    ``gathered`` (#8) at n <= gather_max with a ``stacked_planes`` gate
    and n * top_k <= E; ``gathered_plain`` at n <= gather_max otherwise;
    ``grouped`` (#9) with planes gate/up, a planes or int8 ``stacked``
    down and ``grouped`` True, "interpret", or "auto" at n >=
    grouped_min; else ``dense``."""
    E, k = moe.num_experts, moe.top_k
    thresh = (opts.gather_max if opts.gather_max is not None
              else max(1, E // max(1, k)))
    if n <= thresh:
        if _is_layout(entry["mlp.gate"], "stacked_planes") and n * k <= E:
            return "gathered"
        return "gathered_plain"
    down = entry["mlp.down"]
    if (all(_is_layout(entry[nm], "stacked_planes")
            for nm in ("mlp.gate", "mlp.up"))
            and (_is_layout(down, "stacked_planes")
                 or (_is_layout(down, "stacked") and down.bits == 8))
            and (opts.grouped in (True, "interpret")
                 or (opts.grouped == "auto" and n >= opts.grouped_min))):
        return "grouped"
    return "dense"


def _moe_gathered(sw, entry, x2, topi, topw):
    """The #8 route: every selection's token row against its expert, for
    gate, up and down; the down's input is the selection's own row."""
    m = sw.arch.moe
    n, H = x2.shape
    dp = entry["mlp.down"]
    if not _is_layout(dp, "stacked_planes"):
        raise ValueError(
            "the gathered expert route needs a stacked_planes down "
            "projection; this one is int8 'stacked'.  The JAX engine tests "
            "only the gate's layout here (lightcompress_tpu/serving/"
            "engine.py:93-96) and hands the down's int8 codes to "
            "w4a8_gathered_matmul, which fails on a TPU (a fault of the "
            "reference; pass moe_gather_max=0)")
    n_sel = n * m.top_k
    e_flat = topi.reshape(-1).to(torch.int32)
    t_flat = torch.arange(n, dtype=torch.int32,
                          device=x2.device).repeat_interleave(m.top_k)
    xq, xs = quantize_act_per_token(x2)
    gp, upp = entry["mlp.gate"], entry["mlp.up"]
    g = w4a8_gathered_matmul(xq, xs, gp.codes, gp.scales, gp.zeros, e_flat,
                             t_flat)
    u = w4a8_gathered_matmul(xq, xs, upp.codes, upp.scales, upp.zeros,
                             e_flat, t_flat)
    mq, ms = quantize_act_per_token(
        (A._act(g, sw.arch.act_fn) * u).to(torch.bfloat16))
    d = w4a8_gathered_matmul(
        mq, ms, dp.codes, dp.scales, dp.zeros, e_flat,
        torch.arange(n_sel, dtype=torch.int32, device=x2.device))
    return torch.einsum("nkh,nk->nh", d.reshape(n, m.top_k, H), topw)


def _moe_dense(sw, entry, x2, topi, topw, smallm: int = 0):
    """Every expert on every token (#6 at n <= 256, #7 at n <= smallm),
    combined by the router weights; in blocks of MOE_DENSE_BLOCK tokens
    above that."""
    m = sw.arch.moe
    n, H = x2.shape

    def block(xb, wb):
        g = apply_qlinear_stacked(entry["mlp.gate"], xb, smallm=smallm)
        u = apply_qlinear_stacked(entry["mlp.up"], xb, smallm=smallm)
        mid = A._act(g, sw.arch.act_fn) * u
        d = apply_qlinear_stacked(entry["mlp.down"],
                                  mid.to(torch.bfloat16), pair=True,
                                  smallm=smallm)
        return torch.einsum("enh,ne->nh", d, wb)

    w_full = torch.zeros((n, m.num_experts), dtype=torch.float32,
                         device=x2.device).scatter_(1, topi, topw)
    NB = MOE_DENSE_BLOCK
    if n > NB and n % NB == 0:
        return torch.cat([block(x2[i:i + NB], w_full[i:i + NB])
                          for i in range(0, n, NB)])
    return block(x2, w_full)


def _moe_mlp(sw: ServingWeights, entry, h2: torch.Tensor, ab: int,
             opts: MoEOptions = MoEOptions()) -> torch.Tensor:
    """The serving MoE MLP on (S, T, H): router logits in f32 from bf16
    operands, ``A.moe_route``, the expert route ``pick_moe_route`` picks,
    plus the shared experts at ``act_bits``."""
    arch = sw.arch
    m = arch.moe
    Bs, T, H = h2.shape
    x2 = h2.reshape(-1, H)
    logits = torch.matmul(
        x2.to(torch.bfloat16).float(),
        entry["mlp.router"]["weight"].to(torch.bfloat16).float().t())
    topi, topw = A.moe_route(m, logits, entry.get("mlp.router_bias"))
    route = pick_moe_route(entry, x2.shape[0], m, opts)
    if route == "gathered":
        y = _moe_gathered(sw, entry, x2, topi, topw)
    elif route == "gathered_plain":
        y = torch.zeros((x2.shape[0], H), dtype=torch.float32,
                        device=x2.device)
        for k in range(m.top_k):
            e = topi[:, k]
            gk = apply_qlinear_gathered(entry["mlp.gate"], x2, e)
            uk = apply_qlinear_gathered(entry["mlp.up"], x2, e)
            dk = apply_qlinear_gathered(
                entry["mlp.down"],
                (A._act(gk, arch.act_fn) * uk).to(torch.bfloat16), e)
            y = y + topw[:, k:k + 1] * dk
    elif route == "grouped":
        y = moe_mlp_grouped(entry, x2, topi, topw, arch.act_fn,
                            kernel_route=opts.grouped == "interpret")
    else:
        y = _moe_dense(sw, entry, x2, topi, topw, opts.smallm)
    if "mlp.shared_gate" in entry:
        sg = apply_qlinear(entry["mlp.shared_gate"], x2, act_bits=ab)
        su = apply_qlinear(entry["mlp.shared_up"], x2, act_bits=ab)
        smid = A._act(sg, arch.act_fn) * su
        y = y + apply_qlinear(entry["mlp.shared_down"], smid.to(h2.dtype),
                              act_bits=ab)
    return y.reshape(Bs, T, H).to(h2.dtype)


def _mlp_tail(sw: ServingWeights, entry, h: torch.Tensor, ab: int,
              moe: MoEOptions = MoEOptions()) -> torch.Tensor:
    """Post-attention MLP tail (norm, MLP, residual), dispatching MoE
    blocks to ``_moe_mlp`` (JAX's ``_mlp_tail_serving``)."""
    h2 = A.apply_norm(h, entry["ln2"], sw.arch)
    if "mlp.router" in entry:
        return h + _moe_mlp(sw, entry, h2, ab, moe)
    g, u = _gateup_proj(entry, h2, ab)
    mid = A._act(g, sw.arch.act_fn) * u
    return h + apply_qlinear(entry["mlp.down"], mid, act_bits=ab)


def fused_ok(sw: ServingWeights, qp: QLinearParams) -> bool:
    """The JAX engine's test for a fused decode linear: ``fused_rms``
    weights at ``act_bits=8``, a linear in the planes layout that JAX
    tiles or in s4 (``tiled``).  (JAX also needs zero corrections, which
    every port linear has.)"""
    return sw.fused_rms and sw.act_bits == 8 and qp.tiled


def _flin(sw: ServingWeights, qp: QLinearParams, x2: torch.Tensor,
          rms: bool) -> torch.Tensor:
    """A fused decode linear on (S, K) x: #13 on s4, #14 on planes; the
    bias is added after the kernel."""
    fn = (w4a8_linear_bytes_fused if qp.layout == "s4"
          else w4a8_linear_planes_fused)
    y = fn(x2, qp.codes, qp.scales, qp.zeros, rms=rms, eps=sw.arch.rms_eps)
    return y if qp.bias is None else y + qp.bias


def _decode_qkv(sw, entry, x):
    """q/k/v (S, 1, .) of the decode step: fused where every linear
    involved is ``fused_ok``, else RMSNorm and the routed linears."""
    x2 = x[:, 0, :]
    if "attn.qkv" in entry and fused_ok(sw, entry["attn.qkv"]):
        return torch.split(_flin(sw, entry["attn.qkv"], x2, True)[:, None],
                           _qkv_sizes(sw.arch), dim=-1)
    names = ("attn.q", "attn.k", "attn.v")
    if "attn.qkv" not in entry and all(fused_ok(sw, entry[n])
                                       for n in names):
        return tuple(_flin(sw, entry[n], x2, True)[:, None] for n in names)
    return _qkv_proj(entry, A.apply_norm(x, entry["ln1"], sw.arch), sw.arch,
                     sw.act_bits)


def _decode_mlp(sw, entry, h, moe: MoEOptions = MoEOptions()):
    """h + MLP(h) of the decode step, fused as in ``_decode_qkv`` (the
    down projection must be fused too); MoE blocks take ``_moe_mlp``."""
    down = entry["mlp.down"]
    h2 = h[:, 0, :]
    if "mlp.router" in entry:
        return _mlp_tail(sw, entry, h, sw.act_bits, moe)
    if fused_ok(sw, down):
        if "mlp.gateup" in entry and fused_ok(sw, entry["mlp.gateup"]):
            gu = _flin(sw, entry["mlp.gateup"], h2, True)
            g, u = torch.split(gu, gu.shape[-1] // 2, dim=-1)
        elif "mlp.gateup" not in entry and all(
                fused_ok(sw, entry[n]) for n in ("mlp.gate", "mlp.up")):
            g = _flin(sw, entry["mlp.gate"], h2, True)
            u = _flin(sw, entry["mlp.up"], h2, True)
        else:
            return _mlp_tail(sw, entry, h, sw.act_bits)
        mid = A._act(g, sw.arch.act_fn) * u
        return h + _flin(sw, down, mid, False)[:, None]
    return _mlp_tail(sw, entry, h, sw.act_bits)


def _block_apply(sw: ServingWeights, entry, x: torch.Tensor, cos, sin,
                 mask: torch.Tensor, moe: MoEOptions = MoEOptions(),
                 k_full: Optional[torch.Tensor] = None,
                 v_full: Optional[torch.Tensor] = None):
    """One block on (N, T, H) with its earlier K/V (N, Hkv, Tc, D) in bf16
    (none for a prefill): attention over them and the block's own
    post-rope K/V under ``mask``, broadcast to (N, heads, T, Tc + T).
    Returns (y, k, v) with the block's post-rope K/V (N, Hkv, T, D)
    (JAX's ``_block_apply``)."""
    arch, ab = sw.arch, sw.act_bits
    N, T, _ = x.shape
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    h1 = A.apply_norm(x, entry["ln1"], arch)
    q, k, v = _qkv_proj(entry, h1, arch, ab)
    q = q.reshape(N, T, nh, hd).transpose(1, 2)
    k = k.reshape(N, T, nkv, hd).transpose(1, 2)
    v = v.reshape(N, T, nkv, hd).transpose(1, 2)
    q, k = A.qk_normed(arch, entry, q, k)
    q, k = A.apply_rope(q, k, cos, sin)
    k_all, v_all = k, v
    if k_full is not None:
        k_all = torch.cat([k_full, k.to(k_full.dtype)], dim=2)
        v_all = torch.cat([v_full, v.to(v_full.dtype)], dim=2)
    ctx = A.sdpa(q, k_all, v_all, mask, kv_groups=nh // nkv)
    ctx = ctx.transpose(1, 2).reshape(N, T, nh * hd)
    h = x + apply_qlinear(entry["attn.o"], ctx, act_bits=ab)
    return _mlp_tail(sw, entry, h, ab, moe), k, v


def _int8_attention(qg, kc, ksc, vc, vsc, visible) -> torch.Tensor:
    """JAX's masked einsum attention over int8 codes (S, K, T, D) and bf16
    scales (S, K, T): bf16 scores times the f32 scales, softmax over the
    visible columns, bf16 PV.  Returns (S, K, G, D) bf16."""
    qg = qg.to(torch.bfloat16)
    hd = qg.shape[-1]
    sc = torch.matmul(qg, kc.to(torch.bfloat16).transpose(-1, -2))
    sc = sc.float() * ksc[:, :, None, :].float() * hd ** -0.5
    probs = torch.softmax(sc.masked_fill(~visible, float("-inf")), dim=-1)
    pv = (probs * vsc[:, :, None, :].float()).to(torch.bfloat16)
    return torch.matmul(pv, vc.to(torch.bfloat16))


def _attend_xla8a(qg, kq, ks, vq, vs, cache: KVCache, li: int,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Append-first masked attention: write the fresh K/V at each slot's
    length, then attend over the full buffer with ``col <= length``."""
    append_kv_quantized(cache, li, kq, ks, vq, vs, lengths)
    col = torch.arange(cache.k.shape[3], device=qg.device)
    return _int8_attention(qg, cache.k[li], cache.k_scale[li], cache.v[li],
                           cache.v_scale[li],
                           col <= lengths[:, None, None, None])


def _attend_xla8(qg, kq, ks, vq, vs, cache: KVCache, li: int,
                 lengths: torch.Tensor) -> torch.Tensor:
    """JAX's concat variant: the int8 cache and the quantized fresh token
    concatenated on the time axis, attention where ``col < length`` or at
    the fresh column Tc - 1; then the token is written."""
    cat = functools.partial(torch.cat, dim=2)
    kc, vc = cat([cache.k[li], kq]), cat([cache.v[li], vq])
    Tc = kc.shape[2]
    col = torch.arange(Tc, device=qg.device)
    ctx = _int8_attention(
        qg, kc, cat([cache.k_scale[li], ks]), vc, cat([cache.v_scale[li], vs]),
        (col < lengths[:, None, None, None]) | (col == Tc - 1))
    append_kv_quantized(cache, li, kq, ks, vq, vs, lengths)
    return ctx


@dataclasses.dataclass
class RingStep:
    """One step of a ring chunk: the chunk's ring, the slots' chunk-entry
    lengths, this step's ring column, and the fresh tokens (kq, ks, vq, vs)
    of the layers run so far (int8, or packed int4 on an ``xla4r`` ring)."""
    ring: Ring
    lengths0: torch.Tensor
    pos: int = 0
    fresh: List[tuple] = dataclasses.field(default_factory=list)

    def write(self) -> None:
        """Every layer's fresh token into ring column ``pos`` at once (the
        JAX engine's deferred ring write)."""
        self.ring.kv[:, :, :, self.pos] = torch.stack(
            [torch.cat([kq, vq], dim=1)[:, :, 0]
             for kq, ks, vq, vs in self.fresh])
        self.ring.s[:, :, :, self.pos] = torch.stack(
            [torch.cat([ks, vs], dim=1)[:, :, 0]
             for kq, ks, vq, vs in self.fresh])
        self.fresh = []


def _flash_term(sc: torch.Tensor, visible: torch.Tensor):
    """A masked score term of a flash merge: (max floored at -1e30, exp,
    sum)."""
    sc = sc.masked_fill(~visible, float("-inf"))
    m = torch.clamp(sc.amax(dim=-1), min=-1e30)
    p = torch.exp(sc - m[..., None])
    return m, p, p.sum(dim=-1)


def _merge3(m1, l1, ctx1, m2, l2, ctx2, sc3, v3) -> torch.Tensor:
    """The ring routes' flash merge of the cache term, the ring term and
    the fresh token (score sc3 (S, K, G), value v3 (S, K, D)); f32."""
    m = torch.maximum(torch.maximum(m1, m2), sc3)
    a1, a2, a3 = (torch.exp(t - m) for t in (m1, m2, sc3))
    denom = l1 * a1 + l2 * a2 + a3
    ctx = (ctx1 * a1[..., None] + ctx2 * a2[..., None]
           + v3[:, :, None, :] * a3[..., None])
    return ctx / denom[..., None]


def _attend_ring(qg, kq, ks, vq, vs, cache: KVCache, li: int,
                 rs: RingStep) -> torch.Tensor:
    """The ``xla8r`` attention of one layer (JAX's deferred, fused ring with
    the full-T main term): a flash merge of three terms, the first two
    with their max floored at -1e30: the read-only cache at
    ``col < lengths0`` (bf16 scores and PV, as JAX's bf16 einsums, with
    f32 scales); the ring's columns ``< pos`` (f32); the fresh token (its
    score accumulated in f32).  Returns (S, K, G, D) f32.  JAX's
    split-cache copy (``LCTPU_RING_SPLITCACHE``) only shapes XLA's
    schedule and gives the same values; the port has none."""
    H, hd = kq.shape[1], qg.shape[-1]
    scale = hd ** -0.5
    qb = qg.to(torch.bfloat16)
    kc, vc = cache.k[li], cache.v[li]  # (S, H, T, hd) int8
    ksc, vsc = cache.k_scale[li], cache.v_scale[li]  # (S, H, T) bf16
    sc1 = torch.matmul(qb, kc.to(torch.bfloat16).transpose(-1, -2))
    sc1 = sc1.float() * ksc[:, :, None, :].float() * scale
    col = torch.arange(kc.shape[2], device=qg.device)
    m1, p1, l1 = _flash_term(sc1, col[None, None, None, :]
                             < rs.lengths0[:, None, None, None])
    ctx1 = torch.matmul((p1 * vsc[:, :, None, :].float()).to(torch.bfloat16),
                        vc.to(torch.bfloat16)).float()
    rkv, rsc = rs.ring.kv[li], rs.ring.s[li]  # (S, 2H, W, hd), (S, 2H, W)
    qf = qb.float()
    sc2 = torch.matmul(qf, rkv[:, :H].float().transpose(-1, -2))
    sc2 = sc2 * rsc[:, :H, None, :].float() * scale
    wcol = torch.arange(rkv.shape[2], device=qg.device)
    m2, p2, l2 = _flash_term(sc2, wcol < rs.pos)
    ctx2 = torch.matmul(p2 * rsc[:, H:, None, :].float(), rkv[:, H:].float())
    sc3 = torch.matmul(qf, kq.float().transpose(-1, -2))[..., 0]
    sc3 = sc3 * ks.float() * scale  # ks (S, H, 1) meets (S, H, G)
    v3 = vq[:, :, 0].float() * vs.float()  # (S, H, hd)
    return _merge3(m1, l1, ctx1, m2, l2, ctx2, sc3, v3)


def _planes_dot(a: torch.Tensor, packed: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """a (..., D) against nibble pairs (..., W, D/2) as JAX's two plane
    einsums in ``dtype``: a's low half with the low plane plus its high
    half with the high plane, each product and the sum rounded to
    ``dtype``.  (..., W) scores."""
    lo, hi = kv4_planes(packed)
    h = a.shape[-1] // 2
    return (torch.matmul(a[..., :h], lo.to(dtype).transpose(-1, -2))
            + torch.matmul(a[..., h:], hi.to(dtype).transpose(-1, -2)))


def _planes_pv(p: torch.Tensor, packed: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """p (..., W) against nibble pairs (..., W, D/2): the low and high
    planes' products in ``dtype``, concatenated to (..., D)."""
    lo, hi = kv4_planes(packed)
    return torch.cat([torch.matmul(p, lo.to(dtype)),
                      torch.matmul(p, hi.to(dtype))], dim=-1)


def _attend_ring4(qg, k4, k4s, v4, v4s, cache: KVCache, li: int,
                  rs: RingStep) -> torch.Tensor:
    """The ``xla4r`` attention of one layer (JAX's deferred fused kv4
    ring, engine.py:673-786) over the packed kv4 ``hhd`` cache and a
    packed ring: the cache at ``col < lengths0`` through two bf16 plane
    einsums (summed in bf16, then the f32 K scale and hd**-0.5; PV in
    bf16 on each plane); the ring's columns ``< pos`` in f32 on its
    planes; the fresh token from its unpacked int4 codes times their
    scales in f32; merged as ``_attend_ring``'s terms.  Returns
    (S, K, G, D) f32."""
    H, hd = k4.shape[1], qg.shape[-1]
    scale = hd ** -0.5
    qb = qg.to(torch.bfloat16)
    kc, vc = cache.k[li], cache.v[li]  # (S, H, T, hd/2) packed
    ksc, vsc = cache.k_scale[li], cache.v_scale[li]
    sc1 = _planes_dot(qb, kc, torch.bfloat16)
    sc1 = sc1.float() * ksc[:, :, None, :].float() * scale
    col = torch.arange(kc.shape[2], device=qg.device)
    m1, p1, l1 = _flash_term(sc1, col[None, None, None, :]
                             < rs.lengths0[:, None, None, None])
    pv1 = (p1 * vsc[:, :, None, :].float()).to(torch.bfloat16)
    ctx1 = _planes_pv(pv1, vc, torch.bfloat16).float()
    rkv, rsc = rs.ring.kv[li], rs.ring.s[li]  # (S, 2H, W, hd/2), (S, 2H, W)
    qf = qb.float()
    sc2 = _planes_dot(qf, rkv[:, :H], torch.float32)
    sc2 = sc2 * rsc[:, :H, None, :].float() * scale
    wcol = torch.arange(rkv.shape[2], device=qg.device)
    m2, p2, l2 = _flash_term(sc2, wcol < rs.pos)
    ctx2 = _planes_pv(p2 * rsc[:, H:, None, :].float(), rkv[:, H:],
                      torch.float32)
    kf = unpack_kv4(k4[:, :, 0]) * k4s.float()  # k4s (S, H, 1)
    v3 = unpack_kv4(v4[:, :, 0]) * v4s.float()
    sc3 = torch.matmul(qf, kf[..., None])[..., 0] * scale
    return _merge3(m1, l1, ctx1, m2, l2, ctx2, sc3, v3)


def _block_apply_decode(sw: ServingWeights, entry, x: torch.Tensor, cos,
                        sin, cache: KVCache, li: int, lengths: torch.Tensor,
                        impl: str, moe: MoEOptions = MoEOptions(),
                        ring: Optional[RingStep] = None) -> torch.Tensor:
    """One decode block on (S, 1, H) through the decode body ``impl`` (a
    value of ``ROUTES`` but the generic path; module docstring); the fresh
    token ends up in the cache at each slot's length, or with ``ring`` in
    the step's fresh tokens (packed int4 on a kv4 cache's ring)."""
    arch = sw.arch
    S = x.shape[0]
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    q, k, v = _decode_qkv(sw, entry, x)
    q = q.reshape(S, 1, nh, hd).transpose(1, 2)
    k = k.reshape(S, 1, nkv, hd).transpose(1, 2)
    v = v.reshape(S, 1, nkv, hd).transpose(1, 2)
    q, k = A.qk_normed(arch, entry, q, k)
    q, k = A.apply_rope(q, k, cos, sin)
    # q head h attends kv head h // groups -> (S, nkv, G, hd)
    qg = q[:, :, 0, :].reshape(S, nkv, nh // nkv, hd)
    if ring is not None:
        kv4 = cache.bits == 4
        quant = quantize_kv4 if kv4 else quantize_kv
        fresh = (*quant(k), *quant(v))
        ctx = (_attend_ring4 if kv4 else _attend_ring)(qg, *fresh, cache,
                                                       li, ring)
        ring.fresh.append(fresh)
        return _decode_tail(sw, entry, x, ctx, moe)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    if impl == "xla8a":
        ctx = _attend_xla8a(qg, kq, ks, vq, vs, cache, li, lengths)
    elif impl == "xla8":
        ctx = _attend_xla8(qg, kq, ks, vq, vs, cache, li, lengths)
    elif impl == "pallas":
        ctx = decode_attention_i8(
            qg, cache.k[li], cache.k_scale[li], cache.v[li],
            cache.v_scale[li], kq[:, :, 0], ks[:, :, 0], vq[:, :, 0],
            vs[:, :, 0], lengths)
        append_kv_quantized(cache, li, kq, ks, vq, vs, lengths)
    else:  # bd, bds, bd4: the int8 token is merged, then cached
        if impl == "bd":
            kernel = decode_attention_bd
        elif impl == "bds":
            kernel = functools.partial(decode_attention_bd_flash,
                                       s_block=S_BLOCK)
        elif cache.k.shape[-1] >= BD4_FLASH_MIN:
            kernel = decode_attention_bd4_flash
        else:
            kernel = decode_attention_bd4
        qctx = kernel(qg, cache.k[li], cache.k_scale[li], cache.v[li],
                      cache.v_scale[li], lengths)
        ctx = bd_merge_new_token(qg, qctx, kq[:, :, 0], vq[:, :, 0],
                                 ks[:, :, 0], vs[:, :, 0], hd ** -0.5)
        if impl == "bd4":
            append_kv_bd(cache, li, *quantize_kv4(k), *quantize_kv4(v),
                         lengths)
        else:
            append_kv_bd(cache, li, kq, ks, vq, vs, lengths)
    return _decode_tail(sw, entry, x, ctx, moe)


def _decode_tail(sw: ServingWeights, entry, x: torch.Tensor,
                 ctx: torch.Tensor, moe: MoEOptions) -> torch.Tensor:
    """The decode block after attention: the o projection (fused where
    ``fused_ok``), the residual and the MLP."""
    S = x.shape[0]
    ctx = ctx.reshape(S, 1, -1).to(x.dtype)
    if fused_ok(sw, entry["attn.o"]):
        h = x + _flin(sw, entry["attn.o"], ctx[:, 0], False)[:, None]
    else:
        h = x + apply_qlinear(entry["attn.o"], ctx, act_bits=sw.act_bits)
    return _decode_mlp(sw, entry, h, moe)


class LLMEngine:
    """Continuous-batching engine over ``ServingWeights`` on ``device``
    (the card unless ``device="cpu"``).  The weights must already be on
    that device.

    ``kv_bits`` 8, 4, 16 or "auto" (4 from ``max_len`` 4096 on, as in
    the JAX engine); ``attn_impl`` "auto", "xla", "xla8a", "xla8",
    "xla8r", "xla4r", "bd", "bds", "bd4" or "pallas", resolved to a decode
    body by ``ROUTES`` (module docstring; a MoE model always takes
    ``xla``); ``decode_chunk`` the decode steps per chunk (1: per-step
    decode; "xla8r" and "xla4r" fall back to "xla" without a chunk or at
    other bits, as in JAX).  ``moe_gather_max``, ``moe_grouped``,
    ``moe_grouped_min`` and ``moe_smallm`` set the expert routes
    (``MoEOptions``).  ``kv_bits=8`` with ``attn_impl="bd4"`` raises
    ``NotImplementedError`` (a fault of the JAX engine, ``_unported``), as
    do JAX's other names."""

    def __init__(self, weights: ServingWeights, max_slots: int = 8,
                 max_len: int = 1024, kv_bits: Union[int, str] = 8,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 seed: int = 0, attn_impl: str = "auto",
                 decode_chunk: int = 1,
                 moe_gather_max: Optional[int] = None,
                 moe_grouped: Union[str, bool] = "auto",
                 moe_grouped_min: int = 257, moe_smallm: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if weights.embed.device.type != self.device.type:
            raise ValueError(f"weights are on {weights.embed.device}, the "
                             f"engine on {self.device}")
        if kv_bits == "auto":
            kv_bits = 4 if max_len >= 4096 else 8
        if kv_bits not in (4, 8, 16):
            raise ValueError("kv_bits is 4, 8, 16 or 'auto'")
        self.decode_chunk = max(1, int(decode_chunk))
        chunked = self.decode_chunk > 1
        if attn_impl == "auto":
            attn_impl = pick_attn_impl(kv_bits, chunked)
        elif attn_impl in PROBE_ONLY:
            warnings.warn(
                f"attn_impl='{attn_impl}' is probe-only (loses to the "
                "auto-picked path engine-side at every measured shape; "
                "REPORT r4); use attn_impl='auto'", stacklevel=2)
        if weights.arch.moe is not None:
            attn_impl = "xla"  # as the JAX engine routes MoE blocks
        # the rings are the chunk's window, each on its own cache
        if attn_impl == "xla8r" and (kv_bits != 8 or not chunked):
            attn_impl = "xla"
        if attn_impl == "xla4r" and (kv_bits != 4 or not chunked):
            attn_impl = "xla"
        if (kv_bits, attn_impl) not in ROUTES:
            raise NotImplementedError(
                f"kv_bits={kv_bits} with attn_impl={attn_impl!r} is not "
                f"ported ({_unported(kv_bits, attn_impl)}); the port serves "
                f"{sorted(ROUTES)}")
        self.attn_impl = attn_impl
        self.body = ROUTES[(kv_bits, attn_impl)]
        self.layout = {"bd4": "bd4", "bd": "bd", "bds": "bd"}.get(self.body,
                                                                 "hhd")
        # a chunked engine decodes on a ring where JAX's _decode_chunk
        # does: kv8 xla (its _use_xla8) or xla8r, and kv4 xla4r
        self.ring = chunked and (attn_impl == "xla4r" or (
            kv_bits == 8 and attn_impl in ("xla", "xla8r")))
        # the physical time axis: a ring chunk entered at max_len - k
        # flushes a whole chunk-wide slab, so a chunked hhd engine whose
        # attn_impl is xla, xla8r or xla4r has a chunk of headroom (JAX
        # adds it whether or not it rides the ring); bd and bd4 buffers
        # round up to the flash block.  The lengths mask keeps the logical
        # max_len.
        self.buf_len = max_len + (
            self.decode_chunk if chunked and self.layout == "hhd"
            and attn_impl in ("xla", "xla8r", "xla4r") else 0)
        if self.layout != "hhd":
            self.buf_len = -(-self.buf_len // BD4_ALIGN) * BD4_ALIGN
        self.moe = MoEOptions(moe_gather_max, moe_grouped, moe_grouped_min,
                              moe_smallm)
        self.sw = weights
        self.arch = weights.arch
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.prefill_buckets = [b for b in prefill_buckets if b <= max_len]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache: Optional[KVCache] = None
        self.reset()

    def reset(self):
        a = self.arch
        if self.cache is None:
            self.cache = KVCache.create(
                a.num_layers, self.max_slots, a.num_kv_heads, self.buf_len,
                a.head_dim, bits=self.kv_bits, layout=self.layout,
                device=self.device)
        else:
            self.cache.zero_()
        self.lengths = torch.zeros((self.max_slots,), dtype=torch.int64,
                                   device=self.device)
        self.cur_tokens = torch.zeros((self.max_slots,), dtype=torch.int64,
                                      device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * self.max_slots

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.max_len

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill_batch(self, ids: torch.Tensor, slots: torch.Tensor,
                       true_lens: torch.Tensor, T: int) -> torch.Tensor:
        """N padded prompts (N, T) in one pass; KV written into ``slots``.
        Returns the last true token's logits (N, V)."""
        sw, arch = self.sw, self.arch
        N = ids.shape[0]
        dev = self.device
        x = sw.embed[ids]  # (N, T, H)
        cos, sin = A.rope_cos_sin(arch, torch.arange(T, device=dev))
        mask = A.causal_mask(T, T, device=dev)[None, None]
        neg = torch.finfo(torch.float32).min
        pad = torch.where(torch.arange(T, device=dev)[None, :]
                          < true_lens[:, None], 0.0, neg)
        mask = mask + pad[:, None, None, :]
        for li, entry in enumerate(sw.blocks):
            x, k_new, v_new = _block_apply(sw, entry, x, cos, sin, mask,
                                           self.moe)
            append_slots(self.cache, li, slots, k_new, v_new)
        xl = A.rmsnorm(x, sw.norm.get("weight"), arch.rms_eps)
        xl_last = xl[torch.arange(N, device=dev), true_lens - 1][:, None]
        self.lengths[slots] = true_lens
        return head_logits(sw, xl_last)[:, 0]

    @torch.no_grad()
    def _decode_step(self, cur_tokens: torch.Tensor,
                     active_mask: torch.Tensor,
                     ring: Optional[RingStep] = None) -> torch.Tensor:
        """One token for every slot; lengths advance for active slots.
        With ``ring`` (a ring chunk's step) the cache stays read-only and
        every layer's fresh token goes to the ring's column ``ring.pos``.
        Returns logits (S, V)."""
        sw, arch = self.sw, self.arch
        lengths = self.lengths
        x = sw.embed[cur_tokens][:, None, :]  # (S, 1, H)
        cos, sin = A.rope_cos_sin(arch, lengths[:, None])  # (S, 1, D)
        generic = ring is None and self.body == "generic"
        if generic:
            # the buffer's columns and the fresh token at column T
            T = self.buf_len
            j = torch.arange(T + 1, device=self.device)
            visible = (j < lengths[:, None, None, None]) | (j == T)
            mask = torch.where(visible, 0.0, torch.finfo(torch.float32).min)
        for li, entry in enumerate(sw.blocks):
            if generic:
                x, k_new, v_new = _block_apply(
                    sw, entry, x, cos, sin, mask, self.moe,
                    *read_kv(self.cache, li))
                append_kv(self.cache, li, k_new, v_new, lengths)
            else:
                x = _block_apply_decode(sw, entry, x, cos, sin, self.cache,
                                        li, lengths, self.body, self.moe,
                                        ring)
        if ring is not None:
            ring.write()
        xl = A.rmsnorm(x, sw.norm.get("weight"), arch.rms_eps)
        logits = head_logits(sw, xl)[:, 0]
        self.lengths = torch.where(active_mask, lengths + 1, lengths)
        return logits

    def ring_step(self, width: int) -> RingStep:
        """A ring chunk's first step at the slots' current lengths: a ring
        of ``width`` columns, its entries packed as the cache's (head_dim/2
        bytes on a kv4 cache)."""
        a = self.arch
        return RingStep(Ring.create(a.num_layers, self.max_slots,
                                    a.num_kv_heads, width,
                                    self.cache.k.shape[-1], self.device),
                        self.lengths.clone())

    @torch.no_grad()
    def _decode_chunk(self, n: int, active_mask: torch.Tensor,
                      sampling: SamplingParams) -> torch.Tensor:
        """``n`` decode steps, each step's tokens sampled on the device and
        fed to the next; returns the (n, S) token buffer, on the device.
        On the ring (``self.ring``) the chunk's fresh tokens ride a ring of
        width n, flushed into the cache at the chunk-entry lengths after
        the last step."""
        buf = torch.empty((n, self.max_slots), dtype=torch.int64,
                          device=self.device)
        ring = self.ring_step(n) if self.ring else None
        cur = self.cur_tokens
        for i in range(n):
            if ring is not None:
                ring.pos = i
            logits = self._decode_step(cur, active_mask, ring)
            cur = sample(logits, sampling, self.generator).long()
            buf[i] = cur
        if ring is not None:
            flush_ring_to_cache(self.cache, ring.ring, ring.lengths0)
        self.cur_tokens = cur
        return buf

    # ------------------------------------------------------------------
    def _admit(self, admits: List[Tuple[int, Request]],
               sampling: SamplingParams) -> None:
        """Batched prefill of the admitted prompts, one pass per length
        bucket, split so rows stay within PREFILL_ROWS; the row count is
        padded to a power of two by repeating the last prompt."""
        by_bucket: Dict[int, List[Tuple[int, Request]]] = {}
        for slot, req in admits:
            by_bucket.setdefault(self._bucket(len(req.prompt)),
                                 []).append((slot, req))
        groups = []
        for T, full_group in sorted(by_bucket.items()):
            cap = max(1, PREFILL_ROWS // T)
            cap = 1 << (cap.bit_length() - 1)  # power-of-two floor
            for i in range(0, len(full_group), cap):
                groups.append((T, full_group[i:i + cap]))
        for T, group in groups:
            n = len(group)
            nb = 1 << (n - 1).bit_length()
            ids = np.zeros((nb, T), np.int64)
            slots_arr = np.zeros((nb,), np.int64)
            tlens = np.zeros((nb,), np.int64)
            for i in range(nb):
                slot, req = group[min(i, n - 1)]
                ids[i, :len(req.prompt)] = req.prompt
                slots_arr[i] = slot
                tlens[i] = len(req.prompt)
            dev = self.device
            logits = self._prefill_batch(
                torch.from_numpy(ids).to(dev),
                torch.from_numpy(slots_arr).to(dev),
                torch.from_numpy(tlens).to(dev), T)
            if sampling.temperature == 0.0:
                toks = sample(logits, sampling).cpu().tolist()
            else:
                toks = [int(sample(logits[i][None], sampling,
                                   self.generator)[0]) for i in range(n)]
            new_slots, new_toks = [], []
            for i, (slot, req) in enumerate(group):
                req.out_tokens.append(int(toks[i]))
                new_slots.append(slot)
                new_toks.append(int(toks[i]))
                self.slot_req[slot] = req
            self.cur_tokens[torch.tensor(new_slots, device=dev)] = \
                torch.tensor(new_toks, device=dev)

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: SamplingParams = SamplingParams(),
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Continuous-batching generation over all prompts."""
        queue = deque(Request(i, np.asarray(p, np.int64),
                              sampling.max_new_tokens)
                      for i, p in enumerate(prompts))
        results: Dict[int, List[int]] = {}
        n_total = len(queue)
        while len(results) < n_total:
            admits = []
            for slot in range(self.max_slots):
                if self.slot_req[slot] is None and queue:
                    admits.append((slot, queue.popleft()))
            if admits:
                self._admit(admits, sampling)
            active = [r is not None for r in self.slot_req]
            if not any(active):
                continue
            active_mask = torch.tensor(active, device=self.device)
            if self.decode_chunk > 1:
                live = [sl for sl, r in enumerate(self.slot_req)
                        if r is not None]
                lens = self.lengths.cpu().tolist()
                remaining = min(self.slot_req[sl].max_new_tokens
                                - len(self.slot_req[sl].out_tokens)
                                for sl in live)
                room = self.max_len - 1 - max(lens[sl] for sl in live)
                n = max(1, min(self.decode_chunk, remaining, room))
                # a chunk length between 1 and decode_chunk rounds down to
                # a power of two: a few fixed lengths (the ring's chunk
                # boundaries shape its numerics, as in JAX)
                if n not in (1, self.decode_chunk):
                    n = 1 << (n.bit_length() - 1)
                tok_rows = self._decode_chunk(n, active_mask,
                                              sampling).cpu().tolist()
            else:
                logits = self._decode_step(self.cur_tokens, active_mask)
                toks = sample(logits, sampling, self.generator)
                tok_rows = [toks.cpu().tolist()]
                self.cur_tokens = torch.where(active_mask, toks.long(),
                                              self.cur_tokens)
            lengths_np = self.lengths.cpu().tolist()
            done_slots = []
            for ri, row in enumerate(tok_rows):
                for slot, req in enumerate(self.slot_req):
                    if req is None or slot in done_slots:
                        continue
                    tok = int(row[slot])
                    req.out_tokens.append(tok)
                    hit_eos = eos_token_id is not None and \
                        tok == eos_token_id
                    # the post-chunk length holds for the chunk's last row
                    # only (the chunk length keeps every slot inside the
                    # buffer until then)
                    full = ri == len(tok_rows) - 1 and \
                        lengths_np[slot] >= self.max_len - 1
                    if len(req.out_tokens) >= req.max_new_tokens \
                            or hit_eos or full:
                        results[req.req_id] = req.out_tokens
                        done_slots.append(slot)
            if done_slots:
                idx = torch.tensor(done_slots, device=self.device)
                self.lengths[idx] = 0
                for slot in done_slots:
                    self.slot_req[slot] = None
        return [results[i] for i in range(n_total)]
