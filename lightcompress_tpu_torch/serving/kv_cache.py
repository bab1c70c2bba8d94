"""Slot KV cache (port of lightcompress_tpu/serving/kv_cache.py: the dense
``hhd`` layout at 4, 8 and 16 bits, the block-diagonal int8 ``bd`` slabs
and the nibble-packed ``bd4`` slabs).

``hhd``: (L, S, H, T, D) per slot, int8 with a bf16 scale per (head, token)
or bf16 passthrough; at 4 bits (L, S, H, T, D/2) int8 bytes holding two
int4 codes (``quantize_kv4``'s half planes) with a bf16 scale per (head,
token).  ``bd`` (kv8, for ``ops.attention``'s #18/#19): K
feature-major (L, S, H*D, T) with row h*D + d holding feature d of head h,
V time-major (L, S, T, H*D), int8 codes, bf16 scales (L, S, H, T).
``bd4`` (kv4, for #20/#21): the same slabs of int8 bytes holding two int4
codes (``quantize_kv4``), K (L, S, H*D/2, T), V (L, S, T, H*D/2).
Appends write in place into the preallocated buffers (the JAX package's
dynamic_update_slice loops, with donation, do the same).  A decode chunk's
ring (``flush_ring_to_cache``; at 4 bits its entries are packed as the
cache's) is written into the ``hhd`` cache once per chunk.  ``read_kv``
and ``read_kv_slot`` dequantize to bf16 (the per-step read of JAX's
generic decode path and of its chunked prefill).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, div, resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, S, H, T, D) int8 | bf16; kv4: (L, S, H, T, D/2);
    #                  bd: (L, S, H*D, T); bd4: (L, S, H*D/2, T)
    v: torch.Tensor  # bd: (L, S, T, H*D); bd4: (L, S, T, H*D/2)
    k_scale: Optional[torch.Tensor]  # (L, S, H, T) bf16 (int8, int4 only)
    v_scale: Optional[torch.Tensor]
    bits: int = 8
    layout: str = "hhd"  # "hhd" | "bd" | "bd4"

    @staticmethod
    def create(n_layers: int, n_slots: int, n_kv_heads: int, max_len: int,
               head_dim: int, bits: int = 8, layout: str = "hhd",
               device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        sshape = (n_layers, n_slots, n_kv_heads, max_len)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if layout in ("bd", "bd4"):
            if layout == "bd" and bits != 8:
                raise ValueError("the bd layout holds int8 codes")
            if layout == "bd4" and (bits != 4 or head_dim % 2):
                raise ValueError("the bd4 layout holds int4 codes of an "
                                 "even head_dim")
            hr = n_kv_heads * head_dim * bits // 8
            return KVCache(
                zeros((n_layers, n_slots, hr, max_len), torch.int8),
                zeros((n_layers, n_slots, max_len, hr), torch.int8),
                zeros(sshape, torch.bfloat16), zeros(sshape, torch.bfloat16),
                bits, layout)
        if layout != "hhd":
            raise ValueError(f"unknown cache layout {layout!r}")
        if bits in (4, 8):
            if bits == 4 and head_dim % 2:
                raise ValueError("the kv4 cache packs an even head_dim")
            shape = sshape + (head_dim * bits // 8,)
            return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                           zeros(sshape, torch.bfloat16),
                           zeros(sshape, torch.bfloat16), bits)
        shape = sshape + (head_dim,)
        if bits != 16:
            raise ValueError("the slot cache holds int4, int8 or bf16")
        return KVCache(zeros(shape, torch.bfloat16),
                       zeros(shape, torch.bfloat16), None, None, 16)

    def zero_(self) -> "KVCache":
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                t.zero_()
        return self


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., token) int8 over head_dim: x (..., T, D).  Divides by the
    bf16-rounded scale, so the codes agree with the stored scale."""
    amax = x.float().abs().amax(dim=-1).clamp_min(1e-6)
    scale = div(amax, 127.0).to(torch.bfloat16)
    q = torch.round(x.float() / scale[..., None].float()).clamp(-128, 127)
    return q.to(torch.int8), scale


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., token) symmetric int4 over head_dim, half-plane packed:
    x (..., T, D) -> codes (..., T, D/2) int8 and a bf16 scale amax/7.
    Codes lie in [-8, 7]; the low nibble holds feature d (d < D/2), the
    high nibble feature d + D/2."""
    amax = x.float().abs().amax(dim=-1).clamp_min(1e-6)
    scale = div(amax, 7.0).to(torch.bfloat16)
    q = torch.round(x.float() / scale[..., None].float()).clamp(-8, 7)
    q = q.to(torch.int32)
    half = q.shape[-1] // 2
    packed = (q[..., :half] & 0xF) | ((q[..., half:] & 0xF) << 4)
    return packed.to(torch.int8), scale  # 128..255 wrap as in the JAX cast


def kv4_planes(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D/2) int8 nibble pairs -> (lo, hi) f32 code planes, each
    (..., D/2), sign-extended."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 0x8) - 8
    hi = (((p >> 4) & 0xF) ^ 0x8) - 8
    return lo.float(), hi.float()


def unpack_kv4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2) int8 nibble pairs -> (..., D) f32 codes, [lo | hi]."""
    return torch.cat(kv4_planes(packed), dim=-1)


def _quantized(cache: KVCache, k: torch.Tensor, v: torch.Tensor):
    if cache.bits == 4:
        return (*quantize_kv4(k), *quantize_kv4(v))
    if cache.bits == 8:
        return (*quantize_kv(k), *quantize_kv(v))
    return k.to(cache.k.dtype), None, v.to(cache.v.dtype), None


def append_slots(cache: KVCache, layer: int, slots: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Batched prefill: write (N, H, T, D) into ``slots`` at position 0.
    Repeated slots (row padding) write identical values."""
    T = k_new.shape[2]
    kq, ks, vq, vs = _quantized(cache, k_new, v_new)
    if cache.layout in ("bd", "bd4"):
        N, H, _, R = kq.shape  # R = head_dim (bd) or head_dim/2 (bd4)
        cache.k[layer, slots, :, :T] = kq.transpose(2, 3).reshape(
            N, H * R, T)
        cache.v[layer, slots, :T] = vq.transpose(1, 2).reshape(N, T, H * R)
    else:
        cache.k[layer, slots, :, :T] = kq
        cache.v[layer, slots, :, :T] = vq
    if ks is not None:
        cache.k_scale[layer, slots, :, :T] = ks
        cache.v_scale[layer, slots, :, :T] = vs
    return cache


def _positions(cache: KVCache, lengths: torch.Tensor,
               n: int = 1) -> torch.Tensor:
    """Each slot's first write position for ``n`` tokens; as with
    dynamic_update_slice, a start past T - n clamps to T - n (every layout
    keeps its time axis at dimension 3)."""
    return lengths.clamp(0, cache.k.shape[3] - n)


def append_kv_quantized(cache: KVCache, layer: int, kq, ks, vq, vs,
                        lengths: torch.Tensor) -> KVCache:
    """Decode: write every slot's fresh tokens, already quantized or cast
    ((S, H, n, D) codes, (S, H, n) scales or None), at that slot's length
    (the ``hhd`` cache)."""
    S, _, n = kq.shape[:3]
    pos = _positions(cache, lengths, n)[:, None] + torch.arange(
        n, device=lengths.device)
    rows = torch.arange(S, device=lengths.device)[:, None]
    # advanced indices split by a slice lead the result: (S, n, H, ...)
    cache.k[layer, rows, :, pos] = kq.transpose(1, 2).to(cache.k.dtype)
    cache.v[layer, rows, :, pos] = vq.transpose(1, 2).to(cache.v.dtype)
    if ks is not None:
        cache.k_scale[layer, rows, :, pos] = ks.transpose(1, 2)
        cache.v_scale[layer, rows, :, pos] = vs.transpose(1, 2)
    return cache


def append_kv(cache: KVCache, layer: int, k_new: torch.Tensor,
              v_new: torch.Tensor, lengths: torch.Tensor) -> KVCache:
    """Decode on the ``hhd`` cache: quantize (S, H, n, D) K/V by the
    cache's bits (``quantize_kv4``, ``quantize_kv`` or a cast to bf16) and
    write them at each slot's length (JAX's ``append_kv``)."""
    return append_kv_quantized(cache, layer, *_quantized(cache, k_new, v_new),
                               lengths)


def append_kv_bd(cache: KVCache, layer: int, kq: torch.Tensor,
                 ks: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                 lengths: torch.Tensor) -> KVCache:
    """Decode: write one token per slot into the block-diagonal slabs
    (``bd``: int8 codes (S, H, 1, D) of ``quantize_kv``; ``bd4``: packed
    (S, H, 1, D/2) of ``quantize_kv4``); ks/vs (S, H, 1)."""
    S, H, _, R = kq.shape
    pos = _positions(cache, lengths)
    rows = torch.arange(S, device=lengths.device)
    cache.k[layer, rows, :, pos] = kq.reshape(S, H * R)
    cache.v[layer, rows, pos, :] = vq.reshape(S, H * R)
    cache.k_scale[layer, rows, :, pos] = ks[:, :, 0]
    cache.v_scale[layer, rows, :, pos] = vs[:, :, 0]
    return cache


@dataclasses.dataclass
class Ring:
    """A decode chunk's fresh tokens (``xla8r``, ``xla4r``): k and v of
    every layer in one int8 buffer ``kv`` (L, S, 2H, W, D) (k in head rows
    [0, H), v in [H, 2H); the ``xla4r`` ring's D is the packed head_dim/2)
    and their bf16 scales ``s`` (L, S, 2H, W); column w holds the token of
    chunk step w (the JAX engine's fused ring)."""
    kv: torch.Tensor
    s: torch.Tensor

    @staticmethod
    def create(n_layers: int, n_slots: int, n_kv_heads: int, width: int,
               head_dim: int, device: torch.device) -> "Ring":
        shape = (n_layers, n_slots, 2 * n_kv_heads, width)
        return Ring(torch.zeros(shape + (head_dim,), dtype=torch.int8,
                                device=device),
                    torch.zeros(shape, dtype=torch.bfloat16, device=device))


def flush_ring_to_cache(cache: KVCache, ring: Ring,
                        lengths0: torch.Tensor) -> KVCache:
    """Write a chunk's ring into the int8 or packed int4 ``hhd`` cache,
    every layer at once: slot s's W columns at positions lengths0[s] .. + W - 1 (the
    chunk-entry length).  As with dynamic_update_slice, a start past
    T - W clamps to T - W (the engine's flush headroom keeps real tokens
    clear of that).  Columns of inactive slots land past their length,
    masked until real tokens overwrite them."""
    H, T = cache.k.shape[2], cache.k.shape[3]
    S, W = ring.kv.shape[1], ring.kv.shape[3]
    start = lengths0.clamp(0, T - W)
    pos = start[:, None] + torch.arange(W, device=start.device)  # (S, W)
    rows = torch.arange(S, device=start.device)[:, None]
    # advanced indices split by a slice lead the result: (S, W, L, H, ...)
    kv = ring.kv.permute(1, 3, 0, 2, 4)
    sc = ring.s.permute(1, 3, 0, 2)
    cache.k[:, rows, :, pos] = kv[..., :H, :]
    cache.v[:, rows, :, pos] = kv[..., H:, :]
    cache.k_scale[:, rows, :, pos] = sc[..., :H]
    cache.v_scale[:, rows, :, pos] = sc[..., H:]
    return cache


def _dequant(codes: torch.Tensor, scale: torch.Tensor,
             bits: int) -> torch.Tensor:
    """(..., T, D) codes (packed D/2 at 4 bits) times their (..., T)
    scales in f32, as bf16."""
    c = unpack_kv4(codes) if bits == 4 else codes.float()
    return (c * scale[..., None].float()).to(torch.bfloat16)


def read_kv(cache: KVCache, layer: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized (S, H, T, D) bf16 K/V of one layer of the ``hhd``
    cache (JAX's ``read_kv``); a bf16 cache as stored."""
    if cache.layout != "hhd":
        raise ValueError("read_kv reads the hhd cache")
    k, v = cache.k[layer], cache.v[layer]
    if cache.bits == 16:
        return k, v
    return (_dequant(k, cache.k_scale[layer], cache.bits),
            _dequant(v, cache.v_scale[layer], cache.bits))


def read_kv_slot(cache: KVCache, layer: int, slot: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized (1, H, T, D) bf16 views of one slot of one layer."""
    k, v = cache.k[layer, slot], cache.v[layer, slot]
    if cache.bits == 16:
        return k[None], v[None]
    ksc, vsc = cache.k_scale[layer, slot], cache.v_scale[layer, slot]
    if cache.layout in ("bd", "bd4"):
        H, T = ksc.shape
        k = k.reshape(H, -1, T).transpose(1, 2)
        v = v.reshape(T, H, -1).transpose(0, 1)
    return (_dequant(k, ksc, cache.bits)[None],
            _dequant(v, vsc, cache.bits)[None])
