"""Serving engine: continuous batching over W4 weights and a quantized
slot KV cache (port of lightcompress_tpu/serving/engine.py, dense Llama).

Slots share one batched decode step; new requests are admitted into free
slots between steps, one batched prefill per length bucket; finished
sequences retire at once.  Prefill attention is plain torch ops.  The cache
is updated in place.  Decode attention takes one of three routes
(``attn_impl``, picked as the JAX engine picks on a TPU):

* ``xla`` (kv8, the default): append-first masked attention (``xla8a``),
  plain torch: the fresh token is quantized and written into the cache
  first, then one attention runs over the buffer where ``col <= length``;
* ``bd4`` (kv4): the nibble-packed ``bd4`` cache stays read-only while
  kernel #20 (buffer < 8192) or #21 (from 8192) attends over
  ``col < length``; the fresh token, quantized to int8, is merged in by
  ``bd_merge_new_token``, then written to the cache as int4;
* ``pallas`` (kv8, probe-only in the JAX engine): kernel #17 over the
  read-only int8 cache with the fresh token as an in-register column, then
  the token is written.

On every route, weights built with ``fused_rms`` at ``act_bits=8`` take the
fused decode linears where JAX does (``fused_ok``): q/k/v (or the merged
qkv) and gate/up (or gateup) run RMSNorm and the int8 act quant inside
kernel #14 (planes) or #13 (s4), ``attn.o`` and ``mlp.down`` the act quant
alone.  Prefill takes the plain linears: the folded ln weights are ones.
"""

from __future__ import annotations

import dataclasses
from collections import deque
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import arch as A
from ..ops.attention import (bd_merge_new_token, decode_attention_bd4,
                             decode_attention_bd4_flash, decode_attention_i8)
from ..ops.qlinear import QLinearParams
from ..ops.w4_matmul import (w4a8_linear_bytes_fused,
                             w4a8_linear_planes_fused)
from .kv_cache import (KVCache, append_kv4_bd, append_kv_quantized,
                       append_slots, quantize_kv, quantize_kv4)
from .quantized_model import ServingWeights, apply_qlinear, head_logits
from .sampler import SamplingParams, sample

# rows per batched prefill: a bucket's prompts are split so that
# n_prompts * T stays within this (the JAX engine's default cap)
PREFILL_ROWS = 4096
# bd4 buffers are a multiple of the flash kernel's column block; from this
# length on the bd4 route takes the flash kernel (#21)
BD4_ALIGN = 512
BD4_FLASH_MIN = 8192
# (kv_bits, attn_impl) pairs the port serves
ROUTES = {(8, "xla"), (8, "pallas"), (4, "bd4")}


def pick_attn_impl(kv_bits: Union[int, str]) -> str:
    """The JAX engine's ``pick_attn_impl`` for a per-step dense engine on a
    TPU, at any ``max_len``: kv4 -> the bd4 kernels, everything else ->
    ``xla`` ("auto" is resolved by the engine first)."""
    return "bd4" if kv_bits == 4 else "xla"


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


def _mlp_tail(sw: ServingWeights, entry, h: torch.Tensor,
              ab: int) -> torch.Tensor:
    h2 = A.apply_norm(h, entry["ln2"], sw.arch)
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


def _decode_mlp(sw, entry, h):
    """h + MLP(h) of the decode step, fused as in ``_decode_qkv`` (the
    down projection must be fused too)."""
    down = entry["mlp.down"]
    h2 = h[:, 0, :]
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
                 mask: torch.Tensor):
    """One block on (N, T, H) prompts with no earlier KV.  Returns
    (y, k, v) with post-rope K/V (N, Hkv, T, D)."""
    arch, ab = sw.arch, sw.act_bits
    N, T, _ = x.shape
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    h1 = A.apply_norm(x, entry["ln1"], arch)
    q, k, v = _qkv_proj(entry, h1, arch, ab)
    q = q.reshape(N, T, nh, hd).transpose(1, 2)
    k = k.reshape(N, T, nkv, hd).transpose(1, 2)
    v = v.reshape(N, T, nkv, hd).transpose(1, 2)
    q, k = A.apply_rope(q, k, cos, sin)
    ctx = A.sdpa(q, k, v, mask, kv_groups=nh // nkv)
    ctx = ctx.transpose(1, 2).reshape(N, T, nh * hd)
    h = x + apply_qlinear(entry["attn.o"], ctx, act_bits=ab)
    return _mlp_tail(sw, entry, h, ab), k, v


def _attend_xla8a(qg, kq, ks, vq, vs, cache: KVCache, li: int,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Append-first masked attention: write the fresh K/V at each slot's
    length, then attend over the full buffer with ``col <= length``."""
    append_kv_quantized(cache, li, kq, ks, vq, vs, lengths)
    qg = qg.to(torch.bfloat16)
    hd = qg.shape[-1]
    kc, vc = cache.k[li], cache.v[li]  # (S, nkv, T, hd) int8
    ksc, vsc = cache.k_scale[li], cache.v_scale[li]  # (S, nkv, T) bf16
    sc = torch.matmul(qg, kc.to(torch.bfloat16).transpose(-1, -2))
    sc = sc.float() * ksc[:, :, None, :].float() * hd ** -0.5
    col = torch.arange(kc.shape[2], device=qg.device)
    vis = col[None, None, None, :] <= lengths[:, None, None, None]
    sc = sc.masked_fill(~vis, float("-inf"))
    probs = torch.softmax(sc, dim=-1)
    pv = (probs * vsc[:, :, None, :].float()).to(torch.bfloat16)
    return torch.matmul(pv, vc.to(torch.bfloat16))  # (S, nkv, G, hd)


def _block_apply_decode(sw: ServingWeights, entry, x: torch.Tensor, cos,
                        sin, cache: KVCache, li: int, lengths: torch.Tensor,
                        impl: str) -> torch.Tensor:
    """One decode block on (S, 1, H) through the attention route ``impl``
    (module docstring); the fresh token ends up in the cache at each
    slot's length."""
    arch, ab = sw.arch, sw.act_bits
    S = x.shape[0]
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    q, k, v = _decode_qkv(sw, entry, x)
    q = q.reshape(S, 1, nh, hd).transpose(1, 2)
    k = k.reshape(S, 1, nkv, hd).transpose(1, 2)
    v = v.reshape(S, 1, nkv, hd).transpose(1, 2)
    q, k = A.apply_rope(q, k, cos, sin)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    # q head h attends kv head h // groups -> (S, nkv, G, hd)
    qg = q[:, :, 0, :].reshape(S, nkv, nh // nkv, hd)
    if impl == "xla":
        ctx = _attend_xla8a(qg, kq, ks, vq, vs, cache, li, lengths)
    elif impl == "pallas":
        ctx = decode_attention_i8(
            qg, cache.k[li], cache.k_scale[li], cache.v[li],
            cache.v_scale[li], kq[:, :, 0], ks[:, :, 0], vq[:, :, 0],
            vs[:, :, 0], lengths)
        append_kv_quantized(cache, li, kq, ks, vq, vs, lengths)
    else:  # bd4: the int8 token is merged, the int4 token is cached
        kernel = (decode_attention_bd4_flash
                  if cache.k.shape[-1] >= BD4_FLASH_MIN
                  else decode_attention_bd4)
        qctx = kernel(qg, cache.k[li], cache.k_scale[li], cache.v[li],
                      cache.v_scale[li], lengths)
        ctx = bd_merge_new_token(qg, qctx, kq[:, :, 0], vq[:, :, 0],
                                 ks[:, :, 0], vs[:, :, 0], hd ** -0.5)
        append_kv4_bd(cache, li, *quantize_kv4(k), *quantize_kv4(v),
                      lengths)
    ctx = ctx.reshape(S, 1, nh * hd).to(x.dtype)
    if fused_ok(sw, entry["attn.o"]):
        h = x + _flin(sw, entry["attn.o"], ctx[:, 0], False)[:, None]
    else:
        h = x + apply_qlinear(entry["attn.o"], ctx, act_bits=ab)
    return _decode_mlp(sw, entry, h)


class LLMEngine:
    """Continuous-batching engine over ``ServingWeights`` on ``device``
    (the card unless ``device="cpu"``).  The weights must already be on
    that device.

    ``kv_bits`` 8, 4 or "auto" (4 from ``max_len`` 4096 on, as in the JAX
    engine); ``attn_impl`` "auto", "xla", "bd4" or "pallas" (module
    docstring).  Other JAX routes raise ``NotImplementedError``."""

    def __init__(self, weights: ServingWeights, max_slots: int = 8,
                 max_len: int = 1024, kv_bits: Union[int, str] = 8,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 seed: int = 0, attn_impl: str = "auto",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if weights.embed.device.type != self.device.type:
            raise ValueError(f"weights are on {weights.embed.device}, the "
                             f"engine on {self.device}")
        if kv_bits == "auto":
            kv_bits = 4 if max_len >= 4096 else 8
        if attn_impl == "auto":
            attn_impl = pick_attn_impl(kv_bits)
        elif attn_impl == "pallas":
            warnings.warn(
                "attn_impl='pallas' is probe-only (loses to the auto-picked "
                "path engine-side at every measured shape; REPORT r4); use "
                "attn_impl='auto'", stacklevel=2)
        if (kv_bits, attn_impl) not in ROUTES:
            raise NotImplementedError(
                f"kv_bits={kv_bits} with attn_impl={attn_impl!r} is not "
                f"ported; the port serves {sorted(ROUTES)}")
        self.attn_impl = attn_impl
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
            layout = "bd4" if self.attn_impl == "bd4" else "hhd"
            # the physical time axis: bd4 buffers round up to the flash
            # block; the lengths mask keeps the logical max_len
            self.buf_len = (-(-self.max_len // BD4_ALIGN) * BD4_ALIGN
                            if layout == "bd4" else self.max_len)
            self.cache = KVCache.create(
                a.num_layers, self.max_slots, a.num_kv_heads, self.buf_len,
                a.head_dim, bits=self.kv_bits, layout=layout,
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
            x, k_new, v_new = _block_apply(sw, entry, x, cos, sin, mask)
            append_slots(self.cache, li, slots, k_new, v_new)
        xl = A.rmsnorm(x, sw.norm.get("weight"), arch.rms_eps)
        xl_last = xl[torch.arange(N, device=dev), true_lens - 1][:, None]
        self.lengths[slots] = true_lens
        return head_logits(sw, xl_last)[:, 0]

    @torch.no_grad()
    def _decode_step(self, cur_tokens: torch.Tensor,
                     active_mask: torch.Tensor) -> torch.Tensor:
        """One token for every slot; lengths advance for active slots.
        Returns logits (S, V)."""
        sw, arch = self.sw, self.arch
        lengths = self.lengths
        x = sw.embed[cur_tokens][:, None, :]  # (S, 1, H)
        cos, sin = A.rope_cos_sin(arch, lengths[:, None])  # (S, 1, D)
        for li, entry in enumerate(sw.blocks):
            x = _block_apply_decode(sw, entry, x, cos, sin, self.cache, li,
                                    lengths, self.attn_impl)
        xl = A.rmsnorm(x, sw.norm.get("weight"), arch.rms_eps)
        logits = head_logits(sw, xl)[:, 0]
        self.lengths = torch.where(active_mask, lengths + 1, lengths)
        return logits

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
            logits = self._decode_step(self.cur_tokens, active_mask)
            toks = sample(logits, sampling, self.generator)
            row = toks.cpu().tolist()
            lengths_np = self.lengths.cpu().tolist()
            done_slots = []
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                tok = int(row[slot])
                req.out_tokens.append(tok)
                hit_eos = eos_token_id is not None and tok == eos_token_id
                full = lengths_np[slot] >= self.max_len - 1
                if len(req.out_tokens) >= req.max_new_tokens or hit_eos \
                        or full:
                    results[req.req_id] = req.out_tokens
                    done_slots.append(slot)
            self.cur_tokens = torch.where(active_mask, toks.long(),
                                          self.cur_tokens)
            if done_slots:
                idx = torch.tensor(done_slots, device=self.device)
                self.lengths[idx] = 0
                for slot in done_slots:
                    self.slot_req[slot] = None
        return [results[i] for i in range(n_total)]
