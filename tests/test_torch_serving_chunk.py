"""Port parity: the chunked decode of lightcompress_tpu_torch
(``LLMEngine(decode_chunk=n)``: n steps with on-device sampling, the kv8
ring ``xla8r`` and ``flush_ring_to_cache``) against its own per-step engine
and against lightcompress_tpu's chunked engines on the same weights
(CPU)."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import kv_cache as jkv
from lightcompress_tpu_torch.serving import LLMEngine, SamplingParams
from lightcompress_tpu_torch.serving import kv_cache as tkv
from test_torch_attention import _assert_cache_equal, _t
from test_torch_serving import (N_NEW, PROMPTS, models,  # noqa: F401
                                one_torch_thread, weights)
from test_torch_serving_moe import _weights as moe_weights
from test_torch_serving_moe_engine import (GROUPED_ENV, GROUPED_OPTS,
                                           PROMPTS as MOE_PROMPTS)

KW = dict(max_slots=2, max_len=64, kv_bits=8, prefill_buckets=(16,))
# 5 prompts on 2 slots: slots retire and take new prompts across chunks
MANY = [[3, 17, 9, 2, 100], [5, 1, 7], [9, 9, 4, 4], [8, 2], [60, 61, 62]]


def _port(tsw, **kw):
    return LLMEngine(tsw, device="cpu", **{**KW, **kw})


def _jax(jsw, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the probe-only notice of bd
        return JEngine(jsw, **{**KW, **kw})


def _agree(a, b):
    """Equal tokens at equal positions over two engines' outputs, and the
    total of the second's."""
    return (sum(x == y for oa, ob in zip(a, b) for x, y in zip(oa, ob)),
            sum(len(o) for o in b))


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_xla8a_equals_per_step(weights, chunk):
    """On ``xla8a`` (no ring) the chunked engine runs the per-step decode
    n times with the same sampling: the same greedy tokens as the
    per-step engine, token for token (JAX's own invariant), with more
    prompts than slots.  Chunk 16 > every request's remaining tokens:
    the chunks shrink to powers of two."""
    _, tsw = weights[16]
    sp = SamplingParams(max_new_tokens=9)
    ref = _port(tsw).generate(MANY, sp)
    eng = _port(tsw, decode_chunk=chunk, attn_impl="xla8a")
    assert (eng.attn_impl, eng.ring, eng.buf_len) == ("xla8a", False, 64)
    assert eng.generate(MANY, sp) == ref


def test_chunked_sampling_equals_per_step(weights):
    """With temperature and top-k, the chunk draws from the engine's
    generator in the per-step order: the same sampled tokens."""
    _, tsw = weights[16]
    sp = SamplingParams(temperature=0.8, top_k=20, max_new_tokens=7)
    ref = _port(tsw, seed=3).generate(PROMPTS, sp)
    got = _port(tsw, seed=3, decode_chunk=4, attn_impl="xla8a").generate(
        PROMPTS, sp)
    assert got == ref


# (port options, JAX options, greedy tokens that may differ): the ring's
# slack is what JAX's own ring test allows against its per-step engine
# (tests/test_serving.py: total - 2 on 2 prompts of 9 tokens)
CHUNKED = {
    "xla8a": (dict(attn_impl="xla8a"), dict(attn_impl="xla8a"), 0),
    "xla8r": (dict(), dict(), 2),
    "bd": (dict(attn_impl="bd"), dict(attn_impl="bd_interpret"), 0),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_engines_match_jax(weights, case):
    """The port's chunked engine against JAX's at chunk 4 on the greedy
    fixture of the per-step tests (top-2 margins above MARGIN)."""
    jsw, tsw = weights[16]
    tkw, jkw, slack = CHUNKED[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng = _port(tsw, decode_chunk=4, **tkw)
    jeng = _jax(jsw, decode_chunk=4, **jkw)
    assert teng.buf_len == jeng.buf_len
    assert teng.ring == (case == "xla8r")
    sp = dict(max_new_tokens=N_NEW + 4)
    tout = teng.generate(PROMPTS, SamplingParams(**sp))
    jout = jeng.generate(PROMPTS, JSampling(**sp))
    assert [len(o) for o in tout] == [len(o) for o in jout]
    agree, total = _agree(tout, jout)
    assert agree >= total - slack, (tout, jout)


def test_ring_retire_and_readmit(weights):
    """5 prompts on 2 slots through the ring: slots retire mid-chunk and
    take new prompts at the next chunk; the ring's columns of inactive
    slots land past their lengths.  Against the port's per-step engine:
    the same token counts, and at most the slack of JAX's own ring test
    with retirement against its per-step engine (tests/test_serving.py:
    total - 3).  (On these unvetted prompts the two packages' per-step
    engines themselves part at a near-tie; the ring against JAX's ring
    is held on the vetted fixture above and step by step below.)"""
    _, tsw = weights[16]
    kw = dict(max_len=96)
    sp = SamplingParams(max_new_tokens=10)
    ref = _port(tsw, **kw).generate(MANY, sp)
    eng = _port(tsw, decode_chunk=4, **kw)
    assert (eng.attn_impl, eng.ring) == ("xla", True)
    got = eng.generate(MANY, sp)
    assert [len(o) for o in got] == [10] * len(MANY)
    agree, total = _agree(got, ref)
    assert agree >= total - 3, (got, ref)


def _ring_teacher_forced(jeng, teng, tokens, n_prompt, n_steps, W,
                         sync=False, jit=True):
    """One fixed token stream through prefill and ring chunks of W steps
    in both engines (slot 0 of 2, the ring flushed after each chunk); per
    step the two logits vectors.  The rings' entries are as wide as the
    caches' (head_dim/2 packed bytes on a kv4 cache).  With ``sync`` the
    port is handed JAX's cache and ring before every step; without
    ``jit`` JAX's ring step runs op by op."""
    from test_torch_serving import _sync_cache

    T = jeng.prefill_buckets[0]
    ids = np.zeros((1, T), np.int32)
    ids[0, :n_prompt] = tokens[:n_prompt]
    jeng.reset()
    cache, lengths, jl = jeng._prefill_jit(
        jeng.sw, jeng.cache, jeng.lengths, jnp.asarray(ids), jnp.asarray(0),
        jnp.asarray(n_prompt), T=T)
    teng.reset()
    tl = teng._prefill_batch(torch.from_numpy(ids).long(), torch.tensor([0]),
                             torch.tensor([n_prompt]), T)
    pairs = [(np.asarray(jl), tl[0].numpy())]
    a = jeng.arch
    shape = (a.num_layers, 2, 2 * a.num_kv_heads, W)
    active = [True, False]
    step = jax.jit(jeng._decode_step_ring) if jit else \
        jeng._decode_step_ring
    for c0 in range(0, n_steps, W):
        ring = {"rkv": jnp.zeros(shape + (teng.cache.k.shape[-1],),
                                 jnp.int8),
                "rs": jnp.zeros(shape, jnp.bfloat16)}
        rs = teng.ring_step(W)
        lengths0 = lengths
        for w in range(W):
            if sync:
                _sync_cache(cache, teng.cache)
                rs.ring.kv.copy_(_t(ring["rkv"]))
                rs.ring.s.copy_(_t(ring["rs"]))
            tok = tokens[n_prompt + c0 + w]
            ring, lengths, jlog = step(
                jeng.sw, cache, ring, lengths0, lengths,
                jnp.asarray([tok, 0], jnp.int32), jnp.asarray(active), w)
            rs.pos = w
            tlog = teng._decode_step(torch.tensor([tok, 0]),
                                     torch.tensor(active), rs)
            pairs.append((np.asarray(jlog[0]), tlog[0].numpy()))
        cache = jkv.flush_ring_to_cache(cache, ring, lengths0)
        tkv.flush_ring_to_cache(teng.cache, rs.ring, rs.lengths0)
    return pairs


def test_ring_step_logits_match_jax(weights):
    """Teacher-forced through the ring step (two chunks of 4, flushed
    between): per-step corr >= 0.999 against JAX's deferred fused ring,
    as the per-step engines' test."""
    jsw, tsw = weights[16]
    teng, jeng = _port(tsw, decode_chunk=4), _jax(jsw, decode_chunk=4)
    tokens = [1, 5, 9, 44, 100, 7, 3, 120, 11, 64, 200, 17]
    for jl, tl in _ring_teacher_forced(jeng, teng, tokens, 4, 8, 4):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


def test_flush_ring_to_cache_matches_jax():
    """The ring's (L, S, 2H, W, D) codes and (L, S, 2H, W) scales land in
    the hhd cache at each slot's chunk-entry length, bit for bit as
    JAX's fused-ring flush; a start past T - W clamps."""
    L, S, H, T, W, D = 2, 3, 2, 20, 4, 128
    rng = np.random.RandomState(7)
    jc = jkv.KVCache.create(L, S, H, T, D, bits=8)
    tc = tkv.KVCache.create(L, S, H, T, D, bits=8, device="cpu")
    rkv = jnp.asarray(rng.randint(-127, 128, (L, S, 2 * H, W, D)), jnp.int8)
    rs = jnp.asarray(rng.rand(L, S, 2 * H, W), jnp.bfloat16)
    lengths0 = np.array([5, 0, T - 2])
    jc = jkv.flush_ring_to_cache(jc, {"rkv": rkv, "rs": rs},
                                 jnp.asarray(lengths0, jnp.int32))
    ring = tkv.Ring(_t(rkv), _t(rs).to(torch.bfloat16))
    tkv.flush_ring_to_cache(tc, ring, torch.from_numpy(lengths0))
    _assert_cache_equal(jc, tc)


def test_chunked_max_len_cap(weights):
    """A slot that reaches max_len - 1 at a chunk's end keeps every token
    of the chunk (JAX's own test at max_len 24, chunk 6): xla8a chunked
    equals per-step; the ring gives the same count (the flush headroom
    keeps the chunk-end slab clear of earlier tokens) and at most JAX's
    slack of that test (9)."""
    _, tsw = weights[16]
    kw = dict(max_slots=1, max_len=24)
    p = [[3, 17, 9, 2, 100]]
    sp = SamplingParams(max_new_tokens=50)
    ref = _port(tsw, **kw).generate(p, sp)
    assert len(ref[0]) == 24 - 1 - len(p[0]) + 1
    assert _port(tsw, decode_chunk=6, attn_impl="xla8a", **kw).generate(
        p, sp) == ref
    ring = _port(tsw, decode_chunk=6, **kw)
    assert ring.buf_len == 24 + 6
    got = ring.generate(p, sp)
    assert len(got[0]) == len(ref[0])
    agree, total = _agree(got, ref)
    assert agree >= total - 9, (got, ref)


def test_moe_engine_on_the_ring_matches_jax(monkeypatch):
    """A small Mixtral-shaped MoE engine, chunked: MoE forces ``xla``, so
    it decodes on the ring (every expert linear on the forced grouped
    route), against JAX's chunked MoE engine: the same token counts, at
    most JAX's ring slack (2) in the greedy tokens."""
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)
    jsw, tsw, _ = moe_weights("planes", 16)
    teng = _port(tsw, decode_chunk=4, **GROUPED_OPTS)
    jeng = _jax(jsw, decode_chunk=4)
    assert (teng.attn_impl, teng.ring, teng.buf_len) == ("xla", True, 68)
    assert teng.buf_len == jeng.buf_len
    tout = teng.generate(MOE_PROMPTS, SamplingParams(max_new_tokens=6))
    jout = jeng.generate(MOE_PROMPTS, JSampling(max_new_tokens=6))
    assert [len(o) for o in tout] == [6] * len(MOE_PROMPTS)
    agree, total = _agree(tout, jout)
    assert agree >= total - 2, (tout, jout)


@pytest.mark.parametrize("kw,buf_len", [
    (dict(decode_chunk=8), 72),
    (dict(decode_chunk=8, attn_impl="xla8r"), 72),
    (dict(decode_chunk=8, attn_impl="xla8a"), 64),
    (dict(decode_chunk=8, attn_impl="pallas"), 64),
    (dict(decode_chunk=8, attn_impl="bd"), 512),
    (dict(decode_chunk=1, attn_impl="xla8r"), 64),
])
def test_chunk_buffer_matches_jax(weights, kw, buf_len):
    """A ring engine's buffer is max_len + decode_chunk of flush headroom;
    the per-step routes inside a chunk keep theirs; ``xla8r`` without a
    chunk falls back to ``xla``, as in JAX."""
    jsw, tsw = weights[16]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng = _port(tsw, **kw)
    jkw = dict(kw)
    if jkw.get("attn_impl") in ("pallas", "bd"):
        jkw["attn_impl"] += "_interpret"
    jeng = _jax(jsw, **jkw)
    assert teng.buf_len == jeng.buf_len == buf_len
    assert teng.attn_impl == jeng.attn_impl.replace("_interpret", "")


def test_chunked_kv4_raises(weights):
    """What a chunked kv4 engine takes, as JAX's ``_decode_chunk``: the kv4
    ring ``xla4r`` (``auto`` or named, a chunk of flush headroom); a
    chunked kv4 ``xla`` engine loops the per-step generic decode (JAX's
    headroom too); ``bd4`` stays per step; the ``xla8`` concat variant
    serves, per step inside a chunk.  Only ``kv_bits=8`` with ``bd4``
    still raises (a fault of the JAX engine)."""
    _, tsw = weights[16]
    for kw, impl, ring, buf in (
            (dict(kv_bits=4), "xla4r", True, 68),
            (dict(kv_bits="auto", max_len=4096), "xla4r", True, 4100),
            (dict(kv_bits=4, attn_impl="xla4r"), "xla4r", True, 68),
            (dict(kv_bits=4, attn_impl="xla"), "xla", False, 68),
            (dict(kv_bits=4, attn_impl="bd4"), "bd4", False, 512),
            (dict(attn_impl="xla8"), "xla8", False, 64)):
        eng = _port(tsw, decode_chunk=4, **kw)
        assert (eng.attn_impl, eng.ring, eng.buf_len) == (impl, ring, buf)
    with pytest.raises(NotImplementedError, match="reference faults"):
        _port(tsw, decode_chunk=4, attn_impl="bd4")
