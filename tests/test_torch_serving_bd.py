"""Port parity: the kv8 block-diagonal ``bd`` cache (create, the prefill and
decode writers, the read-back) and the ``attn_impl="bd"|"bds"`` engines of
lightcompress_tpu_torch (kernels #18/#19, their plain versions here)
against lightcompress_tpu's ``bd_interpret``/``bds_interpret`` engines on
the same weights (CPU)."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import kv_cache as jkv
from lightcompress_tpu.serving.engine import _append_one_slot
from lightcompress_tpu.serving.engine import _append_slots as j_append_slots
from lightcompress_tpu_torch.serving import LLMEngine, SamplingParams
from lightcompress_tpu_torch.serving import kv_cache as tkv
from test_torch_attention import _assert_cache_equal, _bf16, _t
from test_torch_serving import (MARGIN, N_NEW, PROMPTS, TOKENS,  # noqa: F401
                                _teacher_forced, models, one_torch_thread,
                                weights)

H, D = 2, 128


def _kv(rng, *shape):
    return jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
        jnp.bfloat16)


def test_bd_cache_create_matches_jax():
    jc = jkv.KVCache.create(2, 3, H, 32, D, bits=8, layout="bd")
    tc = tkv.KVCache.create(2, 3, H, 32, D, bits=8, layout="bd",
                            device="cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
    assert (tc.bits, tc.layout) == (8, "bd")
    with pytest.raises(ValueError):
        tkv.KVCache.create(2, 3, H, 32, D, bits=4, layout="bd",
                           device="cpu")


def test_bd_cache_writes_match_jax():
    """The batched prefill write (with a padding row that repeats the last
    prompt into its slot, as the engine pads) and the one-token decode
    append (a slot at the buffer's end clamps, as dynamic_update_slice
    does) put JAX's bytes into the bd slabs."""
    L, S, T = 2, 3, 32
    rng = np.random.RandomState(1)
    jc = jkv.KVCache.create(L, S, H, T, D, bits=8, layout="bd")
    tc = tkv.KVCache.create(L, S, H, T, D, bits=8, layout="bd",
                            device="cpu")
    k, v = (jnp.concatenate([x, x[2:]]) for x in (_kv(rng, 3, H, 7, D),
                                                 _kv(rng, 3, H, 7, D)))
    slots = np.array([2, 0, 1, 1])
    jc = j_append_slots(jc, 1, jnp.asarray(slots), k, v)
    tkv.append_slots(tc, 1, torch.from_numpy(slots), _bf16(k), _bf16(v))
    _assert_cache_equal(jc, tc)
    kn = jnp.asarray(rng.randn(S, H, 1, D).astype(np.float32))
    vn = jnp.asarray(rng.randn(S, H, 1, D).astype(np.float32))
    lengths = np.array([7, 0, T])
    jc = jkv.append_kv_quantized(jc, 0, *jkv.quantize_kv(kn),
                                 *jkv.quantize_kv(vn),
                                 jnp.asarray(lengths, jnp.int32))
    tkv.append_kv_bd(tc, 0, *tkv.quantize_kv(_t(kn)),
                     *tkv.quantize_kv(_t(vn)), torch.from_numpy(lengths))
    _assert_cache_equal(jc, tc)


def test_bd_one_slot_prefill_matches_jax():
    """JAX's one-slot prefill writer (``_append_one_slot``, the bd branch)
    and the port's batched writer on one slot write the same bytes."""
    rng = np.random.RandomState(2)
    jc = jkv.KVCache.create(2, 3, H, 32, D, bits=8, layout="bd")
    tc = tkv.KVCache.create(2, 3, H, 32, D, bits=8, layout="bd",
                            device="cpu")
    k, v = _kv(rng, 1, H, 9, D), _kv(rng, 1, H, 9, D)
    jc = _append_one_slot(jc, 1, 2, k, v)
    tkv.append_slots(tc, 1, torch.tensor([2]), _bf16(k), _bf16(v))
    _assert_cache_equal(jc, tc)


def test_bd_read_kv_slot_matches_hhd():
    """A slot read back from the bd slabs equals the same K/V read back
    from the hhd cache (the same codes and scales, another layout)."""
    rng = np.random.RandomState(3)
    k, v = _bf16(_kv(rng, 2, H, 5, D)), _bf16(_kv(rng, 2, H, 5, D))
    out = []
    for layout in ("bd", "hhd"):
        c = tkv.KVCache.create(1, 2, H, 16, D, bits=8, layout=layout,
                               device="cpu")
        tkv.append_slots(c, 0, torch.tensor([1, 0]), k, v)
        out.append(tkv.read_kv_slot(c, 0, 1))
    for a, b in zip(*out):
        assert a.shape == (1, H, 16, D)
        assert torch.equal(a, b)


# (JAX engine options, port engine options): max_len 64 gives a 512-column
# bd buffer (#18), max_len 600 a 1024-column one (#19 in two 512-column
# blocks, the second past every slot's length)
CASES = {
    "bd": (dict(max_len=64, attn_impl="bd_interpret"),
           dict(max_len=64, attn_impl="bd")),
    "bds": (dict(max_len=600, attn_impl="bds_interpret"),
            dict(max_len=600, attn_impl="bds")),
}


def _engines(jsw, tsw, case, slots=2, **kw):
    jkw, tkw = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the probe-only notice
        jeng = JEngine(jsw, max_slots=slots, kv_bits=8, prefill_buckets=(16,),
                       **jkw, **kw)
        teng = LLMEngine(tsw, max_slots=slots, kv_bits=8,
                         prefill_buckets=(16,), device="cpu", **tkw, **kw)
    return jeng, teng


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_logits_match_jax(weights, case):
    """act_bits=16, teacher-forced: per-step corr >= 0.999 over prefill and
    decode, each decode step from JAX's cache codes (the linears sum in
    another order than XLA's, and the int8 KV quant turns a last-bit
    difference into a code step now and then)."""
    jeng, teng = _engines(*weights[16], case)
    assert (teng.attn_impl, teng.cache.layout) == (case, "bd")
    assert teng.buf_len == jeng.buf_len == teng.cache.k.shape[-1]
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6, sync=True):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_generate_matches_jax(weights, case):
    """More prompts than slots (retire and re-admit): identical greedy
    tokens on a fixture whose top-2 margins exceed MARGIN while the two
    free-running engines' logits differ by less than half of it."""
    jeng, teng = _engines(*weights[16], case)
    jout = jeng.generate(PROMPTS, JSampling(max_new_tokens=N_NEW))
    tout = teng.generate(PROMPTS, SamplingParams(max_new_tokens=N_NEW))
    for p, cont in zip(PROMPTS, jout):
        for jl, tl in _teacher_forced(jeng, teng, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] > MARGIN
            assert np.abs(jl - tl).max() < MARGIN / 2
    assert tout == jout


@pytest.mark.parametrize("impl", ["bd", "bds"])
def test_bd_engine_buffer_and_warning(weights, impl):
    """The bd buffer rounds max_len up to 512, as JAX's does; bd/bds carry
    JAX's probe-only notice; at kv4 the name takes JAX's generic path on
    the kv4 hhd cache, as JAX's engine builds it."""
    jsw, tsw = weights[16]
    kw = dict(max_slots=1, prefill_buckets=(16,))
    with pytest.warns(UserWarning, match="probe-only"):
        e = LLMEngine(tsw, max_len=700, attn_impl=impl, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = JEngine(jsw, max_len=700, attn_impl=impl + "_interpret", **kw)
    assert (e.buf_len, e.cache.k.shape, e.cache.v.shape) == (
        1024, (2, 1, 2 * 128, 1024), (2, 1, 1024, 2 * 128))
    assert e.buf_len == j.buf_len
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e = LLMEngine(tsw, max_len=64, kv_bits=4, attn_impl=impl,
                      device="cpu", **kw)
        j = JEngine(jsw, max_len=64, kv_bits=4,
                    attn_impl=impl + "_interpret", **kw)
    assert (e.body, e.cache.bits, e.cache.layout, e.buf_len) == (
        "generic", j.cache.bits, j.cache.layout, j.buf_len)
    assert tuple(e.cache.k.shape) == tuple(j.cache.k.shape)
