"""Port parity: the dense slot-cache routes of lightcompress_tpu_torch's
engine that JAX serves under XLA: the kv4 ``hhd`` cache (nibble-packed
half planes) on the generic per-step path (``read_kv``, ``_block_apply``,
``append_kv``) and on the ``xla4r`` ring, the kv16 engine, and the
``xla8`` concat variant, against lightcompress_tpu's on the same weights
and inputs (CPU): the cache writers and readers bit for bit, one decode
block per route, teacher-forced logits, greedy tokens and the route
table."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import engine as j_engine
from lightcompress_tpu.serving import kv_cache as jkv
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.device import bf16_ulp
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.serving import LLMEngine, SamplingParams
from lightcompress_tpu_torch.serving import engine as t_engine
from lightcompress_tpu_torch.serving import kv_cache as tkv
from lightcompress_tpu_torch.serving import quantized_model as t_qm
from test_torch_attention import _t
from test_torch_serving import (TOKENS, _teacher_forced,  # noqa: F401
                                models, one_torch_thread, weights)
from test_torch_serving_chunk import _ring_teacher_forced
from test_torch_serving_moe import _weights as moe_weights
from test_torch_serving_moe_engine import GROUPED_ENV, GROUPED_OPTS

KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,))
L, S, H, T, D = 2, 3, 2, 20, 128


def _cache_pair(bits, seed=0):
    """The same kv cache in both packages, filled through their prefill
    writers with random bf16 K/V: 5 tokens into slots 2 and 0."""
    jc = jkv.KVCache.create(L, S, H, T, D, bits=bits)
    tc = tkv.KVCache.create(L, S, H, T, D, bits=bits, device="cpu")
    rng = np.random.RandomState(seed)
    for li in range(L):
        k, v = (jnp.asarray(rng.randn(2, H, 5, D), jnp.bfloat16)
                for _ in range(2))
        jc = j_engine._append_slots(jc, li, jnp.asarray([2, 0]), k, v)
        tkv.append_slots(tc, li, torch.tensor([2, 0]), _t(k).bfloat16(),
                         _t(v).bfloat16())
    return jc, tc


def _assert_same_cache(jc, tc):
    assert (jc.bits, jc.layout) == (tc.bits, tc.layout)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jc, name), getattr(tc, name)
        if a is None:
            assert b is None
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        np.testing.assert_array_equal(_t(a).numpy(), b.float().numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_cache_writers_and_readers_match_jax(bits):
    """``KVCache.create``, the prefill writer (``append_slots``), the
    decode writer (``append_kv``: one token, a length past the buffer
    clamping to its last column, then 3 tokens whose start clamps to
    T - 3), ``read_kv`` and ``read_kv_slot`` (the kv4 repair: packed
    bytes unpacked before the scales) bit for bit against JAX's."""
    jc, tc = _cache_pair(bits)
    _assert_same_cache(jc, tc)
    rng = np.random.RandomState(1)
    # jitted: eager, JAX compiles each of the writer's per-slot updates
    j_append = jax.jit(jkv.append_kv, static_argnums=1)
    j_read_slot = jax.jit(jkv.read_kv_slot, static_argnums=1)
    for n, lengths in ((1, [5, T + 3, 0]), (3, [5, T - 1, 7])):
        k, v = (jnp.asarray(rng.randn(S, H, n, D), jnp.bfloat16)
                for _ in range(2))
        jl = jnp.asarray(lengths, jnp.int32)
        jc = j_append(jc, 1, k, v, jl)
        tkv.append_kv(tc, 1, _t(k).bfloat16(), _t(v).bfloat16(),
                      torch.tensor(lengths))
        _assert_same_cache(jc, tc)
    for li in range(L):
        for a, b in zip(jkv.read_kv(jc, li), tkv.read_kv(tc, li)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(_t(a).numpy(), b.float().numpy())
        for slot in range(S):
            for a, b in zip(j_read_slot(jc, li, slot),
                            tkv.read_kv_slot(tc, li, slot)):
                assert b.shape == (1, H, T, D)
                np.testing.assert_array_equal(_t(a).numpy(),
                                              b.float().numpy())


def test_flush_packed_ring_matches_jax():
    """A kv4 ring's packed (L, S, 2H, W, D/2) bytes and scales land in the
    kv4 hhd cache at the chunk-entry lengths bit for bit as JAX's flush;
    a start past T - W clamps."""
    W = 4
    jc, tc = _cache_pair(4)
    rng = np.random.RandomState(7)
    rkv = jnp.asarray(rng.randint(-128, 128, (L, S, 2 * H, W, D // 2)),
                      jnp.int8)
    rs = jnp.asarray(rng.rand(L, S, 2 * H, W), jnp.bfloat16)
    lengths0 = np.array([5, 0, T - 2])
    jc = jkv.flush_ring_to_cache(jc, {"rkv": rkv, "rs": rs},
                                 jnp.asarray(lengths0, jnp.int32))
    tkv.flush_ring_to_cache(tc, tkv.Ring(_t(rkv), _t(rs).bfloat16()),
                            torch.from_numpy(lengths0))
    _assert_same_cache(jc, tc)


def _block_inputs(jsw, tsw, lengths):
    """Layer inputs of a decode step of 3 slots at ``lengths``: the
    embeddings of three tokens and their rope tables, in both packages."""
    tok = [TOKENS[4], TOKENS[5], TOKENS[6]]
    x = jsw.embed[jnp.asarray(tok)][:, None, :]
    cos, sin = JA.rope_cos_sin(jsw.arch, jnp.asarray(lengths)[:, None])
    tl = torch.tensor(lengths)
    tcos, tsin = TA.rope_cos_sin(tsw.arch, tl[:, None])
    return x, cos, sin, tl, tcos, tsin


@pytest.fixture
def shared_linears(weights, monkeypatch):
    """act_bits 16 weights whose W4 linears are the same function in both
    packages: JAX's engine module calls the port's ``apply_qlinear`` on the
    matching port linear.  (The plain #1 and XLA's dequant-then-matmul sum
    in other orders; an ulp of K then rounds into a whole int4 or int8
    code step.)  So a block's check isolates its attention route.  Jitted
    JAX code keeps JAX's linears."""
    jsw, tsw = weights[16]
    table = {id(je[n]): te[n] for je, te in zip(jsw.blocks, tsw.blocks)
             for n in je if hasattr(je[n], "codes")}
    jax_lin = j_engine.apply_qlinear

    def lin(p, x, act_bits=16):
        if isinstance(x, jax.core.Tracer):  # a jitted engine: JAX's own
            return jax_lin(p, x, act_bits=act_bits)
        y = t_qm.apply_qlinear(table[id(p)], _t(x).to(torch.bfloat16),
                               act_bits=act_bits)
        return jnp.asarray(y.float().numpy(), jnp.bfloat16)

    monkeypatch.setattr(j_engine, "apply_qlinear", lin)
    return jsw, tsw


def _near(a, b):
    """Within one bf16 ulp at max |y| (the port's bf16 gate): the same ops
    on the same bf16 inputs, cache and linears, f32 sums in another
    order."""
    a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
    assert np.abs(a - b).max() <= bf16_ulp(np.abs(b).max())


@pytest.mark.parametrize("bits", [4, 16])
def test_generic_block_matches_jax(shared_linears, bits):
    """The generic decode block: JAX's ``_block_apply`` over ``read_kv``
    of a cache and the port's over its own copy, under the engine's
    ``j < length | j == T`` mask; then ``append_kv`` of each block's fresh
    K/V writes the same bytes."""
    jsw, tsw = shared_linears
    jc, tc = _cache_pair(bits)
    lengths = [0, 3, 5]
    x, cos, sin, tl, tcos, tsin = _block_inputs(jsw, tsw, lengths)
    j = jnp.arange(T + 1)[None, None, None, :]
    vis = (j < jnp.asarray(lengths)[:, None, None, None]) | (j == T)
    mask = jnp.where(vis, 0.0, jnp.finfo(jnp.float32).min)
    tmask = convert.tensor_from_numpy(mask, "cpu")
    for li in range(L):
        y, k, v = j_engine._block_apply(jsw, jsw.blocks[li], x, cos, sin,
                                        *jkv.read_kv(jc, li), mask)
        ty, tk, tv = t_engine._block_apply(
            tsw, tsw.blocks[li], convert.tensor_from_numpy(x, "cpu"), tcos,
            tsin, tmask, t_engine.MoEOptions(), *tkv.read_kv(tc, li))
        _near(ty, y)
        jc = jkv.append_kv(jc, li, k, v, jnp.asarray(lengths))
        tkv.append_kv(tc, li, tk, tv, tl)
        _assert_same_cache(jc, tc)
        x = y


def test_ring4_block_matches_jax(shared_linears):
    """The ``xla4r`` block (JAX's deferred fused kv4 ring) on the same
    kv4 cache and packed ring: the output within one bf16 ulp at max |y|
    and the fresh tokens' packed int4 codes and scales bit for bit."""
    jsw, tsw = shared_linears
    jc, tc = _cache_pair(4)
    lengths = [0, 7, 5]
    x, cos, sin, tl, tcos, tsin = _block_inputs(jsw, tsw, lengths)
    rng = np.random.RandomState(3)
    W, pos = 4, 2
    rkv = jnp.asarray(rng.randint(-128, 128, (L, S, 2 * H, W, D // 2)),
                      jnp.int8)
    rs = jnp.asarray(rng.rand(L, S, 2 * H, W) * 0.05, jnp.bfloat16)
    lengths0 = jnp.asarray([0, 5, 3], jnp.int32)
    step = t_engine.RingStep(tkv.Ring(_t(rkv), _t(rs).bfloat16()),
                             torch.tensor([0, 5, 3]), pos)
    for li in range(L):
        y, fresh = j_engine._block_apply_decode_i8(
            jsw, jsw.blocks[li], x, cos, sin, jc, li,
            jnp.asarray(lengths), impl="xla4r",
            ring={"rkv": rkv, "rs": rs}, lengths0=lengths0, ring_pos=(pos,))
        ty = t_engine._block_apply_decode(
            tsw, tsw.blocks[li], convert.tensor_from_numpy(x, "cpu"), tcos,
            tsin, tc, li, tl, "generic", ring=step)
        _near(ty, y)
        for a, b in zip(step.fresh[-1], fresh):
            np.testing.assert_array_equal(a.float().numpy(), _t(b).numpy())
        x = y


def test_xla8_block_matches_jax(shared_linears):
    """The ``xla8`` concat block on the same int8 cache: the output within
    one bf16 ulp at max |y|, and the cache after the port's append of its
    fresh token bit for bit JAX's after ``append_kv_quantized``."""
    jsw, tsw = shared_linears
    jc, tc = _cache_pair(8)
    lengths = [0, 3, 5]
    x, cos, sin, tl, tcos, tsin = _block_inputs(jsw, tsw, lengths)
    for li in range(L):
        y, kq, ks, vq, vs = j_engine._block_apply_decode_i8(
            jsw, jsw.blocks[li], x, cos, sin, jc, li, jnp.asarray(lengths),
            impl="xla8")
        ty = t_engine._block_apply_decode(
            tsw, tsw.blocks[li], convert.tensor_from_numpy(x, "cpu"), tcos,
            tsin, tc, li, tl, "xla8")
        _near(ty, y)
        jc = jkv.append_kv_quantized(jc, li, kq, ks, vq, vs,
                                     jnp.asarray(lengths))
        _assert_same_cache(jc, tc)
        x = y


# (JAX engine options, port engine options) of the per-step engines
ENGINES = {
    "kv4_xla": (dict(kv_bits=4, attn_impl="xla"),
                dict(kv_bits=4, attn_impl="xla")),
    "kv16": (dict(kv_bits=16), dict(kv_bits=16)),
    "xla8": (dict(kv_bits=8, attn_impl="xla8"),
             dict(kv_bits=8, attn_impl="xla8")),
}


@pytest.fixture(scope="module")
def engines(weights):
    """Module-scope JAX and port engines (their jits compile once)."""
    jsw, tsw = weights[16]
    return {case: (JEngine(jsw, **KW, **jkw),
                   LLMEngine(tsw, device="cpu", **KW, **tkw))
            for case, (jkw, tkw) in ENGINES.items()}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_engine_logits_match_jax(engines, case):
    """act_bits 16, per-step corr >= 0.999 over prefill and decode, each
    decode step from the same cache codes (as test_torch_serving_kv4.py:
    the linears sum in another order than XLA's, and a kv4 code rounds an
    ulp into a whole step of amax/7)."""
    jeng, teng = engines[case]
    assert (teng.attn_impl, teng.buf_len) == (jeng.attn_impl, jeng.buf_len)
    assert teng.body == ("xla8" if case == "xla8" else "generic")
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6, sync=True):
        assert np.corrcoef(jl.ravel(), tl)[0, 1] >= 0.999


# prompts drawn from np.random.RandomState(0): the kv4 fixture of
# test_torch_serving_kv4.py (its top-2 margins wide: two free-running kv4
# caches part by whole int4 steps)
FIXTURES = ([[106, 164, 94], [59, 17, 196], [136, 207, 207]], 4, 0.25)


def test_greedy_generate_matches_jax(engines):
    """The kv4 ``xla`` engine (the MoE engines' route from ``max_len``
    4096), more prompts than slots (retire and re-admit): identical greedy
    tokens on a fixture whose top-2 margins exceed its margin while the
    free-running engines' logits differ by less than half of it."""
    jeng, teng = engines["kv4_xla"]
    prompts, n_new, margin = FIXTURES
    jeng.reset()
    teng.reset()
    jout = jeng.generate(prompts, JSampling(max_new_tokens=n_new))
    tout = teng.generate(prompts, SamplingParams(max_new_tokens=n_new))
    for p, cont in zip(prompts, jout):
        for jl, tl in _teacher_forced(jeng, teng, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl.ravel())[-2:]
            assert top2[1] - top2[0] > margin
            assert np.abs(jl.ravel() - tl).max() < margin / 2
    assert tout == jout


@pytest.fixture(scope="module")
def ring_engines(weights):
    jsw, tsw = weights[16]
    kw = dict(KW, kv_bits=4, decode_chunk=4)
    return (JEngine(jsw, attn_impl="xla4r", **kw),
            LLMEngine(tsw, device="cpu", **kw))


def test_ring4_step_logits_match_jax(ring_engines, shared_linears):
    """Teacher-forced through the ``xla4r`` ring step (two chunks of 2,
    flushed between), the port handed JAX's cache and ring before each
    step: per-step corr >= 0.999 against JAX's deferred fused kv4 ring,
    run op by op on the shared linears.  (The fresh token attends as its
    int4 codes, so with each package's own linears an ulp of K that
    rounds to the next code moves a step's corr to 0.998.)"""
    jeng, teng = ring_engines
    assert (teng.attn_impl, teng.ring, teng.buf_len) == ("xla4r", True, 68)
    assert teng.buf_len == jeng.buf_len
    for jl, tl in _ring_teacher_forced(jeng, teng, TOKENS, 4, 4, 2,
                                       sync=True, jit=False):
        assert np.corrcoef(jl.ravel(), tl)[0, 1] >= 0.999


def test_ring4_greedy_generate_matches_jax(ring_engines):
    """The chunked kv4 engines (chunks of 4 on the ring, more prompts than
    slots) give JAX's greedy tokens on the kv4 fixture."""
    jeng, teng = ring_engines
    prompts, n_new, _ = FIXTURES
    jeng.reset()
    teng.reset()
    jout = jeng.generate(prompts, JSampling(max_new_tokens=n_new))
    assert teng.generate(prompts, SamplingParams(max_new_tokens=n_new)) \
        == jout


def test_moe_kv4_engine_logits_match_jax(monkeypatch):
    """A small Mixtral-shaped MoE engine at ``kv_bits="auto"`` and
    ``max_len`` 4096 (both packages' experts on the forced grouped route):
    the kv4 hhd cache on the generic path, teacher-forced per-step corr >=
    0.999 from the same cache codes."""
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)
    jsw, tsw, _ = moe_weights("planes", 16)
    kw = dict(max_slots=2, max_len=4096, kv_bits="auto",
              prefill_buckets=(16,))
    jeng = JEngine(jsw, **kw)
    teng = LLMEngine(tsw, device="cpu", **kw, **GROUPED_OPTS)
    assert (teng.attn_impl, teng.kv_bits, teng.cache.layout, teng.body) \
        == ("xla", 4, "hhd", "generic")
    assert (teng.buf_len, teng.cache.k.shape) == (
        jeng.buf_len, tuple(jeng.cache.k.shape))
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 4, sync=True):
        assert np.corrcoef(jl.ravel(), tl)[0, 1] >= 0.999


# the route table: (port options, JAX options where they differ, the
# port's ring); the JAX engine gets an explicit attn_impl (its "auto"
# picks "xla" on the CPU, the port's as on a TPU)
TABLE = [
    (dict(kv_bits=4, attn_impl="xla"), {}, False),
    (dict(kv_bits="auto", max_len=4096, attn_impl="xla"), {}, False),
    (dict(kv_bits=4, attn_impl="xla4r", decode_chunk=4), {}, True),
    (dict(kv_bits=4, decode_chunk=4), dict(attn_impl="xla4r"), True),
    (dict(kv_bits=4, attn_impl="xla4r"), {}, False),
    (dict(kv_bits=4, attn_impl="xla", decode_chunk=4), {}, False),
    (dict(kv_bits=4, attn_impl="pallas"),
     dict(attn_impl="pallas_interpret"), False),
    (dict(kv_bits=4, attn_impl="bd"), dict(attn_impl="bd_interpret"), False),
    (dict(kv_bits=4, attn_impl="xla8"), {}, False),
    (dict(kv_bits=4, attn_impl="bd4", decode_chunk=4),
     dict(attn_impl="bd4_interpret"), False),
    (dict(kv_bits=16), {}, False),
    (dict(kv_bits=16, decode_chunk=4), {}, False),
    (dict(kv_bits=16, attn_impl="xla8r", decode_chunk=4), {}, False),
    (dict(kv_bits=16, attn_impl="bd4"), dict(attn_impl="bd4_interpret"),
     False),
    (dict(kv_bits=8, attn_impl="xla8"), {}, False),
    (dict(kv_bits=8, attn_impl="xla8", decode_chunk=4), {}, False),
    (dict(kv_bits=8, attn_impl="xla4r", decode_chunk=4), {}, True),
]


@pytest.mark.parametrize("i", range(len(TABLE)))
def test_route_table_matches_jax(weights, i):
    """The port's engine built from the same arguments as JAX's gives its
    attn_impl, cache bits, layout and shape and buf_len; kv4 ``hhd``
    engines take the generic path unless on the ``xla4r`` ring, and the
    probe-only names keep their notice."""
    jsw, tsw = weights[16]
    tkw, jdiff, ring = TABLE[i]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        teng = LLMEngine(tsw, device="cpu", **{**KW, **tkw})
    assert (tkw.get("attn_impl") in ("pallas", "bd")) == any(
        "probe-only" in str(w.message) for w in seen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(jsw, **{**KW, **tkw, **jdiff})
    assert teng.attn_impl == jeng.attn_impl.replace("_interpret", "")
    assert (teng.kv_bits, teng.cache.bits, teng.cache.layout) == (
        jeng.kv_bits, jeng.cache.bits, jeng.cache.layout)
    assert tuple(teng.cache.k.shape) == tuple(jeng.cache.k.shape)
    assert teng.buf_len == jeng.buf_len
    assert teng.ring == ring
    if teng.cache.bits == 4 and teng.cache.layout == "hhd" and not ring:
        assert teng.body == "generic"


@pytest.mark.parametrize("kw", [dict(kv_bits="auto", max_len=4096),
                                dict(kv_bits=4, decode_chunk=4),
                                dict(kv_bits=16)])
def test_moe_route_table_matches_jax(monkeypatch, kw):
    """A MoE engine takes ``xla`` whatever it is asked, as JAX forces it:
    kv4 on the hhd cache (a chunk of flush headroom when chunked, no
    ring) and kv16, as JAX's engine builds them."""
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)
    jsw, tsw, _ = moe_weights("planes", 16)
    kw = {**KW, **kw, "attn_impl": "bd4"}
    teng = LLMEngine(tsw, device="cpu", **kw)
    jeng = JEngine(jsw, **kw)
    assert (teng.attn_impl, teng.kv_bits, teng.cache.layout, teng.buf_len) \
        == (jeng.attn_impl, jeng.kv_bits, jeng.cache.layout, jeng.buf_len)
    assert not teng.ring and teng.body == "generic"


def test_kv8_bd4_is_a_reference_fault(weights):
    """``kv_bits=8`` with ``attn_impl="bd4"``: JAX builds an int8 hhd cache
    and hands it to the bd4 kernel, whose block shapes fail at the first
    decode step; the port refuses the engine, naming the fault."""
    jsw, tsw = weights[16]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JEngine(jsw, kv_bits=8, attn_impl="bd4_interpret", **KW)
    assert (jeng.cache.bits, jeng.cache.layout) == (8, "hhd")
    with pytest.raises(ValueError, match="Block shape"):
        jeng.generate([[1, 5, 9]], JSampling(max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="reference faults"):
        LLMEngine(tsw, device="cpu", kv_bits=8, attn_impl="bd4", **KW)
