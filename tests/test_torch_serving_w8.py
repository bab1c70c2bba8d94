"""W8A8 and FP8 serving weights against the JAX package (CPU): the builds'
codes and scales bit for bit, the engines' teacher-forced logits (corr >=
0.999, the same argmax), the int4 ``rows`` storage of stacked experts, and
the three serving builds JAX fails on (reference faults 1-3, ROADMAP C):
each test shows JAX's failure and the port's named refusal."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import init_params as j_init
from lightcompress_tpu.ops.qlinear import quantize_linear as j_qlin
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving import quantized_model as jqm
from lightcompress_tpu.serving.quantized_model import \
    apply_qlinear as j_apply
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.ops.qlinear import (dequant_weight,
                                                 quantize_linear)
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import build_serving_weights
from lightcompress_tpu_torch.serving import quantized_model as tqm
from test_torch_serving import _engines, _teacher_forced, \
    one_torch_thread  # noqa: F401

DIMS = dict(family="llama", vocab_size=256, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=64, rope_theta=500000.0, rms_eps=1e-5)
W8 = dict(bit=8, symmetric=True, granularity="per_channel")
E4M3 = dict(bit="e4m3", symmetric=True, granularity="per_channel")
SPECS = {"w8": W8, "e4m3": E4M3,
         "w8_tensor": dict(W8, granularity="per_tensor"),
         "w6": dict(W8, bit=6),
         "e4m3_g128": dict(E4M3, granularity="per_group", group_size=128),
         "e5m2": dict(E4M3, bit="e5m2")}
TOKENS = [1, 5, 9, 44, 100, 7, 3, 120, 11, 64, 200, 17]


def qp_fields(v):
    return dict(codes=np.asarray(v.codes), scales=np.asarray(v.scales),
                zeros=None if v.zeros is None else np.asarray(v.zeros),
                bias=None if v.bias is None else np.asarray(v.bias),
                bits=v.bits, group_size=v.group_size, layout=v.layout,
                is_float=v.is_float)


def sw_to_port(jsw, act_bits=16):
    """A JAX ServingWeights -> the port's, every layout (convert.py)."""
    blocks = []
    for e in jsw.blocks:
        b = {}
        for name, v in e.items():
            if name in convert.NORM_ENTRIES:
                b[name] = {k: np.asarray(a) for k, a in v.items()}
            else:
                b[name] = qp_fields(v)
        blocks.append(b)
    return convert.serving_weights_from_numpy(
        convert.arch_from_fields(dataclasses.asdict(jsw.arch)),
        np.asarray(jsw.embed), {k: np.asarray(a) for k, a in jsw.norm.items()},
        np.asarray(jsw.lm_head),
        None if jsw.lm_head_scale is None else np.asarray(jsw.lm_head_scale),
        blocks, act_bits, fused_rms=jsw.fused_rms, device="cpu",
        wbits=jsw.wbits)


@pytest.fixture(scope="module")
def models():
    jarch = JArchSpec(**DIMS, dtype=jnp.float32)
    jparams = j_init(jax.random.PRNGKey(11), jarch)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(DIMS, dtype=torch.float32)
    return JLlama(jarch, jparams), Llama(tarch, tparams)


def _same(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_matches_jax(models, name):
    """Every linear's codes and scales, the head and the recorded widths
    of the port's own build equal JAX's, converted."""
    jm, tm = models
    spec = SPECS[name]
    jsw = j_build(jm, JQuantSpec(**spec), act_bits=16)
    conv = sw_to_port(jsw)
    own = build_serving_weights(tm, QuantSpec(**spec), device="cpu")
    assert own.wbits == conv.wbits == jsw.wbits == (
        spec["bit"] if isinstance(spec["bit"], int) else 8)
    for eo, ec in zip(own.blocks, conv.blocks):
        for n in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                  "mlp.up", "mlp.down"):
            a, b = eo[n], ec[n]
            assert (a.layout, a.bits, a.is_float, a.group_size) == (
                b.layout, b.bits, b.is_float, b.group_size) == (
                "rows", 8, name.startswith("e"), 0)
            _same(a.codes, b.codes)
            _same(a.scales, b.scales)
            assert a.zeros is None and b.zeros is None
    _same(own.lm_head, conv.lm_head)


@pytest.mark.parametrize("name", ["w8", "e4m3"])
def test_apply_qlinear_matches_jax(name):
    """One linear: W8A8 (int32 sums, JAX's rescale order) bit for bit;
    e4m3 dequant-then-matmul within one bf16 ulp of max|y|."""
    rng = np.random.RandomState(3)
    w = (rng.randn(192, 256) * 0.05).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.randn(5, 256), jnp.bfloat16).astype(
        jnp.float32))
    spec = SPECS[name]
    jq = j_qlin(jnp.asarray(w), JQuantSpec(**spec), layout="rows")
    yj = np.asarray(j_apply(jq, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    tq = quantize_linear(torch.from_numpy(w), QuantSpec(**spec))
    yt = tqm.apply_qlinear(tq, torch.from_numpy(x).to(torch.bfloat16)
                           ).float().numpy()
    if name == "w8":
        np.testing.assert_array_equal(yj, yt)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(yj).max())) - 7)
        assert np.abs(yj - yt).max() <= ulp
    ref = x @ w.T
    err = np.linalg.norm(yt - ref) / np.linalg.norm(ref)
    assert err < (0.02 if name == "w8" else 0.05)


@pytest.mark.parametrize("name,act_bits", [("w8", 8), ("e4m3", 16)])
def test_engine_logits_match_jax(models, name, act_bits):
    """kv8, teacher-forced: the JAX engine on its build against the port's
    engine on its own build: per-step corr >= 0.999, the same argmax."""
    jm, tm = models
    spec = SPECS[name]
    jsw = j_build(jm, JQuantSpec(**spec), act_bits=act_bits)
    own = build_serving_weights(tm, QuantSpec(**spec), act_bits=act_bits,
                                device="cpu")
    jeng, teng = _engines(jsw, own)
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999
        assert jl.argmax() == tl.argmax()


def test_bf16_head_matches_jax(models):
    """head_bits=16: a bf16 head, no scale; logits as JAX's."""
    jm, tm = models
    jsw = j_build(jm, JQuantSpec(**W8), act_bits=8, head_bits=16)
    own = build_serving_weights(tm, QuantSpec(**W8), act_bits=8,
                                device="cpu", head_bits=16)
    assert own.lm_head_scale is None and own.lm_head.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        own.lm_head.float().numpy(),
        np.asarray(jsw.lm_head.astype(jnp.float32)))
    jeng, teng = _engines(jsw, own)
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 3):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


G128 = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


@pytest.mark.parametrize("spec", [G128, dict(G128, symmetric=True), W8,
                                  E4M3])
def test_stacked_rows_match_jax(spec):
    """Stacked experts in JAX's ``rows`` storage (int4 nibbles, or another
    width's codes): codes, scales, zeros and the dequantized experts equal
    JAX's (layout="rows"; W8 and e4m3 take it under "auto" too)."""
    rng = np.random.RandomState(4)
    w3 = (rng.randn(3, 64, 256) * 0.05).astype(np.float32)
    layout = "rows" if spec["bit"] == 4 else "auto"
    jqp = jqm.quantize_linear_stacked(jnp.asarray(w3), JQuantSpec(**spec),
                                      layout=layout)
    tq = tqm.quantize_linear_stacked(torch.from_numpy(w3), QuantSpec(**spec),
                                     layout=layout)
    conv = convert.qlinear_from_numpy(device="cpu", **qp_fields(jqp))
    for own in (tq, conv):
        assert (own.layout, own.bits, own.is_float) == (
            "stacked", jqp.bits, jqp.is_float)
        _same(own.codes, conv.codes)
        _same(own.scales, conv.scales)
    np.testing.assert_array_equal(np.asarray(jqp.codes.astype(jnp.float32)),
                                  tq.codes.float().numpy())
    np.testing.assert_array_equal(
        tqm.dequant_weight_stacked(tq, torch.float32).numpy(),
        np.asarray(jqm.dequant_weight_stacked(jqp, jnp.float32)))
    x = torch.from_numpy(rng.randn(5, 256).astype(np.float32))
    y = tqm.apply_qlinear_stacked(tq, x)
    assert y.shape == (3, 5, 64) and torch.isfinite(y).all()


def test_rows_dequant_matches_jax():
    """The dense W4 ``rows`` layout (pack_int4 nibbles, raw zeros)."""
    rng = np.random.RandomState(5)
    w = (rng.randn(64, 256) * 0.05).astype(np.float32)
    jq = j_qlin(jnp.asarray(w), JQuantSpec(**G128), layout="rows")
    tq = quantize_linear(torch.from_numpy(w), QuantSpec(**G128),
                         layout="rows")
    np.testing.assert_array_equal(np.asarray(jq.codes), tq.codes.numpy())
    np.testing.assert_array_equal(np.asarray(jq.zeros), tq.zeros.numpy())
    from lightcompress_tpu.ops.qlinear import dequant_weight as j_dq
    np.testing.assert_array_equal(
        np.asarray(j_dq(jq, jnp.float32)),
        dequant_weight(tq, torch.float32).numpy())


def _jax_fault(spec, w, x):
    """JAX's build and apply of one linear: the exception, or the relative
    error of its output."""
    jq = j_qlin(jnp.asarray(w), JQuantSpec(**spec), layout="rows")
    try:
        y = np.asarray(j_apply(jq, jnp.asarray(x)).astype(jnp.float32))
    except Exception as e:  # noqa: BLE001 (the fault shown)
        return e
    ref = x @ w.T
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("fault,spec", [
    (1, dict(W8, symmetric=False)),
    (1, dict(W8, bit=6, symmetric=False)),
    (2, dict(W8, granularity="per_group", group_size=128)),
    (2, dict(bit=3, symmetric=False, granularity="per_group",
             group_size=128)),
    (3, dict(E4M3, granularity="per_block", block_size=128)),
    (3, dict(E4M3, granularity="per_tensor"))])
def test_reference_faults_raise(fault, spec):
    """JAX serves these builds wrongly or fails on them; the port refuses
    them at build time naming the fault."""
    rng = np.random.RandomState(6)
    w = (rng.randn(256, 512) * 0.05).astype(np.float32)
    x = rng.randn(4, 512).astype(np.float32)
    got = _jax_fault(spec, w, x)
    if fault == 1:
        assert got > 1.0  # zeros dropped: the output is garbage
    elif fault == 2:
        assert isinstance(got, ValueError) and "broadcast" in str(got)
    else:
        assert isinstance(got, TypeError) and "reshape" in str(got)
    with pytest.raises(NotImplementedError,
                       match=f"reference fault {fault}"):
        quantize_linear(torch.from_numpy(w), QuantSpec(**spec))


# route -> (the port engine's options, the JAX engine's: the same route,
# its kernels in interpret mode); max_len 256 gives the bd routes a
# 512-column buffer (#20, #18), 8192 an 8192-column one (#21's flash)
ROUTES = {
    "kv8": ({}, {}),
    "kv4_bd4": (dict(kv_bits=4, attn_impl="bd4"),
                dict(kv_bits=4, attn_impl="bd4_interpret")),
    "kv4_bd4_flash": (dict(kv_bits=4, max_len=8192),
                      dict(kv_bits=4, max_len=8192,
                           attn_impl="bd4_interpret")),
    "pallas": (dict(attn_impl="pallas"), dict(attn_impl="pallas_interpret")),
    "bd": (dict(attn_impl="bd"), dict(attn_impl="bd_interpret")),
    "bds": (dict(max_len=600, attn_impl="bds"),
            dict(max_len=600, attn_impl="bds_interpret")),
    "ring": (dict(decode_chunk=4), dict(decode_chunk=4)),
    "kv16": (dict(kv_bits=16), dict(kv_bits=16)),
    "xla8": (dict(attn_impl="xla8"), dict(attn_impl="xla8")),
    "kv4_ring": (dict(kv_bits=4, decode_chunk=4),
                 dict(kv_bits=4, decode_chunk=4, attn_impl="xla4r")),
}


@pytest.fixture(scope="module")
def route_builds():
    """A 2-layer Llama (head_dim 128, as the kernel routes take) in W8A8
    and e4m3, each package's own build of the same weights."""
    dims = dict(DIMS, head_dim=128)
    jarch = JArchSpec(**dims, dtype=jnp.float32)
    jparams = j_init(jax.random.PRNGKey(11), jarch)
    jm = JLlama(jarch, jparams)
    tm = Llama(convert.arch_from_fields(dims, dtype=torch.float32),
               convert.params_from_numpy(
                   jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    return [(j_build(jm, JQuantSpec(**spec), act_bits=8),
             build_serving_weights(tm, QuantSpec(**spec), act_bits=8,
                                   device="cpu"))
            for spec in (W8, E4M3)]


def _port_forced(eng, n_prompt, n_steps):
    """The port's engine alone, teacher-forced as ``_teacher_forced`` (slot
    0 of 2): per step its logits."""
    T = eng.prefill_buckets[0]
    ids = torch.zeros((1, T), dtype=torch.long)
    ids[0, :n_prompt] = torch.tensor(TOKENS[:n_prompt])
    eng.reset()
    out = [eng._prefill_batch(ids, torch.tensor([0]),
                              torch.tensor([n_prompt]), T)[0]]
    for i in range(n_steps):
        out.append(eng._decode_step(torch.tensor([TOKENS[n_prompt + i], 0]),
                                    torch.tensor([True, False]))[0])
    return [o.numpy() for o in out]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_serves_w8_builds(route_builds, route):
    """The engine serves the W8A8 and e4m3 builds on every attention route
    (JAX's engine routes them by the cache alone), teacher-forced through
    prefill and two decode steps (one ring chunk on the rings).  W8A8
    against JAX's engine on the same route, the port handed JAX's cache
    before each step.  e4m3, whose linears are held to JAX's on the kv8
    route above: against the port's per-step ``xla`` engine at the
    route's cache width, which writes the same cache codes and sums the
    attention in another order; on the rings, whose fresh tokens attend
    as cache codes, against JAX's ring as W8A8.  Per step: corr >= 0.999,
    max |diff| <= 5% of max |logit| (the act quant's code flips give up to
    4%), the same argmax; on a kv4 cache one step of a build may part at a
    near tie, since an ulp of K that rounds to the next int4 code moves a
    logit by about 1%."""
    from lightcompress_tpu_torch.serving import LLMEngine
    from test_torch_serving import _teacher_forced
    from test_torch_serving_chunk import _ring_teacher_forced

    tkw, jkw = ROUTES[route]
    kw = dict(max_slots=2, prefill_buckets=(16,), max_len=256)
    for n, (jsw, tsw) in enumerate(route_builds):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the probe-only notices
            teng = LLMEngine(tsw, device="cpu", **{**kw, **tkw})
            if n == 0 or teng.ring:
                jeng = JEngine(jsw, **{**kw, **jkw})
        if teng.ring:
            pairs = _ring_teacher_forced(jeng, teng, TOKENS, 4, 2, 2,
                                         sync=True)
        elif n == 0:
            assert teng.attn_impl == jeng.attn_impl.replace("_interpret",
                                                            "")
            assert teng.buf_len == jeng.buf_len
            pairs = _teacher_forced(jeng, teng, TOKENS, 4, 2, sync=True)
        else:
            ref = LLMEngine(tsw, device="cpu", attn_impl="xla",
                            **{**kw, "max_len": teng.max_len,
                               "kv_bits": teng.cache.bits})
            pairs = zip(_port_forced(ref, 4, 2), _port_forced(teng, 4, 2))
        parted = 0
        for jl, tl in pairs:
            jl = jl.ravel()
            assert np.corrcoef(jl, tl)[0, 1] >= 0.999
            assert np.abs(jl - tl).max() <= 0.05 * np.abs(jl).max()
            parted += int(jl.argmax() != tl.argmax())
        assert parted <= (1 if teng.cache.bits == 4 else 0)
