"""Port parity: the fused serving build (``build_serving_weights`` with
``layout``, ``fused_rms`` and ``fuse_qkv``) and the engine's fused decode
linears (kernels #13 and #14, plain versions on the CPU) against
lightcompress_tpu.  The RMSNorm gammas are set to 1 + 0.1 N(0, 1) from a
seed, so that folding them is not a no-op."""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.models import init_params as j_init
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving import engine as j_engine
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.ops import w4_matmul as tw
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights)
from lightcompress_tpu_torch.serving import engine as t_engine
from test_torch_serving import DIMS, TOKENS, WSPEC, _sw_to_port, \
    _teacher_forced, one_torch_thread  # noqa: F401

# the widths: DIMS, where JAX fuses every decode linear of both layouts;
# narrow (hidden 512, intermediate 1280), where JAX's planes stay untiled
# (K % 1024) and none of them fuses, while s4 fuses q/k/v and o but falls
# back to untiled planes for mlp.down (K % 512), which leaves the whole
# MLP unfused
WIDTHS = {
    "base": DIMS,
    "narrow": dict(DIMS, hidden_size=512, intermediate_size=1280,
                   num_heads=4),
}
FUSED_PLAINS = ("w4a8_linear_planes_fused_plain",
                "w4a8_linear_bytes_fused_plain")


@functools.lru_cache(maxsize=None)
def _models(width, dtype):
    """The JAX Llama at ``width`` (the weights of test_torch_serving.py
    at DIMS) with gammas 1 + 0.1 N(0, 1), and the port's on the same
    parameters."""
    dims = WIDTHS[width]
    jarch = JArchSpec(**dims, dtype=dtype)
    jparams = j_init(jax.random.PRNGKey(5), jarch)
    rng = np.random.RandomState(0)
    for bp in jparams["blocks"]:
        for ln in ("ln1", "ln2"):
            g = 1 + 0.1 * rng.randn(dims["hidden_size"])
            bp[ln]["weight"] = jnp.asarray(g.astype(np.float32), dtype)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(
        dims, dtype=torch.bfloat16 if dtype == jnp.bfloat16 else
        torch.float32)
    return JLlama(jarch, jparams), Llama(tarch, tparams)


def _jax_fused_ok(jsw, e):
    """The JAX engine's ``fused_ok`` (serving/engine.py:420-429)."""
    if not (jsw.fused_rms and e.bits == 4 and e.zeros is not None
            and jsw.act_bits == 8):
        return False
    return ((e.layout == "s4" and e.codes.ndim == 3)
            or (e.layout == "planes" and e.codes.ndim == 4))


def _jax_fused_calls(jsw, entry):
    """How many fused linears JAX's decode block runs on ``entry``
    (serving/engine.py:441-457 and :862-884)."""
    ok = lambda n: _jax_fused_ok(jsw, entry[n])  # noqa: E731
    n = 0
    if "attn.qkv" in entry:
        n += ok("attn.qkv")
    elif all(ok(k) for k in ("attn.q", "attn.k", "attn.v")):
        n += 3
    n += ok("attn.o")
    if "mlp.gateup" in entry:
        n += 2 * (ok("mlp.gateup") and ok("mlp.down"))
    elif all(ok(k) for k in ("mlp.gate", "mlp.up", "mlp.down")):
        n += 3
    return n


@functools.lru_cache(maxsize=None)
def _builds(width, layout, fused_rms, fuse_qkv):
    """The JAX build at act_bits=8 of the bf16 model at ``width`` (the
    fold then multiplies in bf16, as at Llama-3-8B), and the port's own
    build of the same model."""
    jmodel, tmodel = _models(width, jnp.bfloat16)
    kw = dict(act_bits=8, layout=layout, fused_rms=fused_rms,
              fuse_qkv=fuse_qkv)
    return (j_build(jmodel, JQuantSpec(**WSPEC), **kw),
            build_serving_weights(tmodel, QuantSpec(**WSPEC), device="cpu",
                                  **kw))


BUILDS = [("base", layout, fused, fq) for layout in ("planes", "s4")
          for fused in (False, True) for fq in (False, True)] + [
    ("narrow", "planes", True, False), ("narrow", "s4", True, True)]


@pytest.mark.parametrize("width,layout,fused_rms,fuse_qkv", BUILDS)
def test_build_matches_jax(width, layout, fused_rms, fuse_qkv):
    """The port's own build equals the converted JAX build: the same
    entries, codes bit for bit, s and zs equal, the layout and JAX's
    tiling, ones in ln1/ln2 when folded, and ``fused_ok`` where JAX
    fuses."""
    jsw, own = _builds(width, layout, fused_rms, fuse_qkv)
    conv = _sw_to_port(jsw, 8)
    assert own.fused_rms == conv.fused_rms == jsw.fused_rms == fused_rms
    for je, ce, oe in zip(jsw.blocks, conv.blocks, own.blocks):
        assert set(oe) == set(ce) == set(je)
        for name, jq in je.items():
            if name in ("ln1", "ln2"):
                np.testing.assert_array_equal(
                    oe[name]["weight"].float().numpy(),
                    np.asarray(jq["weight"].astype(jnp.float32)))
                if fused_rms:
                    assert (oe[name]["weight"] == 1).all()
                continue
            a, b = oe[name], ce[name]
            assert a.layout == b.layout == jq.layout
            assert a.tiled == b.tiled == (jq.codes.ndim == (
                3 if jq.layout == "s4" else 4))
            np.testing.assert_array_equal(a.codes.numpy(), b.codes.numpy())
            for f in ("scales", "zeros"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x.float().numpy(),
                                              y.float().numpy())
            assert t_engine.fused_ok(own, a) == _jax_fused_ok(jsw, jq)


def _spy(monkeypatch):
    calls = []
    for name in FUSED_PLAINS:
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _f=fn, **k: (
            calls.append(1), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("width,layout,fuse_qkv", [
    (w, lay, fq) for w, lay, fused, fq in BUILDS if fused])
def test_decode_fuses_where_jax_does(monkeypatch, width, layout, fuse_qkv):
    """One decode step of the port's engine runs as many fused linears
    per block as JAX's decode block would on the same build (none at the
    widths where JAX keeps the planes untiled)."""
    jsw, sw = _builds(width, layout, True, fuse_qkv)
    eng = LLMEngine(sw, max_slots=2, max_len=32, prefill_buckets=(8,),
                    device="cpu")
    eng._prefill_batch(torch.tensor([[3, 1, 4, 1, 5, 0, 0, 0]] * 2),
                       torch.tensor([0, 1]), torch.tensor([5, 5]), 8)
    calls = _spy(monkeypatch)
    eng._decode_step(eng.cur_tokens, torch.tensor([True, True]))
    assert len(calls) == sum(_jax_fused_calls(jsw, e) for e in jsw.blocks)


@pytest.fixture(scope="module")
def fused_weights():
    """f32 model (the engine tests of test_torch_serving.py), both fused
    layouts at act_bits=8: (JAX weights, converted port weights)."""
    jmodel, _ = _models("base", jnp.float32)
    out = {}
    for layout in ("planes", "s4"):
        jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=8, layout=layout,
                      fused_rms=True, fuse_qkv=True)
        out[layout] = (jsw, _sw_to_port(jsw, 8))
    return out


def _engines(jsw, tsw, slots=2):
    kw = dict(max_slots=slots, max_len=64, kv_bits=8, prefill_buckets=(16,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the probe-only notice of pallas
        return (JEngine(jsw, attn_impl="pallas_interpret", **kw),
                LLMEngine(tsw, attn_impl="pallas", device="cpu", **kw))


def _sync(jcache, tcache):
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(tcache, name).copy_(torch.from_numpy(
            np.array(getattr(jcache, name).astype(jnp.float32))))


# the fused linears sum their f32 group terms in another order than the
# Pallas kernels; now and then that moves a bf16 rounding of an output,
# which the next linear's act quant turns into a code step: measured 0 on
# three of the four blocks below and 0.031 at max |y| 4.25 on the fourth
BLOCK_TOL = 2.0 ** -6


@pytest.mark.parametrize("layout", ["planes", "s4"])
def test_fused_decode_blocks_match_jax(fused_weights, layout):
    """Every decode block of the port (``pallas`` route, fused linears)
    against the JAX block run op by op (``_block_apply_decode_i8`` with
    the interpret-mode kernels) on the same input and cache: within
    BLOCK_TOL of max |y|, corr >= 0.9999; and the port's step took the
    fused linears (4 per block)."""
    jsw, tsw = fused_weights[layout]
    jeng, teng = _engines(jsw, tsw)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :4] = TOKENS[:4]
    cache, lengths, _ = jeng._prefill_jit(
        jeng.sw, jeng.cache, jeng.lengths, jnp.asarray(ids), jnp.asarray(0),
        jnp.asarray(4), T=16)
    teng._prefill_batch(torch.from_numpy(ids).long(), torch.tensor([0]),
                        torch.tensor([4]), 16)
    _sync(cache, teng.cache)
    tok = [TOKENS[4], TOKENS[5]]
    x = jsw.embed[jnp.asarray(tok)][:, None, :]
    tx = tsw.embed[torch.tensor(tok)][:, None, :]
    cos, sin = JA.rope_cos_sin(jsw.arch, lengths[:, None])
    tl = teng.lengths.clone()
    tcos, tsin = TA.rope_cos_sin(tsw.arch, tl[:, None])
    before = (tw.w4a8_linear_planes_fused_plain,
              tw.w4a8_linear_bytes_fused_plain)
    calls = []
    for li, (je, te) in enumerate(zip(jsw.blocks, tsw.blocks)):
        tx = convert.tensor_from_numpy(x, "cpu")
        x, *_ = j_engine._block_apply_decode_i8(
            jsw, je, x, cos, sin, cache, li, lengths, interpret=True,
            impl="i8")
        fn = dict(zip(FUSED_PLAINS, before))
        with pytest.MonkeyPatch.context() as mp:
            for name, f in fn.items():
                mp.setattr(tw, name, lambda *a, _f=f, **k: (
                    calls.append(1), _f(*a, **k))[1])
            tx = t_engine._block_apply_decode(tsw, te, tx, tcos, tsin,
                                              teng.cache, li, tl, "pallas")
        a, b = tx.float().numpy(), np.asarray(x.astype(jnp.float32))
        assert np.abs(a - b).max() <= BLOCK_TOL * np.abs(b).max()
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.9999
    assert len(calls) == 4 * len(tsw.blocks)


@pytest.mark.parametrize("layout", ["planes", "s4"])
def test_fused_engine_logits_match_jax(fused_weights, layout):
    """Teacher-forced logits of the port's ``pallas`` engine against the
    JAX ``pallas_interpret`` engine, each decode step from the same cache
    codes: corr >= 0.999 per step.  Prefill: the port quantizes
    activations per token to int8 (the W4A8 kernels' plain versions) while
    JAX on the CPU keeps bf16 ones (qlinear_xla).  Decode: both take the
    fused linears and agree op by op (test above), but XLA's jit of the
    whole step keeps bf16 chains in f32 where its eager ops round, which
    moves these logits by up to 0.05 (measured 0.9995 <= corr)."""
    jeng, teng = _engines(*fused_weights[layout])
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6, sync=True):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


# prompts drawn from np.random.RandomState(0) and kept where every greedy
# step of the JAX fused-planes engine has a top-2 logit gap above MARGIN
# while the two free-running engines' logits differ by less than half of
# it (checked below)
PROMPTS = [[243, 197, 254], [9, 185, 127, 32], [142, 99, 53]]
N_NEW = 3
MARGIN = 0.22


def test_fused_greedy_generate_matches_jax(fused_weights):
    """More prompts than slots (retire and re-admit): identical greedy
    tokens from the fused planes build on the fixture above."""
    jsw, tsw = fused_weights["planes"]
    jeng, teng = _engines(jsw, tsw)
    jout = jeng.generate(PROMPTS, JSampling(max_new_tokens=N_NEW))
    tout = teng.generate(PROMPTS, SamplingParams(max_new_tokens=N_NEW))
    for p, cont in zip(PROMPTS, jout):
        for jl, tl in _teacher_forced(jeng, teng, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] > MARGIN
            assert np.abs(jl - tl).max() < MARGIN / 2
    assert tout == jout

