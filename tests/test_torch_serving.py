"""Port parity: serving weights, the int8 KV cache and the LLMEngine of
lightcompress_tpu_torch against lightcompress_tpu's on the same weights
(CPU).  The JAX engine on the CPU takes its XLA path: dequant-then-matmul
linears and the append-first int8 attention (``xla8a``); the port takes
the kernels' plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import init_params as j_init
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving.kv_cache import quantize_kv as j_quantize_kv
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights,
                                             quantize_kv, read_kv_slot,
                                             sample)
from lightcompress_tpu_torch.serving.kv_cache import KVCache, append_slots

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module (other port test modules import
    this fixture).  The suite runs under several xdist workers; torch's
    default of a thread per core then oversubscribes the CPU, and the
    engines' many small ops slowed down a hundredfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the smallest Llama whose linears take the W4 kernels' layout (K % 1024)
DIMS = dict(family="llama", vocab_size=256, hidden_size=1024,
            intermediate_size=2048, num_layers=2, num_heads=8, num_kv_heads=2,
            head_dim=128, rope_theta=500000.0, rms_eps=1e-5)
WSPEC = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


def _sw_to_port(jsw, act_bits):
    arch = convert.arch_from_fields(dataclasses.asdict(jsw.arch))
    blocks = []
    for e in jsw.blocks:
        b = {}
        for name, v in e.items():
            if name in ("ln1", "ln2"):
                b[name] = {k: np.asarray(a) for k, a in v.items()}
            else:
                b[name] = dict(
                    codes=np.asarray(v.codes), scales=np.asarray(v.scales),
                    zeros=None if v.zeros is None else np.asarray(v.zeros),
                    bias=None if v.bias is None else np.asarray(v.bias),
                    bits=v.bits, group_size=v.group_size, layout=v.layout)
        blocks.append(b)
    return convert.serving_weights_from_numpy(
        arch, np.asarray(jsw.embed),
        {k: np.asarray(a) for k, a in jsw.norm.items()},
        np.asarray(jsw.lm_head),
        None if jsw.lm_head_scale is None else np.asarray(jsw.lm_head_scale),
        blocks, act_bits, fused_rms=jsw.fused_rms, device="cpu")


@pytest.fixture(scope="module")
def models():
    jarch = JArchSpec(**DIMS, dtype=jnp.float32)
    jparams = j_init(jax.random.PRNGKey(5), jarch)
    jmodel = JLlama(jarch, jparams)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(DIMS, dtype=torch.float32)
    return jmodel, Llama(tarch, tparams)


@pytest.fixture(scope="module")
def weights(models):
    jmodel, _ = models
    out = {}
    for ab in (8, 16):
        jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=ab)
        out[ab] = (jsw, _sw_to_port(jsw, ab))
    return out


def test_build_serving_weights_matches_jax(models, weights):
    """Codes, bf16 scales and zero corrections and the int8 head of the
    port's own build equal the converted JAX serving weights."""
    _, tmodel = models
    _, conv = weights[16]
    own = build_serving_weights(tmodel, QuantSpec(**WSPEC), device="cpu")
    for eo, ec in zip(own.blocks, conv.blocks):
        for name in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate",
                     "mlp.up", "mlp.down"):
            a, b = eo[name], ec[name]
            np.testing.assert_array_equal(a.codes.numpy(), b.codes.numpy())
            assert a.scales.dtype == b.scales.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.scales.float().numpy(),
                                          b.scales.float().numpy())
            np.testing.assert_array_equal(a.zeros.float().numpy(),
                                          b.zeros.float().numpy())
    assert own.lm_head.dtype == conv.lm_head.dtype == torch.int8
    np.testing.assert_array_equal(own.lm_head.numpy(), conv.lm_head.numpy())
    np.testing.assert_array_equal(own.lm_head_scale.numpy(),
                                  conv.lm_head_scale.numpy())
    np.testing.assert_array_equal(own.embed.float().numpy(),
                                  conv.embed.float().numpy())


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(3, 2, 9, 128).astype(np.float32)).astype(
        jnp.bfloat16)
    x = x.at[0, 0, 0].set(0.0)  # the 1e-6 clamp
    jq, js = j_quantize_kv(x)
    tq, ts = quantize_kv(convert.tensor_from_numpy(x, "cpu"))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


def test_slot_append_and_read():
    cache = KVCache.create(2, 3, 2, 16, 128, bits=8, device="cpu")
    rng = np.random.RandomState(1)
    k = torch.from_numpy(rng.randn(2, 2, 5, 128).astype(np.float32)).to(
        torch.bfloat16)
    v = -k
    append_slots(cache, 1, torch.tensor([2, 0]), k, v)
    kr, vr = read_kv_slot(cache, 1, 2)
    assert kr.shape == (1, 2, 16, 128) and kr.dtype == torch.bfloat16
    # int8 per-token quant error is within half a step of amax/127
    step = k[0].float().abs().amax(-1, keepdim=True) / 127
    assert ((kr[0, :, :5].float() - k[0].float()).abs() <= step).all()
    assert (kr[0, :, 5:] == 0).all() and (vr[0, :, :5] == -kr[0, :, :5]).all()


def _sync_cache(jcache, tcache):
    """Copy a JAX cache's codes and scales into the port's (a bf16 cache
    has no scales)."""
    for name in ("k", "v", "k_scale", "v_scale"):
        src = getattr(jcache, name)
        if src is not None:
            getattr(tcache, name).copy_(torch.from_numpy(
                np.array(src.astype(jnp.float32))))


def _teacher_forced(jeng, teng, tokens, n_prompt, n_steps, sync=False):
    """Feed one fixed token stream through prefill and decode of both
    engines (slot 0 of 2); per step the two logits vectors.  With
    ``sync`` the port is handed JAX's cache before every decode step, so
    that each step of the two engines starts from the same cache codes."""
    prompt = tokens[:n_prompt]
    T = jeng.prefill_buckets[0]
    ids = np.zeros((1, T), np.int32)
    ids[0, :n_prompt] = prompt
    jeng.reset()
    cache, lengths, jl = jeng._prefill_jit(
        jeng.sw, jeng.cache, jeng.lengths, jnp.asarray(ids), jnp.asarray(0),
        jnp.asarray(n_prompt), T=T)
    teng.reset()
    tl = teng._prefill_batch(torch.from_numpy(ids).long(),
                             torch.tensor([0]), torch.tensor([n_prompt]), T)
    pairs = [(np.asarray(jl), tl[0].numpy())]
    jcur, tcur = jeng.cur_tokens, teng.cur_tokens.clone()
    active = [True] + [False] * (jeng.max_slots - 1)
    for i in range(n_steps):
        if sync:
            _sync_cache(cache, teng.cache)
        tok = tokens[n_prompt + i]
        jcur = jcur.at[0].set(tok)
        tcur[0] = tok
        cache, lengths, jlog = jeng._decode_jit(
            jeng.sw, cache, lengths, jcur, jnp.asarray(active))
        tlog = teng._decode_step(tcur, torch.tensor(active))
        pairs.append((np.asarray(jlog[0]), tlog[0].numpy()))
    return pairs


def _engines(jsw, tsw, slots=2):
    kw = dict(max_slots=slots, max_len=64, kv_bits=8, prefill_buckets=(16,))
    return JEngine(jsw, **kw), LLMEngine(tsw, device="cpu", **kw)


TOKENS = [1, 5, 9, 44, 100, 7, 3, 120, 11, 64, 200, 17]


def test_engine_logits_match_jax_w4a16(weights):
    """kv8, act_bits=16: the same int8 cache codes and the same quantized
    weights; the linears sum in another order -> per-step corr >= 0.999."""
    jeng, teng = _engines(*weights[16])
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


def test_engine_logits_w4a8_vs_jax(weights):
    """act_bits=8: the port quantizes activations per token to int8 (the
    W4A8 kernels' plain versions) while the JAX engine on the CPU keeps
    bf16 activations (qlinear_xla), so the act-quant noise bounds the
    agreement: per-step corr >= 0.99."""
    jeng, teng = _engines(*weights[8])
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.99


# prompts drawn from np.random.RandomState(0) and kept where every greedy
# step of the JAX engine has a top-2 logit gap above MARGIN; greedy parity
# needs that gap to exceed the two engines' disagreement (checked below)
PROMPTS = [[31, 202, 244], [125, 2, 3], [95, 72, 154, 194, 248, 180]]
N_NEW = 5
MARGIN = 0.12


def test_greedy_generate_matches_jax(weights):
    """More prompts than slots (continuous batching, retire, re-admit):
    the greedy tokens are identical on a fixture whose top-2 margins all
    exceed MARGIN, while the logits differ by far less."""
    jsw, tsw = weights[16]
    jeng, teng = _engines(jsw, tsw, slots=2)
    jout = jeng.generate(PROMPTS, JSampling(max_new_tokens=N_NEW))
    tout = teng.generate(PROMPTS, SamplingParams(max_new_tokens=N_NEW))
    # fixture check: teacher-force each prompt's JAX continuation and
    # require clear top-2 margins and a logits gap well under them
    for p, cont in zip(PROMPTS, jout):
        j1, t1 = _engines(jsw, tsw)
        for jl, tl in _teacher_forced(j1, t1, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] > MARGIN
            assert np.abs(jl - tl).max() < MARGIN / 2
    assert tout == jout


def test_sampled_generate_respects_top_k(weights):
    _, tsw = weights[16]
    teng = LLMEngine(tsw, max_slots=2, max_len=64, prefill_buckets=(16,),
                     seed=3, device="cpu")
    outs = teng.generate(PROMPTS, SamplingParams(
        max_new_tokens=4, temperature=1.0, top_k=5, top_p=0.9))
    assert [len(o) for o in outs] == [4, 4, 4]
    assert all(0 <= t < DIMS["vocab_size"] for o in outs for t in o)


def test_sampler_filters():
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    logits = torch.from_numpy(
        np.random.RandomState(2).randn(64, 50).astype(np.float32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    for _ in range(5):
        t = sample(logits, SamplingParams(temperature=1.0, top_k=3), g)
        assert (top3 == t[:, None].long()).any(dim=-1).all()
    greedy = sample(logits, SamplingParams())
    assert torch.equal(greedy.long(), logits.argmax(-1))
    nucleus = sample(logits, SamplingParams(temperature=0.5, top_p=1e-6), g)
    assert torch.equal(nucleus, greedy)
