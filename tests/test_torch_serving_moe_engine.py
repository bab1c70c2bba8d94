"""Port parity: the MoE engine against the JAX engine on the forced grouped
expert route (``LCTPU_MOE_GROUPED=interpret``, ``LCTPU_MOE_GATHER_MAX=0``
on the JAX side, ``moe_grouped=True``, ``moe_gather_max=0`` on the port's),
on the small Mixtral-shaped model of test_torch_serving_moe.py (CPU): the
teacher-forced logits and the greedy tokens."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu_torch.serving import LLMEngine, SamplingParams
from test_torch_serving_moe import _weights
from test_torch_serving import one_torch_thread  # noqa: F401


def _engines(jsw, tsw, slots=2, **tkw):
    kw = dict(max_slots=slots, max_len=64, kv_bits=8, prefill_buckets=(16,))
    return JEngine(jsw, **kw), LLMEngine(tsw, device="cpu", **kw, **tkw)


def _teacher_forced(jeng, teng, tokens, n_prompt, n_steps):
    """One fixed token stream through prefill and decode of both engines
    (slot 0 of 2); per step the two logits vectors."""
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
    jcur, tcur = jeng.cur_tokens, teng.cur_tokens.clone()
    active = [True] + [False] * (jeng.max_slots - 1)
    for i in range(n_steps):
        tok = tokens[n_prompt + i]
        jcur = jcur.at[0].set(tok)
        tcur[0] = tok
        cache, lengths, jlog = jeng._decode_jit(
            jeng.sw, cache, lengths, jcur, jnp.asarray(active))
        pairs.append((np.asarray(jlog[0]),
                      teng._decode_step(tcur, torch.tensor(active))[0]
                      .numpy()))
    return pairs


GROUPED_ENV = dict(LCTPU_MOE_GATHER_MAX="0", LCTPU_MOE_GROUPED="interpret")
GROUPED_OPTS = dict(moe_gather_max=0, moe_grouped=True)
TOKENS = [1, 5, 9, 44, 100, 7, 3, 120, 11, 64, 200, 17]
# prompts drawn from np.random.RandomState(0) (3 to 6 tokens each) and kept
# where every greedy step of the JAX engine has a top-2 logit gap above
# MARGIN; the two engines' logits differ by up to 0.06 on them (jitted XLA
# keeps some bf16 chains in f32, and the int8 act quant of the expert
# inputs turns last-bit differences into code steps)
PROMPTS = [[163, 192, 95, 197], [93, 131, 98], [109, 75, 184, 16]]
N_NEW = 3
MARGIN = 0.16


@pytest.fixture
def grouped_env(monkeypatch):
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)


@functools.lru_cache(maxsize=None)
def _grouped_engines():
    """One engine pair on the forced grouped route, shared by the tests
    that use it (the JAX engine compiles its steps on first use; every
    test that uses it sets the route's environment first)."""
    jsw, tsw, _ = _weights("planes", 16)
    return _engines(jsw, tsw, **GROUPED_OPTS)


def test_engine_logits_match_jax_grouped(grouped_env):
    """W4A16 attention linears, every expert linear through the grouped
    route (#9 plain here, interpret mode in JAX) in prefill and decode:
    per-step corr >= 0.999, as the dense engines' test."""
    jeng, teng = _grouped_engines()
    assert teng.attn_impl == "xla"
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 5):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


def test_greedy_generate_matches_jax_grouped(grouped_env):
    """More prompts than slots through both engines on the forced grouped
    route: identical greedy tokens, on a fixture whose top-2 margins all
    exceed MARGIN while the logits differ by far less."""
    jeng, teng = _grouped_engines()
    jeng.reset()
    teng.reset()
    jout = jeng.generate(PROMPTS, JSampling(max_new_tokens=N_NEW))
    tout = teng.generate(PROMPTS, SamplingParams(max_new_tokens=N_NEW))
    for p, cont in zip(PROMPTS, jout):
        for jl, tl in _teacher_forced(jeng, teng, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] > MARGIN
            assert np.abs(jl - tl).max() < MARGIN / 2
    assert tout == jout
