"""Port parity: the Qwen3-MoE engine against the JAX engine on the forced
grouped expert route with the int8 down through kernel #10
(``LCTPU_MOE_GROUPED=interpret``, ``LCTPU_MOE_GATHER_MAX=0`` on the JAX
side, ``moe_grouped="interpret"``, ``moe_gather_max=0`` on the port's), on
the small Qwen3-MoE-shaped model of test_torch_qwen3moe.py (CPU): the
teacher-forced logits and the greedy tokens."""

import functools

import numpy as np
import pytest

from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu_torch.serving import SamplingParams
from lightcompress_tpu_torch.ops import moe_matmul as tm
from test_torch_qwen3moe import _weights
from test_torch_serving_moe_engine import (GROUPED_ENV, _engines,
                                           _teacher_forced)
from test_torch_serving import one_torch_thread  # noqa: F401

TOKENS = [1, 5, 9, 44, 100, 7, 3, 120, 11, 64, 200, 17]
# prompts drawn from np.random.RandomState(0) (3 to 6 tokens each) and kept
# where every greedy step of the JAX engine has a top-2 logit gap above
# MARGIN while the two engines' logits differ by less than MARGIN / 2 (they
# differ by up to 0.06 on such prompts: jitted XLA keeps some bf16 chains in
# f32, and the int8 act quants turn last-bit differences into code steps)
PROMPTS = [[9, 185, 127, 32], [209, 50, 155], [120, 1, 65, 231, 169, 57]]
N_NEW = 3
MARGIN = 0.16


@pytest.fixture
def grouped_env(monkeypatch):
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)


@functools.lru_cache(maxsize=None)
def _grouped_engines():
    """One engine pair on the forced grouped route (W4A16 attention
    linears; the experts' activations are int8 on this route whatever
    act_bits is)."""
    jsw, tsw, _ = _weights(16)
    return _engines(jsw, tsw, moe_gather_max=0, moe_grouped="interpret")


def test_engine_logits_match_jax_grouped(grouped_env, monkeypatch):
    """qk_norm in prefill and decode, every expert linear through the
    grouped route (#9 and #10 plain here, interpret mode in JAX): per-step
    corr >= 0.999; #10's plain version carries every down projection."""
    jeng, teng = _grouped_engines()
    assert teng.attn_impl == "xla" and teng.arch.qk_norm
    calls = []
    fn = tm.w8a8_grouped_matmul_plain
    monkeypatch.setattr(tm, "w8a8_grouped_matmul_plain",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    pairs = _teacher_forced(jeng, teng, TOKENS, 4, 5)
    for jl, tl in pairs:
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999
    assert len(calls) == teng.arch.num_layers * len(pairs)


def test_greedy_generate_matches_jax_grouped(grouped_env):
    """More prompts than slots through both engines: identical greedy
    tokens, on a fixture whose top-2 margins all exceed MARGIN while the
    logits differ by less than half of it."""
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
