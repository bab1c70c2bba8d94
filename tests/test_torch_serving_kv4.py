"""Port parity: the kv4 engine (bd4 nibble cache, kernels #20 and #21) and
the ``attn_impl="pallas"`` int8 engine (kernel #17) of
lightcompress_tpu_torch against lightcompress_tpu's ``bd4_interpret`` and
``pallas_interpret`` engines on the same weights (CPU).  The port takes the
kernels' plain versions."""

import warnings

import numpy as np
import pytest

from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu_torch.serving import LLMEngine, SamplingParams
from test_torch_serving import (MARGIN, N_NEW, PROMPTS, TOKENS,  # noqa: F401
                                _teacher_forced, models, one_torch_thread,
                                weights)

# (JAX engine options, port engine options): max_len 64 gives a 512-column
# bd4 buffer (#20), max_len 8192 an 8192-column one (#21)
CASES = {
    "bd4_512": (dict(kv_bits=4, max_len=64, attn_impl="bd4_interpret"),
                dict(kv_bits=4, max_len=64, attn_impl="bd4")),
    "bd4_8192": (dict(kv_bits=4, max_len=8192, attn_impl="bd4_interpret"),
                 dict(kv_bits="auto", max_len=8192)),
    "pallas": (dict(kv_bits=8, max_len=64, attn_impl="pallas_interpret"),
               dict(kv_bits=8, max_len=64, attn_impl="pallas")),
}


def _engines(jsw, tsw, case, slots=2):
    jkw, tkw = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the probe-only notice of pallas
        jeng = JEngine(jsw, max_slots=slots, prefill_buckets=(16,), **jkw)
        teng = LLMEngine(tsw, max_slots=slots, prefill_buckets=(16,),
                         device="cpu", **tkw)
    return jeng, teng


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_logits_match_jax(weights, case):
    """act_bits=16, per-step corr >= 0.999 over prefill and decode, each
    decode step from the same cache codes.  The linears sum in another
    order than XLA's, so K/V differ by an ulp here and there; an int4 code
    rounds that to a whole step of amax/7, and left to diverge the two kv4
    caches bring the corr to 0.9966 within six steps (0.9998 for kv8).
    The cache writers themselves are held bit for bit on the same inputs
    in test_torch_attention.py."""
    jeng, teng = _engines(*weights[16], case)
    assert teng.cache.layout == ("hhd" if case == "pallas" else "bd4")
    assert teng.buf_len == jeng.buf_len
    for jl, tl in _teacher_forced(jeng, teng, TOKENS, 4, 6, sync=True):
        assert np.corrcoef(jl, tl)[0, 1] >= 0.999


# prompts drawn from np.random.RandomState(0), kept where every greedy step
# of the JAX engines has a top-2 logit gap above the margin (checked
# below).  The kv4 engines are free to diverge here (see above), so their
# logits differ by up to 0.11 and their fixture needs the wider margin.
FIXTURES = {
    "kv8": (PROMPTS, N_NEW, MARGIN),
    "kv4": ([[106, 164, 94], [59, 17, 196], [136, 207, 207]], 4, 0.25),
}


@pytest.mark.parametrize("case", ["bd4_512", "bd4_8192", "pallas"])
def test_greedy_generate_matches_jax(weights, case):
    """More prompts than slots (retire and re-admit): identical greedy
    tokens on a fixture whose top-2 margins exceed its margin while the
    two free-running engines' logits differ by less than half of it."""
    jsw, tsw = weights[16]
    prompts, n_new, margin = FIXTURES["kv8" if case == "pallas" else "kv4"]
    jeng, teng = _engines(jsw, tsw, case)
    jout = jeng.generate(prompts, JSampling(max_new_tokens=n_new))
    tout = teng.generate(prompts, SamplingParams(max_new_tokens=n_new))
    for p, cont in zip(prompts, jout):
        for jl, tl in _teacher_forced(jeng, teng, p + cont, len(p),
                                      len(cont) - 1):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] > margin
            assert np.abs(jl - tl).max() < margin / 2
    assert tout == jout


def test_engine_routes(weights):
    """``auto`` picks as the JAX engine does on a TPU; the kv4 names JAX
    sends to its generic path (``xla``, ``pallas``, ``xla4r`` without a
    chunk, which falls back to ``xla``) serve there on the kv4 ``hhd``
    cache; ``kv_bits=8`` with ``bd4`` still raises (a fault of the JAX
    engine); ``pallas`` carries the probe-only notice."""
    _, tsw = weights[16]
    kw = dict(max_slots=1, prefill_buckets=(16,), device="cpu")
    assert LLMEngine(tsw, max_len=4096, kv_bits="auto", **kw).attn_impl \
        == "bd4"
    e = LLMEngine(tsw, max_len=700, kv_bits=4, **kw)
    assert (e.attn_impl, e.buf_len, e.cache.k.shape[-1]) == ("bd4", 1024,
                                                              1024)
    assert LLMEngine(tsw, max_len=2048, kv_bits="auto", **kw).attn_impl \
        == "xla"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for impl, want in (("xla", "xla"), ("pallas", "pallas"),
                           ("xla4r", "xla")):
            e = LLMEngine(tsw, max_len=64, kv_bits=4, attn_impl=impl, **kw)
            assert (e.attn_impl, e.body, e.cache.layout, e.buf_len,
                    e.cache.k.shape[-1]) == (want, "generic", "hhd", 64, 64)
    with pytest.raises(NotImplementedError, match="reference faults"):
        LLMEngine(tsw, max_len=64, kv_bits=8, attn_impl="bd4", **kw)
    with pytest.warns(UserWarning, match="probe-only"):
        LLMEngine(tsw, max_len=64, attn_impl="pallas", **kw)
