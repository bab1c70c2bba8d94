"""ops/scaled_matmul.py against the JAX package on the same seeded numpy
inputs: the int8 products (int32 accumulation) and both dots of
int8_decode_attention bit for bit, the act quants' codes bit for bit, the
fp8 paths within the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcompress_tpu.ops import scaled_matmul as J
from lightcompress_tpu_torch.ops import scaled_matmul as P
from test_torch_serving import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values for both packages."""
    x = (rng.randn(*shape) * scale).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return jnp.asarray(xb, jnp.bfloat16), torch.from_numpy(xb).to(
        torch.bfloat16)


@pytest.mark.parametrize("shape", [(5, 96), (2, 3, 256)])
def test_quantize_act_int8_codes_bit_for_bit(shape):
    rng = np.random.RandomState(0)
    xj, xt = _bf16_pair(rng, shape, 3.0)
    qj, sj = J.quantize_act_int8(xj)
    qt, st = P.quantize_act_int8(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("M,N,K", [(1, 64, 256), (8, 40, 128), (33, 128, 512)])
@pytest.mark.parametrize("per_tensor", [False, True])
def test_int8_matmul_dynamic_bit_for_bit(M, N, K, per_tensor):
    rng = np.random.RandomState(M + N)
    xj, xt = _bf16_pair(rng, (M, K))
    w = rng.randint(-127, 128, size=(N, K)).astype(np.int8)
    ws = (rng.rand(1 if per_tensor else N, 1) * 0.01 + 1e-3).astype(
        np.float32)
    bias = rng.randn(N).astype(np.float32)
    for b in (None, bias):
        yj = J.int8_matmul_dynamic(
            xj, jnp.asarray(w), jnp.asarray(ws),
            None if b is None else jnp.asarray(b))
        yt = P.int8_matmul_dynamic(xt, _t(w), _t(ws),
                                   None if b is None else _t(b))
        assert yt.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(yj), yt.float().numpy())


def test_int8_mm_exact_where_f32_rounds():
    """At K 14336 the int32 sums pass 2^24: the port's product is exact,
    an f32 product of the same int8 values is not."""
    rng = np.random.RandomState(1)
    a = np.full((3, 14336), 127, np.int8)
    a[1] = rng.randint(-128, 128, 14336)
    b = rng.randint(-128, 128, size=(16, 14336)).astype(np.int8)
    b[0] = 127
    ref = a.astype(np.int64) @ b.astype(np.int64).T
    got = P.int8_mm(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert abs(ref).max() > 2 ** 24


def test_int8_matmul_static_bit_for_bit():
    rng = np.random.RandomState(2)
    xj, xt = _bf16_pair(rng, (6, 128))
    w = rng.randint(-127, 128, size=(48, 128)).astype(np.int8)
    ws = (rng.rand(48) * 0.01).astype(np.float32)
    xs = np.float32(0.021)
    yj = J.int8_matmul_static(xj, jnp.asarray(w), jnp.asarray(ws),
                              jnp.asarray(xs))
    yt = P.int8_matmul_static(xt, _t(w), _t(ws), torch.tensor(xs))
    np.testing.assert_array_equal(_np(yj), yt.float().numpy())


def test_quantize_act_fp8_block_bit_for_bit():
    rng = np.random.RandomState(3)
    xj, xt = _bf16_pair(rng, (4, 384), 5.0)
    qj, sj = J.quantize_act_fp8_block(xj)
    qt, st = P.quantize_act_fp8_block(xt)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(_np(qj), qt.float().numpy())


def _fp8_weight(rng, N, K):
    w = (rng.randn(N, K) * 0.1).astype(np.float32)
    w8 = torch.from_numpy(w).to(torch.float8_e4m3fn)
    return jnp.asarray(w8.float().numpy()).astype(jnp.float8_e4m3fn), w8


def test_fp8_matmul_block_dynamic_close():
    """bf16 products of the same dequantized operands, f32 sums in another
    order, one bf16 rounding: within one bf16 ulp of max|y|."""
    from lightcompress_tpu.quant import weight_cast_to_fp8 as jcast

    rng = np.random.RandomState(4)
    xj, xt = _bf16_pair(rng, (3, 256))
    w = (rng.randn(256, 256) * 0.05).astype(np.float32)
    wq, ws = jcast(jnp.asarray(w), 128)
    yj = _np(J.fp8_matmul_block_dynamic(xj, wq, ws, 128))
    yt = P.fp8_matmul_block_dynamic(
        xt, torch.from_numpy(_np(wq)).to(torch.float8_e4m3fn),
        _t(np.asarray(ws)), 128).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(yj).max())) - 7)
    assert np.abs(yj - yt).max() <= ulp


@pytest.mark.parametrize("block", [0, 128])
def test_fp8_matmul_both_branches(block):
    """JAX's dequantize-to-bf16 branch (its CPU branch) against the port's
    on the same inputs (one bf16 rounding apart), and the port's native
    fp8 branch, forced, within the e4m3 act quant's error of the f32
    reference (the check ``tests/test_eval_extras.py`` makes)."""
    rng = np.random.RandomState(5 + block)
    N, K = 256, 256
    wj, wt = _fp8_weight(rng, N, K)
    xj, xt = _bf16_pair(rng, (2, K))
    if block:
        ws = (rng.rand(N // block, K // block) + 0.5).astype(np.float32)
    else:
        ws = (rng.rand(N) + 0.5).astype(np.float32)
    yj = _np(J.fp8_matmul(xj, wj, jnp.asarray(ws), block_size=block))
    yt = P.fp8_matmul(xt, wt, _t(ws), block_size=block).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(yj).max())) - 7)
    assert np.abs(yj - yt).max() <= ulp
    if block:
        return
    # the native branch, as a card with fp8 tensor cores takes it
    P_has = P.has_fp8
    try:
        P.has_fp8 = lambda dev: True
        yn = P.fp8_matmul(xt, wt, _t(ws)).float().numpy()
    finally:
        P.has_fp8 = P_has
    ref = (xt.float().numpy() @ wt.float().numpy().T) * ws
    np.testing.assert_allclose(yn, ref, atol=0.15, rtol=0.1)


def test_exact_int_bmm_equals_jax_int32_dots():
    """Both dots of int8_decode_attention: the port's f64 product equals
    JAX's int32 dot_general bit for bit at S 4096 (sums past 2^24)."""
    rng = np.random.RandomState(6)
    p8 = rng.randint(0, 128, size=(2, 2, 4, 4096)).astype(np.int8)
    p8[0, 0, 0] = 127
    v8 = rng.randint(-128, 128, size=(2, 2, 4096, 16)).astype(np.int8)
    v8[0, 0, :, 0] = 127
    jx = jax.lax.dot_general(jnp.asarray(p8), jnp.asarray(v8),
                             (((3,), (2,)), ((0, 1), (0, 1))),
                             preferred_element_type=jnp.int32)
    got = P._exact_int_bmm(_t(p8).float(), _t(v8).float())
    np.testing.assert_array_equal(np.asarray(jx), got.numpy())
    assert np.abs(np.asarray(jx)).max() > 2 ** 24


def test_int8_decode_attention_matches_jax():
    """Same q codes, same int32 dots (above); the f32 softmax and its
    probability scale differ by ulps between the packages, which can move
    a p8 code by one step: the context within 1e-4 of its max."""
    rng = np.random.RandomState(7)
    B, K, G, S, D = 2, 2, 4, 64, 32
    q = rng.randn(B, K, G, D).astype(np.float32)
    k8 = rng.randint(-127, 128, size=(B, K, S, D)).astype(np.int8)
    v8 = rng.randint(-127, 128, size=(B, K, S, D)).astype(np.int8)
    ks = (rng.rand(B, K, S) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.rand(B, K, S) * 0.02 + 0.001).astype(np.float32)
    yj = np.asarray(J.int8_decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks), jnp.asarray(v8),
        jnp.asarray(vs)))
    yt = P.int8_decode_attention(_t(q), _t(k8), _t(ks), _t(v8),
                                 _t(vs)).numpy()
    assert yt.shape == (B, K, G, D) and yt.dtype == np.float32
    assert np.abs(yj - yt).max() <= 1e-4 * np.abs(yj).max()
