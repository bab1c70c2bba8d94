"""Port parity: plane packing, layout conversion, per-token act quant and
the plain versions of the three W4 kernels of lightcompress_tpu_torch
against the JAX Pallas kernels run in interpret mode (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import qlinear as jq
from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import qlinear as tq
from lightcompress_tpu_torch.ops import w4_matmul as tw
from lightcompress_tpu_torch.quant import QuantSpec

G128 = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


def _jax_qp(N, K, seed, scale_layout="split", sym=False):
    rng = np.random.RandomState(seed)
    w = (rng.randn(N, K) * 0.05).astype(np.float32)
    spec = JQuantSpec(**dict(G128, symmetric=sym))
    return w, jq.quantize_linear(jnp.asarray(w), spec, layout="planes",
                                 scale_layout=scale_layout)


def _to_port(qp):
    return convert.qlinear_from_numpy(
        np.asarray(qp.codes), np.asarray(qp.scales),
        None if qp.zeros is None else np.asarray(qp.zeros), None, qp.bits,
        qp.group_size, qp.layout, device="cpu")


def _bf16_exact(rng, shape):
    x = jnp.asarray(rng.randn(*shape).astype(np.float32))
    return np.array(x.astype(jnp.bfloat16).astype(jnp.float32))


def test_plane_pack_matches_jax():
    rng = np.random.RandomState(0)
    codes = rng.randint(0, 16, (16, 1024)).astype(np.int32)
    jp = np.asarray(jpm.pack_int4_planes(jnp.asarray(codes)))
    tp = tw.pack_int4_planes(torch.from_numpy(codes))
    np.testing.assert_array_equal(tp.numpy(), jp)
    back = tw.unpack_int4_planes(tp, 1024)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("scale_layout,sym", [("split", False),
                                              ("contig", False),
                                              ("split", True)])
def test_convert_dequant_matches_jax(scale_layout, sym):
    """The tiled codes, split scales and combined slab all convert back
    to weights equal to the JAX dequant."""
    _, qp = _jax_qp(256, 2048, seed=1, scale_layout=scale_layout, sym=sym)
    assert qp.codes.ndim == 4
    assert qp.scales.ndim == (3 if scale_layout == "contig" else 4)
    ref = np.asarray(jq.dequant_weight(qp, dtype=jnp.float32))
    got = tq.dequant_weight(_to_port(qp), torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sym", [False, True])
def test_quantize_linear_matches_converted(sym):
    """The port's own packing of a weight equals the converted JAX one."""
    w, qp = _jax_qp(256, 1024, seed=2, sym=sym)
    conv = _to_port(qp)
    own = tq.quantize_linear(torch.from_numpy(w),
                             QuantSpec(**dict(G128, symmetric=sym)))
    np.testing.assert_array_equal(own.codes.numpy(), conv.codes.numpy())
    for a, b in ((own.scales, conv.scales), (own.zeros, conv.zeros)):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_quantize_act_per_token_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(37, 1024) * 3).astype(np.float32)
    x[5] = 0.0  # the 1e-8 clamp
    jq8, js = jpm.quantize_act_per_token(jnp.asarray(x))
    tq8, ts = tw.quantize_act_per_token(torch.from_numpy(x))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _close(got, ref):
    # f32 outputs; the two sum the same exact products in another order
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("K", [1024, 2048])
def test_w4a16_plain_matches_pallas(M, K):
    _, qp = _jax_qp(256, K, seed=4)
    x = _bf16_exact(np.random.RandomState(5), (M, K))
    ref = np.asarray(jpm.w4a16_matmul_planes(
        jnp.asarray(x), qp.codes, qp.scales, qp.zeros, group=128,
        interpret=True))
    p = _to_port(qp)
    got = tw.w4a16_matmul(torch.from_numpy(x), p.codes, p.scales, p.zeros)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


@pytest.mark.parametrize("M", [1, 7, 32, 256])
@pytest.mark.parametrize("K", [1024, 2048])
def test_w4a8_decode_plain_matches_pallas(M, K):
    """Plain #2 in its TPU kernels' order (``w4a8_rows_tpu_order``) against
    the interpret kernel, M up to the decode regime's 256."""
    _, qp = _jax_qp(256, K, seed=6, scale_layout="contig")
    x = _bf16_exact(np.random.RandomState(7), (M, K))
    xq, xs = jpm.quantize_act_per_token(jnp.asarray(x))
    ref = np.asarray(jpm.w4a8_matmul_planes(
        xq, xs, qp.codes, qp.scales, None, group=128, interpret=True))
    p = _to_port(qp)
    got = tw.w4a8_matmul_decode(torch.from_numpy(np.array(xq)),
                                torch.from_numpy(np.array(xs)), p.codes,
                                p.scales, p.zeros)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("M", [1, 7, 64, 256, 300])
@pytest.mark.parametrize("K", [1024, 2048])
def test_decode_plain_equals_prefill_plain(M, K):
    """#2's two bodies agree: plain #2 equals plain #3 in f32 bit for bit,
    and #2 stored in bf16 equals plain #3's bf16 store."""
    p = _to_port(_jax_qp(256, K, seed=15)[1])
    args = (p.codes, p.scales, p.zeros)
    xq, xs = tw.quantize_act_per_token(torch.from_numpy(
        _bf16_exact(np.random.RandomState(16 + M), (M, K))))
    ref = tw.w4a8_matmul_prefill_plain(xq, xs, *args, torch.float32)
    got = tw.w4a8_matmul_decode_plain(xq, xs, *args)
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert torch.equal(tw.w4a8_matmul_decode(xq, xs, *args, torch.bfloat16),
                       tw.w4a8_matmul_prefill_plain(xq, xs, *args))


@pytest.mark.parametrize("K", [1024, 2048])
def test_w4a8_prefill_plain_matches_pallas(K):
    M = 300  # not a multiple of the TPU kernel's m_tile
    _, qp = _jax_qp(256, K, seed=8, scale_layout="contig")
    x = _bf16_exact(np.random.RandomState(9), (M, K))
    xq, xs = jpm.quantize_act_per_token(jnp.asarray(x))
    ref = np.asarray(jpm.w4a8_matmul_planes_mtiled(
        xq, xs, qp.codes, qp.scales, group=128, m_tile=128,
        out_dtype=jnp.float32, interpret=True))
    p = _to_port(qp)
    got = tw.w4a8_matmul_prefill(torch.from_numpy(np.array(xq)),
                                 torch.from_numpy(np.array(xs)), p.codes,
                                 p.scales, p.zeros, out_dtype=torch.float32)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("M", [256, 300])
def test_prefill_route_past_the_shared_row_sums(M):
    """At K 50176 (49 word blocks), past the K up to which the planes tile
    keeps its row sums in shared memory, the port routes a planes linear
    as JAX's ``w4a8_prefill_available`` does: to the W4A8 prefill kernel
    at M 300 (which takes any K % 1024 on the card), not at M 256."""
    K = 50176
    assert K > tw.ROWSUM_SMEM_K_MAX
    _, qp = _jax_qp(128, K, seed=14)
    x = np.zeros((M, K), dtype=np.float32)
    want = jpm.w4a8_prefill_available(jnp.asarray(x), qp)
    assert want == (M > 256)
    assert tw.w4a8_prefill_available(torch.from_numpy(x), _to_port(qp)) \
        == want


PLAINS = ("w4a16_matmul_plain", "w4a8_matmul_decode_plain",
          "w4a8_matmul_prefill_plain")


@pytest.mark.parametrize("M,act_bits,route", [
    (8, 16, "w4a16_matmul_plain"), (8, 8, "w4a8_matmul_decode_plain"),
    (300, 8, "w4a8_matmul_prefill_plain"), (300, 16, None)])
def test_qlinear_apply_routes_like_jax(monkeypatch, M, act_bits, route):
    """The JAX routing rules (M <= 256 decode kernels, M > 256 the W4A8
    prefill kernel or dequant-then-matmul at act_bits=16); on the CPU the
    chosen wrapper runs its plain version and launches nothing."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in PLAINS:
        monkeypatch.setattr(tw, name, spy(name, getattr(tw, name)))
    _, qp = _jax_qp(256, 1024, seed=10)
    x = torch.from_numpy(_bf16_exact(np.random.RandomState(11), (M, 1024)))
    tw.reset_launch_counts()
    y = tq.qlinear_apply(x, _to_port(qp), act_bits=act_bits)
    assert y.shape == (M, 256) and y.dtype == x.dtype
    assert calls[:1] == ([route] if route else [])
    assert all(k.launches == 0 for k in tw.KERNELS)


def test_w4a16_prefill_goes_to_dequant_matmul():
    """act_bits=16 at M > 256 takes dequant-then-matmul, as JAX's
    qlinear_xla does."""
    _, qp = _jax_qp(256, 1024, seed=12)
    x = _bf16_exact(np.random.RandomState(13), (300, 1024))
    ref = np.asarray(jq.qlinear_xla(jnp.asarray(x), qp))
    got = tq.qlinear_apply(torch.from_numpy(x), _to_port(qp), act_bits=16)
    _close(got.numpy(), ref)
