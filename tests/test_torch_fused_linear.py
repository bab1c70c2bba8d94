"""Port parity: the s4 byte-pair layout and the plain versions of kernels
#12 (``w4a8_matmul_bytes``), #13 (``w4a8_linear_bytes_fused``) and #14
(``w4a8_linear_planes_fused``; #13 and #14 in their TPU kernels' float
orders) of lightcompress_tpu_torch against the JAX Pallas kernels run in
interpret mode (CPU).  The JAX weights reach the
port through ``convert.qlinear_from_numpy``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.ops import qlinear as jq
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.device import bf16_ulp
from lightcompress_tpu_torch.ops import qlinear as tq
from lightcompress_tpu_torch.ops import w4_matmul as tw
from lightcompress_tpu_torch.quant import QuantSpec

G128 = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)
EPS = 1e-5
# f32 outputs of the same exact integer dots, summed in another order
TOL = 1e-5
# bf16 outputs: one bf16 ulp at the largest |y|
TOL_BF16 = 2.0 ** -8
# the RMSNorm's sum of squares runs in another order than XLA's, which can
# move the rsqrt by an ulp and flip an act code at a rounding tie: at most
# one flip in a thousand codes, and then the output gate is a bf16 ulp
FLIPS_PER_CODE = 1e-3


def _jax_qp(N, K, seed, layout, sym=False):
    rng = np.random.RandomState(seed)
    w = (rng.randn(N, K) * 0.05).astype(np.float32)
    spec = JQuantSpec(**dict(G128, symmetric=sym))
    return w, jq.quantize_linear(jnp.asarray(w), spec, layout=layout)


def _to_port(qp):
    return convert.qlinear_from_numpy(
        np.asarray(qp.codes), np.asarray(qp.scales), np.asarray(qp.zeros),
        None, qp.bits, qp.group_size, qp.layout, device="cpu")


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_s4_pack_matches_jax():
    rng = np.random.RandomState(0)
    codes = rng.randint(0, 16, (256, 1024)).astype(np.int32)
    jb = np.asarray(jpm.pack_s4_pairs(jnp.asarray(codes), 128))
    tb = tw.pack_s4_pairs(torch.from_numpy(codes))
    assert tb.dtype == torch.int8
    np.testing.assert_array_equal(tb.numpy(), jb.reshape(256, 512))
    np.testing.assert_array_equal(tw.unpack_s4_pairs(tb).numpy(), codes - 8)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("N,K", [(256, 1024), (384, 1536)])
def test_s4_quantize_linear_matches_jax(N, K, sym):
    """The port's s4 build equals the converted JAX one (codes, bf16 s and
    zs bit for bit), and both dequantize to the same weight."""
    w, qp = _jax_qp(N, K, seed=1, layout="s4", sym=sym)
    assert qp.layout == "s4" and qp.codes.ndim == 3
    conv = _to_port(qp)
    own = tq.quantize_linear(torch.from_numpy(w),
                             QuantSpec(**dict(G128, symmetric=sym)),
                             layout="s4")
    assert (own.layout, own.tiled) == (conv.layout, conv.tiled) == ("s4",
                                                                    True)
    np.testing.assert_array_equal(own.codes.numpy(), conv.codes.numpy())
    for a, b in ((own.scales, conv.scales), (own.zeros, conv.zeros)):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    np.testing.assert_array_equal(
        tq.dequant_weight(own, torch.float32).numpy(),
        np.asarray(jq.dequant_weight(qp, jnp.float32)))


@pytest.mark.parametrize("N,K", [(256, 640), (200, 1024)])
def test_s4_falls_back_to_planes_like_jax(N, K):
    """K % 512 or N % 128 off: both packages build planes instead."""
    w, qp = _jax_qp(N, K, seed=2, layout="s4")
    own = tq.quantize_linear(torch.from_numpy(w), QuantSpec(**G128),
                             layout="s4")
    assert qp.layout == own.layout == "planes"
    assert own.tiled == (qp.codes.ndim == 4) == False  # noqa: E712
    conv = _to_port(qp)
    np.testing.assert_array_equal(own.codes.numpy(), conv.codes.numpy())
    np.testing.assert_array_equal(own.scales.numpy(), conv.scales.numpy())


def test_s4_symmetric_zero_correction():
    """Symmetric weights: the +8 offset folds into zs = (z - 8)*s, exactly
    zero, and #12 equals the bare scaled dot of the signed codes."""
    w, qp = _jax_qp(128, 512, seed=3, layout="s4", sym=True)
    p = _to_port(qp)
    assert not p.zeros.float().any()
    rng = np.random.RandomState(4)
    xq, xs = tw.quantize_act_per_token(torch.from_numpy(
        rng.randn(8, 512).astype(np.float32)))
    c = tw.unpack_s4_pairs(p.codes).float().reshape(128, 4, 128)
    ref = torch.einsum("mgk,ngk,ng->mn", xq.float().reshape(8, 4, 128), c,
                       p.scales.float()) * xs
    got = tw.w4a8_matmul_bytes(xq, xs, p.codes, p.scales, p.zeros)
    _close(got.numpy(), ref.numpy(), TOL)
    jy = jpm.w4a8_matmul_bytes(jnp.asarray(xq.numpy()),
                               jnp.asarray(xs.numpy()), qp.codes, qp.scales,
                               qp.zeros, interpret=True)
    _close(got.numpy(), np.asarray(jy), TOL)


@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("K", [512, 2048])
def test_w4a8_bytes_plain_matches_pallas(M, K):
    """#12 (f32 out, times the act scale) against the interpret kernel."""
    _, qp = _jax_qp(256, K, seed=5, layout="s4")
    rng = np.random.RandomState(6)
    xq, xs = jpm.quantize_act_per_token(jnp.asarray(
        rng.randn(M, K).astype(np.float32)))
    ref = np.asarray(jpm.w4a8_matmul_bytes(xq, xs, qp.codes, qp.scales,
                                           qp.zeros, interpret=True))
    p = _to_port(qp)
    got = tw.w4a8_matmul_bytes(torch.from_numpy(np.array(xq)),
                               torch.from_numpy(np.array(xs)), p.codes,
                               p.scales, p.zeros)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, TOL)


def _jax_act(x, rms):
    """The JAX kernels' prologue written in XLA: the act codes and scales
    they quantize to."""
    xf = jnp.asarray(x, jnp.float32)
    if rms:
        xf = xf * jax.lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + EPS)
    q, s = jpm.quantize_act_per_token(xf)
    return np.asarray(q), np.asarray(s)


FUSED = {
    # layout, K, the JAX kernel, the port wrapper
    "bytes": ("s4", 1536, jpm.w4a8_linear_bytes_fused,
              tw.w4a8_linear_bytes_fused),
    "planes": ("planes", 2048, jpm.w4a8_linear_planes_fused,
               tw.w4a8_linear_planes_fused),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("kernel", sorted(FUSED))
def test_fused_plain_matches_pallas(kernel, rms, dtype):
    """#13 and #14, the RMSNorm on and off: outputs in x's dtype within
    TOL (f32) or TOL_BF16 (bf16) of the interpret kernel, act codes equal
    to the JAX prologue's but for at most FLIPS_PER_CODE flips, act scales
    within an ulp of the rsqrt."""
    layout, K, jfn, tfn = FUSED[kernel]
    _, qp = _jax_qp(256, K, seed=7, layout=layout)
    rng = np.random.RandomState(8)
    x = jnp.asarray((rng.randn(8, K) * 3).astype(np.float32)).astype(dtype)
    xn = np.array(x.astype(jnp.float32))
    ref = jfn(x, qp.codes, qp.scales, qp.zeros, rms=rms, eps=EPS,
              interpret=True)
    assert ref.dtype == x.dtype
    p = _to_port(qp)
    tx = convert.tensor_from_numpy(x, "cpu")
    y, codes, scales = tw._fused_with_act(tfn, tx, p.codes, p.scales,
                                          p.zeros, rms=rms, eps=EPS)
    assert y.dtype == tx.dtype and y.shape == (8, 256)
    jcodes, jscales = _jax_act(xn, rms)
    flips = int((codes.numpy() != jcodes).sum())
    assert flips <= FLIPS_PER_CODE * jcodes.size
    np.testing.assert_allclose(scales.numpy(), jscales, rtol=2e-7, atol=0)
    tol = TOL if dtype == "float32" and not flips else TOL_BF16
    _close(y.float().numpy(), np.asarray(ref.astype(jnp.float32)), tol)
    # the wrapper returns the same y alone
    assert torch.equal(tfn(tx, p.codes, p.scales, p.zeros, rms=rms,
                           eps=EPS), y)


@pytest.mark.parametrize("M,route", [(8, "w4a8_matmul_bytes_plain"),
                                     (300, None)])
def test_s4_routes_like_jax(monkeypatch, M, route):
    """s4 at act_bits=8: #12 at M <= 256, dequant-then-matmul above (the
    JAX qlinear_xla); the planes kernels are not touched."""
    calls = []
    names = ("w4a8_matmul_bytes_plain", "w4a8_matmul_decode_plain",
             "w4a8_matmul_prefill_plain", "w4a16_matmul_plain")
    for name in names:
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _, qp = _jax_qp(256, 1024, seed=9, layout="s4")
    x = np.random.RandomState(10).randn(M, 1024).astype(np.float32)
    y = tq.qlinear_apply(torch.from_numpy(x), _to_port(qp), act_bits=8)
    assert calls == ([route] if route else [])
    if route is None:
        _close(y.numpy(), np.asarray(jq.qlinear_xla(jnp.asarray(x), qp)),
               TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("M", [1, 5, 8])
def test_bytes_fused_tpu_order_matches_pallas(M, rms, dtype):
    """Plain #13 in its TPU kernel's order (four accumulators by g % 4,
    the zero correction summed in order) against the interpret kernel at
    M 1, 5 and 8: f32 outputs within TOL (TOL_BF16 if an act code
    flipped), bf16 outputs within one bf16 ulp at the largest |y|
    (``bf16_ulp``: the interpret kernel's own prologue can flip an act
    code, which moves an output across a bf16 rounding boundary; TOL_BF16,
    2^-8 of max|y|, is below one ulp when max|y|'s mantissa exceeds 1);
    act codes the JAX prologue's but for FLIPS_PER_CODE flips; and the
    order function on the returned codes gives the returned y."""
    _, qp = _jax_qp(256, 2048, seed=11, layout="s4")
    rng = np.random.RandomState(12 + M)
    x = jnp.asarray((rng.randn(M, 2048) * 3).astype(np.float32)).astype(
        dtype)
    ref = jpm.w4a8_linear_bytes_fused(x, qp.codes, qp.scales, qp.zeros,
                                      rms=rms, eps=EPS, interpret=True)
    p = _to_port(qp)
    y, codes, scales = tw.w4a8_linear_bytes_fused_plain(
        convert.tensor_from_numpy(x, "cpu"), p.codes, p.scales, p.zeros,
        rms=rms, eps=EPS)
    jcodes, _ = _jax_act(np.array(x.astype(jnp.float32)), rms)
    flips = int((codes.numpy() != jcodes).sum())
    assert flips <= FLIPS_PER_CODE * jcodes.size
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        _close(y.numpy(), ref, TOL if not flips else TOL_BF16)
    else:
        np.testing.assert_allclose(y.float().numpy(), ref, rtol=0,
                                   atol=bf16_ulp(float(np.abs(ref).max())))
    assert y.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    np.testing.assert_array_equal(
        tw.w4a8_matmul_pairs_tpu_order(codes, scales, p.codes, p.scales,
                                       p.zeros).to(y.dtype).float().numpy(),
        y.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("M", [1, 5, 8])
def test_planes_fused_tpu_order_matches_pallas(M, rms, dtype):
    """Plain #14 in its TPU kernel's order (``_phase_dot``'s: the four
    accumulators, then each plane's zero correction in plane order:
    ``w4a8_rows_phase_dot``) against the interpret kernel at M 1, 5 and 8,
    gated as #13's (``test_bytes_fused_tpu_order_matches_pallas``): f32
    outputs within TOL (TOL_BF16 if an act code flipped), bf16 outputs
    within one bf16 ulp at the largest |y|; act codes the JAX prologue's
    but for FLIPS_PER_CODE flips; and the order function on the returned
    codes gives the returned y bit for bit."""
    _, qp = _jax_qp(256, 2048, seed=17, layout="planes")
    rng = np.random.RandomState(18 + M)
    x = jnp.asarray((rng.randn(M, 2048) * 3).astype(np.float32)).astype(
        dtype)
    ref = jpm.w4a8_linear_planes_fused(x, qp.codes, qp.scales, qp.zeros,
                                       rms=rms, eps=EPS, interpret=True)
    p = _to_port(qp)
    y, codes, scales = tw.w4a8_linear_planes_fused_plain(
        convert.tensor_from_numpy(x, "cpu"), p.codes, p.scales, p.zeros,
        rms=rms, eps=EPS)
    jcodes, _ = _jax_act(np.array(x.astype(jnp.float32)), rms)
    flips = int((codes.numpy() != jcodes).sum())
    assert flips <= FLIPS_PER_CODE * jcodes.size
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        _close(y.numpy(), ref, TOL if not flips else TOL_BF16)
    else:
        np.testing.assert_allclose(y.float().numpy(), ref, rtol=0,
                                   atol=bf16_ulp(float(np.abs(ref).max())))
    assert y.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    np.testing.assert_array_equal(
        tw.w4a8_rows_phase_dot(codes, scales, p.codes, p.scales,
                               p.zeros).to(y.dtype).float().numpy(),
        y.float().numpy())


@pytest.mark.parametrize("M,K", [(1, 512), (8, 4096), (33, 14336)])
def test_pairs_tpu_order_matches_grouped_order(M, K):
    """#13's order (``w4a8_matmul_pairs_tpu_order``) against #12's one
    accumulator (``_grouped``, ``w4a8_matmul_bytes_plain``) on the same
    codes: f32 sums of the same exact products in another order, within
    TOL."""
    _, qp = _jax_qp(128, K, seed=13, layout="s4")
    p = _to_port(qp)
    rng = np.random.RandomState(14)
    xq, xs = tw.quantize_act_per_token(torch.from_numpy(
        (rng.randn(M, K) * 3).astype(np.float32)))
    got = tw.w4a8_matmul_pairs_tpu_order(xq, xs, p.codes, p.scales, p.zeros)
    ref = tw.w4a8_matmul_bytes_plain(xq, xs, p.codes, p.scales, p.zeros)
    assert got.dtype == torch.float32 and got.shape == (M, 128)
    _close(got.numpy(), ref.numpy(), TOL)
