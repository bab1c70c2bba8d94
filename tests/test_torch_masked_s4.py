"""Port parity: the masked-plane W4A16 kernel #4 (``w4a16_matmul_planes_
masked``) and the natural-order s4 W4A8 kernel #11 (``w4a8_matmul_s4_
bytes``): their packers bit for bit, their plain versions against the JAX
Pallas kernels in interpret mode, #4 against #1 on the same codes, and the
``convert`` readers of the JAX tiles (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import w4_matmul as tw

G = 128
# plain #4 and #11 against the interpret-mode kernels: the same exact group
# dots (bf16 x times codes*16^j in f32; int8 dots), the scaled groups summed
# in f32 in the same four accumulators, the correction's dot in another
# order: summation-order noise
TOL = 1e-5
# #4 against #1 on the same codes: the same products, but #4 multiplies by
# a pre-divided scale one ulp off 16^-j on planes 4-7 (JAX's exp2) and
# folds plane 7's -8 into the correction
TOL_VS_1 = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _codes(rng, N, K, plane7=None):
    codes = rng.randint(0, 16, (N, K)).astype(np.int32)
    if plane7 is not None:
        codes[:, 7 * K // 8:] = plane7
    return codes


@pytest.mark.parametrize("plane7", [None, 0, 15])
def test_masked_packers_bit_for_bit(plane7):
    rng = np.random.RandomState(0)
    N, K = 64, 2048
    codes = _codes(rng, N, K, plane7)
    scales = (rng.rand(N, K // G) * 0.02 + 0.005).astype(np.float32)
    zeros = rng.randint(0, 16, (N, K // G)).astype(np.float32)
    gpp = K // 8 // G
    want_wp = np.asarray(jpm.pack_int4_planes_masked(jnp.asarray(codes)))
    got_wp = tw.pack_int4_planes_masked(torch.from_numpy(codes))
    np.testing.assert_array_equal(got_wp.numpy(), want_wp)
    np.testing.assert_array_equal(
        tw.unpack_int4_planes_masked(got_wp, K).numpy(), codes)
    # the pre-division: JAX's tile_scales_masked untiled
    want_s = convert.untile_scales(convert.tensor_from_numpy(
        jpm.tile_scales_masked(jnp.asarray(scales), 32, gpp),
        "cpu")).numpy()
    got_s = tw.masked_scales(torch.from_numpy(scales))
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    want_zs = np.asarray(jpm.masked_zero_scales(
        jnp.asarray(zeros), jnp.asarray(scales), gpp))
    got_zs = tw.masked_zero_scales(torch.from_numpy(zeros),
                                   torch.from_numpy(scales))
    np.testing.assert_array_equal(got_zs.numpy(), want_zs)


def _masked_case(seed, B, N, K, plane7=None):
    rng = np.random.RandomState(seed)
    codes = _codes(rng, N, K, plane7)
    scales = (rng.rand(N, K // G) * 0.02 + 0.005).astype(np.float32)
    zeros = rng.randint(0, 16, (N, K // G)).astype(np.float32)
    x = rng.randn(B, K).astype(np.float32)
    return codes, scales, zeros, x


@pytest.mark.parametrize("plane7", [None, 0, 15])
@pytest.mark.parametrize("sdtype", ["f32", "bf16"])
def test_masked_plain_matches_interpret_kernel(plane7, sdtype):
    B, N, K = 8, 256, 2048
    codes, scales, zeros, x = _masked_case(1, B, N, K, plane7)
    gpp = K // 8 // G
    wp = jpm.pack_int4_planes_masked(jnp.asarray(codes))
    # the root bench's storage: tiled, pre-divided, f32 or bf16
    sd = jnp.bfloat16 if sdtype == "bf16" else jnp.float32
    s_t = jpm.tile_scales_masked(jnp.asarray(scales), 128, gpp).astype(sd)
    zs_t = jpm.tile_scales(jpm.masked_zero_scales(
        jnp.asarray(zeros), jnp.asarray(scales), gpp), 128, gpp).astype(sd)
    wp_t = jpm.tile_packed(wp, 128, G)
    ref = np.asarray(jpm.w4a16_matmul_planes_masked(
        jnp.asarray(x), wp_t, s_t, zs_t, group=G, interpret=True))
    qp = convert.qlinear_from_numpy(np.asarray(wp_t), np.asarray(s_t),
                                    np.asarray(zs_t), None, 4, G, "masked",
                                    device="cpu")
    assert qp.scales.dtype == (torch.bfloat16 if sdtype == "bf16"
                               else torch.float32)
    got = tw.w4a16_matmul_planes_masked(torch.from_numpy(x), qp.codes,
                                        qp.scales, qp.zeros)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    assert _rel(got.numpy(), ref) < TOL
    # the raw-scale entry of the JAX wrapper pre-divides the same way
    raw = np.asarray(jpm.w4a16_matmul_planes_masked(
        jnp.asarray(x), wp, jnp.asarray(scales),
        jpm.masked_zero_scales(jnp.asarray(zeros), jnp.asarray(scales), gpp),
        group=G, n_tile=128, interpret=True))
    if sdtype == "f32":
        assert _rel(got.numpy(), raw) < TOL


def test_masked_matches_planes_kernel_on_same_codes():
    """#4 and #1 compute the same product through different unpacks."""
    B, N, K = 8, 128, 4096
    codes, scales, zeros, x = _masked_case(2, B, N, K)
    c = torch.from_numpy(codes)
    s, z = torch.from_numpy(scales), torch.from_numpy(zeros)
    xt = torch.from_numpy(x)
    y4 = tw.w4a16_matmul_planes_masked(
        xt, tw.pack_int4_planes_masked(c), tw.masked_scales(s),
        tw.masked_zero_scales(z, s))
    y1 = tw.w4a16_matmul_plain(xt, tw.pack_int4_planes(c), s, z * s)
    assert _rel(y4.numpy(), y1.numpy()) < TOL_VS_1


def test_pack_s4_bytes_bit_for_bit():
    rng = np.random.RandomState(3)
    N, K = 256, 1024
    codes = rng.randint(0, 16, (N, K)).astype(np.int32)
    want = np.asarray(jpm.pack_s4_bytes(jnp.asarray(codes), 128))
    got = tw.pack_s4_bytes(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want.reshape(N, K // 2))
    np.testing.assert_array_equal(tw.unpack_s4_bytes(got).numpy(),
                                  codes - 8)


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("sdtype", ["f32", "bf16"])
def test_s4_plain_matches_interpret_kernel(M, sdtype):
    rng = np.random.RandomState(4 + M)
    N, K, NT = 256, 1024, 128
    codes = jnp.asarray(rng.randint(0, 16, (N, K)), jnp.int32)
    scales = (rng.rand(N, K // G) * 0.1).astype(np.float32)
    zeros = rng.randint(0, 16, (N, K // G)).astype(np.float32)
    sd = jnp.bfloat16 if sdtype == "bf16" else jnp.float32
    s_t = jpm.tile_scales_s4(jnp.asarray(scales), NT).astype(sd)
    zs_t = jpm.tile_scales_s4(jnp.asarray((zeros - 8.0) * scales),
                              NT).astype(sd)
    xq, xs = jpm.quantize_act_per_token(
        jnp.asarray(rng.randn(M, K).astype(np.float32)))
    wb = jpm.pack_s4_bytes(codes, NT)
    ref = np.asarray(jpm.w4a8_matmul_s4_bytes(xq, xs, wb, s_t, zs_t,
                                              group=G, n_tile=NT,
                                              interpret=True))
    twb, ts, tzs = convert.s4_bytes_from_numpy(np.asarray(wb),
                                               np.asarray(s_t),
                                               np.asarray(zs_t), "cpu")
    assert twb.shape == (N, K // 2) and ts.shape == (N, K // G)
    got = tw.w4a8_matmul_s4_bytes(convert.tensor_from_numpy(xq, "cpu"),
                                  convert.tensor_from_numpy(xs, "cpu"),
                                  twb, ts, tzs)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
def test_s4_plain_equals_pairs_tpu_order(M, sdtype):
    """Plain #11 on natural s4 bytes equals #13's TPU order
    (``w4a8_matmul_pairs_tpu_order``) on the same codes packed as byte
    pairs, bit for bit: both keep the four accumulators by g % 4 and sum
    the zero correction in ascending g."""
    rng = np.random.RandomState(M)
    N, K = 96, 1024
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    s = torch.from_numpy((rng.rand(N, K // G) * 0.02 + 0.005)
                         .astype(np.float32))
    z = torch.from_numpy(rng.randint(0, 16, (N, K // G)).astype(np.float32))
    sb, zb = s.to(sdtype), ((z - 8) * s).to(sdtype)
    xq, xs = tw.quantize_act_per_token(
        torch.from_numpy(rng.randn(M, K).astype(np.float32)))
    got = tw.w4a8_matmul_s4_plain(xq, xs, tw.pack_s4_bytes(u), sb, zb)
    want = tw.w4a8_matmul_pairs_tpu_order(xq, xs, tw.pack_s4_pairs(u), sb,
                                          zb)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("which", ["masked", "s4"])
def test_wrappers_refuse_k_off_the_group(which):
    x = torch.zeros((2, 1000))
    if which == "masked":
        with pytest.raises(ValueError):
            tw.w4a16_matmul_planes_masked(
                x, torch.zeros((32, 125), dtype=torch.int32),
                torch.zeros((32, 7)), torch.zeros((32, 7)))
    else:
        with pytest.raises(ValueError):
            tw.w4a8_matmul_s4_bytes(
                x.to(torch.int8), torch.ones((2, 1)),
                torch.zeros((32, 500), dtype=torch.int8),
                torch.zeros((32, 7)), torch.zeros((32, 7)))


def test_launch_counters_registered():
    assert tw.w4a16_matmul_planes_masked in tw.KERNELS
    assert tw.w4a8_matmul_s4_bytes in tw.KERNELS
    # the plain route on the CPU launches nothing
    tw.reset_launch_counts()
    x = torch.zeros((1, 1024))
    tw.w4a16_matmul_planes_masked(x, torch.zeros((32, 128),
                                                 dtype=torch.int32),
                                  torch.zeros((32, 8)), torch.zeros((32, 8)))
    assert tw.w4a16_matmul_planes_masked.launches == 0
