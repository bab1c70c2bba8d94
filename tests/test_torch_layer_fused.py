"""Port parity: the plain versions of the fused layer tail of
lightcompress_tpu_torch (#15 ``w4a8_attn_tail_fused``, #16
``w4a8_layer_fused``) against the JAX Pallas kernels in interpret mode
(CPU), at the JAX tests' shapes (B 8, H 1024, I 2048) with random
per-group scales and zero points.  The JAX tiled weights reach the port
through ``convert.qlinear_from_numpy``."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import layer_fused as LF
from lightcompress_tpu_torch.ops import w4_matmul as W
from test_torch_serving import one_torch_thread  # noqa: F401

B, H, I, NQ, G128 = 8, 1024, 2048, 1536, 128
EPS = 1e-6
# bf16 outputs: one bf16 ulp at the largest |y|
TOL_BF16 = 2.0 ** -8
# the prologues' RMSNorm and amax run in another float order than XLA's,
# which can move a scale by an ulp and flip an act code at a rounding tie:
# at most one flip in a thousand codes per prologue
FLIPS_PER_CODE = 1e-3


def _linear(rng, oc, ic, nt):
    """A JAX tiled planes linear (codes (N/NT, gpp, NT, g), split bf16
    scale and premultiplied zero tiles), as the JAX tests make them, and
    the port's untiled (codes, s, zs)."""
    codes = jnp.asarray(rng.randint(0, 16, (oc, ic)), jnp.int32)
    s = jnp.asarray(rng.rand(oc, ic // G128) * 0.02 + 0.005, jnp.float32)
    z = jnp.asarray(rng.randint(0, 16, (oc, ic // G128)), jnp.float32)
    gpp = ic // 8 // G128
    wp = jpm.tile_packed(jpm.pack_int4_planes(codes), nt, G128)
    sr = jpm.tile_scales(s, nt, gpp).astype(jnp.bfloat16)
    zsr = jpm.tile_scales(z * s, nt, gpp).astype(jnp.bfloat16)
    qp = convert.qlinear_from_numpy(np.asarray(wp), np.asarray(sr),
                                    np.asarray(zsr), None, 4, G128, "planes",
                                    device="cpu")
    return (wp, sr, zsr), (qp.codes, qp.scales, qp.zeros)


def _case(seed, nxt):
    rng = np.random.RandomState(seed)
    lins = [_linear(rng, H, H, 256), _linear(rng, 2 * I, H, 512),
            _linear(rng, H, I, 256)]
    if nxt:
        lins.append(_linear(rng, NQ, H, 256))
    ctx = jnp.asarray(rng.randn(B, H), jnp.bfloat16)
    x = jnp.asarray(rng.randn(B, H), jnp.bfloat16)
    jw = [t for j, _ in lins for t in j]
    tw = [t for _, p in lins for t in p]
    return (ctx, x, jw), (convert.tensor_from_numpy(ctx, "cpu"),
                          convert.tensor_from_numpy(x, "cpu"), tw)


class _Ref:
    """A stand-in for a Pallas scratch ref: keeps what is stored."""

    def __setitem__(self, key, value):
        self.value = value


def _jax_prologue(src: torch.Tensor, rms: bool):
    """The JAX kernels' ``_qdq_prologue`` on the same f32 input: (codes,
    scales)."""
    xq, xs, xsum = _Ref(), _Ref(), _Ref()
    K = src.shape[1]
    jpm._qdq_prologue(jnp.asarray(src.float().numpy()), xq, xs, xsum,
                      src.shape[0], K // (8 * G128), G128, rms, EPS)
    return np.asarray(xq.value), np.asarray(xs.value)


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _check_prologues(srcs, acts):
    """Each prologue's codes against JAX's ``_qdq_prologue`` on the same
    input (ctx; rms(h); mid; rms(y)): at most FLIPS_PER_CODE flips, the act
    scales within an ulp of the rsqrt."""
    for i, (src, (codes, scales)) in enumerate(zip(srcs, acts)):
        jcodes, jscales = _jax_prologue(src, rms=i in (1, 3))
        flips = int((codes.numpy() != jcodes).sum())
        assert flips <= FLIPS_PER_CODE * jcodes.size, (i, flips)
        np.testing.assert_allclose(scales.numpy(), jscales, rtol=2e-7,
                                   atol=0)


def test_attn_tail_plain_matches_pallas(one_torch_thread):  # noqa: F811
    """#15: y in x's dtype within a bf16 ulp of the interpret kernel."""
    (ctx, x, jw), (tctx, tx, tw) = _case(7, False)
    ref = jpm.w4a8_attn_tail_fused(ctx, x, *jw, group=G128, eps=EPS,
                                   interpret=True)
    srcs = []
    y, q, acts = LF._plain(tctx, tx, tuple(tw[0:3]), tuple(tw[3:6]),
                           tuple(tw[6:9]), None, EPS, srcs)
    assert q is None and y.dtype == tx.dtype and y.shape == (B, H)
    _close(y, ref, TOL_BF16)
    _check_prologues(srcs, acts)
    # the wrapper on the CPU is the plain version
    assert torch.equal(LF.w4a8_attn_tail_fused(tctx, tx, *tw, eps=EPS), y)
    assert torch.equal(LF.w4a8_attn_tail_fused_plain(tctx, tx, *tw,
                                                     eps=EPS), y)


def test_layer_fused_plain_matches_pallas(one_torch_thread):  # noqa: F811
    """#16: y and the next block's qkv (from the f32 y) within a bf16 ulp
    of the interpret kernel; y equals #15's on the same inputs."""
    (ctx, x, jw), (tctx, tx, tw) = _case(9, True)
    ref_y, ref_q = jpm.w4a8_layer_fused(ctx, x, *jw, group=G128, eps=EPS,
                                        interpret=True)
    srcs = []
    y, q, acts = LF._plain(tctx, tx, tuple(tw[0:3]), tuple(tw[3:6]),
                           tuple(tw[6:9]), tuple(tw[9:12]), EPS, srcs)
    assert q.shape == (B, NQ) and q.dtype == tx.dtype
    _close(y, ref_y, TOL_BF16)
    _close(q, ref_q, TOL_BF16)
    assert len(acts) == 4
    _check_prologues(srcs, acts)
    y2, q2 = LF.w4a8_layer_fused(tctx, tx, *tw, eps=EPS)
    assert torch.equal(y2, y) and torch.equal(q2, q)
    assert torch.equal(LF.w4a8_attn_tail_fused(tctx, tx, *tw[:9], eps=EPS),
                       y)


def test_layer_fused_rejects_bad_shapes():
    (_, _, _), (tctx, tx, tw) = _case(11, False)
    with pytest.raises(ValueError):  # ctx and x differ
        LF.w4a8_attn_tail_fused(tctx[:, :512], tx, *tw)
    with pytest.raises(ValueError):  # down's K is not I
        LF.w4a8_attn_tail_fused(tctx, tx, *tw[:6], *tw[0:3])
    with pytest.raises(ValueError):  # o is not (H, H)
        LF.w4a8_attn_tail_fused(tctx, tx, *tw[3:6], *tw[3:6], *tw[6:9])
    assert [k.launches for k in LF.KERNELS] == [0, 0]


@pytest.mark.parametrize("N,K,M", [(256, 1024, 8), (256, 2048, 5),
                                   (512, 4096, 3)])
def test_phase_dot_plain_matches_pallas_bit_for_bit(N, K, M):
    """``w4a8_rows_phase_dot`` (each matmul phase of plain #15/#16) is the
    JAX kernels' ``_phase_dot`` order: the same f32 bits as ``_phase_dot``
    in an interpret-mode Pallas kernel, the act scale left at 1."""
    rng = np.random.RandomState(N + K + M)
    (wp, sr, zsr), (codes, s, zs) = _linear(rng, N, K, N)
    xq = jnp.asarray(rng.randint(-127, 128, (M, K)), jnp.int8)
    gpp = K // 8 // G128
    xsum = jnp.sum(xq.astype(jnp.int32).reshape(M, gpp * 8, G128),
                   axis=2).astype(jnp.float32)

    def kernel(xq_ref, xsum_ref, wp_ref, s_ref, zs_ref, o_ref):
        o_ref[:] = jpm._phase_dot(xq_ref, xsum_ref, wp_ref, s_ref, zs_ref,
                                  M, N, gpp, G128)

    ref = pl.pallas_call(kernel,
                         out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
                         interpret=True)(xq, xsum, wp, sr, zsr)
    got = W.w4a8_rows_phase_dot(torch.from_numpy(np.array(xq)),
                                torch.ones((M, 1)), codes, s, zs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nxt", [False, True])
def test_phase_times_reads_stamps(nxt):
    """``phase_times`` over a launch's stamps: each segment from block 0
    past the previous barrier to the last block's arrival, block 0's own
    arrival, the barrier after it, and the total."""
    segs = 8 if nxt else 6
    st = torch.zeros(33, dtype=torch.int64)
    t = 1000
    st[0] = t
    for s in range(segs):
        st[1 + 3 * s] = t + 1000 * (s + 1)        # block 0 arrives
        st[2 + 3 * s] = t + 1000 * (s + 1) + 500  # the last block
        st[3 + 3 * s] = t + 1000 * (s + 1) + 700  # block 0 past the barrier
        t += 1000 * (s + 1) + 700
    times = LF.phase_times(st, nxt)
    names = LF.SEGMENTS[:segs]
    for s, name in enumerate(names):
        assert times[f"{name}_us"] == (1000 * (s + 1) + 500) / 1e3
        assert times[f"{name}_block0_us"] == (1000 * (s + 1)) / 1e3
        if s + 1 < segs:
            assert times[f"{name}_barrier_us"] == 0.2
    assert f"{names[-1]}_barrier_us" not in times
    assert times["total_us"] == (int(st[3 * segs - 1]) - 1000) / 1e3
