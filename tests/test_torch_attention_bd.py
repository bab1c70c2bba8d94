"""Port parity: the plain versions of the kv8 block-diagonal decode
attention kernels of lightcompress_tpu_torch (#18 ``decode_attention_bd``,
#19 ``decode_attention_bd_flash``) against lightcompress_tpu's, with the
Pallas kernels in interpret mode (CPU); and the merged context after
``bd_merge_new_token``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_attention as jpa
from lightcompress_tpu.serving import kv_cache as jkv
from lightcompress_tpu_torch.ops import attention as ta
from test_torch_attention import CTX_TOL, _bf16, _check_partials, _t
from test_torch_serving import one_torch_thread  # noqa: F401

H, D = 2, 128


def _grid_q(rng, B, G):
    """q (B, H, G, D) bf16 on the int8 grid: codes in [-127, 127] times
    2^-4, each row's largest |code| 127.  Its per-row scale amax/127 is
    2^-4 exactly, so q quantizes to the same codes however the division is
    taken.  (The jitted JAX wrappers quantize q under XLA's rewrite of
    ``qf / (amax / 127)``, which can land a code one step from the eager
    IEEE division that the port and JAX's own eager ``_quantize_q`` take:
    test_quantize_q_matches_jax_eager.)"""
    codes = rng.randint(-126, 127, (B, H, G, D))
    idx = rng.randint(0, D, (B, H, G))
    np.put_along_axis(codes, idx[..., None],
                      127 * rng.choice([-1, 1], (B, H, G, 1)), axis=-1)
    return jnp.asarray(codes * 2.0 ** -4, jnp.bfloat16)


def _bd_case(B, G, S, seed):
    """q (B, H, G, D) bf16 (``_grid_q``) and the kv8 bd slabs of random
    K/V: K feature-major (B, H*D, S), V time-major (B, S, H*D), bf16
    scales."""
    rng = np.random.RandomState(seed)
    q = _grid_q(rng, B, G)
    kq, ks = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, S, D) * 2,
                                         jnp.float32))
    vq, vs = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, S, D),
                                         jnp.float32))
    kt = kq.transpose(0, 1, 3, 2).reshape(B, H * D, S)
    vt = vq.transpose(0, 2, 1, 3).reshape(B, S, H * D)
    jargs = (q, kt, ks.astype(jnp.bfloat16), vt, vs.astype(jnp.bfloat16))
    targs = (_bf16(q), _t(kt), _bf16(jargs[2]), _t(vt), _bf16(jargs[4]))
    return jargs, targs


def _lengths(B, S, masked):
    """Lengths {0, partial, full} (cut to B), or None (every column)."""
    if not masked:
        return None, None
    lens = np.array([0, S // 3 + 5, S][:B], np.int32)
    return jnp.asarray(lens), torch.from_numpy(lens)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,G", [(2, 2), (3, 4)])
def test_bd_matches_jax(B, G, masked):
    S = 256
    jargs, targs = _bd_case(B, G, S, 10 + B + G)
    jl, tl = _lengths(B, S, masked)
    _check_partials(jpa.decode_attention_bd(*jargs, jl, interpret=True),
                    ta.decode_attention_bd(*targs, tl))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S,s_block", [(1024, 512), (256, 128)])
@pytest.mark.parametrize("B,G", [(2, 2), (3, 4)])
def test_bd_flash_matches_jax(B, G, S, s_block, masked):
    jargs, targs = _bd_case(B, G, S, 20 + B + G + S // 128)
    jl, tl = _lengths(B, S, masked)
    _check_partials(
        jpa.decode_attention_bd_flash(*jargs, jl, s_block=s_block,
                                      interpret=True),
        ta.decode_attention_bd_flash(*targs, tl, s_block=s_block))


def test_bd_flash_default_block_matches_jax():
    """Both wrappers' default column block (256) at S 512: two blocks, the
    second past one slot's length."""
    S = 512
    jargs, targs = _bd_case(3, 4, S, 30)
    lens = np.array([0, 300, 100], np.int32)
    _check_partials(
        jpa.decode_attention_bd_flash(*jargs, jnp.asarray(lens),
                                      interpret=True),
        ta.decode_attention_bd_flash(*targs, torch.from_numpy(lens)))


def sequence_plain(q, kt, ks, vt, vs, lengths, nib, s_block):
    """The flash recurrence over every block in one sequence, as plain #19
    and #21 ran it before their kernel split S over ranks."""
    B, Hh, G, Dd = q.shape
    S = kt.shape[2]
    sb = ta.flash_block(S, s_block)
    q8, qs = ta.quantize_q(q)
    qsc = qs * Dd ** -0.5
    kp, vp = ta._bd_planes(kt, vt, Hh, nib)
    L = ta._lengths(lengths, B, S, q.device)
    col = torch.arange(S)
    o = torch.zeros((B, Hh, G, Dd))
    m = torch.full((B, Hh, G), -1e30)
    d = torch.zeros((B, Hh, G))
    for s0 in range(0, S, sb):
        sl = slice(s0, s0 + sb)
        valid = (col[sl][None, :] < L[:, None])[:, None, None, :]
        m_new, e, ctx = ta._block_partials(
            q8, qsc, [k[..., sl] for k in kp], ks[..., sl],
            [v[:, :, sl] for v in vp], vs[..., sl], valid, m)
        alpha = torch.exp(m - m_new)
        o = o * alpha[..., None] + ctx
        d = d * alpha + e.sum(dim=-1)
        m = m_new
    return o, m, d


@pytest.mark.parametrize("parts", [2, 3, 6])
def test_bd_flash_parts_matches_jax(parts):
    """Plain #19 in its kernel's schedule (four 256-column blocks over
    ``parts`` ranks; 6: more ranks than blocks), ragged lengths with an
    empty slot, against the JAX kernel in interpret mode; m bit for bit
    the sequence's."""
    S, s_block = 1024, 256
    jargs, targs = _bd_case(3, 4, S, 70 + parts)
    lens = np.array([0, 300, S - 17], np.int32)
    got = ta.decode_attention_bd_flash_plain(
        *targs, torch.from_numpy(lens), s_block=s_block, parts=parts)
    _check_partials(
        jpa.decode_attention_bd_flash(*jargs, jnp.asarray(lens),
                                      s_block=s_block, interpret=True), got)
    seq = sequence_plain(*targs, torch.from_numpy(lens), False, s_block)
    assert torch.equal(got[1], seq[1])


@pytest.mark.parametrize("masked", [False, True])
def test_bd_flash_one_part_is_the_sequence(masked):
    """``parts`` = 1 (the CPU route) is the sequence of blocks bit for
    bit."""
    S = 1024
    _, targs = _bd_case(3, 2, S, 80)
    tl = torch.tensor([0, 700, S], dtype=torch.int32) if masked else None
    got = ta.decode_attention_bd_flash_plain(*targs, tl, s_block=256,
                                             parts=1)
    for a, b in zip(got, sequence_plain(*targs, tl, False, 256)):
        assert torch.equal(a, b)
    for a, b in zip(got, ta.decode_attention_bd_flash(*targs, tl,
                                                      s_block=256)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flash", [False, True])
def test_bd_merge_new_token_matches_jax(flash):
    """The merged, normalized context of the fresh int8 token and #18's
    (or #19's) partials, as the engine's bd/bds routes compute it."""
    S, B, G = 512, 3, 4
    jargs, targs = _bd_case(B, G, S, 40 + flash)
    lens = np.array([0, 200, S], np.int32)
    if flash:
        jq = jpa.decode_attention_bd_flash(*jargs, jnp.asarray(lens),
                                           s_block=128, interpret=True)
        tq = ta.decode_attention_bd_flash(*targs, torch.from_numpy(lens),
                                          s_block=128)
    else:
        jq = jpa.decode_attention_bd(*jargs, jnp.asarray(lens),
                                     interpret=True)
        tq = ta.decode_attention_bd(*targs, torch.from_numpy(lens))
    rng = np.random.RandomState(41)
    kn, kns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D),
                                          jnp.float32))
    vn, vns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D),
                                          jnp.float32))
    fresh = (kn[:, :, 0], vn[:, :, 0], kns[:, :, 0], vns[:, :, 0])
    jout = np.asarray(jpa.bd_merge_new_token(jargs[0], jq, *fresh,
                                             D ** -0.5))
    tout = ta.bd_merge_new_token(
        targs[0], tq, _t(fresh[0]), _t(fresh[1]), _bf16(fresh[2]),
        _bf16(fresh[3]), D ** -0.5).numpy()
    assert np.isfinite(tout).all()
    assert np.abs(tout - jout).max() <= CTX_TOL * np.abs(jout).max()


def test_quantize_q_matches_jax_eager():
    """The per-row int8 query of random bf16 q, bit for bit against JAX's
    ``_quantize_q`` run eagerly (IEEE division)."""
    rng = np.random.RandomState(60)
    q = jnp.asarray(rng.randn(4, H, 4, D) * 3, jnp.bfloat16)
    jq8, jqs = jpa._quantize_q(q)
    tq8, tqs = ta.quantize_q(_bf16(q))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))


def test_bd_whole_row_limit():
    """#18 splits S over a cluster of up to 8 CTAs, each keeping 4 * G + 2
    bytes of shared memory per column of its share: the wrapper's limit
    admits S 86016 at G 4 (the largest multiple of 16 whose share at 8
    parts fits in 227 KB) and S 44800 at G 8."""
    for G, S in ((4, 86016), (8, 44800)):
        per = ta.kv8_columns(S, ta.CLUSTER_PARTS[-1])
        assert ta.split_smem_bytes(G, per, 1) <= ta.SMEM_MAX
        assert ta.split_fits(G, S) and not ta.split_fits(G, S + 16)


def test_bd_shapes_checked():
    _, targs = _bd_case(2, 2, 64, 50)
    q, kt, ks, vt, vs = targs
    with pytest.raises(ValueError, match="bd slabs"):
        ta.decode_attention_bd(q, kt[:, :-1], ks, vt, vs)
    with pytest.raises(ValueError, match="bd slabs"):
        ta.decode_attention_bd_flash(q, kt, ks, vt[:, :, :-2], vs)
