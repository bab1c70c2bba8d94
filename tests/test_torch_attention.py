"""Port parity: the kv4 cache writers and the plain versions of the three
decode-attention kernels of lightcompress_tpu_torch (#17, #20, #21) against
lightcompress_tpu's, with the Pallas kernels in interpret mode (CPU)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_attention as jpa
from lightcompress_tpu.serving import kv_cache as jkv
from lightcompress_tpu.serving.engine import _append_slots as j_append_slots
from lightcompress_tpu.serving.engine import pick_attn_impl as j_pick
from lightcompress_tpu_torch.ops import attention as ta
from lightcompress_tpu_torch.serving import kv_cache as tkv
from lightcompress_tpu_torch.serving.engine import pick_attn_impl
from test_torch_serving import one_torch_thread  # noqa: F401

B, H, G, D = 3, 2, 4, 128


def _t(a):
    """A JAX array as a CPU tensor (bf16 kept as bf16)."""
    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


def test_quantize_kv4_matches_jax():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(3, 2, 9, D).astype(np.float32) * 3).astype(
        jnp.bfloat16)
    x = x.at[0, 0, 0].set(0.0)  # the 1e-6 clamp
    jq, js = jkv.quantize_kv4(x)
    tq, ts = tkv.quantize_kv4(_bf16(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    np.testing.assert_array_equal(tkv.unpack_kv4(tq).numpy(),
                                  np.asarray(jkv.unpack_kv4(jq)))


def _assert_cache_equal(jc, tc):
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(
            _t(getattr(jc, name)).numpy(),
            getattr(tc, name).float().numpy()
            if name.endswith("scale") else getattr(tc, name).numpy(),
            err_msg=name)


def test_bd4_cache_writes_match_jax():
    """The batched prefill write (with a padding row that repeats the last
    prompt into its slot, as the engine pads; rows of one slot that
    differ have no defined order in an index_put) and the one-token decode
    append (a slot at the buffer's end clamps) put the same bytes into the
    bd4 slabs."""
    L, S, T = 2, 3, 32
    rng = np.random.RandomState(1)
    jc = jkv.KVCache.create(L, S, H, T, D, bits=4, layout="bd4")
    tc = tkv.KVCache.create(L, S, H, T, D, bits=4, layout="bd4",
                            device="cpu")
    k = jnp.asarray(rng.randn(4, H, 7, D).astype(np.float32)).astype(
        jnp.bfloat16)
    v = jnp.asarray(rng.randn(4, H, 7, D).astype(np.float32)).astype(
        jnp.bfloat16)
    k, v = k.at[3].set(k[2]), v.at[3].set(v[2])
    slots = np.array([2, 0, 1, 1])
    jc = j_append_slots(jc, 1, jnp.asarray(slots), k, v)
    tkv.append_slots(tc, 1, torch.from_numpy(slots), _bf16(k), _bf16(v))
    _assert_cache_equal(jc, tc)
    kn = jnp.asarray(rng.randn(S, H, 1, D).astype(np.float32))
    vn = jnp.asarray(rng.randn(S, H, 1, D).astype(np.float32))
    lengths = np.array([7, 0, T])
    jc = jkv.append_kv4_bd(jc, 0, *jkv.quantize_kv4(kn), *jkv.quantize_kv4(vn),
                           jnp.asarray(lengths, jnp.int32))
    tkv.append_kv_bd(tc, 0, *tkv.quantize_kv4(_t(kn)),
                      *tkv.quantize_kv4(_t(vn)), torch.from_numpy(lengths))
    _assert_cache_equal(jc, tc)
    # read back: slot 2 holds prompt row 0 (codes times scales)
    kr, vr = tkv.read_kv_slot(tc, 1, 2)
    assert kr.shape == (1, H, T, D)
    step = _t(k[0]).abs().amax(-1, keepdim=True) / 7
    # half a step, plus the bf16 rounding of the scale and of the result
    assert ((kr[0, :, :7].float() - _t(k[0])).abs() <= step * 0.6).all()
    assert (vr[0, :, 7:] == 0).all()


def _bd4_case(S, seed):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(B, H, G, D), jnp.bfloat16)
    k4, ks = jkv.quantize_kv4(jnp.asarray(rng.randn(B, H, S, D) * 2,
                                          jnp.float32))
    v4, vs = jkv.quantize_kv4(jnp.asarray(rng.randn(B, H, S, D),
                                          jnp.float32))
    kt4 = k4.transpose(0, 1, 3, 2).reshape(B, H * D // 2, S)
    vt4 = v4.transpose(0, 2, 1, 3).reshape(B, S, H * D // 2)
    jargs = (q, kt4, ks.astype(jnp.bfloat16), vt4, vs.astype(jnp.bfloat16))
    targs = (_bf16(q), _t(kt4), _bf16(jargs[2]), _t(vt4), _bf16(jargs[4]))
    return jargs, targs


# observed worst normalized-context error over the bd4 cases: 2.2e-7 of
# max|ref| (the same int8 probability codes; the denominators sum in
# another order); the gate allows one flipped code
CTX_TOL = 2e-2


def _check_partials(jout, tout):
    (jc, jm, jd), (tc, tm, td) = [tuple(np.asarray(a, np.float64)
                                        for a in o) for o in (jout, tout)]
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    jn = jc / np.maximum(jd, 1e-30)[..., None]
    tn = tc / np.maximum(td, 1e-30)[..., None]
    assert np.abs(tn - jn).max() <= CTX_TOL * np.abs(jn).max()


@pytest.mark.parametrize("masked", [False, True])
def test_bd4_matches_jax(masked):
    S = 256
    jargs, targs = _bd4_case(S, 2)
    lengths = np.array([0, 37, S], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    _check_partials(jpa.decode_attention_bd4(*jargs, jl, interpret=True),
                    ta.decode_attention_bd4(*targs, tl))


@pytest.mark.parametrize("masked", [False, True])
def test_bd4_flash_matches_jax(masked):
    S = 256
    jargs, targs = _bd4_case(S, 3)
    lengths = np.array([0, 100, 193], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    _check_partials(
        jpa.decode_attention_bd4_flash(*jargs, jl, s_block=64,
                                       interpret=True),
        ta.decode_attention_bd4_flash(*targs, tl, s_block=64))


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_bd4_flash_parts_matches_jax(parts):
    """Plain #21 in its kernel's schedule (four 64-column blocks over
    ``parts`` ranks; 5: more ranks than blocks), ragged lengths with an
    empty slot, against the JAX kernel in interpret mode; ``parts`` 1 the
    sequence of blocks bit for bit.  q lies on the int8 grid (``_grid_q``:
    the jitted JAX wrapper quantizes it under XLA's rewrite of the
    division)."""
    from test_torch_attention_bd import _grid_q, sequence_plain

    S = 256
    jargs, targs = _bd4_case(S, 20 + parts)
    q = _grid_q(np.random.RandomState(30 + parts), B, G)
    jargs, targs = (q,) + jargs[1:], (_bf16(q),) + targs[1:]
    lengths = np.array([0, 100, 193], np.int32)
    tl = torch.from_numpy(lengths)
    got = ta.decode_attention_bd4_flash_plain(*targs, tl, s_block=64,
                                              parts=parts)
    _check_partials(
        jpa.decode_attention_bd4_flash(*jargs, jnp.asarray(lengths),
                                       s_block=64, interpret=True), got)
    seq = sequence_plain(*targs, tl, True, 64)
    assert torch.equal(got[1], seq[1])
    one = ta.decode_attention_bd4_flash_plain(*targs, tl, s_block=64)
    for a, b in zip(one, seq):
        assert torch.equal(a, b)


def test_i8_append_masked_matches_jax():
    S = 256
    rng = np.random.RandomState(4)
    q = jnp.asarray(rng.randn(B, H, G, D), jnp.bfloat16)
    kq, ks = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, S, D) * 2,
                                         jnp.float32))
    vq, vs = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, S, D),
                                         jnp.float32))
    kn, kns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D) * 2,
                                          jnp.float32))
    vn, vns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D),
                                          jnp.float32))
    lengths = np.array([0, 37, S], np.int32)
    jout = jpa.decode_attention_i8(
        q, kq, ks, vq, vs, kn[:, :, 0], kns[:, :, 0], vn[:, :, 0],
        vns[:, :, 0], lengths=jnp.asarray(lengths), h_block=2,
        interpret=True)
    tout = ta.decode_attention_i8(
        _bf16(q), _t(kq), _bf16(ks), _t(vq), _bf16(vs), _t(kn[:, :, 0]),
        _bf16(kns[:, :, 0]), _t(vn[:, :, 0]), _bf16(vns[:, :, 0]),
        torch.from_numpy(lengths))
    jo = np.asarray(jout)
    assert np.abs(tout.numpy() - jo).max() <= CTX_TOL * np.abs(jo).max()
    with pytest.raises(NotImplementedError):
        ta.decode_attention_i8(_bf16(q), _t(kq), _bf16(ks), _t(vq),
                               _bf16(vs))


def test_bd_merge_new_token_matches_jax():
    jargs, targs = _bd4_case(64, 5)
    lengths = np.array([0, 9, 64], np.int32)
    jq = jpa.decode_attention_bd4(*jargs, jnp.asarray(lengths),
                                  interpret=True)
    rng = np.random.RandomState(6)
    kn, kns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D),
                                          jnp.float32))
    vn, vns = jkv.quantize_kv(jnp.asarray(rng.randn(B, H, 1, D),
                                          jnp.float32))
    fresh = (kn[:, :, 0], vn[:, :, 0], kns[:, :, 0], vns[:, :, 0])
    jout = jpa.bd_merge_new_token(jargs[0], jq, *fresh, D ** -0.5)
    tout = ta.bd_merge_new_token(
        targs[0], tuple(_t(a) for a in jq), _t(fresh[0]), _t(fresh[1]),
        _bf16(fresh[2]), _bf16(fresh[3]), D ** -0.5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jout)).max())


@pytest.mark.parametrize("kv_bits", [4, 8, "auto"])
@pytest.mark.parametrize("max_len", [64, 4096, 8192])
def test_pick_attn_impl_matches_jax_on_tpu(kv_bits, max_len):
    assert pick_attn_impl(kv_bits) == \
        j_pick(kv_bits, max_len, False, SimpleNamespace(mla=None, moe=None),
               backend="tpu")
