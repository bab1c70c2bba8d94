"""Port parity: the plain version of the bench's int8 decode attention of
lightcompress_tpu_torch (#22 ``decode_attention_kv8``) against the JAX
Pallas kernel in interpret mode (CPU), at one column (S 1), odd S and
groups 1 and 4, with bf16 (the bench's) and f32 per-token scales."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_attention as jpa
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import attention as ta
from test_torch_serving import one_torch_thread  # noqa: F401

B, H, D = 4, 2, 128
# the scores and PV sum in f32 in another order than XLA's dots; where the
# last bit of a probability differs, pv = bf16(p * vs) can round one bf16
# step apart (2^-8 of that probability) and move the context by that times
# a code of at most 127: 1e-3 of the largest |ctx|
TOL = 1e-3


def _case(S, G, dtype, seed):
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(B, H, G, D), jnp.bfloat16)
    kq = jnp.asarray(rng.randint(-127, 128, (B, H, S, D)), jnp.int8)
    vq = jnp.asarray(rng.randint(-127, 128, (B, H, S, D)), jnp.int8)
    ks = jnp.asarray(rng.rand(B, H, S) * 0.02 + 1e-3, dtype)
    vs = jnp.asarray(rng.rand(B, H, S) * 0.02 + 1e-3, dtype)
    jargs = (q, kq, ks, vq, vs)
    return jargs, [convert.tensor_from_numpy(a, "cpu") for a in jargs]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [1, 17, 129])
def test_kv8_plain_matches_pallas(one_torch_thread, S, G,  # noqa: F811
                                  dtype):
    jargs, targs = _case(S, G, dtype, seed=S + G)
    ref = np.asarray(jpa.decode_attention_kv8(*jargs, interpret=True))
    got = ta.decode_attention_kv8(*targs)
    assert got.dtype == torch.float32 and got.shape == (B, H, G, D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))
    assert torch.equal(ta.decode_attention_kv8_plain(*targs), got)


def test_kv8_single_column_is_the_value_row():
    """S 1: the softmax is exactly 1, so ctx = bf16(vs) * v."""
    _, (q, kq, ks, vq, vs) = _case(1, 4, "bfloat16", seed=3)
    got = ta.decode_attention_kv8(q, kq, ks, vq, vs)
    want = vs.float()[..., None] * vq.float()  # (B, H, 1, D)
    torch.testing.assert_close(got, want.expand_as(got), rtol=0, atol=0)


def test_kv8_rejects_bad_shapes():
    _, (q, kq, ks, vq, vs) = _case(17, 4, "bfloat16", seed=5)
    with pytest.raises(ValueError):
        ta.decode_attention_kv8(q, kq, ks[..., :16], vq, vs)
    with pytest.raises(ValueError):
        ta.decode_attention_kv8(q, kq, ks, vq[:, :, :16], vs)
    assert ta.decode_attention_kv8.launches == 0


# ---------------------------------------------------------------------------
# the kernel's split schedule (a cluster of CTAs over S), rendered in torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [1, 3, 17, 129])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_kv8_split_schedule_matches_pallas(one_torch_thread,  # noqa: F811
                                           parts, S, G, dtype):
    """Each part's max and sum of exp merged in part order, then the parts'
    PV dots added in part order: within TOL of the Pallas kernel."""
    jargs, targs = _case(S, G, dtype, seed=7 * S + G + parts)
    ref = np.asarray(jpa.decode_attention_kv8(*jargs, interpret=True))
    got = ta.decode_attention_kv8_parts_plain(*targs, parts)
    assert got.dtype == torch.float32 and got.shape == (B, H, G, D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


def test_kv8_split_single_column_is_the_value_row():
    """S 1 over 4 parts (three empty): exactly bf16(vs) * v, as unsplit."""
    _, (q, kq, ks, vq, vs) = _case(1, 4, "bfloat16", seed=11)
    got = ta.decode_attention_kv8_parts_plain(q, kq, ks, vq, vs, 4)
    want = vs.float()[..., None] * vq.float()
    torch.testing.assert_close(got, want.expand_as(got), rtol=0, atol=0)


@pytest.mark.parametrize("S,parts,per", [(1, 4, 16), (17, 2, 16),
                                         (2049, 1, 2064), (2049, 2, 1040),
                                         (4097, 4, 1040), (4097, 8, 528)])
def test_kv8_columns(S, parts, per):
    """A part's columns: ceil(S / parts) rounded up to 16."""
    assert ta.kv8_columns(S, parts) == per
    assert ta.kv8_columns(S, parts) * parts >= S


def test_kv8_parts_least_waves_times_columns():
    """The split the wrapper picks from the card's co-resident clusters
    (here made up): fewer parts on a tie, the most that fit when none
    covers the pairs, and a ValueError past the shared memory of a CTA at
    the widest split."""
    card = {1: 264, 2: 132, 4: 62, 8: 45}.get  # the H100's at G 4, S 2049
    assert ta.kv8_parts(256, 2049, 4, card) == 1   # one wave of whole rows
    assert ta.kv8_parts(64, 2049, 4, card) == 2    # 8 slots: one wave
    assert ta.kv8_parts(32, 2049, 4, card) == 8    # 4 slots
    assert ta.kv8_parts(8, 2049, 4, card) == 8
    # a split that does not fit one wave costs its waves
    assert ta.kv8_parts(64, 4097, 4, {1: 132, 2: 132, 4: 62, 8: 30}.get) == 2
    # S past one CTA's shared memory undivided: the split that fits
    assert ta.kv8_smem_bytes(4, 40000, 1) > ta.SMEM_MAX
    assert ta.kv8_parts(256, 40000, 4, card) > 1
    S_max = 81280
    assert ta.kv8_smem_bytes(4, S_max) <= ta.SMEM_MAX < \
        ta.kv8_smem_bytes(4, S_max + 1)
    with pytest.raises(ValueError):
        ta.kv8_parts(1, S_max + 1, 4, card)
