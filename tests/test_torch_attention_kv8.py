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
