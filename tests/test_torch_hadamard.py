"""Port parity: ``ops/hadamard.py`` against the JAX package's on the same
numpy inputs (CPU).  The ±1 matrices bit for bit at every K that
``get_hadK`` reaches for n up to 256 * 2^10 and at the dims of the loaded
families; the transforms bit for bit where they are add/sub stages, within
2e-6 of max|y| where a dense K x K factor sums in f32 (XLA's dot and
PyTorch's matmul add in other orders); the online rotations bit for bit
in bf16 (JAX rounds every stage and the scale to bf16, eager or jitted);
the randomised matrices from the same draw."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models.base import BaseModel as JBaseModel
from lightcompress_tpu.ops import hadamard as J
from lightcompress_tpu_torch.models.base import BaseModel
from lightcompress_tpu_torch.ops import hadamard as T
from test_torch_serving import one_torch_thread  # noqa: F401

# f32 dense-factor products: other summation orders, a few f32 ulps
TOL_DENSE = 2e-6
# hidden and intermediate sizes of the families the port loads (Llama-2,
# Llama-3, Mixtral, Qwen2/3, Qwen3-MoE, DeepSeek-V2-Lite, Mistral)
FAMILY_DIMS = (4096, 11008, 14336, 3584, 18944, 12288, 768, 1408, 5120,
               13824, 2048, 6144)


def test_every_reachable_K_is_bit_for_bit():
    reached = set()
    for n in range(1, 256 * 2 ** 10 + 1, 1):
        try:
            jm, jk = J.get_hadK(n)
        except ValueError:
            with pytest.raises(ValueError):
                T.get_hadK(n)
            continue
        tm, tk = T.get_hadK(n)
        assert tk == jk, n
        reached.add(jk)
    assert {12, 20, 28, 44, 108, 148, 156, 172} <= reached
    for K in sorted(reached):
        np.testing.assert_array_equal(T.hadamard_matrix_K(K),
                                      J.hadamard_matrix_K(K))


@pytest.mark.parametrize("n", FAMILY_DIMS)
def test_family_dims(n):
    jm, jk = J.get_hadK(n)
    tm, tk = T.get_hadK(n)
    assert tk == jk
    if jm is not None:
        np.testing.assert_array_equal(tm, jm)
        assert tm.dtype == jm.dtype == np.float32
    assert dict(zip((14336, 11008), (28, 172))).get(n, tk) == tk


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n", [2, 16, 128, 1024])
def test_fwht_and_pow2_hadU_bit_for_bit(n):
    x = _x((6, n))
    np.testing.assert_array_equal(T.fwht(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(J.fwht)(jnp.asarray(x))))
    np.testing.assert_array_equal(
        T.matmul_hadU(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(J.matmul_hadU)(jnp.asarray(x))))


@pytest.mark.parametrize("n", [384, 640, 896, 1408])
def test_dense_factor_hadU(n):
    x = _x((5, n), seed=n)
    want = np.asarray(jax.jit(J.matmul_hadU)(jnp.asarray(x)))
    got = T.matmul_hadU(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL_DENSE * np.abs(want).max()
    # orthonormal: the round trip of an f32 matrix
    H = T.matmul_hadU(torch.eye(n)).double()
    assert (H @ H.T - torch.eye(n, dtype=torch.float64)).abs().max() < 1e-5


@pytest.mark.parametrize("n", [128, 384, 896])
def test_bf16_hadU_bit_for_bit_eager_and_jitted(n):
    x = _x((8, n), seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    got = T.matmul_hadU(torch.from_numpy(x).bfloat16()).float().numpy()
    # eager JAX (op by op) too where the dense factor is small
    for f in ((J.matmul_hadU,) if n == 384 else ()) + (
            jax.jit(J.matmul_hadU),):
        np.testing.assert_array_equal(got,
                                      np.asarray(f(xj).astype(jnp.float32)))


@pytest.mark.parametrize("had_dim,output", [(-1, False), (-1, True),
                                             (32, True), (32, False)])
def test_apply_exact_had_to_linear(had_dim, output):
    W = _x((96, 128), seed=2) if output else _x((64, 384), seed=2)
    if had_dim > 0:
        W = _x((128, 64), seed=3)
    want = np.asarray(J.apply_exact_had_to_linear(jnp.asarray(W), had_dim,
                                                  output))
    got = T.apply_exact_had_to_linear(torch.from_numpy(W), had_dim,
                                      output).numpy()
    dense = had_dim == -1 and T.get_hadK(W.shape[0 if output else 1])[1] > 1
    if dense:
        assert np.abs(got - want).max() <= TOL_DENSE * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [128, 384])
def test_randomised_matrices_from_the_same_draw(n):
    key = jax.random.PRNGKey(7)
    signs = np.asarray(jax.random.rademacher(key, (n,), dtype=jnp.float32))
    want = np.asarray(J.random_hadamard_matrix(n, key))
    got = T.hadamard_from_signs(torch.from_numpy(signs)).numpy()
    tol = 0 if T.get_hadK(n)[1] == 1 else TOL_DENSE * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    g = np.asarray(jax.random.normal(key, (n, n), dtype=jnp.float32))
    wq = np.asarray(J.random_orthogonal_matrix(n, key))
    tq = T.orthogonal_from_gaussian(torch.from_numpy(g)).numpy()
    assert np.abs(tq - wq).max() < 1e-4
    # the port's own draws are orthogonal and seeded
    gen = torch.Generator().manual_seed(0)
    for Q in (T.random_hadamard_matrix(n, gen),
              T.random_orthogonal_matrix(n, gen)):
        Qd = Q.double()
        assert (Qd @ Qd.T - torch.eye(n, dtype=torch.float64)).abs().max() \
            < 1e-5
    a = T.random_hadamard_matrix(n, torch.Generator().manual_seed(3))
    b = T.random_hadamard_matrix(n, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode,dim,n", [("full", 0, 384), ("full", 0, 128),
                                        ("head", 32, 128)])
def test_online_rotation_bf16(mode, dim, n):
    """The model's online rotation of a bf16 activation, as the fake-quant
    linear applies it (eager and inside JAX's jitted forward)."""
    x = _x((2, 5, n), seed=4)
    jm = JBaseModel.__new__(JBaseModel)
    jm.rotate_cfg = {"mlp.down": (mode, dim)}
    tm = BaseModel.__new__(BaseModel)
    tm.rotate_cfg = {"mlp.down": (mode, dim)}
    got = tm.apply_online_rotate("mlp.down",
                                 torch.from_numpy(x).bfloat16())
    xj = jnp.asarray(x, jnp.bfloat16)
    for f in (lambda t: jm.apply_online_rotate("mlp.down", t),
              jax.jit(lambda t: jm.apply_online_rotate("mlp.down", t))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(f(xj).astype(jnp.float32)))
    # a linear without a rotation passes through
    y = torch.from_numpy(x)
    assert tm.apply_online_rotate("attn.q", y) is y
    assert math.isclose(float(got.float().pow(2).sum()),
                        float((torch.from_numpy(x) ** 2).sum()), rel_tol=2e-2)
