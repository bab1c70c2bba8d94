"""Port parity: the plain versions of the Qwen3-MoE slice's two kernels,
#10 ``w8a8_grouped_matmul`` (the grouped route's int8 per-channel expert
down projection) and #7 ``w4a8_stacked_matmul_smallm`` (the small-M
stacked route), against the JAX package, whose Pallas kernels run in
interpret mode (CPU); and the stacked linear's choice between #6 and #7
against JAX's ``LCTPU_MOE_SMALLM``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import quantized_model as jqm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import moe_matmul as tm
from lightcompress_tpu_torch.serving import quantized_model as tqm
from test_torch_moe_matmul import _act, _quant, _w3

G128 = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


def _experts(E, N, K, seed, sym=False):
    """A JAX stacked entry (planes where the shape fits, else int8) and
    its port conversion."""
    qp = jqm.quantize_linear_stacked(_w3(E, N, K, seed),
                                     JQuantSpec(**dict(G128, symmetric=sym)))
    return qp, convert.qlinear_from_numpy(
        np.asarray(qp.codes), np.asarray(qp.scales),
        None if qp.zeros is None else np.asarray(qp.zeros), None, qp.bits,
        qp.group_size, qp.layout, device="cpu")


def _grouped_rows(n, top_k, E, K, seed, absent=()):
    """x rows of n tokens gathered into the grouping of a seeded routing
    (as moe_mlp_grouped gathers them: the zero dummy row with scale 1 for
    padding), with the grouping."""
    rng = np.random.RandomState(seed)
    live = [e for e in range(E) if e not in absent]
    topi = np.stack([rng.choice(live, top_k, replace=False)
                     for _ in range(n)]).astype(np.int32)
    gr, _, be = jqm.moe_group_selections(jnp.asarray(topi), E, 128)
    gr = np.asarray(gr)
    x = np.concatenate([_act((n, K), seed + 1), np.zeros((1, K), np.float32)])
    (jxq, jxs), (txq, txs) = _quant(x)
    jxs = jxs.at[n].set(1.0)
    txs[n] = 1.0
    return (jxq[gr], jxs[gr]), (txq[gr], txs[gr]), be, gr == n


# ---------------------------------------------------------------------------
# #10 w8a8_grouped_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,N,K,n,top_k,absent", [
    (4, 256, 768, 40, 2, (1,)),     # Qwen3-30B-A3B's down K; padding blocks
    (8, 128, 384, 100, 2, ()),      # the small test models' down K
    (3, 384, 1536, 9, 1, (0, 2)),   # a DeepSeek-V2 down K, one live expert
])
def test_w8a8_grouped_plain_matches_pallas(E, N, K, n, top_k, absent):
    """Bit for bit: an exact integer dot, then JAX's two f32 products in
    its order; padding-only blocks give 0."""
    jqp, tqp = _experts(E, N, K, seed=N + K)
    assert jqp.layout == tqp.layout == "stacked" and tqp.bits == 8
    (jxq, jxs), (txq, txs), be, pad = _grouped_rows(n, top_k, E, K, seed=n,
                                                    absent=absent)
    ref = jpm.w8a8_grouped_matmul(jxq, jxs, jqp.codes, jqp.scales, be,
                                  m_tile=128, interpret=True)
    tm.reset_launch_counts()
    got = tm.w8a8_grouped_matmul(txq, txs, tqp.codes, tqp.scales,
                                 torch.from_numpy(np.asarray(be)))
    assert tm.w8a8_grouped_matmul.launches == 0
    assert got.shape == (pad.shape[0], N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool((got[torch.from_numpy(pad)] == 0).all())


@pytest.mark.parametrize("N", [200, 77])
def test_w8a8_grouped_plain_at_ragged_n(N):
    """N not a multiple of 128 (the JAX kernel assumes one, so a dequant
    matmul is the oracle): each row against its expert's dequantized
    weight in float64, to f32 rounding."""
    E, K = 4, 768
    _, tqp = _experts(E, N, K, seed=N)
    _, (xq, xs), be, _ = _grouped_rows(30, 2, E, K, seed=3)
    be = torch.from_numpy(np.asarray(be))
    got = tm.w8a8_grouped_matmul(xq, xs, tqp.codes, tqp.scales, be)
    w = tqp.codes.double() * tqp.scales.double()  # (E, N, K)
    e = be.long().repeat_interleave(128)
    ref = torch.einsum("rk,rnk->rn", xq.double() * xs.double(), w[e])
    assert got.shape == (xq.shape[0], N)
    tol = 1e-6 * float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= tol


def test_w8a8_grouped_plain_nan_for_bad_expert_id():
    E, N, K = 2, 128, 256
    _, tqp = _experts(E, N, K, seed=1)
    xq = torch.ones((256, K), dtype=torch.int8)
    xs = torch.ones((256, 1))
    got = tm.w8a8_grouped_matmul(xq, xs, tqp.codes, tqp.scales,
                                 torch.tensor([1, 5], dtype=torch.int32))
    assert bool(torch.isfinite(got[:128]).all())
    assert bool(torch.isnan(got[128:]).all())


def test_w8a8_grouped_checks_its_operands():
    E, N, K = 2, 128, 768
    _, tqp = _experts(E, N, K, seed=2)
    xq = torch.zeros((256, K), dtype=torch.int8)
    xs = torch.ones((256, 1))
    be = torch.zeros(2, dtype=torch.int32)
    args = (tqp.codes, tqp.scales)
    with pytest.raises(ValueError):  # K mismatch
        tm.w8a8_grouped_matmul(xq[:, :512], xs, *args, be)
    with pytest.raises(ValueError):  # Mp not a multiple of m_tile
        tm.w8a8_grouped_matmul(xq[:200], xs[:200], *args, be)
    with pytest.raises(ValueError):  # block_eid of the wrong length
        tm.w8a8_grouped_matmul(xq, xs, *args, be[:1])
    with pytest.raises(ValueError):  # W4 codes are not int8 experts
        tm.w8a8_grouped_matmul(xq, xs, tqp.codes.int(), tqp.scales, be)
    with pytest.raises(ValueError):  # scales per group, not per channel
        tm.w8a8_grouped_matmul(xq, xs, tqp.codes,
                               tqp.scales.expand(E, N, 2), be)


# ---------------------------------------------------------------------------
# #7 w4a8_stacked_matmul_smallm
# ---------------------------------------------------------------------------

def _close(got, ref, rel=1e-5):
    """#7 sums its bf16 block dots in f32 in other orders than the
    interpret-mode kernel's XLA dot: 1e-5 of the largest output."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("pair,B,E,N,K", [
    (False, 8, 4, 384, 1024),   # Qwen3-MoE's gate/up shape class, small
    (False, 3, 3, 128, 2048),   # B padded to 8 inside the JAX kernel
    (True, 8, 4, 128, 2048),    # pair mode: the down projection
])
def test_smallm_plain_matches_pallas(pair, B, E, N, K):
    jqp, tqp = _experts(E, N, K, seed=B + N + K)
    assert tqp.layout == "stacked_planes"
    (jxq, jxs), (txq, txs) = _quant(_act((E * B if pair else B, K), 7, 2.0))
    if pair:
        jxq, jxs = jxq.reshape(E, B, K), jxs.reshape(E, B, 1)
        txq, txs = txq.reshape(E, B, K), txs.reshape(E, B, 1)
    ref = jpm.w4a8_stacked_matmul_smallm(jxq, jxs, jqp.codes, jqp.scales,
                                         pair=pair, interpret=True)
    tm.reset_launch_counts()
    got = tm.w4a8_stacked_matmul_smallm(txq, txs, tqp.codes, tqp.scales,
                                        tqp.zeros, pair=pair)
    assert all(k.launches == 0 for k in tm.KERNELS)
    _close(got, ref)


def test_smallm_plain_rounds_weights_to_bf16():
    """#7 rounds u * s to bf16 where #6 keeps the f32 product: on scales
    whose products need more than bf16's 8 bits the two differ, and #7
    equals an f64 dot of x with the bf16-rounded weights."""
    E, N, K, B = 2, 128, 1024, 4
    _, tqp = _experts(E, N, K, seed=5)
    _, (xq, xs) = _quant(_act((B, K), 9))
    args = (tqp.codes, tqp.scales, tqp.zeros)
    y7 = tm.w4a8_stacked_matmul_smallm(xq, xs, *args)
    y6 = tm.w4a8_stacked_matmul(xq, xs, *args)
    assert not torch.equal(y6, y7)
    from lightcompress_tpu_torch.ops.w4_matmul import unpack_int4_planes
    u = torch.stack([unpack_int4_planes(c, K) for c in tqp.codes]).double()
    s = tqp.scales.double().repeat_interleave(128, dim=-1)
    zs = tqp.zeros.double().repeat_interleave(128, dim=-1)
    wb = (u * s).to(torch.bfloat16).double()
    ref = (torch.einsum("bk,enk->ebn", xq.double(), wb)
           - torch.einsum("bk,enk->ebn", xq.double(), zs)) * xs.double()
    tol = 1e-6 * float(ref.abs().max())
    assert float((y7.double() - ref).abs().max()) <= tol


@pytest.mark.parametrize("smallm,n,pair", [(8, 8, False), (8, 9, False),
                                           (0, 4, False), (16, 5, True)])
def test_apply_qlinear_stacked_smallm_matches_jax(monkeypatch, smallm, n,
                                                  pair):
    """The stacked linear picks #7 at n <= smallm and #6 above, in pair
    mode too, as JAX's ``apply_qlinear_stacked`` under
    ``LCTPU_MOE_SMALLM``; outputs to 1e-5 of the largest."""
    E, N, K = 4, 128, 1024
    jqp, tqp = _experts(E, N, K, seed=n)
    x = _act((E, n, K) if pair else (n, K), 11, 0.5)
    monkeypatch.setenv("LCTPU_MOE_SMALLM", str(smallm))
    ref = jqm.apply_qlinear_stacked(jqp, jnp.asarray(x, jnp.bfloat16),
                                    pair=pair, interpret=True)
    tm.reset_launch_counts()
    calls = []
    for name in ("w4a8_stacked_matmul_plain",
                 "w4a8_stacked_matmul_smallm_plain"):
        def spy(*a, _fn=getattr(tm, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tm, name, spy)
    got = tqm.apply_qlinear_stacked(
        tqp, torch.from_numpy(x).to(torch.bfloat16), pair=pair,
        smallm=smallm)
    want = ("w4a8_stacked_matmul_smallm_plain" if n <= smallm
            else "w4a8_stacked_matmul_plain")
    assert calls == [want]
    _close(got, ref)


def test_smallm_checks_its_operands():
    E, N, K = 2, 128, 1024
    _, tqp = _experts(E, N, K, seed=12)
    xq = torch.zeros((3, K), dtype=torch.int8)
    xs = torch.ones((3, 1))
    args = (tqp.codes, tqp.scales, tqp.zeros)
    with pytest.raises(ValueError):
        tm.w4a8_stacked_matmul_smallm(xq, xs, *args, pair=True)
    with pytest.raises(ValueError):
        tm.w4a8_stacked_matmul_smallm(xq[:, :512], xs, *args)
