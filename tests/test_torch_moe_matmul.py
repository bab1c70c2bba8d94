"""Port parity: the stacked-expert quantization, the selection grouping and
the plain versions of the three MoE kernels (#6 ``w4a8_stacked_matmul``,
#8 ``w4a8_gathered_matmul``, #9 ``w4a8_grouped_matmul``) against the JAX
package, whose Pallas kernels run in interpret mode (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import quantized_model as jqm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import moe_matmul as tm
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import quantized_model as tqm
from test_torch_serving import one_torch_thread  # noqa: F401

G128 = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


def _w3(E, oc, ic, seed, dtype=jnp.bfloat16):
    rng = np.random.RandomState(seed)
    return jnp.asarray((rng.randn(E, oc, ic) * 0.05).astype(np.float32),
                       dtype)


def _to_port(qp):
    return convert.qlinear_from_numpy(
        np.asarray(qp.codes), np.asarray(qp.scales),
        None if qp.zeros is None else np.asarray(qp.zeros), None, qp.bits,
        qp.group_size, qp.layout, device="cpu")


def _jax_experts(E, N, K, seed, sym=False):
    """A JAX stacked_planes entry and its port conversion."""
    qp = jqm.quantize_linear_stacked(_w3(E, N, K, seed),
                                     JQuantSpec(**dict(G128, symmetric=sym)))
    assert qp.layout == "stacked_planes"
    return qp, _to_port(qp)


@pytest.mark.parametrize("E,oc,ic,sym,layout", [
    (4, 256, 1024, False, "stacked_planes"),
    (3, 128, 2048, True, "stacked_planes"),
    (4, 256, 768, False, "stacked"),    # ic % 1024: the int8 fallback
    (2, 192, 1024, False, "stacked"),   # oc % 128
])
def test_quantize_linear_stacked_matches_jax(E, oc, ic, sym, layout):
    """The port's own stacked quantization equals the converted JAX
    entry: the layout, the recorded bit width, codes bit for bit, s and
    zs (or the int8 scales) equal, and the dequantized experts equal."""
    w3 = _w3(E, oc, ic, seed=ic + oc)
    jqp = jqm.quantize_linear_stacked(w3, JQuantSpec(**dict(
        G128, symmetric=sym)))
    conv = _to_port(jqp)
    own = tqm.quantize_linear_stacked(
        convert.tensor_from_numpy(w3, "cpu"),
        QuantSpec(**dict(G128, symmetric=sym)))
    assert jqp.layout == conv.layout == own.layout == layout
    assert own.bits == conv.bits == jqp.bits == (4 if layout ==
                                                  "stacked_planes" else 8)
    np.testing.assert_array_equal(own.codes.numpy(), conv.codes.numpy())
    fields = ("scales", "zeros") if layout == "stacked_planes" \
        else ("scales",)
    for f in fields:
        a, b = getattr(own, f), getattr(conv, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    np.testing.assert_array_equal(
        tqm.dequant_weight_stacked(own, torch.float32).numpy(),
        np.asarray(jqm.dequant_weight_stacked(jqp, jnp.float32)))


def test_quantize_linear_stacked_rows_refused():
    """The int4 ``rows`` storage is ported (tests/test_torch_serving_w8.py);
    per-tensor stacked rows, which JAX's stacked dequant cannot reshape,
    are refused naming reference fault 3."""
    with pytest.raises(NotImplementedError, match="reference fault 3"):
        tqm.quantize_linear_stacked(
            torch.zeros(2, 128, 768),
            QuantSpec(**dict(G128, granularity="per_tensor", group_size=0)),
            layout="rows")


def _routing(n, top_k, E, seed, absent=()):
    """(n, top_k) distinct experts per token drawn from the seed, never
    one of ``absent``."""
    rng = np.random.RandomState(seed)
    live = [e for e in range(E) if e not in absent]
    return np.stack([rng.choice(live, top_k, replace=False)
                     for _ in range(n)]).astype(np.int32)


@pytest.mark.parametrize("n,top_k,E,m_tile,absent", [
    (37, 3, 5, 8, ()),           # the JAX invariants test's case
    (1024, 2, 8, 128, ()),       # a Mixtral prefill: 8 x 128 tokens
    (300, 2, 8, 128, (1, 6)),    # absent experts: padding-only blocks
    (1, 2, 8, 128, ()),
])
def test_moe_group_selections_matches_jax(n, top_k, E, m_tile, absent):
    topi = _routing(n, top_k, E, seed=n, absent=absent)
    want = jqm.moe_group_selections(jnp.asarray(topi), E, m_tile)
    got = tqm.moe_group_selections(torch.from_numpy(topi), E, m_tile)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _act(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale).astype(np.float32)


def _quant(x):
    xq, xs = jpm.quantize_act_per_token(jnp.asarray(x))
    return (xq, xs), (torch.from_numpy(np.array(xq)),
                      torch.from_numpy(np.array(xs)))


def _close(got, ref):
    """The plain versions run the TPU kernels' sequence of f32 ops; the
    interpret-mode kernels sum the zero correction as an f32 dot whose
    order XLA picks, so agreement is to a few f32 ulps of the largest
    output."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("pair,B,K,N", [(False, 5, 1024, 256),
                                        (True, 8, 2048, 128),
                                        (False, 8, 2048, 256),
                                        (False, 65, 1024, 128),
                                        (True, 65, 1024, 128),
                                        (False, 200, 1024, 128),
                                        (True, 200, 1024, 128)])
def test_stacked_plain_matches_pallas(pair, B, K, N):
    """Plain #6, which both of its bodies equal bit for bit, against the
    interpret kernel; B 65 and 200 leave a ragged last 64-row tile."""
    E = 4
    jqp, tqp = _jax_experts(E, N, K, seed=B + K)
    (jxq, jxs), (txq, txs) = _quant(_act((E * B if pair else B, K), 1))
    if pair:
        jxq, jxs = jxq.reshape(E, B, K), jxs.reshape(E, B, 1)
        txq, txs = txq.reshape(E, B, K), txs.reshape(E, B, 1)
    ref = jpm.w4a8_stacked_matmul(jxq, jxs, jqp.codes, jqp.scales,
                                  pair=pair, interpret=True)
    tm.reset_launch_counts()
    got = tm.w4a8_stacked_matmul(txq, txs, tqp.codes, tqp.scales, tqp.zeros,
                                 pair=pair)
    assert got.shape == (E, B, N) and tm.w4a8_stacked_matmul.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("d", [-1, 0, 1])
def test_stacked_body_by_rows(d):
    """#6 runs on the planes tile from STACKED_TILE_MIN_B rows on and on
    its decode block below, by B alone; on the CPU either way the plain
    version, one answer for both bodies."""
    B = tm.STACKED_TILE_MIN_B + d
    assert tm.stacked_body(B) == ("tile" if d >= 0 else "decode")
    assert tm.stacked_body(1) == "decode" and tm.stacked_body(256) == "tile"
    E, N, K = 2, 128, 1024
    _, tqp = _jax_experts(E, N, K, seed=13)
    _, (xq, xs) = _quant(_act((B, K), 6))
    args = (xq, xs, tqp.codes, tqp.scales, tqp.zeros)
    tm.reset_launch_counts()
    outs = [tm._w4a8_stacked_matmul(*args, False, body)
            for body in ("tile", "decode")]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], tm.w4a8_stacked_matmul(*args))
    assert tm.w4a8_stacked_matmul.launches == 0


def test_gathered_plain_matches_pallas():
    """Repeated experts and repeated tokens among the selections."""
    E, N, K, n = 4, 256, 1024, 4
    jqp, tqp = _jax_experts(E, N, K, seed=7)
    (jxq, jxs), (txq, txs) = _quant(_act((n, K), 2))
    e_idx = np.array([2, 0, 2, 3, 2, 1, 0, 2], np.int32)
    t_idx = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    ref = jpm.w4a8_gathered_matmul(jxq, jxs, jqp.codes, jqp.scales,
                                   jnp.asarray(e_idx), jnp.asarray(t_idx),
                                   interpret=True)
    got = tm.w4a8_gathered_matmul(txq, txs, tqp.codes, tqp.scales,
                                  tqp.zeros, torch.from_numpy(e_idx),
                                  torch.from_numpy(t_idx))
    assert got.shape == (8, N)
    _close(got, ref)


def gathered_tiles(e_idx, t_idx, E: int, n_rows: int,
                   rows: int = tm.GATHER_TILE_ROWS):
    """#8's grouping rendered on the CPU, as its blocks find it on the
    device (``gather_tile`` in ops/csrc/w4_planes_decode.cuh): the valid
    selections of each expert (both indices in range) ranked in selection
    order; the selection of every rank that is a multiple of ``rows`` leads
    a tile of the next ``rows`` ranks.  Returns ``(tiles, nan_rows)``:
    tiles as (leader, expert, x rows, output rows) in leader order, and the
    selections with an index out of range.  Every other selection's block
    does nothing."""
    e_idx, t_idx = e_idx.tolist(), t_idx.tolist()
    valid = [0 <= e < E and 0 <= t < n_rows for e, t in zip(e_idx, t_idx)]
    tiles, nan_rows = [], []
    for sel, e in enumerate(e_idx):
        if not valid[sel]:
            nan_rows.append(sel)
            continue
        members = [i for i in range(len(e_idx)) if valid[i] and e_idx[i] == e]
        rank = members.index(sel)
        if rank % rows == 0:
            mine = members[rank:rank + rows]
            tiles.append((sel, e, [t_idx[i] for i in mine], mine))
    return tiles, nan_rows


def _render_gathered(xq, xs, qp, e_idx, t_idx, rows):
    """#8's output from its grouping (``gathered_tiles``): each tile's rows
    through the expert's plain rows, NaN rows where an index is out of
    range; the tiles checked as the kernel forms them."""
    E, n = qp.codes.shape[0], xq.shape[0]
    tiles, nan_rows = gathered_tiles(e_idx, t_idx, E, n, rows)
    out = torch.full((e_idx.shape[0], qp.codes.shape[1]), float("nan"))
    seen = []
    for lead, e, xrows, orows in tiles:
        assert orows[0] == lead and 1 <= len(orows) <= rows
        assert all(int(e_idx[i]) == e for i in orows)
        assert [int(t_idx[i]) for i in orows] == xrows
        xr = torch.tensor(xrows)
        out[orows] = tm.expert_rows_plain(xq[xr], xs[xr], qp.codes[e],
                                          qp.scales[e], qp.zeros[e])
        seen += orows
    assert sorted(seen + nan_rows) == list(range(e_idx.shape[0]))
    # each distinct expert's weight once a tile of ``rows`` selections
    counts = torch.bincount(e_idx[seen].long(), minlength=E)
    assert len(tiles) == int((-(-counts // rows)).sum())
    return out


GATHER_CASES = [(n, pair, 16) for n in (1, 2, 3, 4) for pair in (False, True)]


@pytest.mark.parametrize("n,pair,rows", GATHER_CASES + [(4, False, 2),
                                                        (4, True, 3)])
def test_gathered_tiles_render_the_kernel(n, pair, rows):
    """#8's grouping rendered on the CPU: n tokens routed top-2 over 4
    experts (duplicate experts from n 3 on), the down's pair mode (t_idx =
    arange over n * 2 rows), and tiles of 2 or 3 rows (an expert over
    several tiles).  Bit for bit the plain version; to f32 ulps JAX's
    interpret-mode kernel."""
    E, N, K = 4, 256, 1024
    jqp, tqp = _jax_experts(E, N, K, seed=20 + n)
    e_idx = _routing(n, 2, E, seed=n + 7 * pair).reshape(-1)
    n_sel = e_idx.shape[0]
    t_idx = np.arange(n_sel) if pair else np.repeat(np.arange(n), 2)
    t_idx = t_idx.astype(np.int32)
    (jxq, jxs), (txq, txs) = _quant(_act((n_sel if pair else n, K), n))
    te, tt = torch.from_numpy(e_idx), torch.from_numpy(t_idx)
    got = _render_gathered(txq, txs, tqp, te, tt, rows)
    assert torch.equal(got, tm.w4a8_gathered_matmul_plain(
        txq, txs, tqp.codes, tqp.scales, tqp.zeros, te, tt))
    ref = jpm.w4a8_gathered_matmul(jxq, jxs, jqp.codes, jqp.scales,
                                   jnp.asarray(e_idx), jnp.asarray(t_idx),
                                   interpret=True)
    _close(got, ref)


def test_gathered_tiles_nan_rows():
    """Selections with an expert or a token out of range lead no tile and
    are NaN rows, in the rendering and in the plain version; the others
    keep their bits."""
    E, N, K, n = 4, 128, 1024, 3
    _, tqp = _jax_experts(E, N, K, seed=31)
    _, (xq, xs) = _quant(_act((n, K), 9))
    e_idx = torch.tensor([1, 4, 1, -1, 2, 1], dtype=torch.int32)
    t_idx = torch.tensor([0, 0, 3, 1, 2, 2], dtype=torch.int32)
    tiles, nan_rows = gathered_tiles(e_idx, t_idx, E, n)
    assert nan_rows == [1, 2, 3]
    assert [(lead, e) for lead, e, _, _ in tiles] == [(0, 1), (4, 2)]
    got = _render_gathered(xq, xs, tqp, e_idx, t_idx, 16)
    ref = tm.w4a8_gathered_matmul_plain(xq, xs, tqp.codes, tqp.scales,
                                        tqp.zeros, e_idx, t_idx)
    assert torch.equal(got.isnan(), ref.isnan())
    assert ref[nan_rows].isnan().all() and torch.isfinite(ref[[0, 4, 5]]).all()
    assert torch.equal(got[[0, 4, 5]], ref[[0, 4, 5]])


def test_grouped_plain_matches_pallas():
    """Rows grouped as moe_mlp_grouped groups them, with two experts
    absent (padding-only blocks) and the zero dummy row."""
    E, N, K, n, top_k = 4, 128, 1024, 40, 2
    jqp, tqp = _jax_experts(E, N, K, seed=9)
    topi = _routing(n, top_k, E, seed=3, absent=(1,))
    gr, _, be = jqm.moe_group_selections(jnp.asarray(topi), E, 128)
    x = np.concatenate([_act((n, K), 4), np.zeros((1, K), np.float32)])
    (jxq, jxs), (txq, txs) = _quant(x)
    jxs = jxs.at[n].set(1.0)
    txs[n] = 1.0
    gr = np.asarray(gr)
    ref = jpm.w4a8_grouped_matmul(jxq[gr], jxs[gr], jqp.codes, jqp.scales,
                                  be, m_tile=128, interpret=True)
    got = tm.w4a8_grouped_matmul(txq[gr], txs[gr], tqp.codes, tqp.scales,
                                 tqp.zeros, torch.from_numpy(np.asarray(be)))
    assert got.shape == (gr.shape[0], N)
    _close(got, ref)
    pad = torch.from_numpy(gr == n)
    assert bool((got[pad] == 0).all())


def test_plain_versions_agree_with_dequant():
    """#6, #8 and #9's plain versions against a matmul of the dequantized
    experts with the dequantized acts (independent of the kernel order):
    they differ by f32 rounding only."""
    E, N, K, B = 3, 128, 1024, 6
    _, tqp = _jax_experts(E, N, K, seed=11)
    _, (xq, xs) = _quant(_act((B, K), 5))
    w = tqm.dequant_weight_stacked(tqp, torch.float32)
    ref = torch.matmul(xq.float() * xs, w.transpose(1, 2))  # (E, B, N)
    args = (tqp.codes, tqp.scales, tqp.zeros)
    tol = 1e-5 * float(ref.abs().max())
    assert (tm.w4a8_stacked_matmul(xq, xs, *args) - ref).abs().max() < tol
    e_idx = torch.tensor([1, 2, 0, 1], dtype=torch.int32)
    t_idx = torch.tensor([0, 3, 5, 5], dtype=torch.int32)
    got = tm.w4a8_gathered_matmul(xq, xs, *args, e_idx, t_idx)
    want = ref[e_idx.long(), t_idx.long()]
    assert (got - want).abs().max() < tol
    block_eid = torch.tensor([2, 0], dtype=torch.int32)
    rows = torch.arange(256) % B
    got = tm.w4a8_grouped_matmul(xq[rows], xs[rows], *args, block_eid)
    want = ref[block_eid.long().repeat_interleave(128), rows]
    assert (got - want).abs().max() < tol


def test_wrappers_check_their_operands():
    E, N, K = 2, 128, 1024
    _, tqp = _jax_experts(E, N, K, seed=12)
    xq = torch.zeros((3, K), dtype=torch.int8)
    xs = torch.ones((3, 1))
    args = (tqp.codes, tqp.scales, tqp.zeros)
    with pytest.raises(ValueError):
        tm.w4a8_stacked_matmul(xq, xs, *args, pair=True)
    with pytest.raises(ValueError):
        tm.w4a8_stacked_matmul(xq[:, :512], xs, *args)
    with pytest.raises(ValueError):
        tm.w4a8_grouped_matmul(xq, xs, *args, torch.zeros(1))
    with pytest.raises(ValueError):
        tm.w4a8_gathered_matmul(xq, xs, *args, torch.zeros(2),
                                torch.zeros(3))
