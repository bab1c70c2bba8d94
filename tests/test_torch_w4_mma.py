"""The int8 tensor-core tile of #9 and #12 (``ops/csrc/w4_mma.cuh``) in
torch on the CPU: its order of float operations and its operand mapping,
held to the plain versions before the card runs the kernels.

* #9 keeps expert_rows_plain's float order bit for bit while it walks
  stages of plane pairs (planes 2b, 2b + 1 of word block gi), takes the
  group dot's f32 through the bits 0x4B400000 + d, keeps the row sums as
  int16, and sums the zero correction after the stages with fused
  multiply-adds (its products are exact).  The rendering
  below runs that schedule and must equal the plain version bit for bit.
* The B operand: #9's byte gather (byte permutes of four words, then the
  low and the high nibbles) must give planes 2b .. 2b + 3 at four
  consecutive k; #12's sign-extended low and high nibbles of one word must
  give groups 2p and 2p + 1 at four consecutive k.
* #12 takes the tile from ``BYTES_TILE_MIN_M`` rows on, by M alone.

The kernels themselves run in ``tests/test_torch_cuda_kernels.py`` (on the
card)."""

import numpy as np
import pytest
import torch

from lightcompress_tpu_torch.ops import moe_matmul as tm
from lightcompress_tpu_torch.ops import w4_matmul as W
from test_torch_serving import one_torch_thread  # noqa: F401


def _experts(E, N, K, seed):
    """Random stacked planes experts with asymmetric bf16 s and zs, and
    int8 rows with f32 scales, from numpy."""
    rng = np.random.RandomState(seed)
    G = K // 128
    u = torch.from_numpy(rng.randint(0, 16, (E, N, K)).astype(np.int32))
    wp = torch.stack([W.pack_int4_planes(u[e]) for e in range(E)])
    s = torch.from_numpy((rng.rand(E, N, G) * 0.02 + 1e-3)
                         .astype(np.float32)).to(torch.bfloat16)
    zs = torch.from_numpy((rng.rand(E, N, G) * 0.15)
                          .astype(np.float32)).to(torch.bfloat16)
    return wp, s, zs


def _rows(M, K, seed):
    rng = np.random.RandomState(seed)
    xq = torch.from_numpy(rng.randint(-127, 128, (M, K)).astype(np.int8))
    xs = torch.from_numpy((rng.rand(M, 1) * 0.05 + 1e-3).astype(np.float32))
    return xq, xs


def _exact_f32(d: torch.Tensor) -> torch.Tensor:
    """The kernels' int32 -> f32: the float of bits 0x4B400000 + d, less
    1.5 * 2^23."""
    return (d.to(torch.int32) + 0x4B400000).view(torch.float32) \
        - torch.tensor(12582912.0)


def _tile_order_rows(xq, x_scale, wp, s, zs):
    """#9's schedule for one expert: stages (gi, b), planes 2b and 2b + 1
    into accumulators (2b) % 4 and (2b + 1) % 4; the row sums kept as
    int16; the zero correction summed after the stages in (gi, j) order;
    then ((a0 + a1) + (a2 + a3) - corr) * xscale."""
    M, K = xq.shape
    N, G = s.shape
    gpp, kp = G // 8, K // 8
    u = W.unpack_int4_planes(wp, K).reshape(N, 8, kp)  # [n][plane][word]
    sf, zf = s.float(), zs.float()
    acc = [torch.zeros((M, N)) for _ in range(4)]
    xsum = {}
    for gi in range(gpp):
        for b in range(4):
            for h in range(2):
                j = 2 * b + h
                g = j * gpp + gi
                xg = xq[:, j * kp + gi * 128:j * kp + gi * 128 + 128]
                wg = u[:, j, gi * 128:gi * 128 + 128]
                d = torch.matmul(xg.long(), wg.long().t())  # exact
                xsum[g] = xg.long().sum(-1).to(torch.int16)
                acc[j % 4] = acc[j % 4] + _exact_f32(d) * sf[:, g]
    corr = torch.zeros((M, N))
    for gi in range(gpp):
        for j in range(8):
            g = j * gpp + gi
            prod = xsum[g].float()[:, None] * zf[:, g]
            # exact, so the kernel's fused multiply-add rounds as this does
            assert torch.equal(prod.double(),
                               xsum[g].double()[:, None] * zf[:, g].double())
            corr = corr + prod
    return ((acc[0] + acc[1]) + (acc[2] + acc[3]) - corr) * x_scale


@pytest.mark.parametrize("K", [1024, 2048])
def test_tile_order_equals_plain(K):
    """The kernel's schedule gives expert_rows_plain's bits, per expert
    and through the grouped plain version (E 2, N 128, 64-row segments,
    the zero padding row included)."""
    E, N = 2, 128
    wp, s, zs = _experts(E, N, K, seed=K)
    xq, xs = _rows(128, K, seed=K + 1)
    xq[-3:] = 0
    xs[-3:] = 1.0
    for e in range(E):
        got = _tile_order_rows(xq, xs, wp[e], s[e], zs[e])
        ref = tm.expert_rows_plain(xq, xs, wp[e], s[e], zs[e])
        assert torch.equal(got, ref)
    be = torch.tensor([1, 0], dtype=torch.int32)
    grouped = tm.w4a8_grouped_matmul(xq, xs, wp, s, zs, be, m_tile=64)
    assert torch.equal(grouped[:64], _tile_order_rows(
        xq[:64], xs[:64], wp[1], s[1], zs[1]))
    assert torch.equal(grouped[64:], _tile_order_rows(
        xq[64:], xs[64:], wp[0], s[0], zs[0]))
    assert bool((grouped[-3:] == 0).all())


def test_exact_f32_covers_group_dots():
    """0x4B400000 + d is exact for |d| < 2^22; a group dot is at most
    128 * 127 * 15 = 243840 in magnitude (unsigned codes) or 128 * 127 * 8
    (signed)."""
    d = torch.arange(-(1 << 22) + 1, 1 << 22, dtype=torch.int32)
    assert torch.equal(_exact_f32(d), d.float())
    assert 128 * 127 * 15 < 1 << 22


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s): byte i of the result is byte
    (s >> 4i) & 7 of the eight bytes y:x (x the low four)."""
    b = np.stack([(v >> (8 * k)) & 0xFF for v in (x, y) for k in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= b[(sel >> (4 * i)) & 7] << (8 * i)
    return out


@pytest.mark.parametrize("b", [0, 2])
def test_plane_gather(b):
    """#9's unpack at stage b (0 or 2): bytes b and b + 1 of words
    kw..kw+3 (two byte permutes with selector b | (b + 4) << 4 | (b + 1)
    << 8 | (b + 5) << 12, then 0x5410 and 0x7632); their low and high
    nibbles are planes 2b .. 2b + 3 at k = kw..kw+3 of the group."""
    rng = np.random.RandomState(b)
    N, K = 4, 1024
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wp = W.pack_int4_planes(u).numpy().view(np.uint32).astype(np.int64)
    kp = K // 8
    sel = b | ((b + 4) << 4) | ((b + 1) << 8) | ((b + 5) << 12)
    for kw in range(0, kp, 4):
        w = [wp[:, kw + e] for e in range(4)]
        t0, t1 = _byte_perm(w[0], w[1], sel), _byte_perm(w[2], w[3], sel)
        for i, v in enumerate((_byte_perm(t0, t1, 0x5410),
                               _byte_perm(t0, t1, 0x7632))):
            for h, nib in ((0, v & 0x0F0F0F0F), (1, (v >> 4) & 0x0F0F0F0F)):
                lanes = np.stack([(nib >> (8 * e)) & 0xFF for e in range(4)],
                                 1)
                j = 2 * b + 2 * i + h
                assert np.array_equal(lanes,
                                      u[:, j * kp + kw:j * kp + kw + 4])


def test_byte_pair_lanes():
    """#12's B operand: the word at byte p*128 + 4q of a row, its low
    nibbles sign-extended (sext_lo: ((n & 0xF) ^ 8) - 8 a byte) = the codes
    c' of group 2p at k = 4q..4q+3, its high ones = group 2p + 1's."""
    rng = np.random.RandomState(0)
    N, K = 4, 1024
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wb = W.pack_s4_pairs(u)
    c = W.unpack_s4_pairs(wb).numpy()
    words = wb.numpy().view(np.uint32).astype(np.int64)
    for p in range(K // 256):
        for q in range(32):
            w = words[:, p * 32 + q]
            for h in range(2):
                nib = (w >> (4 * h)) & 0x0F0F0F0F
                lanes = np.stack([(((nib >> (8 * e)) & 0xF) ^ 8) - 8
                                  for e in range(4)], 1)
                g = 2 * p + h
                k = g * 128 + 4 * q
                assert np.array_equal(lanes, c[:, k:k + 4])
                assert np.array_equal(lanes, u[:, k:k + 4].numpy() - 8)


@pytest.mark.parametrize("M", sorted({1, 8, W.BYTES_TILE_MIN_M - 1,
                                      W.BYTES_TILE_MIN_M, 256, 300}))
def test_bytes_body_by_m(M):
    """#12 takes its tile from BYTES_TILE_MIN_M rows on, its decode block
    below; on the CPU either is the plain version."""
    assert W.bytes_body(M) == ("tile" if M >= W.BYTES_TILE_MIN_M
                               else "decode")
    rng = np.random.RandomState(M)
    N, K = 64, 512
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wb = W.pack_s4_pairs(u)
    s = torch.from_numpy((rng.rand(N, K // 128) * 0.02)
                         .astype(np.float32)).to(torch.bfloat16)
    zs = torch.from_numpy((rng.rand(N, K // 128) * 0.1)
                          .astype(np.float32)).to(torch.bfloat16)
    xq, xs = _rows(M, K, seed=M + 7)
    assert torch.equal(W.w4a8_matmul_bytes(xq, xs, wb, s, zs),
                       W.w4a8_matmul_bytes_plain(xq, xs, wb, s, zs))


def test_grouped_plain_bad_expert_is_nan():
    """An expert id out of range gives NaN rows in the plain #9, as the
    kernel writes them; the other rows are unchanged."""
    E, N, K = 2, 128, 1024
    wp, s, zs = _experts(E, N, K, seed=5)
    xq, xs = _rows(192, K, seed=6)
    good = tm.w4a8_grouped_matmul(xq, xs, wp, s, zs,
                                  torch.tensor([0, 1, 0], dtype=torch.int32),
                                  m_tile=64)
    got = tm.w4a8_grouped_matmul(xq, xs, wp, s, zs,
                                 torch.tensor([0, 2, -1], dtype=torch.int32),
                                 m_tile=64)
    assert bool(torch.isnan(got[64:]).all())
    assert torch.equal(got[:64], good[:64])
