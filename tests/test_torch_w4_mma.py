"""The int8 tensor-core tiles of ``ops/csrc/w4_mma.cuh`` in torch on the
CPU: their order of float operations and their operand mappings, held to
the plain versions before the card runs the kernels.

* The planes tile of #3 and #9 (``w4_planes_wgmma.cuh``) keeps the TPU
  kernels' float order (``w4a8_rows_tpu_order``) bit for bit while it walks
  stages of plane pairs (planes 2b, 2b + 1 of word block gi), takes the
  group dot's f32 through the bits 0x4B400000 + d, keeps the row sums as
  int16, and sums the zero correction after the stages with fused
  multiply-adds (its products are exact).  The rendering below runs that
  schedule and must equal plain #9 and plain #3 (dense rows, a ragged M,
  f32 and bf16) bit for bit.
* The B operand: the planes byte gather (byte permutes of four words, then
  the low and the high nibbles) must give planes 2b .. 2b + 3 at four
  consecutive k; #12's sign-extended low and high nibbles of one word must
  give groups 2p and 2p + 1 at four consecutive k.
* #5's decode tile: the lane loads and unpack that make the m16n8k32 B
  fragments, and the ldmatrix A fragments, must assemble x . u^T; its
  schedule (four accumulators over a half, the halves added in either
  order) must equal plain #5 bit for bit.
* #12 takes the tile from ``BYTES_TILE_MIN_M`` rows on, by M alone.
* #6 on the planes tile: the stacked row mappings (block x = expert
  x / T, row tile x % T; shared or per-expert x rows; a tile's rows past B
  computed, never stored) give plain #6 bit for bit.
* #13's decode tile: codes from rint(v * (1/sc)), divided only near a
  tie, equal rint(v / sc); its schedule (warps by the group of a pair,
  accumulators a_h and a_{h+2}, the correction in order) equals
  ``w4a8_matmul_pairs_tpu_order`` bit for bit.
* #2 and #14's planes decode tile (``csrc/w4_matmul.cu``): warps by
  plane class q of Q (planes j = q mod Q, whole accumulators a_r, r = q
  mod Q), their accumulators met through shared memory, the zero
  corrections of every group in the epilogue, one sum (#2) or one a plane
  (#14), row chunks of MT rows: ``w4a8_rows_tpu_order`` and
  ``w4a8_rows_phase_dot`` bit for bit.  #2 takes #3's planes tile from
  ``PLANES_TILE_MIN_M`` rows on, by M alone, at the same bits.
* #1 and #4's bf16 tile (``csrc/w4a16_tile.cu``): the shared-memory
  layouts, the lane reads and the unpack to bf16 codes make m16n8k16 A
  and B fragments that assemble x . c^T for every plane, on plain and on
  masked words.  #7 runs the same tile (``csrc/w4_moe.cu``) on int8 x
  staged into the same bf16 slab.
* #11's int8 decode tile (``csrc/w4_bytes.cu``): natural s4 words as B
  (low nibbles the even k, high the odd), x's evens and odds as A,
  assemble each group's dot; its schedule (stages of four groups, warp h
  holding a_h and a_{h+2}, groups past G none, the correction rounded
  product by product) equals plain #11 bit for bit.

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


def _expert_rows_pr9(xq, x_scale, wp, s, zs):
    """plain #9's expert rows as they were before plain #3 took the same
    order (kept here to show the bits did not move)."""
    M, K = xq.shape
    N, G = s.shape
    gpp = G // 8
    xg = xq.float().reshape(M, G, K // G)
    ug = W.unpack_int4_planes(wp, K).float().reshape(N, G, K // G)
    xsum = xg.sum(dim=-1)
    sf, zf = s.float(), zs.float()
    acc = [torch.zeros((M, N)) for _ in range(4)]
    corr = torch.zeros((M, N))
    for gi in range(gpp):
        for j in range(8):
            gg = j * gpp + gi
            dot = torch.matmul(xg[:, gg], ug[:, gg].t())
            acc[j % 4] = acc[j % 4] + dot * sf[:, gg]
            corr = corr + xsum[:, gg, None] * zf[:, gg]
    return ((acc[0] + acc[1]) + (acc[2] + acc[3]) - corr) * x_scale.float()


@pytest.mark.parametrize("K,M", [(1024, 100), (1024, 300), (4096, 100),
                                 (14336, 100)])
def test_dense_tile_order_equals_plain_prefill(K, M):
    """#3 on the planes tile: dense rows, one expert; the last row tile is
    ragged (TMA fills rows past M with zeros, the stores are masked).  The
    schedule over the zero-padded tiles, cut to M rows, equals plain #3 bit
    for bit in f32 and in bf16; plain #9's expert rows (the same function)
    keep their earlier bits."""
    N = 64
    wp, s, zs = (t[0] for t in _experts(1, N, K, seed=K + M))
    xq, xs = _rows(M, K, seed=K + M + 1)
    Mp = -(-M // 64) * 64
    xpad = torch.cat([xq, xq.new_zeros((Mp - M, K))])
    spad = torch.cat([xs, xs.new_ones((Mp - M, 1))])
    got = _tile_order_rows(xpad, spad, wp, s, zs)[:M]
    ref = W.w4a8_matmul_prefill_plain(xq, xs, wp, s, zs, torch.float32)
    assert torch.equal(got, ref)
    assert torch.equal(got.to(torch.bfloat16),
                       W.w4a8_matmul_prefill_plain(xq, xs, wp, s, zs))
    assert torch.equal(W.w4a8_matmul_prefill(xq, xs, wp, s, zs,
                                             out_dtype=torch.float32), ref)
    assert torch.equal(tm.expert_rows_plain(xq, xs, wp, s, zs),
                       _expert_rows_pr9(xq, xs, wp, s, zs))


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


def _unpack_lanes(w4: np.ndarray) -> list:
    """unpack4 at b = 0 and 2 over a lane's four words (columns of w4):
    the eight planes' int8 lane words (planes_b_frags)."""
    out = []
    for b in (0, 2):
        sel = b | ((b + 4) << 4) | ((b + 1) << 8) | ((b + 5) << 12)
        t0 = _byte_perm(w4[:, 0], w4[:, 1], sel)
        t1 = _byte_perm(w4[:, 2], w4[:, 3], sel)
        for v in (_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632)):
            out += [v & 0x0F0F0F0F, (v >> 4) & 0x0F0F0F0F]
    return out


def _lanes(word: np.ndarray) -> np.ndarray:
    """The four int8 lanes of 32-bit words, as signed values."""
    b = np.stack([(word >> (8 * i)) & 0xFF for i in range(4)], -1)
    return np.where(b > 127, b - 256, b)


def _swz(r: int, c: int) -> int:
    return r * 128 + ((c ^ (r & 7)) << 4)


@pytest.mark.parametrize("gi", [0, 1])
def test_decode_tile_fragments(gi):
    """#5's warp tile (n8 channels, two m16 row tiles) at word block gi of
    a K = 2048 planes weight: lane (g, t) loads words kk*32 + 4t and
    kk*32 + 16 + 4t of channel g (decode_b_word) and unpacks them into the
    eight planes' b0, b1; ldmatrix x4 on the swizzled x tile of plane j
    (lane L names row L & 15 of m16 tile i, chunk 2kk + (L >> 4)) gives
    a0..a3.  Assembled by the m16n8k32 fragment layouts, the four k steps'
    products are x_j,gi . u_j,gi^T for every plane j."""
    rng = np.random.RandomState(gi)
    N, K, M = 8, 2048, 32
    kp = K // 8
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    words = W.pack_int4_planes(u).numpy().view(np.uint32).astype(np.int64)
    x = rng.randint(-127, 128, (M, K)).astype(np.int64)
    un = u.numpy().astype(np.int64)
    for j in range(8):
        cols = slice(j * kp + gi * 128, j * kp + gi * 128 + 128)
        # the x tile of plane j: [32 rows][128 bytes], chunk c of row r at
        # swz(r, c)
        tile = np.zeros(32 * 128, dtype=np.int64)
        for r in range(M):
            for c in range(8):
                o = _swz(r, c)
                tile[o:o + 16] = x[r, cols][16 * c:16 * c + 16]
        d = np.zeros((M, N), dtype=np.int64)
        for kk in range(4):
            A = np.zeros((2, 16, 32), dtype=np.int64)
            B = np.zeros((32, N), dtype=np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                w0 = gi * 128 + kk * 32 + 4 * t
                for reg, w in enumerate((w0, w0 + 16)):
                    planes = _unpack_lanes(words[g:g + 1, w:w + 4])
                    B[16 * reg + 4 * t:16 * reg + 4 * t + 4, g] = \
                        _lanes(planes[j])[0]
                for i in range(2):
                    for q in range(4):  # matrix q, row given by lane 8q + g
                        src = 8 * q + g
                        o = _swz(16 * i + (src & 15), 2 * kk + (src >> 4))
                        vals = tile[o + 4 * t:o + 4 * t + 4]
                        # a0: row g, k 4t; a1: row g + 8; a2: k 16 + 4t; a3
                        A[i, g + 8 * (q & 1),
                          16 * (q >> 1) + 4 * t:16 * (q >> 1) + 4 * t + 4] \
                            = vals
            for i in range(2):
                d[16 * i:16 * i + 16] += A[i] @ B
        assert np.array_equal(d, x[:, cols] @ un[:, cols].T)


def _bf16_bits(h) -> np.ndarray:
    """bf16 bit patterns (uint16 values) as float64."""
    h = np.asarray(h, dtype=np.uint32) << 16
    return h.astype(np.uint32).view(np.float32).astype(np.float64)


def _byte_pair(lo, hi, b):
    """byte_pair: __byte_perm(lo, hi, b | b << 4 | (4 + b) << 8 |
    (4 + b) << 12), byte b of lo in bytes 0, 1 and of hi in bytes 2, 3."""
    bl, bh = (lo >> (8 * b)) & 0xFF, (hi >> (8 * b)) & 0xFF
    return bl | (bl << 8) | (bh << 16) | (bh << 24)


def _code_pair(p, nib, signed):
    """code_pair: the low (nib 0) or high nibbles of a byte pair as bf16
    128 + c less 128 (signed: 128 + (c ^ 8) less 136), both halves."""
    v = ((p >> 4) if nib else p) & 0x000F000F
    base = 0x4308 if signed else 0x4300
    v = v ^ 0x43084308 if signed else v | 0x43004300
    return (_bf16_bits(v & 0xFFFF) - _bf16_bits(base),
            _bf16_bits(v >> 16) - _bf16_bits(base))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gi", [0, 1])
def test_bf16_tile_fragments(gi, masked):
    """#1 and #4's tile (csrc/w4a16_tile.cu) at word block gi of a K = 2048
    weight, warp 1 of a 64-channel block with 16 tokens (two n8 tiles): the
    word block and the x slab lie in shared memory as the copies put them
    (word row c, chunk q at q ^ 4 (c & 1); x plane j, token r, chunk c at
    c ^ (r & 7)); lane (g, t) reads 16 bytes of words 16 kk + 4t .. + 3 of
    channels g and g + 8 and unpacks them (byte_pair, code_pair) into the
    A registers a0..a3 of every plane at logical k {2t, 2t + 1} (words 0,
    1) and {2t + 8, 2t + 9} (words 2, 3), and 8 bytes of x (physical k
    16 kk + 4t .. + 3 of token 8 nt + g) into b0, b1.  Assembled by the
    m16n8k16 layouts, the eight k steps' products are x_j,gi . c_j,gi^T for
    every plane j; on the masked words (plane 7 stored XOR 8, both signs
    present) times 16^j they are x_j,gi . (w & (0xF << 4j))^T."""
    rng = np.random.RandomState(10 * gi + masked)
    N, K, TB, warp = 64, 2048, 16, 1
    kp = K // 8
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wp = (W.pack_int4_planes_masked(u) if masked else W.pack_int4_planes(u))
    words = wp.numpy().view(np.uint32).astype(np.int64)
    x = rng.randint(-8, 9, (TB, K)).astype(np.float64)  # exact in bf16
    xb = x.astype(np.float32).view(np.uint32) >> 16  # bf16 bits
    # the word block: 64 rows of 32 chunks (four words each)
    wsh = np.zeros((N, 32, 4), dtype=np.int64)
    for c in range(N):
        for q in range(32):
            wsh[c, q ^ ((c & 1) << 2)] = words[c, gi * 128 + 4 * q:
                                                gi * 128 + 4 * q + 4]
    # the x slab: [plane][token] rows of 16 chunks of eight bf16
    xsh = np.zeros((8, TB, 16, 8), dtype=np.int64)
    for j in range(8):
        for r in range(TB):
            for c in range(16):
                k0 = j * kp + gi * 128 + 8 * c
                xsh[j, r, c ^ (r & 7)] = xb[r, k0:k0 + 8]
    ch = slice(16 * warp, 16 * warp + 16)
    for j in range(8):
        signed = masked and j == 7
        d = np.zeros((16, TB))
        for kk in range(8):
            A = np.zeros((16, 16))
            B = np.zeros((16, TB))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                sw = (g & 1) << 2
                q = (4 * kk + t) ^ sw
                wa, wb = wsh[16 * warp + g, q], wsh[16 * warp + g + 8, q]
                b, nib = j // 2, j % 2
                for reg, (row, w0) in enumerate(((g, wa[0:2]), (g + 8, wb[0:2]),
                                                 (g, wa[2:4]),
                                                 (g + 8, wb[2:4]))):
                    lo, hi = _code_pair(_byte_pair(w0[0], w0[1], b), nib,
                                        signed)
                    k = 2 * t + 8 * (reg >> 1)
                    A[row, k], A[row, k + 1] = lo, hi
                for nt in range(TB // 8):
                    r = 8 * nt + g
                    c = (2 * kk + (t >> 1)) ^ (r & 7)
                    e = _bf16_bits(xsh[j, r, c, 4 * (t & 1):4 * (t & 1) + 4])
                    B[2 * t, r], B[2 * t + 1, r] = e[0], e[1]
                    B[2 * t + 8, r], B[2 * t + 9, r] = e[2], e[3]
            d += A @ B
        cols = slice(j * kp + gi * 128, j * kp + gi * 128 + 128)
        if masked:
            mask = (0xF << (4 * j)) - (1 << 32 if j == 7 else 0)
            val = (wp.numpy()[ch, gi * 128:gi * 128 + 128] & mask)
            assert np.array_equal(d * 16.0 ** j, val.astype(np.float64)
                                  @ x[:, cols].T)
            if j == 7:
                assert (val < 0).any() and (val > 0).any()
        else:
            assert np.array_equal(
                d, u.numpy()[ch, cols].astype(np.float64) @ x[:, cols].T)


def _ksplit_schedule(xq, x_scale, wp, s, zs, first):
    """#5's kernel: per half h (gi in [h*gpp/2, (h+1)*gpp/2)), for gi and
    plane j the exact dot's f32 (0x4B400000 + d) times s into accumulator
    j % 4 and the exact xsum * zs into corr (fused multiply-add: rounded
    once); part = ((a0 + a1) + (a2 + a3)) - corr; the halves added to
    zero, half ``first`` first (the kernel: 0 + part_0, then part_1),
    then times x_scale."""
    M, K = xq.shape
    N, G = s.shape
    gpp, kp = G // 8, K // 8
    u = W.unpack_int4_planes(wp, K).reshape(N, 8, kp)
    sf, zf = s.float(), zs.float()
    parts = []
    for h in range(2):
        acc = [torch.zeros((M, N)) for _ in range(4)]
        corr = torch.zeros((M, N))
        for gi in range(h * gpp // 2, (h + 1) * gpp // 2):
            for j in range(8):
                g = j * gpp + gi
                xg = xq[:, g * 128:g * 128 + 128].long()
                d = xg @ u[:, j, gi * 128:gi * 128 + 128].long().t()
                acc[j % 4] = acc[j % 4] + _exact_f32(d) * sf[:, g]
                prod = xg.sum(-1).float()[:, None] * zf[:, g]
                assert torch.equal(prod.double(), xg.sum(-1).double()[:, None]
                                   * zf[:, g].double())
                corr = corr + prod
        parts.append((acc[0] + acc[1]) + (acc[2] + acc[3]) - corr)
    out = torch.zeros((M, N))
    for h in (first, 1 - first):
        out = out + parts[h]
    return out * x_scale


@pytest.mark.parametrize("K,M", [(2048, 1), (2048, 33), (6144, 8)])
def test_ksplit_schedule_equals_plain(K, M):
    """#5's schedule equals plain #5 bit for bit, and so does the other
    order of the halves."""
    N = 64
    wp, s, zs = (t[0] for t in _experts(1, N, K, seed=K + M))
    xq, xs = _rows(M, K, seed=M)
    ref = W.w4a8_matmul_planes_ksplit_plain(xq, xs, wp, s, zs)
    for first in (0, 1):
        assert torch.equal(_ksplit_schedule(xq, xs, wp, s, zs, first), ref)
    assert torch.equal(W.w4a8_matmul_planes_ksplit(xq, xs, wp, s, zs), ref)


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


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("B", [1, 63, 65, 130])
def test_stacked_tile_rows_equal_plain(pair, B):
    """#6's row mappings on the planes tile: block x takes 64 rows of
    expert x // T, x rows from (e * B if pair else 0) + 64 t, outputs e * B
    + 64 t + r for 64 t + r < B; rows of a tile past B (the next expert's,
    or zeros past the end) are computed and dropped.  Rendered with #9's
    schedule, bit for bit plain #6."""
    E, N, K = 3, 64, 1024
    wp, s, zs = _experts(E, N, K, seed=B)
    xq, xs = _rows(E * B if pair else B, K, seed=B + 1)
    T = -(-B // 64)
    rows = xq.shape[0]
    xpad = torch.cat([xq, xq.new_zeros((64 * (E * T + 1), K))])
    spad = torch.cat([xs, xs.new_ones((64 * (E * T + 1), 1))])
    out = torch.full((E * B, N), float("nan"))
    for blk in range(E * T):
        e, t0 = blk // T, 64 * (blk % T)
        m0 = (e * B if pair else 0) + t0
        assert m0 < rows
        y = _tile_order_rows(xpad[m0:m0 + 64], spad[m0:m0 + 64], wp[e],
                             s[e], zs[e])
        keep = min(64, B - t0)
        out[e * B + t0:e * B + t0 + keep] = y[:keep]
    ref = tm.w4a8_stacked_matmul_plain(
        xq.reshape(E, B, K) if pair else xq,
        xs.reshape(E, B, 1) if pair else xs, wp, s, zs, pair)
    assert torch.equal(out.reshape(E, B, N), ref)


def test_fused_quant_reciprocal_equals_division():
    """#13's codes: t = v * (1/sc) rounded to even (by adding 1.5 * 2^23),
    or rint(v / sc) where |t - rint(t)| exceeds the kernel's 0.5 - 2^-14
    (the kernel divides the chunk of eight that holds such a t), equals
    rint(v / sc)
    (IEEE f32 throughout, as the kernel's __frcp_rn, __fmul_rn and
    __fdiv_rn) on random rows and on values a few ulps from every tie."""
    rng = np.random.RandomState(0)
    guard = np.float32(0.5 - 2.0 ** -14)
    amax = torch.from_numpy((rng.rand(64, 1) * 20 + 1e-3)
                            .astype(np.float32))
    sc = amax / 127.0
    v = torch.from_numpy(rng.rand(64, 4096).astype(np.float32) * 2 - 1) \
        * amax
    # ties: (k + 0.5) * sc, nudged by -3 .. 3 ulps
    k = torch.from_numpy(rng.randint(-127, 127, (64, 512))).float()
    tie = (k + 0.5) * sc
    for d in range(-3, 4):
        v = torch.cat([v, torch.nextafter(tie, torch.sign(tie) * d * np.inf)
                       if d else tie], dim=1)
    v = torch.clamp(v, -amax, amax)
    inv = 1.0 / sc
    t = v * inv
    # rint(t): t + 1.5 * 2^23 rounds to an integer, half to even (f32)
    q = (t + 12582912.0) - 12582912.0
    assert torch.equal(q, torch.round(t))
    slow = (t - q).abs() > guard
    q = torch.where(slow, torch.round(v / sc), q)
    # the division is taken near every tie and rarely elsewhere
    assert bool(slow[:, 4096:].all())
    assert float(slow[:, :4096].float().mean()) < 1e-3
    assert torch.equal(q, torch.round(v / sc))
    assert float(q.abs().max()) <= 127


@pytest.mark.parametrize("M,K", [(5, 1024), (16, 4096)])
def test_fused_tile_schedule_equals_pairs_order(M, K):
    """#13's tile: warp (ct, h) takes group 2p + h of pair p into its
    accumulator of even p (a_h) or odd p (a_{h+2}); the h = 0 warps sum
    the correction of groups 2p, 2p + 1 in order (exact products: a fused
    multiply-add rounds as the sum does); y = ((a0 + a1) + (a2 + a3) -
    corr) * xscale.  Bit for bit ``w4a8_matmul_pairs_tpu_order``."""
    rng = np.random.RandomState(K + M)
    N, G = 64, K // 128
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wb = W.pack_s4_pairs(u)
    s = torch.from_numpy((rng.rand(N, G) * 0.02 + 1e-3)
                         .astype(np.float32)).to(torch.bfloat16)
    zs = torch.from_numpy(((rng.rand(N, G) - 0.5) * 0.1)
                          .astype(np.float32)).to(torch.bfloat16)
    xq, xs = _rows(M, K, seed=M)
    c = W.unpack_s4_pairs(wb).reshape(N, G, 128)
    x = xq.long().reshape(M, G, 128)
    acc = {(h, odd): torch.zeros((M, N)) for h in (0, 1) for odd in (0, 1)}
    corr = torch.zeros((M, N))
    for p in range(G // 2):
        for h in (0, 1):
            g = 2 * p + h
            d = torch.matmul(x[:, g], c[:, g].long().t())
            key = (h, p & 1)
            acc[key] = acc[key] + _exact_f32(d) * s[:, g].float()
        for g in (2 * p, 2 * p + 1):
            corr = corr + x[:, g].sum(-1).float()[:, None] * zs[:, g].float()
    y = ((acc[0, 0] + acc[1, 0]) + (acc[0, 1] + acc[1, 1]) - corr) * xs
    assert torch.equal(y, W.w4a8_matmul_pairs_tpu_order(xq, xs, wb, s, zs))


@pytest.mark.parametrize("M,K,sdtype", [(5, 1024, "bf16"), (17, 384, "f32"),
                                         (33, 640, "bf16")])
def test_s4_tile_schedule_equals_plain(M, K, sdtype):
    """#11's tile: stage p holds groups 4p .. 4p + 3 (past G: none); warp
    (ct, h) takes groups 4p + h and 4p + 2 + h into its accumulators a_h
    and a_{h+2}; the h = 0 warps sum the correction of each stage's groups
    in order, product and sum each rounded (f32 zs' makes the product
    inexact); y = ((a0 + a1) + (a2 + a3) - corr) * xscale.  Bit for bit
    plain #11, and that equals #13's order on the same codes packed as
    byte pairs."""
    rng = np.random.RandomState(K + M)
    N, G = 64, K // 128
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wb = W.pack_s4_bytes(u)
    dt = torch.bfloat16 if sdtype == "bf16" else torch.float32
    s = torch.from_numpy((rng.rand(N, G) * 0.02 + 1e-3)
                         .astype(np.float32)).to(dt)
    zs = torch.from_numpy(((rng.rand(N, G) - 0.5) * 0.1)
                          .astype(np.float32)).to(dt)
    xq, xs = _rows(M, K, seed=M)
    c = W.unpack_s4_bytes(wb).reshape(N, G, 128)
    x = xq.long().reshape(M, G, 128)
    acc = {(h, j): torch.zeros((M, N)) for h in (0, 1) for j in (0, 1)}
    corr = torch.zeros((M, N))
    for p in range((G + 3) // 4):
        for h in (0, 1):
            for j in (0, 1):
                g = 4 * p + 2 * j + h
                if g < G:
                    d = torch.matmul(x[:, g], c[:, g].long().t())
                    acc[h, j] = acc[h, j] + _exact_f32(d) * s[:, g].float()
        for g in range(4 * p, min(4 * p + 4, G)):
            corr = corr + (x[:, g].sum(-1).float()[:, None]
                           * zs[:, g].float())
    y = ((acc[0, 0] + acc[1, 0]) + (acc[0, 1] + acc[1, 1]) - corr) * xs
    assert torch.equal(y, W.w4a8_matmul_s4_plain(xq, xs, wb, s, zs))
    if K % 256 == 0:
        assert torch.equal(y, W.w4a8_matmul_pairs_tpu_order(
            xq, xs, W.pack_s4_pairs(u), s, zs))


@pytest.mark.parametrize("K,p", [(384, 0), (640, 1), (1024, 1)])
def test_s4_tile_fragments(K, p):
    """#11's tile at stage p of a natural s4 weight (32 channels, 32 rows):
    the stage's words (bytes 256p .. +256 of each row as two [32][128]
    tiles, zeros past the row) and x tiles [4][32][128] (columns 512p ..
    +512, zeros past K) lie swizzled as the copies put them; warp (ct, h)
    takes group 4p + 2j + h from word tile j and x tile 2j + h: its
    ldmatrix x4 (lane L: channel 8 ct + (L & 7), chunk 4h + (L >> 3))
    gives lane (g, t) word t of k step kk's chunk: b0 = its low nibbles
    (the even k of 32 kk + 8t .. + 7), b1 = its high ones (the odd k); the
    lane's 8 bytes of x at k 32 kk + 8t, evens then odds (byte permutes
    0x6420, 0x7531), are a0 / a2 (row g) and a1 / a3 (row g + 8).
    Assembled by the m16n8k32 layouts, the four k steps give x_g . c'_g^T;
    the eight lanes' sums of a row's chunks give its row sum."""
    rng = np.random.RandomState(K + p)
    N, M, G, kh = 32, 32, K // 128, K // 2
    u = torch.from_numpy(rng.randint(0, 16, (N, K)).astype(np.int32))
    wb = W.pack_s4_bytes(u).numpy().view(np.uint8).astype(np.int64)
    c = W.unpack_s4_bytes(W.pack_s4_bytes(u)).numpy().astype(np.int64)
    x = rng.randint(-127, 128, (M, K)).astype(np.int64)
    wt = np.zeros((2, 32 * 128), dtype=np.int64)
    for ch in range(N):
        for q in range(16):
            b = 256 * p + 16 * q
            if b < kh:
                o = _swz(ch, q & 7)
                wt[q >> 3, o:o + 16] = wb[ch, b:b + 16]
    xt = np.zeros((4, 32 * 128), dtype=np.int64)
    for r in range(M):
        for q in range(32):
            if 4 * p + (q >> 3) < G:
                o = _swz(r, q & 7)
                xt[q >> 3, o:o + 16] = x[r, 512 * p + 16 * q:
                                         512 * p + 16 * q + 16]

    def word(buf, o):
        return sum(int(buf[o + i] & 0xFF) << (8 * i) for i in range(4))

    seen = 0
    for h in (0, 1):
        for j in (0, 1):
            g_ = 4 * p + 2 * j + h
            if g_ >= G:
                continue
            seen += 1
            cols = slice(128 * g_, 128 * g_ + 128)
            ws, xs = wt[j], xt[2 * j + h]
            for ct in range(4):
                d = np.zeros((M, 8), dtype=np.int64)
                for kk in range(4):
                    A = np.zeros((2, 16, 32), dtype=np.int64)
                    B = np.zeros((32, 8), dtype=np.int64)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        w = word(ws, _swz(8 * ct + g, 4 * h + kk) + 4 * t)
                        for reg, nib in ((0, w & 0x0F0F0F0F),
                                         (1, (w >> 4) & 0x0F0F0F0F)):
                            B[16 * reg + 4 * t:16 * reg + 4 * t + 4, g] = [
                                (((nib >> (8 * e)) & 0xF) ^ 8) - 8
                                for e in range(4)]
                        for i in range(2):
                            for hr in range(2):
                                o = _swz(16 * i + g + 8 * hr,
                                         2 * kk + (t >> 1)) + 8 * (t & 1)
                                lo = np.array([word(xs, o)], dtype=np.int64)
                                hi = np.array([word(xs, o + 4)],
                                              dtype=np.int64)
                                for reg, sel in ((0, 0x6420), (1, 0x7531)):
                                    v = _lanes(_byte_perm(lo, hi, sel))[0]
                                    A[i, g + 8 * hr, 16 * reg + 4 * t:
                                      16 * reg + 4 * t + 4] = v
                    for i in range(2):
                        d[16 * i:16 * i + 16] += A[i] @ B
                ch = slice(8 * ct, 8 * ct + 8)
                assert np.array_equal(d, x[:, cols] @ c[ch, cols].T)
            for r in range(M):
                tot = sum(_lanes(np.array([word(xs, _swz(r, cc) + 4 * i)]))
                          [0].sum() for cc in range(8) for i in range(4))
                assert tot == x[r, cols].sum()
    assert seen == min(4, G - 4 * p)


@pytest.mark.parametrize("TB", [8, 32])
def test_smallm_slab_staging(TB):
    """#7's tile stages gi's int8 x as #1's bf16 slab: item i (16 values,
    row i >> 3 = j TB + r, values 16 (i & 7) .. of token r's plane-j group
    gi) into chunks 2 (i & 7) and + 1 of row (j, r) at c ^ (r & 7); each
    value's bf16 is exact, and #1's B reads of the slab (token 8 nt + g,
    physical k 16 kk + 4t .. + 3) find x there.  The 8 items of a row are
    8 neighbouring lanes of one warp, so their butterfly sums the group."""
    rng = np.random.RandomState(TB)
    K, gi = 2048, 1
    kp = K // 8
    x = rng.randint(-128, 128, (TB, K)).astype(np.int64)
    xb = x.astype(np.float32).view(np.uint32) >> 16
    assert np.array_equal(_bf16_bits(xb), x.astype(np.float64))
    slab = np.zeros((8, TB, 16, 8), dtype=np.int64)
    sums = {}
    for i in range(64 * TB):
        row, q = i >> 3, i & 7
        j, r = row // TB, row % TB
        k0 = j * kp + gi * 128 + 16 * q
        vals = xb[r, k0:k0 + 16]
        slab[j, r, (2 * q) ^ (r & 7)] = vals[:8]
        slab[j, r, (2 * q + 1) ^ (r & 7)] = vals[8:]
        sums.setdefault(row, []).append(((i % 128) // 32, i % 32))
    # a row's items sit in one warp, in one aligned group of 8 lanes
    for v in sums.values():
        warps, lanes = {w for w, _ in v}, sorted(ln for _, ln in v)
        assert len(warps) == 1 and lanes == list(range(lanes[0],
                                                       lanes[0] + 8))
        assert lanes[0] % 8 == 0
    for j in range(8):
        for nt in range(TB // 8):
            for kk in range(8):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r = 8 * nt + g
                    c = (2 * kk + (t >> 1)) ^ (r & 7)
                    e = slab[j, r, c, 4 * (t & 1):4 * (t & 1) + 4]
                    k = j * kp + gi * 128 + 16 * kk + 4 * t
                    assert np.array_equal(e, xb[r, k:k + 4])


def _planes_decode_schedule(xq, x_scale, wp, s, zs, Q, per_plane, MT):
    """#2 and #14's planes decode tile: row chunks of MT rows; warp class q
    of Q takes the planes j = q (mod Q) of every word block gi and holds
    the accumulators a_r, r = q (mod Q): per gi, for its planes in order,
    the exact integer dot (its four k steps' int32 parts, exact in any
    order) as f32 (0x4B400000 + d) times s into a_{j % 4}; the classes
    meet through shared memory, v = (a0 + a1) + (a2 + a3); then the zero
    corrections of all groups from the group sums (exact products: a fused
    multiply-add rounds as the sum does), one sum in (gi, j) order (#2) or
    each plane's over gi, subtracted in plane order (#14); times
    x_scale."""
    M, K = xq.shape
    N, G = s.shape
    gpp, kp = G // 8, K // 8
    u = W.unpack_int4_planes(wp, K).reshape(N, 8, kp).long()
    sf, zf = s.float(), zs.float()
    out = torch.full((M, N), float("nan"))
    for m0 in range(0, M, MT):
        x = xq[m0:m0 + MT].long()
        rows = x.shape[0]
        acc = [None] * 4
        for q in range(Q):
            mine = [torch.zeros((rows, N)) for _ in range(4 // Q)]
            for gi in range(gpp):
                for i in range(8 // Q):
                    j = q + Q * i
                    k0 = j * kp + gi * 128
                    d = sum(x[:, k0 + 32 * kk:k0 + 32 * kk + 32]
                            @ u[:, j, gi * 128 + 32 * kk:
                                gi * 128 + 32 * kk + 32].t()
                            for kk in range(4))
                    a = i % (4 // Q)
                    mine[a] = mine[a] + _exact_f32(d) * sf[:, j * gpp + gi]
            for a in range(4 // Q):
                acc[q + Q * a] = mine[a]
        v = (acc[0] + acc[1]) + (acc[2] + acc[3])
        xsum = x.reshape(rows, G, 128).sum(-1)
        corr = [torch.zeros((rows, N)) for _ in range(8 if per_plane
                                                      else 1)]
        for gi in range(gpp):
            for j in range(8):
                g = j * gpp + gi
                prod = xsum[:, g].float()[:, None] * zf[:, g]
                assert torch.equal(prod.double(), xsum[:, g].double()[:, None]
                                   * zf[:, g].double())
                c = j if per_plane else 0
                corr[c] = corr[c] + prod
        for c in corr:
            v = v - c
        out[m0:m0 + MT] = v * x_scale[m0:m0 + MT]
    return out


@pytest.mark.parametrize("Q", [2, 4])
@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("M,K,MT", [(1, 1024, 16), (8, 3072, 16),
                                    (33, 2048, 32)])
def test_planes_decode_schedule_equals_plain(M, K, MT, per_plane, Q):
    """The planes decode tile's schedule, by plane class (Q 2: 32 channels
    a block, #14 and wide #2; Q 4: 16 channels), gives #2's TPU order
    (``w4a8_rows_tpu_order``) or, with the corrections a plane, #14's
    (``w4a8_rows_phase_dot``) bit for bit, over one or more row chunks."""
    wp, s, zs = (t[0] for t in _experts(1, 64, K, seed=K + M))
    xq, xs = _rows(M, K, seed=M + 11)
    ref = (W.w4a8_rows_phase_dot if per_plane
           else W.w4a8_rows_tpu_order)(xq, xs, wp, s, zs)
    got = _planes_decode_schedule(xq, xs, wp, s, zs, Q, per_plane, MT)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("M", sorted({1, 8, W.PLANES_TILE_MIN_M - 1,
                                      W.PLANES_TILE_MIN_M, 256}))
def test_planes_body_by_m(M):
    """#2 takes #3's planes tile from PLANES_TILE_MIN_M rows on, its planes
    decode tile below (by M alone), and on the CPU either body (and either
    store, f32 or bf16) is the plain version, which both equal."""
    assert W.planes_body(M) == ("tile" if M >= W.PLANES_TILE_MIN_M
                                else "decode")
    wp, s, zs = (t[0] for t in _experts(1, 128, 1024, seed=M))
    xq, xs = _rows(M, 1024, seed=M + 3)
    ref = W.w4a8_rows_tpu_order(xq, xs, wp, s, zs)
    for body in ("decode", "tile"):
        for dt in (torch.float32, torch.bfloat16):
            got = W._w4a8_matmul_decode(xq, xs, wp, s, zs, dt, body)
            assert got.dtype == dt and torch.equal(got, ref.to(dt))
    assert torch.equal(W.w4a8_matmul_decode(xq, xs, wp, s, zs), ref)


@pytest.mark.parametrize("N", [64, 1024, W.DECODE_CHAN16_MAX_N,
                               W.DECODE_CHAN16_MAX_N + 64, 14336])
def test_decode_chan_by_n(N):
    """#2's decode tile takes 16 channels a block up to
    DECODE_CHAN16_MAX_N, 32 above; either divides the planes kernels' N %
    64."""
    chan = W.decode_chan(N)
    assert chan == (16 if N <= W.DECODE_CHAN16_MAX_N else 32)
    assert N % chan == 0
