"""The int8 tensor-core tile of #19/#21 (``attn_bd_flash_kernel`` in
``ops/csrc/decode_attention.cu``) rendered in numpy on the CPU: its operand
mappings held to plain integer dots before the card runs the kernel.

* A warp's ring chunk (64 columns of K: R feature rows of 64 bytes and the
  columns' K and V scales; 64 time steps of V: rows of R bytes), copied by
  the TMA with the 64-byte (K, kv4 V) or 128-byte (kv8 V) swizzle; the
  lanes' loads of one instruction hit distinct banks.
* Scores: lane (g, tig) reads time steps 8 g .. 8 g + 7 of the rows 8 a +
  lane7_64(tig, b); a 4 x 4 byte transpose (eight byte permutes) makes
  the m16n8k32 A fragments (m16 tile i: time steps 8 g + 2 i, + 1), kv4's
  nibbles sign-extended after it; q8 in the same feature order as B.  The
  int32 outputs equal q8 . k (kv4: the low nibbles against q's low half,
  the high ones against its high half).
* PV: the lane's time steps 32 kk + 8 a + lane7(tig, b) of 16 features
  (kv8 bytes 16 g ..; kv4 bytes 8 g .., low then high nibbles), the same
  transpose, p8 of query g at those time steps as B: p8 . v.
* The warp's chunk cursor (``flash_settle``) visits each chunk of its rank
  once, in the order the consumer loops take them, and ``flash_ranks``
  splits the blocks as the kernel's ranks do.
"""

import numpy as np
import pytest

from lightcompress_tpu_torch.ops import attention as ta

D, D2, CH = 128, 64, 64


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy values."""
    b = [(v >> (8 * k)) & 0xFF for v in (x, y) for k in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= b[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _transpose4(w0, w1, w2, w3):
    """The kernel's transpose4: byte i of o[j] is byte j of w_i."""
    t0, t1 = _byte_perm(w0, w1, 0x5140), _byte_perm(w0, w1, 0x7362)
    t2, t3 = _byte_perm(w2, w3, 0x5140), _byte_perm(w2, w3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _lanes(word):
    """The four bytes of uint32 words as signed int8 values (last axis)."""
    b = np.stack([(word >> (8 * i)) & 0xFF for i in range(4)], -1)
    return np.where(b > 127, b - 256, b)


def _nib(word, hi):
    """nib_lo / nib_hi: the low (high) nibbles sign-extended, as a word."""
    n = (word >> (4 * hi)) & 0x0F0F0F0F
    return n | ((n & 0x08080808) * 0x1E) & 0xFFFFFFFF


def _pack(vals):
    """Four int8 values (last axis) as one uint32 word."""
    v = (np.asarray(vals) & 0xFF).astype(np.int64)
    return v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24


def sw64(r, c):
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def sw128(r, c):
    return r * 128 + ((c ^ (r & 7)) << 4)


def lane7_64(tig, b):
    return (tig & 1) | (b << 1) | ((tig >> 1) << 2)


def lane7_128(tig, b):
    return 2 * tig + b


def _word(buf, off):
    return int(buf[off]) | int(buf[off + 1]) << 8 | \
        int(buf[off + 2]) << 16 | int(buf[off + 3]) << 24


def _mma(a, b):
    """mma.sync m16n8k32 s8 over a warp: a [32][4], b [32][2] uint32 words
    in the PTX fragment layouts; returns the lanes' d [32][4]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, 4 * t:4 * t + 4] = _lanes(a[lane][0])
        A[g + 8, 4 * t:4 * t + 4] = _lanes(a[lane][1])
        A[g, 16 + 4 * t:20 + 4 * t] = _lanes(a[lane][2])
        A[g + 8, 16 + 4 * t:20 + 4 * t] = _lanes(a[lane][3])
        B[4 * t:4 * t + 4, g] = _lanes(b[lane][0])
        B[16 + 4 * t:20 + 4 * t, g] = _lanes(b[lane][1])
    C = A @ B
    return [[C[lane >> 2, 2 * (lane & 3)], C[lane >> 2, 2 * (lane & 3) + 1],
             C[(lane >> 2) + 8, 2 * (lane & 3)],
             C[(lane >> 2) + 8, 2 * (lane & 3) + 1]] for lane in range(32)]


def _k_chunk(kslab, nv):
    """The ring slot of a K chunk: R rows of 64 columns, 64-byte swizzle
    (the TMA box; the columns from nv on, zeros here, are never read)."""
    R = kslab.shape[0]
    buf = np.zeros(R * CH, np.int64)
    for r in range(R):
        for p in range((nv + 15) // 16):
            o = sw64(r, p)
            buf[o:o + 16] = kslab[r, 16 * p:16 * p + 16] & 0xFF
    return buf


def _v_chunk(vslab, nv, nib, buf):
    """The ring slot ``buf`` after a V chunk's copy: the nv valid time
    steps' R bytes (the rest keeps what an earlier chunk left)."""
    R = vslab.shape[1]
    buf = buf.copy()
    for t in range(nv):
        for p in range(R // 16):
            o = sw64(t, p) if nib else sw128(t, p)
            buf[o:o + 16] = vslab[t, 16 * p:16 * p + 16] & 0xFF
    return buf


def _q_frags(q8, G, nib):
    """The lanes' B fragments of q8 (G, D) for the four k steps."""
    qb = np.zeros((32, 4, 2), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        if g >= G:
            continue
        for ks in range(4):
            for s in range(2):
                vals = []
                for i in range(4):
                    j = 4 * s + i
                    ka = (ks & 1) if nib else ks
                    r = 8 * (4 * ka + (j >> 1)) + lane7_64(tig, j & 1)
                    vals.append(q8[g, r + (D2 if nib and ks >= 2 else 0)])
                qb[lane, ks, s] = _pack(vals)
    return qb


def _scores(buf, qb, nib):
    """A chunk's QK on the tile: the int32 dot of each (time step of the
    chunk, query 0..7)."""
    out = np.zeros((CH, 8), np.int64)
    acc = [[[0] * 4 for _ in range(4)] for _ in range(32)]
    for ka in range(2 if nib else 4):
        xs = []
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            wv = []
            for jj in range(8):
                r = 8 * (4 * ka + (jj >> 1)) + lane7_64(tig, jj & 1)
                o = sw64(r, g >> 1) + 8 * (g & 1)
                wv.append((_word(buf, o), _word(buf, o + 4)))
            x = []
            for s in range(2):
                x.append(_transpose4(*[np.int64(wv[4 * s + i][0])
                                       for i in range(4)])
                         + _transpose4(*[np.int64(wv[4 * s + i][1])
                                         for i in range(4)]))
            xs.append(x)
        for i in range(4):
            steps = [(ka, 0)] if not nib else [(ka, 0), (ka + 2, 1)]
            for ks, hi in steps:
                a = []
                for lane in range(32):
                    x = xs[lane]
                    regs = [x[0][2 * i], x[0][2 * i + 1], x[1][2 * i],
                            x[1][2 * i + 1]]
                    a.append([_nib(w, hi) if nib else w for w in regs])
                d = _mma(a, [qb[lane, ks] for lane in range(32)])
                for lane in range(32):
                    for e in range(4):
                        acc[lane][i][e] += d[lane][e]
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for i in range(4):
            for e in range(4):
                out[8 * g + 2 * i + (e >> 1), 2 * tig + (e & 1)] = \
                    acc[lane][i][e]
    return out


def _pv(buf, p8, G, nib):
    """A chunk's PV on the tile: the int32 sums (query 0..7, feature)."""
    out = np.zeros((8, D), np.int64)
    lt = lane7_64 if nib else lane7_128
    for kk in range(2):
        a_all, b_all = [], []
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            bw = []
            for s in range(2):
                vals = []
                for i in range(4):
                    jj = 4 * s + i
                    t = 32 * kk + 8 * (jj >> 1) + lt(tig, jj & 1)
                    vals.append(p8[g, t] if g < G else 0)
                bw.append(_pack(vals))
            b_all.append(bw)
            y = []
            for s in range(2):
                ts = [32 * kk + 8 * ((4 * s + i) >> 1) + lt(tig, i & 1)
                      for i in range(4)]
                if nib:
                    w = [[_word(buf, sw64(t, g >> 1) + 8 * (g & 1) + 4 * c)
                          for c in range(2)] for t in ts]
                    x = []
                    for c in range(2):
                        x += _transpose4(*[np.int64(w[i][c])
                                           for i in range(4)])
                    y.append([_nib(v, 0) for v in x] +
                             [_nib(v, 1) for v in x])
                else:
                    w = [[_word(buf, sw128(t, g) + 4 * c) for c in range(4)]
                         for t in ts]
                    x = []
                    for c in range(4):
                        x += _transpose4(*[np.int64(w[i][c])
                                           for i in range(4)])
                    y.append(x)
            a_all.append(y)
        for i in range(8):
            d = _mma([[a_all[ln][0][2 * i], a_all[ln][0][2 * i + 1],
                       a_all[ln][1][2 * i], a_all[ln][1][2 * i + 1]]
                      for ln in range(32)], b_all)
            for lane in range(32):
                g, tig = lane >> 2, lane & 3
                for e in range(4):
                    phi = 2 * i + (e >> 1)
                    f = (8 * g + phi if phi < 8 else D2 + 8 * g + phi - 8) \
                        if nib else 16 * g + phi
                    out[2 * tig + (e & 1), f] += d[lane][e]
    return out


def _planes(codes, nib):
    """int8 codes, or kv4 bytes as (low, high) sign-extended nibbles."""
    if not nib:
        return [codes]
    c = codes.astype(np.int64) & 0xFF
    return [((c & 0xF) ^ 8) - 8, (((c >> 4) & 0xF) ^ 8) - 8]


@pytest.mark.parametrize("nv", [64, 37, 16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("nib", [False, True])
def test_flash_tile_scores(nib, G, nv):
    """A K chunk's scores on the tile equal q8 . k for every valid column
    (kv4: q's low half against the low nibbles, high against high)."""
    rng = np.random.RandomState(G + 3 * nv + nib)
    R = D2 if nib else D
    kslab = rng.randint(-128, 128, (R, CH))
    q8 = rng.randint(-127, 128, (G, D))
    got = _scores(_k_chunk(kslab, nv), _q_frags(q8, G, nib), nib)
    planes = _planes(kslab, nib)
    want = sum(q8[:, i * R:(i + 1) * R] @ p for i, p in enumerate(planes))
    assert np.array_equal(got[:nv, :G], want.T[:nv])


@pytest.mark.parametrize("nv", [64, 37, 1])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("nib", [False, True])
def test_flash_tile_pv(nib, G, nv):
    """A V chunk's PV on the tile equals p8 . v over its valid time steps
    (time steps past them hold stale bytes; their p8 is 0)."""
    rng = np.random.RandomState(100 + G + 3 * nv + nib)
    R = D2 if nib else D
    vslab = rng.randint(-128, 128, (CH, R))
    buf = _v_chunk(vslab, nv, nib, rng.randint(0, 256, CH * R))
    p8 = rng.randint(0, 128, (8, CH))
    p8[:, nv:] = 0
    got = _pv(buf, p8, G, nib)
    planes = _planes(vslab, nib)
    want = np.concatenate([p8[:G] @ p for p in planes], axis=1)
    assert np.array_equal(got[:G], want)


@pytest.mark.parametrize("sb", [16, 48, 512])
def test_flash_scale_copies(sb):
    """A K chunk's slot also takes its columns' K and V scales by two bulk
    copies of 32 * ceil(nv / 16) bytes each (flash_issue): a multiple of
    16, within the slot's 128 bytes, every valid column's scale, and never
    past the buffer's S columns (S - c0 is a multiple of 16)."""
    for S in (sb, 2 * sb, 4 * sb):
        for L in range(1, S + 1, 7):
            for c0 in range(0, L, sb):
                n = min(sb, L - c0)
                for c in range(-(-n // CH)):
                    nv = min(CH, n - c * CH)
                    size = 32 * ((nv + 15) // 16)
                    assert size % 16 == 0 and 2 * nv <= size <= 2 * CH
                    assert c0 + c * CH + size // 2 <= S


def test_flash_p8_reciprocal_equals_division():
    """The PV B fragments' codes: t = pv * (1 / ps) rounded to even (by
    adding 1.5 * 2^23), or rint(pv / ps) where t lies within 2^-14 of a tie,
    equal rint(pv / ps) (IEEE f32, as the kernel's __frcp_rn, __fmul_rn and
    __fdiv_rn), ps = max(max(pv), 1e-20) / 127, on random rows, rows of
    tiny pv and values a few ulps from every tie."""
    import torch

    rng = np.random.RandomState(1)
    guard = np.float32(0.5 - 2.0 ** -14)
    pmax = torch.from_numpy(np.concatenate([
        rng.rand(60, 1) * 40 + 1e-6, np.full((4, 1), 3e-21)]).astype(
            np.float32))
    ps = torch.clamp(pmax, min=1e-20) / 127.0
    pv = torch.from_numpy(rng.rand(64, 2048).astype(np.float32)) * pmax
    k = torch.from_numpy(rng.randint(0, 127, (64, 256))).float()
    tie = (k + 0.5) * ps
    for dd in range(-3, 4):
        pv = torch.cat([pv, torch.nextafter(tie, torch.full_like(tie, dd *
                                                               np.inf))
                        if dd else tie], dim=1)
    pv = torch.clamp(pv, min=0.0)
    pv = torch.minimum(pv, pmax)
    t = pv * (1.0 / ps)
    q = (t + 12582912.0) - 12582912.0
    slow = (t - q).abs() > guard
    q = torch.where(slow, torch.round(pv / ps), q)
    assert bool(slow[:60, 2048:].all())
    assert float(slow[:, :2048].float().mean()) < 1e-3
    assert torch.equal(q, torch.round(pv / ps))
    assert float(q.max()) <= 127 and float(q.min()) >= 0


def _banks(addrs, width):
    """The most lanes of one 128-byte phase that share a bank (distinct
    words)."""
    per = 128 // width
    worst = 1
    for p in range(32 // per):
        banks = {}
        for lane in range(p * per, (p + 1) * per):
            for w in range(width // 4):
                banks.setdefault((addrs[lane] + 4 * w) // 4 % 32,
                                 set()).add(addrs[lane] + 4 * w)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("a,b", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_flash_tile_loads_hit_distinct_banks(a, b):
    """Every load instruction of the tile: K rows (8-byte reads of 64-byte
    rows), kv8 V (16-byte reads of 128-byte rows), kv4 V (8-byte reads)."""
    lanes = [(ln >> 2, ln & 3) for ln in range(32)]
    k = [sw64(8 * a + lane7_64(t, b), g >> 1) + 8 * (g & 1) for g, t in lanes]
    v8 = [sw128(8 * a + lane7_128(t, b), g) for g, t in lanes]
    v4 = [sw64(8 * a + lane7_64(t, b), g >> 1) + 8 * (g & 1)
          for g, t in lanes]
    assert _banks(k, 8) == _banks(v8, 16) == _banks(v4, 8) == 1


def _settle(cur, warp, jend, L, sb):
    """flash_settle: the cursor (block, K 0 / V 1, chunk) at its next chunk
    at or after itself, or None past the last."""
    j, v, c = cur
    while j < jend:
        n = min(sb, L - j * sb)
        if c < (n + CH - 1) // CH:
            return j, v, c
        c = warp
        if v:
            j += 1
        v ^= 1
    return None


@pytest.mark.parametrize("S,sb,parts", [(4096, 512, 4), (4096, 512, 8),
                                        (1280, 256, 3), (11504, 16, 16),
                                        (512, 512, 1)])
def test_flash_chunk_cursor_and_ranks(S, sb, parts):
    """Each warp's fill cursor visits, in order, exactly the chunks its
    consumer loops take (K chunks c = warp, warp + 4, .. of a block, then
    its V chunks), over the rank's valid blocks; the ranks' blocks tile
    the buffer's blocks in order (``flash_ranks``)."""
    blocks = S // sb
    ranks = ta.flash_ranks(blocks, parts)
    assert ranks[0][0] == 0 and ranks[-1][1] == blocks
    assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
    per = -(-blocks // parts)
    for L in (0, 1, 63, 65, S // 3, S - 5, S):
        nvb = -(-L // sb)
        for r in range(parts):
            j0, jend = r * per, min(r * per + per, nvb)
            for warp in range(4):
                want = []
                for j in range(j0, jend):
                    n = min(sb, L - j * sb)
                    for v in (0, 1):
                        want += [(j, v, c) for c in
                                 range(warp, -(-n // CH), 4)]
                got = []
                cur = _settle((j0, 0, warp), warp, jend, L, sb) \
                    if j0 < jend else None
                while cur is not None:
                    got.append(cur)
                    cur = _settle((cur[0], cur[1], cur[2] + 4), warp, jend,
                                  L, sb)
                assert got == want


def test_flash_parts_never_read_lengths():
    """The rank count comes from the pairs, the blocks and the card's CTAs
    alone: one block takes one rank, never more ranks than blocks or than
    BD_FLASH_PARTS_MAX, more ranks where the card has room for them."""
    import inspect

    assert "lengths" not in inspect.signature(ta.bd_flash_parts).parameters
    assert ta.bd_flash_parts(64, 1, 264) == 1
    for pairs, blocks, ctas in ((64, 8, 264), (8, 16, 528), (256, 32, 264),
                                (8, 719, 396), (1, 2, 132)):
        p = ta.bd_flash_parts(pairs, blocks, ctas)
        assert 1 <= p <= min(blocks, ta.BD_FLASH_PARTS_MAX)
        assert len(ta.flash_ranks(blocks, p)) == p
    assert ta.bd_flash_parts(8, 16, 528) > ta.bd_flash_parts(512, 16, 264)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_smem_fits_every_block_the_old_kernel_took(G):
    """The whole-block kernel held 5 * G bytes a column beside its q words,
    PV sums and reduction scratch (5 * G * D + 32 * G bytes); the tile
    holds 4 * G and a ring of at least one slot, so every s_block the old
    kernel could launch still fits, and the engine's 512 columns keep two
    CTAs an SM."""
    D = ta.KERNEL_HEAD_DIM
    sb = (ta.SMEM_MAX - 5 * G * D - 32 * G) // (5 * G) // 16 * 16
    assert 5 * G * (sb + D) + 32 * G <= ta.SMEM_MAX
    for nib in (False, True):
        n = ta.bd_flash_slots(G, sb, nib)
        assert ta.bd_flash_smem_bytes(G, sb, nib, n) <= ta.SMEM_MAX
        n = ta.bd_flash_slots(G, ta.S_BLOCK, nib)
        assert 2 * (ta.bd_flash_smem_bytes(G, ta.S_BLOCK, nib, n) + 1024) \
            <= 233472
