"""#17, #18 and #20's S split over a thread-block cluster
(``attn_split_kernel`` in ``ops/csrc/decode_attention.cu``) rendered on the
CPU, before the card runs the kernel.

* The split's arithmetic in torch: S cut into ranks of
  ``kv8_columns(S, parts)`` columns; the row max met over the ranks in
  order (#18 and #20 floored at -1e30, #17 with the fresh token's score);
  the max of pv (giving ps) and the f32 sums of e (giving d) met likewise;
  the ranks' int32 PV sums added exactly, times ps.  It equals plain #18
  and, over the kv4 nibble slabs, plain #20 bit for bit in ctx and m, d
  within 1e-6 relative, and plain #17 within 1e-6 relative (only d's f32
  order differs), at 1, 2, 4 and 8 ranks, with ragged and empty slots.
* The cluster-size chooser (``split_parts``, its nibble mode too) at the
  engines' and chip_smoke's shapes, from the card's cluster counts alone
  (never the lengths), and the shared-memory cap of a rank.
* #17's tensor-core fragments in numpy: its time-major K rows load as the
  m16n8k32 A fragments with no transpose (q8 in the same feature order as
  B), its V rows take #19's byte-transposed kv8 PV fragments; the lanes'
  loads and the score stores on distinct banks.
"""

import inspect

import numpy as np
import pytest
import torch

from lightcompress_tpu_torch.device import div
from lightcompress_tpu_torch.ops import attention as ta
from test_torch_attention_flash_tile import (_banks, _mma, _pv, _v_chunk,
                                             _word, lane7_64, sw128)
from test_torch_serving import one_torch_thread  # noqa: F401

H, D = 2, 128


def _case(G, S, seed, lengths, nib=False):
    """q (B, H, G, D) bf16, the int8 hhd cache (B, H, S, D) with bf16
    scales, its bd slabs, the fresh token, int32 lengths.  ``nib``: codes
    in [-8, 7] and the bd4 slabs that pack them (the low nibble of byte
    row h * D/2 + d feature d, the high one feature d + D/2)."""
    gen = torch.Generator().manual_seed(seed)
    B = len(lengths)
    q = torch.randn((B, H, G, D), generator=gen).to(torch.bfloat16)
    lo, hi = (-8, 8) if nib else (-127, 128)
    kq = torch.randint(lo, hi, (B, H, S, D), generator=gen,
                       dtype=torch.int8)
    vq = torch.randint(lo, hi, (B, H, S, D), generator=gen,
                       dtype=torch.int8)
    ks, vs = ((torch.rand((B, H, S), generator=gen) * 0.02 + 1e-3).to(
        torch.bfloat16) for _ in range(2))
    if nib:
        def pack(c):
            c = c.to(torch.int32)
            return ((c[..., :D // 2] & 0xF)
                    | ((c[..., D // 2:] & 0xF) << 4)).to(torch.int8)
        kt = pack(kq).transpose(2, 3).reshape(B, H * D // 2, S).contiguous()
        vt = pack(vq).transpose(1, 2).reshape(B, S, H * D // 2).contiguous()
    else:
        kt = kq.transpose(2, 3).reshape(B, H * D, S).contiguous()
        vt = vq.transpose(1, 2).reshape(B, S, H * D).contiguous()
    kn = torch.randint(-127, 128, (B, H, D), generator=gen, dtype=torch.int8)
    vn = torch.randint(-127, 128, (B, H, D), generator=gen, dtype=torch.int8)
    kns, vns = ((torch.rand((B, H), generator=gen) * 0.02 + 1e-3).to(
        torch.bfloat16) for _ in range(2))
    return q, (kq, ks, vq, vs), (kt, vt), (kn, kns, vn, vns), \
        torch.tensor(lengths, dtype=torch.int32)


def split_render(q, kq, ks, vq, vs, L, parts, fresh=None):
    """The kernel's split schedule: #18 (``fresh`` None) -> (ctx, m, d), #17
    -> the normalized context.  Scores, e, pv and p8 elementwise as the
    plain versions; the reductions over the ranks in rank order."""
    B, Hh, G, Dd = q.shape
    S = kq.shape[2]
    q8, qs = ta.quantize_q(q)
    qsc = qs * Dd ** -0.5
    sc = torch.matmul(q8.double(), kq.double().transpose(-1, -2))
    scf = (sc.float() * qsc[..., None]) * ks.float()[:, :, None, :]
    valid = (torch.arange(S)[None, :] < L[:, None])[:, None, None, :]
    scf = scf.masked_fill(~valid, float("-inf"))
    per = ta.kv8_columns(S, parts)
    spans = [(r * per, min(S, (r + 1) * per)) for r in range(parts)]
    # meet (a): the ranks' maxima in order (an empty rank's is -inf)
    m = None
    for a, b in spans:
        mr = scf[..., a:b].amax(dim=-1) if b > a else \
            torch.full(scf.shape[:-1], float("-inf"))
        m = mr if m is None else torch.maximum(m, mr)
    if fresh is None:
        m = torch.clamp(m, min=-1e30)
    else:
        kn, kns, vn, vns = fresh
        scn = torch.matmul(q8.double(), kn.double()[..., None])[..., 0]
        snew = (scn.float() * qsc) * kns.float()[..., None]
        m = torch.maximum(m, snew)
    e = torch.exp(scf - m[..., None])
    pv = e * vs.float()[:, :, None, :]
    # meet (b): max(pv) and the ranks' sums of e in order
    d = torch.zeros(m.shape)
    pmax = torch.zeros(m.shape)
    for a, b in spans:
        if b > a:
            d = d + e[..., a:b].sum(dim=-1)
            pmax = torch.maximum(pmax, pv[..., a:b].amax(dim=-1))
    ps = div(torch.clamp(pmax, min=1e-20), 127.0)[..., None]
    p8 = torch.round(pv / ps).double()
    # meet (c): the ranks' int32 PV sums, exact
    acc = torch.zeros(q.shape, dtype=torch.int64)
    for a, b in spans:
        if b > a:
            part = torch.matmul(p8[..., a:b], vq[:, :, a:b].double())
            assert (part.abs() < 2 ** 31).all()
            acc = acc + part.long()
    ctx = acc.double().float() * ps
    if fresh is None:
        return ctx, m, d
    en = torch.exp(snew - m)
    pvn = en * vns.float()[..., None]
    ctx = ctx + pvn[..., None] * vn.float()[:, :, None, :]
    return ctx / (d + en)[..., None]


LENGTHS = {"ragged": [0, 208, 1, 100, 37], "empty": [0, 0, 0],
           "full": [208, 208]}


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_split_render_equals_plain(case, G, parts):
    """At S 208 (ranks of 208, 112, 64 and 32 columns; at 8 the last rank
    is empty): #18's ctx and m bit for bit plain #18's, d within 1e-6
    relative; #17 within 1e-6 relative of plain #17 (elementwise: only d
    differs)."""
    S = 208
    q, (kq, ks, vq, vs), (kt, vt), fresh, L = _case(
        G, S, 7 * G + parts + len(case), LENGTHS[case])
    ctx, m, d = split_render(q, kq, ks, vq, vs, L, parts)
    rc, rm, rd = ta.decode_attention_bd_plain(q, kt, ks, vt, vs, L)
    assert torch.equal(ctx, rc) and torch.equal(m, rm)
    assert ((d - rd).abs() <= 1e-6 * rd.abs()).all()
    if case == "empty":
        assert (ctx == 0).all() and (m == -1e30).all() and (d == 0).all()
    out = split_render(q, kq, ks, vq, vs, L, parts, fresh)
    ref = ta.decode_attention_i8_plain(q, kq, ks, vq, vs, *fresh, lengths=L)
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= 1e-6 * ref.abs()).all()


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_split_render_equals_plain_bd4(case, G, parts):
    """#20's split (the kernel's nibble mode: the same meets as #18, ps a
    max over the whole row) over the kv4 bd4 slabs at S 208: ctx and m bit
    for bit plain #20's, d within 1e-6 relative, at every rank count; an
    empty slot's (0, -1e30, 0)."""
    S = 208
    q, (kq, ks, vq, vs), (kt4, vt4), _, L = _case(
        G, S, 11 * G + parts + len(case), LENGTHS[case], nib=True)
    ctx, m, d = split_render(q, kq, ks, vq, vs, L, parts)
    rc, rm, rd = ta.decode_attention_bd4_plain(q, kt4, ks, vt4, vs, L)
    assert torch.equal(ctx, rc) and torch.equal(m, rm)
    assert ((d - rd).abs() <= 1e-6 * rd.abs()).all()
    if case == "empty":
        assert (ctx == 0).all() and (m == -1e30).all() and (d == 0).all()
    assert torch.equal(split_render(q, kq, ks, vq, vs, L, 1)[0], ctx)


# ---------------------------------------------------------------------------
# the chooser and the cap
# ---------------------------------------------------------------------------

# the co-resident clusters of an H100-like card (132 SMs in GPCs of up to
# 18): three CTAs an SM, clusters within a GPC
def _h100_clusters(parts):
    return {1: 396, 2: 198, 4: 99, 8: 48}[parts]


def test_split_parts_never_read_lengths():
    """The chooser and the card's query take no lengths: they live on the
    device, and a host read would stall the stream."""
    for fn in (ta.split_parts, ta.split_card_parts, ta.split_clusters):
        assert "lengths" not in inspect.signature(fn).parameters
    assert "mode" in inspect.signature(ta.split_parts).parameters
    assert set(ta.SPLIT_MODES) == {"bd", "i8", "bd4"}


MAIN_SHAPES = [(64, 512, 4), (64, 4096, 4), (8, 4096, 4), (256, 4096, 8),
               (8, 16384, 4), (64, 16, 1)]


def _check_main_shape(pairs, S, G, mode):
    """The pick is a cluster size whose share fits, at the least modelled
    cost, fewer parts on ties; more parts where the card has room for
    them."""
    p = ta.split_parts(pairs, S, G, _h100_clusters, mode)
    assert p in ta.CLUSTER_PARTS
    assert ta.split_smem_bytes(G, ta.kv8_columns(S, p), 1, mode) \
        <= ta.SMEM_MAX

    def cost(x):
        return -(-pairs // _h100_clusters(x)) * (
            ta.kv8_columns(S, x) + ta.SPLIT_FIXED_COLUMNS)

    fits = [x for x in ta.CLUSTER_PARTS
            if ta.split_smem_bytes(G, ta.kv8_columns(S, x), 1, mode)
            <= ta.SMEM_MAX]
    assert all(cost(p) < cost(x) for x in fits if x < p)
    assert all(cost(p) <= cost(x) for x in fits if x > p)
    assert ta.split_parts(pairs, S, G, lambda x: 10 ** 6, mode) >= p


@pytest.mark.parametrize("pairs,S,G", MAIN_SHAPES)
def test_split_parts_at_the_main_shapes(pairs, S, G):
    """The engines' and chip_smoke's shapes (8 slots of 8 kv heads over 512
    and 4096 columns) and others, in #17/#18's mode (``_check_main_shape``)."""
    _check_main_shape(pairs, S, G, "bd")


@pytest.mark.parametrize("pairs,S,G", MAIN_SHAPES)
def test_split_parts_at_the_main_shapes_bd4(pairs, S, G):
    """The same shapes in #20's nibble mode."""
    _check_main_shape(pairs, S, G, "bd4")


def test_split_parts_at_the_cap():
    """Past a CTA's shared memory at fewer parts, only the largest split
    takes S; past it at 8 parts, the chooser raises (the wrappers raise
    before it, ``split_fits``)."""
    assert ta.split_parts(64, 86016, 4, _h100_clusters) == 8
    assert ta.split_fits(4, 86016) and not ta.split_fits(4, 86032)
    with pytest.raises(ValueError):
        ta.split_parts(64, 86032, 4, _h100_clusters)
    for G in (1, 2, 4, 8):
        for S in (16, 512, 4096, 16384):
            per = ta.kv8_columns(S, 1)
            if ta.split_smem_bytes(G, per, 1) <= ta.SMEM_MAX:
                n = ta.split_slots(G, per)
                assert 1 <= n <= ta.SPLIT_SLOTS
                assert ta.split_smem_bytes(G, per, n) <= ta.SMEM_MAX


# the largest S #20's split takes at G queries a kv head (a rank's share
# at 8 parts within 227 KB; its ring slots hold R = 64 bytes a column)
BD4_CAP = {1: 282880, 2: 169216, 4: 93184, 8: 48640}


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_split_parts_at_the_cap_bd4(G):
    """The nibble mode's cap: the ring's smaller slots leave more room for
    the scores than #18's (86016 at G 4); at the cap only 8 parts fit, one
    column more and ``split_fits`` and the chooser refuse; every ring
    depth ``split_slots`` picks fits."""
    S = BD4_CAP[G]
    assert ta.split_fits(G, S, "bd4")
    assert not ta.split_fits(G, S + 16, "bd4")
    assert ta.split_smem_bytes(G, ta.kv8_columns(S, 8), 1, "bd4") \
        <= ta.SMEM_MAX < ta.split_smem_bytes(G, ta.kv8_columns(S, 8), 1)
    assert ta.split_parts(64, S, G, _h100_clusters, "bd4") == 8
    with pytest.raises(ValueError):
        ta.split_parts(64, S + 16, G, _h100_clusters, "bd4")
    for S in (16, 512, 4096, 8192, S):
        for parts in ta.CLUSTER_PARTS:
            per = ta.kv8_columns(S, parts)
            if ta.split_smem_bytes(G, per, 1, "bd4") <= ta.SMEM_MAX:
                n = ta.split_slots(G, per, "bd4")
                assert 1 <= n <= ta.SPLIT_SLOTS
                assert ta.split_smem_bytes(G, per, n, "bd4") <= ta.SMEM_MAX


@pytest.mark.parametrize("S,parts", [(16, 8), (208, 8), (512, 4),
                                     (4097 // 16 * 16, 8), (86016, 8)])
def test_split_ranks_tile_the_buffer(S, parts):
    """Ranks of ``kv8_columns(S, parts)`` columns (a multiple of 16) cover
    [0, S) in order; the ranks past S hold no column (they still meet)."""
    per = ta.kv8_columns(S, parts)
    assert per % 16 == 0 and per * parts >= S
    cols = [c for r in range(parts) for c in
            range(r * per, min(S, (r + 1) * per))]
    assert cols == list(range(S))
    assert 128 % parts == 0  # meet (c): D / parts features a rank


# ---------------------------------------------------------------------------
# #17's tensor-core fragments
# ---------------------------------------------------------------------------

CH = 64


def _i8_chunk(rows, nv):
    """The ring slot of a #17 K or V chunk: nv time-major rows of 128 bytes
    (the TMA box, 128-byte swizzle); the rest zeros."""
    buf = np.zeros(CH * D, np.int64)
    for t in range(nv):
        for c in range(D // 16):
            o = sw128(t, c)
            buf[o:o + 16] = rows[t, 16 * c:16 * c + 16] & 0xFF
    return buf


def _i8_q_frags(q8, G):
    """The lanes' B fragments of q8 (G, D) for the four k steps: features
    32 tig + 8 ks + 0..3 (b0) and + 4..7 (b1)."""
    qb = np.zeros((32, 4, 2), np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        if g >= G:
            continue
        for ks in range(4):
            for s in range(2):
                f = 32 * tig + 8 * ks + 4 * s
                v = q8[g, f:f + 4].astype(np.int64) & 0xFF
                qb[lane, ks, s] = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24
    return qb


def _i8_scores(buf, qb):
    """A chunk's QK on the tile: m16 tile i is time steps 16 i .. 16 i + 15;
    lane (g, tig) loads 16 bytes at sw128(16 i + g + 8 rr, 2 tig + hh), and
    k step ks takes words 2 ks and 2 ks + 1 of its 32 bytes of each row."""
    out = np.zeros((CH, 8), np.int64)
    for i in range(4):
        acc = np.zeros((32, 4), np.int64)
        for ks in range(4):
            a = []
            for lane in range(32):
                g, tig = lane >> 2, lane & 3
                w = [[_word(buf, sw128(16 * i + g + 8 * rr, 2 * tig + hh)
                            + 4 * c) for hh in range(2) for c in range(4)]
                     for rr in range(2)]
                a.append([w[0][2 * ks], w[1][2 * ks], w[0][2 * ks + 1],
                          w[1][2 * ks + 1]])
            acc += np.array(_mma(a, [qb[ln, ks] for ln in range(32)]))
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            for e in range(4):
                out[16 * i + g + 8 * (e >> 1), 2 * tig + (e & 1)] = \
                    acc[lane, e]
    return out


@pytest.mark.parametrize("nv", [64, 37, 1])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_i8_tile_scores(G, nv):
    """A #17 K chunk's scores on the tile equal q8 . k at every valid time
    step, with no byte transpose."""
    rng = np.random.RandomState(G + 5 * nv)
    rows = rng.randint(-128, 128, (CH, D))
    q8 = rng.randint(-127, 128, (G, D))
    got = _i8_scores(_i8_chunk(rows, nv), _i8_q_frags(q8, G))
    assert np.array_equal(got[:nv, :G], (q8 @ rows.T).T[:nv])


@pytest.mark.parametrize("nv", [64, 20])
@pytest.mark.parametrize("G", [1, 8])
def test_i8_tile_pv(G, nv):
    """A #17 V chunk (the hhd cache's time-major rows, as #18's V slab's)
    through #19's kv8 PV fragments equals p8 . v over its valid steps."""
    rng = np.random.RandomState(50 + G + nv)
    rows = rng.randint(-128, 128, (CH, D))
    buf = _v_chunk(rows, nv, False, rng.randint(0, 256, CH * D))
    p8 = rng.randint(0, 128, (8, CH))
    p8[:, nv:] = 0
    assert np.array_equal(_pv(buf, p8, G, False)[:G], p8[:G] @ rows)


@pytest.mark.parametrize("i", [0, 3])
@pytest.mark.parametrize("hh", [0, 1])
def test_i8_tile_loads_and_stores_on_distinct_banks(i, hh):
    """#17's 16-byte K loads hit distinct banks (the 128-byte swizzle); the
    score stores of both layouts (#17: time step 16 i + g + 8 rr, #18: 8 g
    + u; query 2 tig + (e & 1)) put at most two lanes on a bank at every
    split's row stride."""
    lanes = [(ln >> 2, ln & 3) for ln in range(32)]
    for rr in range(2):
        k = [sw128(16 * i + g + 8 * rr, 2 * t + hh) for g, t in lanes]
        assert _banks(k, 16) == 1
    assert lane7_64(0, 0) == 0  # the #18 layout is #19's
    for S, parts in ((512, 4), (4096, 4), (4096, 8), (208, 2)):
        ss = (ta.kv8_columns(S, parts) + 31) // 32 * 32 + 9
        for e in range(4):
            for rows in ([16 * i + g + 8 * (e >> 1) for g, _ in lanes],
                         [8 * g + 2 * i + (e >> 1) for g, _ in lanes]):
                words = [(2 * t + (e & 1)) * ss + r
                         for (g, t), r in zip(lanes, rows)]
                per_bank = {}
                for w in words:
                    per_bank.setdefault(w % 32, set()).add(w)
                assert max(len(v) for v in per_bank.values()) <= 2
