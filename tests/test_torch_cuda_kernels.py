"""The Hopper W4 kernels against their plain versions on the card.

Marked ``cuda``: they skip without a CUDA device (a CUDA kernel has no CPU
mode).  On a machine with the card, where JAX (which
``tests/conftest.py`` imports) may be absent: ``python -m pytest
--noconftest -m cuda tests/test_torch_cuda_kernels.py``.  Imports no JAX."""

import dataclasses

import pytest
import torch

from lightcompress_tpu_torch.device import bf16_ulp
from lightcompress_tpu_torch.models import ArchSpec, Llama, init_params
from lightcompress_tpu_torch.models import arch as A
from lightcompress_tpu_torch.ops import moe_matmul as MM
from lightcompress_tpu_torch.ops import w4_matmul as W
from lightcompress_tpu_torch.ops.qlinear import quantize_linear
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, build_serving_weights,
                                             quantize_kv)
from lightcompress_tpu_torch.serving import quantized_model as QM

pytestmark = pytest.mark.cuda

WSPEC = QuantSpec(bit=4, symmetric=False, granularity="per_group",
                  group_size=128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' f32 matmuls in full f32 (the default, set here)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(dev, N, K):
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + K)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    return quantize_linear(w, WSPEC), gen


@pytest.mark.parametrize("M", [1, 7, 33, 300, 1000])
@pytest.mark.parametrize("N,K", [(128, 1024), (256, 14336), (6144, 4096)])
def test_kernels_match_plain(dev, M, N, K):
    """#1 within summation-order noise of its plain version; #2 (on the
    body ``planes_body(M)`` picks) and #3 (the planes tile: ragged M
    against its 64-row tiles, the fused q|k|v width 6144) equal to their
    plain versions bit for bit in f32 and bf16."""
    qp, gen = _weights(dev, N, K)
    args = (qp.codes, qp.scales, qp.zeros)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs = W.quantize_act_per_token(x)
    W.reset_launch_counts()
    pairs = [
        # f32 output from the f32 input path: summation-order noise only
        (W.w4a16_matmul(x.float(), *args), W.w4a16_matmul_plain(x, *args),
         1e-4),
    ]
    exact = [
        (W.w4a8_matmul_decode(xq, xs, *args),
         W.w4a8_matmul_decode_plain(xq, xs, *args)),
        (W.w4a8_matmul_prefill(xq, xs, *args, out_dtype=torch.float32),
         W.w4a8_matmul_prefill_plain(xq, xs, *args, torch.float32)),
        (W.w4a8_matmul_prefill(xq, xs, *args),
         W.w4a8_matmul_prefill_plain(xq, xs, *args)),
    ]
    torch.cuda.synchronize()
    for got, ref, tol in pairs:
        err = (got.float() - ref.float()).abs().max()
        assert err <= tol * ref.float().abs().max(), (err, tol)
    for got, ref in exact:
        assert got.dtype == ref.dtype and torch.isfinite(got).all()
        assert torch.equal(got, ref)
    assert [k.launches for k in W.KERNELS] == [1, 1, 2, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", [(1024, 4096), (4096, 14336)])
@pytest.mark.parametrize("M", [1, 8, 16, 32, 64, 256])
def test_planes_decode_bodies_equal_plain(dev, M, N, K, store):
    """#2 on both of its bodies (the planes decode tile with 16 and with 32
    channels a block, and #3's planes tile) at M 1-256: bit for bit its
    plain version (``w4a8_rows_tpu_order``) stored in f32 or bf16, the same
    bits on a second call; each launch counted on #2."""
    qp, gen = _weights(dev, N, K)
    args = (qp.codes, qp.scales, qp.zeros)
    xq, xs = W.quantize_act_per_token(
        torch.randn((M, K), generator=gen, device=dev) * 3)
    ref = W.w4a8_matmul_decode_plain(xq, xs, *args, store)
    W.reset_launch_counts()
    runs = [lambda c=c: W._w4a8_matmul_decode(xq, xs, *args, store,
                                              "decode", c)
            for c in (16, 32)]
    runs.append(lambda: W._w4a8_matmul_decode(xq, xs, *args, store, "tile"))
    for run in runs:
        got = run()
        again = run()
        torch.cuda.synchronize()
        assert got.dtype == store and torch.isfinite(got).all()
        assert torch.equal(got, ref)
        assert torch.equal(got, again)
    assert W.w4a8_matmul_decode.launches == 6
    assert torch.equal(W.w4a8_matmul_decode(xq, xs, *args, store), ref)


def test_kernels_reject_what_they_cannot_take(dev):
    qp, _ = _weights(dev, 128, 1024)
    x = torch.zeros((4, 1024), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        W.w4a16_matmul(x, qp.codes, qp.scales.float(), qp.zeros)
    with pytest.raises(ValueError):
        W.w4a16_matmul(x[:, :512], qp.codes[:, :64], qp.scales[:, :4],
                       qp.zeros[:, :4])
    xq, xs = W.quantize_act_per_token(x)
    with pytest.raises(ValueError):  # #3's tile takes N % 128 == 0
        W.w4a8_matmul_prefill(xq, xs, qp.codes[:64], qp.scales[:64],
                              qp.zeros[:64])
    with pytest.raises(ValueError):  # so does #2's from PLANES_TILE_MIN_M
        W._w4a8_matmul_decode(xq, xs, qp.codes[:64], qp.scales[:64],
                              qp.zeros[:64], torch.float32, "tile")
    with pytest.raises(RuntimeError):  # 24 channels a block: refused
        W._w4a8_matmul_decode(xq, xs, qp.codes, qp.scales, qp.zeros,
                              torch.float32, "decode", 24)


def test_quantization_on_card_matches_cpu(dev):
    """Weight codes, bf16 scales and zero corrections, int8 activations and
    KV codes are the same bits on the card as on the CPU (which the CPU
    tests hold to the JAX package), bf16 ties included."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    w = (torch.randn((256, 2048), generator=gen) * 0.03).to(
        torch.bfloat16).float()
    a, b = quantize_linear(w, WSPEC), quantize_linear(w.to(dev), WSPEC)
    for name in ("codes", "scales", "zeros"):
        assert torch.equal(getattr(a, name), getattr(b, name).cpu()), name
    x = (torch.randn((64, 2048), generator=gen) * 3).to(torch.bfloat16)
    for fn in (W.quantize_act_per_token, quantize_kv):
        for p, q in zip(fn(x), fn(x.to(dev))):
            assert torch.equal(p, q.cpu()), fn.__name__


def test_engine_on_card_matches_cpu(dev):
    """Prefill logits at W4A8 (256 rows: the decode kernel) on the card
    against the CPU path: the same codes, sums in other orders that the
    int8 act quant turns into rare one-step code flips -> corr >= 0.999."""
    arch = ArchSpec("llama", vocab_size=256, hidden_size=1024,
                    intermediate_size=2048, num_layers=2, num_heads=8,
                    num_kv_heads=2, head_dim=128)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    model = Llama(arch, init_params(gen, arch))
    ids = torch.randint(0, 256, (4, 64), generator=gen)
    tl = torch.tensor([64, 50, 33, 9])
    logits, sws = {}, {}
    for d in ("cpu", dev):
        sws[str(d)] = sw = build_serving_weights(model, WSPEC, act_bits=8,
                                                 device=d)
        eng = LLMEngine(sw, max_slots=4, max_len=128, prefill_buckets=(64,),
                        device=d)
        logits[str(d)] = eng._prefill_batch(ids.to(d), torch.arange(4).to(d),
                                            tl.to(d), 64).cpu()
    assert torch.equal(sws["cpu"].lm_head, sws[str(dev)].lm_head.cpu())
    a, b = logits["cpu"], logits[str(dev)]
    for i in range(4):
        assert torch.corrcoef(torch.stack([a[i], b[i]]))[0, 1] >= 0.999


# ---------------------------------------------------------------------------
# decode attention (#17, #20, #21)
# ---------------------------------------------------------------------------

ATT_H, ATT_G, ATT_D = 8, 4, 128


def _ragged(B, S, dev):
    """Lengths with an empty slot, a full one and ragged ones between."""
    lens = [0, S, 1, S // 2 + 3, S - 5, 17, S // 3, 100]
    return torch.tensor(lens[:B] if B > 1 else [S - 7], device=dev)


def _attn_inputs(dev, B, S, seed):
    from lightcompress_tpu_torch.serving.kv_cache import quantize_kv4

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((B, ATT_H, ATT_G, ATT_D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev) * 2
    v = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev)
    return q, k, v, quantize_kv4


def _bd4_slabs(k, v, quantize_kv4):
    B, H, S, D = k.shape
    k4, ks = quantize_kv4(k)
    v4, vs = quantize_kv4(v)
    kt4 = k4.transpose(2, 3).reshape(B, H * D // 2, S).contiguous()
    vt4 = v4.transpose(1, 2).reshape(B, S, H * D // 2).contiguous()
    return kt4, ks, vt4, vs


def _check_partials(got, ref):
    """m and d to relative 1e-5; the normalized context to 2e-2 of its
    largest value (an ulp of exp may flip one int8 probability code)."""
    (c, m, d), (rc, rm, rd) = got, ref
    assert torch.equal(torch.isfinite(m), torch.isfinite(rm))
    assert ((m - rm).abs() <= 1e-5 * rm.abs()).all()
    assert ((d - rd).abs() <= 1e-5 * rd.abs()).all()
    n = c / d.clamp_min(1e-30)[..., None]
    rn = rc / rd.clamp_min(1e-30)[..., None]
    assert (n - rn).abs().max() <= 2e-2 * rn.abs().max()


@pytest.mark.parametrize("B,G", [(1, 1), (8, 2), (8, 4), (16, 8), (32, 8)])
@pytest.mark.parametrize("S", [512, 4096, 8192])
def test_bd4_kernels_match_plain(dev, B, S, G):
    """#20 (the split kernel's nibble mode) and #21 against their plain
    versions, ragged, empty and full slots, B 1-32, G 1-8 (G 8 at B 16 and
    32: a ring slot refilled only after its products): #20's m bit for bit,
    a second call the same bits, and on every forced cluster size (1, 2, 4,
    8) and ring depth (1, 2) ctx and m the same bits as the wrapper's, d
    within 1e-6 relative (``_split_across_parts``)."""
    from lightcompress_tpu_torch.ops import attention as T

    q, slabs, lens = _flash_case(dev, True, B, S, G, S + B + G)
    for lengths in lens:
        T.reset_launch_counts()
        got = T.decode_attention_bd4(q, *slabs, lengths)
        again = T.decode_attention_bd4(q, *slabs, lengths)
        ref = T.decode_attention_bd4_plain(q, *slabs, lengths)
        _check_partials(
            T.decode_attention_bd4_flash(q, *slabs, lengths),
            T.decode_attention_bd4_flash_plain(q, *slabs, lengths))
        torch.cuda.synchronize()
        assert [k.launches for k in T.KERNELS] == [0, 2, 1, 0, 0, 0]
        _check_flash(got, again, ref)
        _split_across_parts(T, q, slabs, lengths, got, "bd4")


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("S", [512, 4096, 8192])
def test_i8_kernel_matches_plain(dev, B, S):
    from lightcompress_tpu_torch.ops import attention as T

    q, k, v, _ = _attn_inputs(dev, B, S, S + B + 1)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    kn, kns = quantize_kv(k[:, :, :1] * 1.5)
    vn, vns = quantize_kv(v[:, :, :1])
    fresh = (kn[:, :, 0], kns[:, :, 0], vn[:, :, 0], vns[:, :, 0])
    L = _ragged(B, S, dev)
    T.reset_launch_counts()
    got = T.decode_attention_i8(q, kq, ks, vq, vs, *fresh, lengths=L)
    ref = T.decode_attention_i8_plain(q, kq, ks, vq, vs, *fresh, lengths=L)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert [k.launches for k in T.KERNELS] == [1, 0, 0, 0, 0, 0]


def test_attention_launch_refused_raises(dev):
    """A rank of #20's split holds its share's scores in shared memory:
    forced to one CTA a pair at S = 16384 it needs about 270 KB, above the
    227 KiB a block may have, so the launch is refused and the launch
    raises; past ``split_fits`` (S 93184 at G 4) the wrapper raises and
    names the flash kernel, which takes that buffer."""
    from lightcompress_tpu_torch.ops import attention as T

    B, S = 1, 16384
    q = torch.zeros((B, ATT_H, ATT_G, ATT_D), device=dev,
                    dtype=torch.bfloat16)
    kt4 = torch.zeros((B, ATT_H * ATT_D // 2, S), device=dev,
                      dtype=torch.int8)
    vt4 = torch.zeros((B, S, ATT_H * ATT_D // 2), device=dev,
                      dtype=torch.int8)
    sc = torch.ones((B, ATT_H, S), device=dev, dtype=torch.bfloat16)
    assert T.split_smem_bytes(ATT_G, S, 1, "bd4") > T.SMEM_MAX
    q8, qs = T.quantize_q(q)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((B, ATT_H, ATT_G, ATT_D), **f32),
            torch.empty((B, ATT_H, ATT_G), **f32),
            torch.empty((B, ATT_H, ATT_G), **f32))
    with pytest.raises(RuntimeError, match="CUDA error"):
        T._split_launch(q8, qs, (kt4, sc, vt4, sc), T._lengths(None, B, S,
                                                               dev),
                        outs, 1, 1, "bd4")
    with pytest.raises(ValueError):
        T.decode_attention_bd4(q, kt4, sc.float(), vt4, sc)
    S = 93200
    assert T.split_fits(ATT_G, S - 16, "bd4")
    assert not T.split_fits(ATT_G, S, "bd4")
    kt4 = torch.zeros((B, ATT_H * ATT_D // 2, S), device=dev,
                      dtype=torch.int8)
    vt4 = torch.zeros((B, S, ATT_H * ATT_D // 2), device=dev,
                      dtype=torch.int8)
    sc = torch.ones((B, ATT_H, S), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bd4_flash"):
        T.decode_attention_bd4(q, kt4, sc, vt4, sc)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [512, 1280, 4096])
def test_bd_kernels_match_plain(dev, S, G):
    """#18 and #19 (the engine's 512-column block: at S 1280 it halves to
    256) over the kv8 bd slabs at 8 slots with ragged lengths."""
    from lightcompress_tpu_torch.ops import attention as T

    B = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(S + G)
    q = torch.randn((B, ATT_H, G, ATT_D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev) * 2
    v = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    kt = kq.transpose(2, 3).reshape(B, ATT_H * ATT_D, S).contiguous()
    vt = vq.transpose(1, 2).reshape(B, S, ATT_H * ATT_D).contiguous()
    L = _ragged(B, S, dev)
    T.reset_launch_counts()
    for lengths in (L, None):
        _check_partials(T.decode_attention_bd(q, kt, ks, vt, vs, lengths),
                        T.decode_attention_bd_plain(q, kt, ks, vt, vs,
                                                    lengths))
        _check_partials(
            T.decode_attention_bd_flash(q, kt, ks, vt, vs, lengths,
                                        s_block=T.S_BLOCK),
            T.decode_attention_bd_flash_plain(q, kt, ks, vt, vs, lengths,
                                              s_block=T.S_BLOCK))
    torch.cuda.synchronize()
    assert [k.launches for k in T.KERNELS] == [0, 0, 0, 2, 2, 0]


def test_bd_whole_row_limit_raises(dev):
    """Above #18's shared-memory limit (a rank's share of S at 8 parts: S
    86016 at G 4) the wrapper raises and names the flash route; #19 takes
    the same buffer.  #17 raises alike."""
    from lightcompress_tpu_torch.ops import attention as T

    B, S = 1, 86032
    assert T.split_fits(ATT_G, S - 16) and not T.split_fits(ATT_G, S)
    q = torch.zeros((B, ATT_H, ATT_G, ATT_D), device=dev,
                    dtype=torch.bfloat16)
    kt = torch.zeros((B, ATT_H * ATT_D, S), device=dev, dtype=torch.int8)
    vt = torch.zeros((B, S, ATT_H * ATT_D), device=dev, dtype=torch.int8)
    sc = torch.ones((B, ATT_H, S), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bds"):
        T.decode_attention_bd(q, kt, sc, vt, sc)
    c, m, d = T.decode_attention_bd_flash(q, kt, sc, vt, sc)
    torch.cuda.synchronize()
    assert torch.isfinite(c).all() and (d == S).all()
    kq = kt.reshape(B, ATT_H, S, ATT_D)
    fresh = (torch.zeros((B, ATT_H, ATT_D), device=dev, dtype=torch.int8),
             sc[:, :, 0], torch.zeros((B, ATT_H, ATT_D), device=dev,
                                      dtype=torch.int8), sc[:, :, 0])
    with pytest.raises(ValueError, match="shared memory"):
        T.decode_attention_i8(q, kq, sc, kq, sc, *fresh)


def _split_case(dev, B, S, G, seed, nib=False):
    """q (B, 8, G, 128) bf16, the int8 hhd cache with bf16 scales, its kv8
    bd slabs (``nib``: the kv4 bd4 slabs of the same K and V), the fresh
    token, and lengths: ragged (an empty slot, a full one, one of a single
    column, the rest seeded), all 0, None."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((B, ATT_H, G, ATT_D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev) * 2
    v = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    kt = kq.transpose(2, 3).reshape(B, ATT_H * ATT_D, S).contiguous()
    vt = vq.transpose(1, 2).reshape(B, S, ATT_H * ATT_D).contiguous()
    if nib:
        from lightcompress_tpu_torch.serving.kv_cache import quantize_kv4
        kt, ks, vt, vs = _bd4_slabs(k, v, quantize_kv4)
    kn, kns = quantize_kv(k[:, :, :1] * 1.5)
    vn, vns = quantize_kv(v[:, :, :1])
    fresh = (kn[:, :, 0].contiguous(), kns[:, :, 0].contiguous(),
             vn[:, :, 0].contiguous(), vns[:, :, 0].contiguous())
    ragged = torch.randint(0, S + 1, (B,), generator=gen, device=dev)
    ragged[:3] = torch.tensor([0, S, 1], device=dev)[:B]
    return q, (kq, ks, vq, vs), (kt, ks, vt, vs), fresh, (
        ragged.to(torch.int32), torch.zeros(B, dtype=torch.int32,
                                            device=dev), None)


SPLIT_BG = [(1, 1), (8, 2), (8, 4), (3, 8), (16, 8), (32, 8)]
SPLIT_CASES = [(S, B, G) for S in (16, 512, 4096) for B, G in SPLIT_BG] + \
    [(16384, 8, 4), (16384, 2, 8)]


def _split_outs(T, q8, qs, cache, L, mode, fresh=None):
    """The split kernel in ``mode`` (#18 "bd", #20 "bd4", #17 "i8" with
    ``fresh``) on every cluster size (1, 2, 4, 8) and ring depth (1, 2)
    whose share fits: {(parts, slots): outputs}, fewest parts first."""
    B, H, G, D = q8.shape
    S = cache[0].shape[2] if mode == "i8" else cache[0].shape[-1]
    f32 = dict(dtype=torch.float32, device=q8.device)
    outs = {}
    for parts in T.CLUSTER_PARTS:
        for slots in (1, 2):
            if T.split_smem_bytes(G, T.kv8_columns(S, parts), slots,
                                  mode) > T.SMEM_MAX:
                continue
            o = (torch.empty((B, H, G, D), **f32),) if fresh is not None \
                else (torch.empty((B, H, G, D), **f32),
                      torch.empty((B, H, G), **f32),
                      torch.empty((B, H, G), **f32))
            T._split_launch(q8, qs, cache, L, o, parts, slots, mode, fresh)
            outs[parts, slots] = o
    return outs


def _split_across_parts(T, q, slabs, lengths, got, mode):
    """#18 ("bd") or #20 ("bd4") on every forced cluster size and ring depth:
    ctx and m the same bits as ``got`` (the wrapper's), d within 1e-6
    relative; an empty slot's (0, -1e30, 0)."""
    B, S = q.shape[0], slabs[0].shape[-1]
    q8, qs = T.quantize_q(q)
    outs = _split_outs(T, q8, qs, slabs, T._lengths(lengths, B, S, q.device),
                       mode)
    torch.cuda.synchronize()
    first = next(iter(outs.values()))  # the fewest parts that fit
    for o in list(outs.values()) + [got]:
        assert torch.equal(o[0], first[0])
        assert torch.equal(o[1], first[1])
        assert ((o[2] - first[2]).abs() <= 1e-6 * first[2].abs()).all()
    if lengths is not None and not lengths.any():
        assert (got[0] == 0).all() and (got[2] == 0).all()
        assert (got[1] == -1e30).all()


@pytest.mark.parametrize("S,B,G", SPLIT_CASES)
@pytest.mark.parametrize("kind", ["bd", "i8", "bd4"])
def test_split_kernels_equal_across_parts(dev, kind, S, B, G):
    """#18 (``bd``), #20 (``bd4``) and #17 (``i8``) on every cluster size
    (1, 2, 4, 8) and ring depth (1, 2): #18's and #20's ctx and m the same
    bits at every split and m its plain version's bit for bit; #17 within
    1e-6 relative across splits (only d's f32 order differs) and within
    2e-2 of its largest value against its plain version; a second call the
    same bits; the wrappers one launch a call.  S 16-16384 (past the old
    whole-row cap of 11488 at G 4), B 1-32, G 1-8 (G 8 at B 16 and 32: a
    ring slot refilled only after its products), ragged, empty and full
    slots."""
    from lightcompress_tpu_torch.ops import attention as T

    nib = kind == "bd4"
    q, cache, slabs, fresh, lens = _split_case(
        dev, B, S, G, S + 3 * B + G + len(kind), nib)
    i8 = kind == "i8"
    q8, qs = T.quantize_q(q)
    for lengths in lens:
        T.reset_launch_counts()
        if i8:
            L = T._lengths(lengths, B, S, dev)
            outs = _split_outs(T, q8, qs, cache, L, "i8", fresh)
            T.reset_launch_counts()
            got = T.decode_attention_i8(q, *cache, *fresh, lengths=lengths)
            again = T.decode_attention_i8(q, *cache, *fresh,
                                          lengths=lengths)
            ref = T.decode_attention_i8_plain(q, *cache, *fresh,
                                              lengths=lengths)
        else:
            run = T.decode_attention_bd4 if nib else T.decode_attention_bd
            plain = T.decode_attention_bd4_plain if nib else \
                T.decode_attention_bd_plain
            got = run(q, *slabs, lengths)
            again = run(q, *slabs, lengths)
            ref = plain(q, *slabs, lengths)
        torch.cuda.synchronize()
        assert [k.launches for k in T.KERNELS] == (
            [2, 0, 0, 0, 0, 0] if i8 else
            [0, 2, 0, 0, 0, 0] if nib else [0, 0, 0, 2, 0, 0])
        if i8:
            first = next(iter(outs.values()))  # the fewest parts that fit
            assert torch.equal(got, again)
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
            for o in list(outs.values()) + [(got,)]:
                assert ((o[0] - first[0]).abs()
                        <= 1e-6 * first[0].abs()).all()
        else:
            _check_flash(got, again, ref)
            _split_across_parts(T, q, slabs, lengths, got, kind)


def _flash_case(dev, nib, B, S, G, seed):
    """q (B, 8, G, 128) bf16 and the kv8 (or kv4, ``nib``) block-diagonal
    slabs of random K/V, with lengths: ragged (an empty slot, a full one,
    the rest seeded), all 0, and None (every column)."""
    from lightcompress_tpu_torch.serving.kv_cache import quantize_kv4

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((B, ATT_H, G, ATT_D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev) * 2
    v = torch.randn((B, ATT_H, S, ATT_D), generator=gen, device=dev)
    if nib:
        slabs = _bd4_slabs(k, v, quantize_kv4)
    else:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        slabs = (kq.transpose(2, 3).reshape(B, ATT_H * ATT_D, S).contiguous(),
                 ks,
                 vq.transpose(1, 2).reshape(B, S, ATT_H * ATT_D).contiguous(),
                 vs)
    ragged = torch.randint(0, S + 1, (B,), generator=gen, device=dev)
    ragged[:8] = _ragged(min(B, 8), S, dev)
    return q, slabs, (ragged.to(torch.int32),
                      torch.zeros(B, dtype=torch.int32, device=dev), None)


def _flash_fns(nib):
    from lightcompress_tpu_torch.ops import attention as T

    if nib:
        return (T.decode_attention_bd4_flash,
                T.decode_attention_bd4_flash_plain)
    return T.decode_attention_bd_flash, T.decode_attention_bd_flash_plain


def _check_flash(got, again, ref):
    """``_check_partials``, m bit for bit (the scores are exact int32 dots
    in both), and a second call's bits the first's."""
    _check_partials(got, ref)
    assert torch.equal(got[1], ref[1])
    for a, b in zip(got, again):
        assert torch.equal(a, b)


FLASH_BG = [(B, G) for B in (1, 8, 32) for G in (1, 2, 4, 8)]
FLASH_CASES = [(nib, S, sb) for nib in (False, True)
               for S in (512, 1280, 4096, 8192) + ((16384,) if nib else ())
               for sb in (512, 256)]


@pytest.mark.parametrize("nib,S,sb", FLASH_CASES)
@pytest.mark.parametrize("B,G", FLASH_BG)
def test_bd_flash_kernels_match_their_split(dev, nib, S, sb, B, G):
    """#19 (kv8) and #21 (kv4) against their plain versions at the ranks
    the wrapper picks (``bd_flash_card_parts``), S 512-16384 in blocks of
    512 or 256 columns (halved to divide S), ragged, empty and full
    slots; B 1-32, G 1-8 (G 8 at B 32: a ring slot refilled only after
    its products)."""
    from lightcompress_tpu_torch.ops import attention as T

    q, slabs, lens = _flash_case(dev, nib, B, S, G, S + 7 * B + G + nib)
    run, plain = _flash_fns(nib)
    sbk = T.flash_block(S, sb)
    parts, _ = T.bd_flash_card_parts(B * ATT_H, G, S, sbk, nib, dev)
    T.reset_launch_counts()
    for lengths in lens:
        got = run(q, *slabs, lengths, s_block=sb)
        again = run(q, *slabs, lengths, s_block=sb)
        ref = plain(q, *slabs, lengths, s_block=sb, parts=parts)
        torch.cuda.synchronize()
        _check_flash(got, again, ref)
        if lengths is not None and not lengths.any():
            assert (got[0] == 0).all() and (got[2] == 0).all()
            assert (got[1] == -1e30).all()
    assert run.launches == 2 * len(lens)


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("parts", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("nib", [False, True])
def test_bd_flash_each_split_matches_its_schedule(dev, nib, parts, slots):
    """#19/#21 on each forced split (16 ranks over 8 blocks: half of them
    past every block) and ring depth against the plain rendering of that
    split; a second call the same bits."""
    from lightcompress_tpu_torch.ops import attention as T

    B, S, G, sb = 8, 4096, 4, 512
    q, (kt, ks, vt, vs), lens = _flash_case(dev, nib, B, S, G,
                                            parts + 10 * slots + nib)
    _, plain = _flash_fns(nib)
    q8, qs = T.quantize_q(q)
    f32 = dict(dtype=torch.float32, device=dev)
    for lengths in lens:
        L = T._lengths(lengths, B, S, dev)
        outs = [(torch.empty((B, ATT_H, G, ATT_D), **f32),
                 torch.empty((B, ATT_H, G), **f32),
                 torch.empty((B, ATT_H, G), **f32)) for _ in range(2)]
        for o in outs:
            T._bd_flash_launch(q8, qs, kt, ks, vt, vs, L, o, sb, parts,
                               slots, nib)
        ref = plain(q, kt, ks, vt, vs, lengths, s_block=sb, parts=parts)
        torch.cuda.synchronize()
        _check_flash(outs[0], outs[1], ref)


@pytest.mark.parametrize("G,S", [(1, 40000), (4, 11488), (8, 5664)])
@pytest.mark.parametrize("nib", [False, True])
def test_bd_flash_largest_blocks(dev, nib, G, S):
    """One block of the whole buffer, as large as the whole-block kernel
    took (5 * G bytes of shared memory a column): at G 1 the block's V
    scales do not fit beside the ring and the softmax reads them from
    global memory."""
    from lightcompress_tpu_torch.ops import attention as T

    q, slabs, lens = _flash_case(dev, nib, 1, S, G, S + G + nib)
    run, plain = _flash_fns(nib)
    assert 5 * G * (S + ATT_D) + 32 * G <= T.SMEM_MAX
    for lengths in lens:
        got = run(q, *slabs, lengths, s_block=S)
        again = run(q, *slabs, lengths, s_block=S)
        ref = plain(q, *slabs, lengths, s_block=S, parts=1)
        torch.cuda.synchronize()
        _check_flash(got, again, ref)


@pytest.mark.parametrize("nib", [False, True])
def test_bd_flash_sixteen_column_blocks(dev, nib):
    """The JAX default block (256) halved to 16 at S 11504 (719 blocks):
    the kernel against the plain rendering of its split."""
    from lightcompress_tpu_torch.ops import attention as T

    B, S, G = 1, 11504, 4
    q, slabs, lens = _flash_case(dev, nib, B, S, G, 11 + nib)
    run, plain = _flash_fns(nib)
    parts, _ = T.bd_flash_card_parts(B * ATT_H, G, S, 16, nib, dev)
    for lengths in lens:
        got = run(q, *slabs, lengths, s_block=T.FLASH_BLOCK)
        again = run(q, *slabs, lengths, s_block=T.FLASH_BLOCK)
        ref = plain(q, *slabs, lengths, s_block=T.FLASH_BLOCK, parts=parts)
        torch.cuda.synchronize()
        _check_flash(got, again, ref)


@pytest.mark.parametrize("impl,kernel", [("bd", "decode_attention_bd"),
                                         ("bds", "decode_attention_bd_flash")])
def test_bd_engine_launches_once_a_layer_and_step(dev, impl, kernel):
    """The bd/bds engines on the card: their kernel once a layer and
    decode step, no other attention kernel."""
    import warnings

    from lightcompress_tpu_torch.ops import attention as T
    from lightcompress_tpu_torch.serving import SamplingParams

    arch = ArchSpec("llama", vocab_size=256, hidden_size=1024,
                    intermediate_size=2048, num_layers=2, num_heads=8,
                    num_kv_heads=2, head_dim=128)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    sw = build_serving_weights(Llama(arch, init_params(gen, arch)), WSPEC,
                               act_bits=8, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = LLMEngine(sw, max_slots=2, max_len=600, prefill_buckets=(16,),
                        attn_impl=impl, device=dev)
    T.reset_launch_counts()
    out = eng.generate([[1, 2, 3], [4, 5, 6, 7]],
                       SamplingParams(max_new_tokens=5))
    torch.cuda.synchronize()
    assert [len(o) for o in out] == [5, 5]
    assert {k.__name__: k.launches for k in T.KERNELS if k.launches} == {
        kernel: arch.num_layers * 4}


# ---------------------------------------------------------------------------
# s4 byte pairs and the fused linears (#12, #13, #14)
# ---------------------------------------------------------------------------

# (name, N, K, rms) of the fused build's decode linears at Llama-3-8B
# (q|k|v and gate|up merged), with the RMSNorm as the engine runs it
FUSED_SHAPES = [("qkv", 6144, 4096, True), ("o", 4096, 4096, False),
                ("gateup", 28672, 4096, True), ("down", 4096, 14336, False)]
# the kernels reduce sum(x*x) in another order than the plain version, which
# can move the rsqrt by an ulp and flip an act code at a rounding tie
FLIPS_PER_CODE = 1e-3


def _check_fused(got, ref, tol=None):
    """Output within ``tol`` of max|y| (None: one bf16 ulp at max|y|), act
    codes equal but for FLIPS_PER_CODE flips, act scales within an ulp of
    the rsqrt."""
    (y, c, s), (ry, rc, rs) = got, ref
    assert torch.isfinite(y).all() and y.dtype == ry.dtype
    flips = int((c != rc).sum())
    assert flips <= FLIPS_PER_CODE * c.numel(), flips
    assert ((s - rs).abs() <= 2.4e-7 * rs.abs()).all()
    top = float(ry.float().abs().max())
    lim = bf16_ulp(top) if tol is None else tol * top
    assert float((y.float() - ry.float()).abs().max()) <= lim


@pytest.mark.parametrize("M,name,N,K,rms", [
    (8, *s) for s in FUSED_SHAPES] + [
    (8, "qkv", 6144, 4096, False), (8, "down", 4096, 14336, True),
    (32, "down", 4096, 14336, False), (32, "down", 4096, 14336, True),
    (100, "o", 4096, 4096, False)])
def test_fused_and_s4_kernels_match_plain(dev, M, name, N, K, rms):
    """#12, #13 and #14 against their plain versions at the fused build's
    decode shapes; B = 32 at K = 14336 walks 8-row chunks of x whose int8
    codes (114.7 KB a chunk) would not fit a block's shared memory whole;
    M = 100 runs #12's tile."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + K + M)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    planes = quantize_linear(w, WSPEC)
    s4 = quantize_linear(w, WSPEC, layout="s4")
    assert s4.layout == "s4"
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    W.reset_launch_counts()
    kw = dict(rms=rms, eps=1e-5)
    _check_fused(
        W._fused_with_act(W.w4a8_linear_planes_fused, x, planes.codes,
                          planes.scales, planes.zeros, **kw),
        W.w4a8_linear_planes_fused_plain(x, planes.codes, planes.scales,
                                         planes.zeros, **kw))
    _check_fused(
        W._fused_with_act(W.w4a8_linear_bytes_fused, x, s4.codes,
                          s4.scales, s4.zeros, **kw),
        W.w4a8_linear_bytes_fused_plain(x, s4.codes, s4.scales, s4.zeros,
                                        **kw))
    xq, xs = W.quantize_act_per_token(x)
    got = W.w4a8_matmul_bytes(xq, xs, s4.codes, s4.scales, s4.zeros)
    ref = W.w4a8_matmul_bytes_plain(xq, xs, s4.codes, s4.scales, s4.zeros)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert [k.launches for k in W.KERNELS] == [0, 0, 0, 1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("N,K", [(1024, 4096), (256, 14336)])
@pytest.mark.parametrize("M", [1, 5, 8, 32, 33])
def test_bytes_fused_tile_equals_tpu_order(dev, M, N, K, rms, xdtype):
    """#13's int8 tensor-core tile: bit for bit the TPU kernel's order
    (``w4a8_matmul_pairs_tpu_order``) on its own exported act codes and
    scales, at most FLIPS_PER_CODE act-code flips against the plain
    prologue, the same bits on a second call; one or two m16 tiles (M 32)
    and a second row tile (M 33); K 4096 and 14 word blocks (14336)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + K + M)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    s4 = quantize_linear(w, WSPEC, layout="s4")
    assert s4.layout == "s4"
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(xdtype)
    wa = (s4.codes, s4.scales, s4.zeros)
    kw = dict(rms=rms, eps=1e-5)
    W.reset_launch_counts()
    y, codes, scales = W._fused_with_act(W.w4a8_linear_bytes_fused, x, *wa,
                                         **kw)
    again = W.w4a8_linear_bytes_fused(x, *wa, **kw)
    torch.cuda.synchronize()
    assert y.dtype == xdtype and y.shape == (M, N)
    assert torch.isfinite(y).all()
    ref = W.w4a8_matmul_pairs_tpu_order(codes, scales, *wa).to(xdtype)
    assert torch.equal(y, ref)
    assert torch.equal(y, again)
    _, pcodes, pscales = W.w4a8_linear_bytes_fused_plain(x, *wa, **kw)
    assert int((codes != pcodes).sum()) <= FLIPS_PER_CODE * codes.numel()
    assert ((scales - pscales).abs() <= 2.4e-7 * pscales.abs()).all()
    assert W.w4a8_linear_bytes_fused.launches == 2


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("N,K", [(1024, 4096), (256, 14336)])
@pytest.mark.parametrize("M", [1, 8, 32, 33])
def test_planes_fused_tile_equals_phase_dot(dev, M, N, K, rms, xdtype):
    """#14 on the planes decode tile: bit for bit its TPU kernel's order
    (``w4a8_rows_phase_dot``) on its own exported act codes and scales, at
    most FLIPS_PER_CODE act-code flips against the plain prologue and one
    bf16 ulp at max|y| from the plain version on x, the same bits
    on a second call; one or two m16 tiles (M 32) and a second row tile
    (M 33); K 4096 and 14 word blocks (14336)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + K + M + 1)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    planes = quantize_linear(w, WSPEC)
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(xdtype)
    wa = (planes.codes, planes.scales, planes.zeros)
    kw = dict(rms=rms, eps=1e-5)
    W.reset_launch_counts()
    y, codes, scales = W._fused_with_act(W.w4a8_linear_planes_fused, x, *wa,
                                         **kw)
    again = W.w4a8_linear_planes_fused(x, *wa, **kw)
    torch.cuda.synchronize()
    assert y.dtype == xdtype and y.shape == (M, N)
    assert torch.isfinite(y).all()
    ref = W.w4a8_rows_phase_dot(codes, scales, *wa).to(xdtype)
    assert torch.equal(y, ref)
    assert torch.equal(y, again)
    _check_fused((y, codes, scales),
                 W.w4a8_linear_planes_fused_plain(x, *wa, **kw))
    assert W.w4a8_linear_planes_fused.launches == 2


def test_bytes_fused_rejects_what_it_cannot_take(dev):
    """fp16 x, N % 32, K % 512 and f32 scales are refused on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    w = torch.randn((256, 1024), generator=gen, device=dev) * 0.02
    s4 = quantize_linear(w, WSPEC, layout="s4")
    x = torch.randn((8, 1024), generator=gen, device=dev)
    with pytest.raises(ValueError):
        W.w4a8_linear_bytes_fused(x.half(), s4.codes, s4.scales, s4.zeros)
    with pytest.raises(ValueError):
        W.w4a8_linear_bytes_fused(x, s4.codes[:240], s4.scales[:240],
                                  s4.zeros[:240])
    with pytest.raises(ValueError):
        W.w4a8_linear_bytes_fused(x[:, :640], s4.codes[:, :320],
                                  s4.scales[:, :5], s4.zeros[:, :5])
    with pytest.raises(ValueError):
        W.w4a8_linear_bytes_fused(x, s4.codes, s4.scales.float(),
                                  s4.zeros.float())


# (name, N, K) of the seven linears of an unfused Llama-3-8B block
BLOCK_SHAPES = [("q", 4096, 4096), ("k", 1024, 4096), ("v", 1024, 4096),
                ("o", 4096, 4096), ("gate", 14336, 4096),
                ("up", 14336, 4096), ("down", 4096, 14336)]


# #12's tile against its decode block: ragged M (64-row tiles), the
# crossover and its neighbours, a ragged N (96 against 128-channel tiles),
# symmetric weights (zs = 0)
S4_TILE_CASES = [
    (M, "ragged_n", 96, 4096, False) for M in (9, 33, 100, 255, 256)] + [
    (M, "down", 4096, 14336, False) for M in (9, 33, 100, 255)] + [
    (W.BYTES_TILE_MIN_M + d, "q", 4096, 4096, False) for d in (-1, 0, 1)] + [
    (M, "o_sym", 4096, 4096, True) for M in (8, 100, 256)]


@pytest.mark.parametrize("M,name,N,K,sym", [
    (M, *s, False) for s in BLOCK_SHAPES for M in (8, 256)] + S4_TILE_CASES)
def test_s4_kernel_matches_plain_at_block_shapes(dev, M, name, N, K, sym):
    """#12 at the shapes the unfused s4 engine launches it: a block's seven
    linears at decode (8 slots) and at a prefill of 256 rows; and its
    tile's edges (``S4_TILE_CASES``), whichever body ``bytes_body(M)``
    picks."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + K + M)
    # the s4 layout takes N % 128 == 0; a ragged N is the first N rows of
    # a wider weight (the kernel takes N % 32 == 0)
    w = torch.randn((-(-N // 128) * 128, K), generator=gen, device=dev) * 0.02
    spec = QuantSpec(bit=4, symmetric=sym, granularity="per_group",
                     group_size=128)
    s4 = quantize_linear(w, spec, layout="s4")
    assert s4.layout == "s4" and bool(s4.zeros.float().any()) != sym
    s4 = dataclasses.replace(s4, codes=s4.codes[:N], scales=s4.scales[:N],
                             zeros=s4.zeros[:N])
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    xq, xs = W.quantize_act_per_token(x)
    W.reset_launch_counts()
    got = W.w4a8_matmul_bytes(xq, xs, s4.codes, s4.scales, s4.zeros)
    ref = W.w4a8_matmul_bytes_plain(xq, xs, s4.codes, s4.scales, s4.zeros)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert [k.launches for k in W.KERNELS] == [0, 0, 0, 1, 0, 0, 0, 0, 0]


def test_fused_kernels_f32_and_symmetric(dev):
    """f32 activations in and out, and symmetric weights, whose s4 zero
    correction is exactly 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    spec = QuantSpec(bit=4, symmetric=True, granularity="per_group",
                     group_size=128)
    w = torch.randn((1024, 2048), generator=gen, device=dev) * 0.02
    planes = quantize_linear(w, spec)
    s4 = quantize_linear(w, spec, layout="s4")
    assert not s4.zeros.float().any()
    x = torch.randn((5, 2048), generator=gen, device=dev) * 3
    for rms in (False, True):
        _check_fused(
            W._fused_with_act(W.w4a8_linear_planes_fused, x, planes.codes,
                              planes.scales, planes.zeros, rms=rms),
            W.w4a8_linear_planes_fused_plain(x, planes.codes, planes.scales,
                                             planes.zeros, rms=rms), 1e-4)
        _check_fused(
            W._fused_with_act(W.w4a8_linear_bytes_fused, x, s4.codes,
                              s4.scales, s4.zeros, rms=rms),
            W.w4a8_linear_bytes_fused_plain(x, s4.codes, s4.scales,
                                            s4.zeros, rms=rms), 1e-4)
    with pytest.raises(ValueError):
        W.w4a8_linear_bytes_fused(x.half(), s4.codes, s4.scales, s4.zeros)


# ---------------------------------------------------------------------------
# the MoE kernels (#6, #8, #9) at Mixtral-8x7B's expert shapes: 8 experts,
# gate/up 14336 x 4096, down 4096 x 14336
# ---------------------------------------------------------------------------

MIXTRAL = ArchSpec(family="llama", vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, head_dim=128,
                   moe=A.MoESpec(num_experts=8, top_k=2,
                                 moe_intermediate_size=14336))
EXPERT_SHAPES = {"gate": (14336, 4096), "down": (4096, 14336)}


@pytest.fixture(scope="module")
def experts():
    """Stacked Mixtral-shaped expert weights, made once per module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    out = {}
    for name, (N, K) in EXPERT_SHAPES.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(N + 2 * K)
        w3 = (torch.randn((8, N, K), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        out[name] = QM.quantize_linear_stacked(w3, WSPEC)
        assert out[name].layout == "stacked_planes"
    return out


def _moe_close(got, ref):
    """The kernels run the plain versions' sequence of rounded f32 ops, so
    they are held to the f32 tolerance of the W4 kernels (1e-4 of the
    largest output); chip_smoke.py reports whether they are equal."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max()
    assert err <= 1e-4 * ref.abs().max(), err


def _acts(dev, shape, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    xq, xs = W.quantize_act_per_token(x.reshape(-1, shape[-1]))
    return xq.reshape(shape), xs.reshape(*shape[:-1], 1)


@pytest.mark.parametrize("B", [3, 8, 256])
@pytest.mark.parametrize("pair", [False, True])
def test_stacked_kernel_matches_plain(dev, experts, B, pair):
    qp = experts["down" if pair else "gate"]
    K = qp.codes.shape[2] * 8
    xq, xs = _acts(dev, (8, B, K) if pair else (B, K), B)
    args = (qp.codes, qp.scales, qp.zeros)
    MM.reset_launch_counts()
    got = MM.w4a8_stacked_matmul(xq, xs, *args, pair=pair)
    _moe_close(got, MM.w4a8_stacked_matmul_plain(xq, xs, *args, pair))
    assert [k.launches for k in MM.KERNELS] == [1, 0, 0, 0, 0]


@pytest.mark.parametrize("case", ["n1", "n2", "n3", "n4", "one_expert",
                                  "many", "bad_index"])
@pytest.mark.parametrize("name", ["gate", "down"])
def test_gathered_kernel_matches_plain(dev, experts, case, name):
    """#8 equals its plain version bit for bit: n = 1-4 tokens routed
    top-2 by a seeded router (2-8 selections, duplicate experts at n 3 and
    4), every selection on one expert, 40
    selections on one expert (three 16-row tiles), and indices out of
    range (NaN rows); ``down`` in pair mode (t_idx = arange).  A second
    call gives the same bits; one launch a call."""
    qp = experts[name]
    K = qp.codes.shape[2] * 8
    n = {"many": 20, "bad_index": 4}.get(case, int(case[1]) if
                                          case[0] == "n" else 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + len(case))
    topi, _ = A.moe_route(MIXTRAL.moe, torch.randn((n, 8), generator=gen,
                                                    device=dev))
    e_idx = topi.reshape(-1).to(torch.int32)
    if case in ("one_expert", "many"):
        e_idx = torch.full_like(e_idx, 5)
    n_sel = e_idx.shape[0]
    if name == "down":
        t_idx = torch.arange(n_sel, dtype=torch.int32, device=dev)
        xq, xs = _acts(dev, (n_sel, K), n_sel)
    else:
        t_idx = torch.arange(n, dtype=torch.int32,
                             device=dev).repeat_interleave(2)
        xq, xs = _acts(dev, (n, K), n)
    if case == "bad_index":
        e_idx[1], e_idx[6], t_idx[3] = 8, -1, xq.shape[0]
    args = (qp.codes, qp.scales, qp.zeros)
    ref = MM.w4a8_gathered_matmul_plain(xq, xs, *args, e_idx, t_idx)
    MM.reset_launch_counts()
    got = MM.w4a8_gathered_matmul(xq, xs, *args, e_idx, t_idx)
    assert [k.launches for k in MM.KERNELS] == [0, 1, 0, 0, 0]
    outs = [got, MM.w4a8_gathered_matmul(xq, xs, *args, e_idx, t_idx)]
    torch.cuda.synchronize()
    bad = ref.isnan().all(dim=1)
    assert int(bad.sum()) == (3 if case == "bad_index" else 0)
    assert torch.isfinite(ref[~bad]).all()
    for o in outs:
        assert torch.equal(o.isnan(), ref.isnan())
        assert torch.equal(o[~bad], ref[~bad])


# Qwen3-30B-A3B's gate/up (N 768, K 2048: gpp 2) over 16 of its 128
# experts, routed top-8
QWEN3_GATE_UP = (768, 2048)


@pytest.mark.parametrize("case,name", [
    ("all_live", "gate"), ("all_live", "down"),
    ("trailing_padding", "gate"), ("trailing_padding", "down"),
    ("m_tile64", "gate"), ("m_tile64", "down"),
    ("bad_expert", "gate"), ("qwen3", "gate")])
def test_grouped_kernel_matches_plain(dev, experts, case, name):
    """#9 equals its plain version bit for bit: the Mp = 3072 grouping of
    1024 tokens with every expert live; 300 tokens over 5 experts, whose
    grouping ends in padding-only blocks (block_eid clamped to E - 1); the
    1024 tokens grouped in 64-row segments (m_tile = 64, the kernel's own
    tile); expert ids out of range (NaN rows); and Qwen3-30B-A3B's gate
    shape (gpp 2) over 16 experts routed top-8."""
    n, live, E, top_k = {"trailing_padding": (300, 5, 8, 2),
                         "qwen3": (384, 16, 16, 8)}.get(case, (1024, 8, 8, 2))
    m_tile = 64 if case == "m_tile64" else MM.M_TILE
    if case == "qwen3":
        N, K = QWEN3_GATE_UP
        gen = torch.Generator(device=dev)
        gen.manual_seed(N + K)
        qp = QM.quantize_linear_stacked(
            (torch.randn((E, N, K), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16), WSPEC)
    else:
        qp = experts[name]
    K = qp.codes.shape[2] * 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + live)
    moe = A.MoESpec(num_experts=E, top_k=top_k,
                    moe_intermediate_size=qp.codes.shape[1])
    topi, _ = A.moe_route(moe, torch.randn((n, live), generator=gen,
                                           device=dev))
    gr, _, be = QM.moe_group_selections(topi, E, m_tile)
    counts = torch.bincount(topi.reshape(-1), minlength=E)
    assert int((counts > 0).sum()) == live
    if case == "all_live":
        assert gr.shape[0] == 3072
    elif case == "trailing_padding":
        assert int(be[-1]) == 7 and int(counts[7]) == 0
    bad = torch.zeros_like(be, dtype=torch.bool)
    if case == "bad_expert":
        be = be.clone()
        be[1], be[4] = E, -1
        bad[1] = bad[4] = True
    xq_t, xs_t = _acts(dev, (n, K), n)
    xq = torch.cat([xq_t, xq_t.new_zeros((1, K))])[gr.long()]
    xs = torch.cat([xs_t, xs_t.new_ones((1, 1))])[gr.long()]
    args = (qp.codes, qp.scales, qp.zeros)
    MM.reset_launch_counts()
    got = MM.w4a8_grouped_matmul(xq, xs, *args, be, m_tile)
    ref = MM.w4a8_grouped_matmul_plain(xq, xs, *args, be, m_tile)
    torch.cuda.synchronize()
    rows_bad = bad.repeat_interleave(m_tile)
    assert bool(torch.isnan(got[rows_bad]).all())
    assert bool(torch.isnan(ref[rows_bad]).all())
    got, ref = got[~rows_bad], ref[~rows_bad]
    _moe_close(got, ref)
    assert torch.equal(got, ref)
    pad = (gr.long() == n)[~rows_bad]
    assert bool((got[pad] == 0).all())
    assert [k.launches for k in MM.KERNELS] == [0, 0, 1, 0, 0]


def test_moe_kernels_reject_what_they_cannot_take(dev, experts):
    qp = experts["gate"]
    args = (qp.codes, qp.scales, qp.zeros)
    xq = torch.zeros((192, 4096), dtype=torch.int8, device=dev)
    xs = torch.ones((192, 1), device=dev)
    with pytest.raises(ValueError):
        MM.w4a8_stacked_matmul(xq, xs, qp.codes, qp.scales.float(), qp.zeros)
    with pytest.raises(ValueError):
        MM.w4a8_grouped_matmul(xq, xs, *args,
                               torch.zeros(2, dtype=torch.int32,
                                           device=dev), m_tile=64 + 32)
    with pytest.raises(ValueError):
        MM.w4a8_gathered_matmul(xq, xs, *args,
                                torch.zeros(3, dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# #7 and #10: the Qwen3-MoE slice (Qwen3-30B-A3B: 128 experts, gate/up
# 768 x 2048 in stacked planes, the down 2048 x 768 int8 per channel)
# ---------------------------------------------------------------------------

def _stacked(dev, E, N, K, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w3 = (torch.randn((E, N, K), generator=gen, device=dev)
          * 0.02).to(torch.bfloat16)
    return QM.quantize_linear_stacked(w3, WSPEC)


def _smallm_close(got, ref):
    """#7 sums its exact bf16 products in f32 in another order than its
    plain version's matmuls: 1e-5 of the largest output."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max()
    assert err <= 1e-5 * ref.abs().max(), err


@pytest.mark.parametrize("E,N,K,B", [
    (128, 768, 2048, B) for B in (8, 1, 3, 16, 32, 33)] + [
    (4, 256, 1024, 3), (3, 128, 2048, 20)])
def test_smallm_kernel_matches_plain(dev, E, N, K, B):
    """Shared x: Qwen3-30B-A3B's gate at the 8-slot decode and at B 1-33
    (the 8-, 16- and 32-token tiles, and two 32-row chunks at 33), a B
    below the 8-row chunk, and B over two chunks; a second call gives the
    same bits."""
    qp = _stacked(dev, E, N, K, N + K)
    assert qp.layout == "stacked_planes"
    xq, xs = _acts(dev, (B, K), B)
    args = (qp.codes, qp.scales, qp.zeros)
    MM.reset_launch_counts()
    got = MM.w4a8_stacked_matmul_smallm(xq, xs, *args)
    again = MM.w4a8_stacked_matmul_smallm(xq, xs, *args)
    _smallm_close(got, MM.w4a8_stacked_matmul_smallm_plain(xq, xs, *args))
    assert got.shape == (E, B, N) and torch.equal(got, again)
    assert [k.launches for k in MM.KERNELS] == [0, 0, 0, 2, 0]


@pytest.mark.parametrize("B", [8, 5])
def test_smallm_kernel_pair_matches_plain(dev, experts, B):
    """Pair mode at Mixtral-8x7B's down (E 8, N 4096, K 14336); a second
    call gives the same bits."""
    qp = experts["down"]
    K = qp.codes.shape[2] * 8
    xq, xs = _acts(dev, (8, B, K), B + 1)
    args = (qp.codes, qp.scales, qp.zeros)
    MM.reset_launch_counts()
    got = MM.w4a8_stacked_matmul_smallm(xq, xs, *args, pair=True)
    again = MM.w4a8_stacked_matmul_smallm(xq, xs, *args, pair=True)
    _smallm_close(got, MM.w4a8_stacked_matmul_smallm_plain(xq, xs, *args,
                                                           True))
    assert torch.equal(got, again)
    assert [k.launches for k in MM.KERNELS] == [0, 0, 0, 2, 0]


@pytest.mark.parametrize("N,K", [(128, 2048), (256, 1024)])
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("B", [1, 8, 9, 63, 64, 65, 200, 256])
@pytest.mark.parametrize("body", ["tile", "decode"])
def test_stacked_bodies_equal_plain_bit_for_bit(dev, body, B, pair, N, K):
    """#6 on each body, forced, at E 3: bit for bit its plain version,
    shared and per-expert (pair) rows, ragged last 64-row tiles (9, 63,
    65, 200), one launch a call."""
    E = 3
    qp = _stacked(dev, E, N, K, N + K + B)
    xq, xs = _acts(dev, (E, B, K) if pair else (B, K), B + int(pair))
    args = (qp.codes, qp.scales, qp.zeros)
    MM.reset_launch_counts()
    got = MM._w4a8_stacked_matmul(xq, xs, *args, pair, body)
    ref = MM.w4a8_stacked_matmul_plain(xq, xs, *args, pair)
    torch.cuda.synchronize()
    assert got.shape == (E, B, N) and torch.isfinite(got).all()
    assert torch.equal(got, ref)
    assert [k.launches for k in MM.KERNELS] == [1, 0, 0, 0, 0]


QWEN3 = A.MoESpec(num_experts=128, top_k=8, moe_intermediate_size=768)


def _w8_operands(dev, E, N, K, n, moe, seed):
    """int8 experts and the grouping of n tokens routed by a seeded
    router over E experts (``moe``'s top-k)."""
    qp = _stacked(dev, E, N, K, seed)
    assert (qp.layout, qp.bits) == ("stacked", 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    topi, _ = A.moe_route(moe, torch.randn((n, E), generator=gen,
                                           device=dev))
    gr, _, be = QM.moe_group_selections(topi, E)
    xq_t, xs_t = _acts(dev, (n, K), n)
    xq = torch.cat([xq_t, xq_t.new_zeros((1, K))])[gr.long()]
    xs = torch.cat([xs_t, xs_t.new_ones((1, 1))])[gr.long()]
    return qp, xq, xs, be, gr.long() == n


@pytest.mark.parametrize("E,N,K,n,top_k", [
    (128, 2048, 768, 1024, 8),   # Qwen3-30B-A3B's down at a 1024-token
    (128, 1000, 768, 1024, 8),   # prefill; a ragged N
    (4, 77, 784, 40, 2),         # ragged N under one tile, K % 64 != 0
    (8, 384, 1536, 300, 2)])
def test_w8a8_grouped_kernel_matches_plain(dev, E, N, K, n, top_k):
    """Bit for bit, padding rows 0, at every shape; a second call the
    same bits."""
    moe = A.MoESpec(num_experts=E, top_k=top_k, moe_intermediate_size=K)
    qp, xq, xs, be, pad = _w8_operands(dev, E, N, K, n, moe, N + K)
    MM.reset_launch_counts()
    got = MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be)
    again = MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be)
    ref = MM.w8a8_grouped_matmul_plain(xq, xs, qp.codes, qp.scales, be)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
    assert bool((got[pad] == 0).all())
    assert [k.launches for k in MM.KERNELS] == [0, 0, 0, 0, 2]


@pytest.mark.parametrize("Mp,N,K,m_tile", [
    (128, 128, 768, 128),   # one tile: fewer tiles than SMs
    (128, 77, 784, 128),    # one ragged tile, K % 128 != 0
    (320, 200, 768, 64),    # 64-row tiles (m_tile % 128 != 0)
    (384, 256, 1536, 192)])
def test_w8a8_grouped_kernel_small_groupings(dev, Mp, N, K, m_tile):
    """Groupings built directly (experts drawn at random, a bad id in the
    last block): bit for bit the plain version, NaN where the id is out of
    range, the same bits on a second call."""
    E = 3
    qp = _stacked(dev, E, N, K, Mp + N)
    xq, xs = _acts(dev, (Mp, K), Mp + K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(Mp)
    be = torch.randint(0, E, (Mp // m_tile,), generator=gen, device=dev,
                       dtype=torch.int32)
    if be.numel() > 1:
        be[-1] = E
    got = MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be, m_tile)
    again = MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be, m_tile)
    ref = MM.w8a8_grouped_matmul_plain(xq, xs, qp.codes, qp.scales, be,
                                       m_tile)
    torch.cuda.synchronize()
    live = be.repeat_interleave(m_tile) < E
    assert torch.equal(got[live], ref[live])
    assert bool(torch.isnan(got[~live]).all())
    assert torch.equal(got[live], again[live])


def test_w8a8_grouped_kernel_bad_expert_id_writes_nan(dev):
    E, N, K = 4, 200, 768
    qp = _stacked(dev, E, N, K, 3)
    xq, xs = _acts(dev, (384, K), 3)
    be = torch.tensor([1, 7, -1], dtype=torch.int32, device=dev)
    got = MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be)
    ref = MM.w8a8_grouped_matmul_plain(xq, xs, qp.codes, qp.scales, be)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[:128]).all())
    assert bool(torch.isnan(got[128:]).all())
    assert torch.equal(got[:128], ref[:128])
    assert bool(torch.isnan(ref[128:]).all())


def test_w8a8_grouped_kernel_rejects_what_it_cannot_take(dev):
    E, N = 2, 128
    qp = _stacked(dev, E, N, 776, 4)  # K % 16 == 8
    xq = torch.zeros((128, 776), dtype=torch.int8, device=dev)
    xs = torch.ones((128, 1), device=dev)
    be = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales, be)
    qp = _stacked(dev, E, N, 768, 4)
    xq = torch.zeros((192, 768), dtype=torch.int8, device=dev)
    xs = torch.ones((192, 1), device=dev)
    with pytest.raises(ValueError):  # m_tile % 64
        MM.w8a8_grouped_matmul(xq, xs, qp.codes, qp.scales,
                               torch.zeros(2, dtype=torch.int32, device=dev),
                               m_tile=96)


# ---------------------------------------------------------------------------
# the bench's kernels: #5 split-K, #22 kv8 attention, #15/#16 fused tail
# ---------------------------------------------------------------------------

def _random_planes(gen, dev, N, K):
    """Random plane words, random per-group scales and zero points."""
    wp = torch.randint(-2**31, 2**31 - 1, (N, K // 8), generator=gen,
                       device=dev, dtype=torch.int32)
    s = torch.rand((N, K // 128), generator=gen, device=dev) * 0.02 + 0.005
    z = torch.randint(0, 16, (N, K // 128), generator=gen, device=dev).float()
    return wp, s.to(torch.bfloat16), (z * s).to(torch.bfloat16)


@pytest.mark.parametrize("M", [1, 7, 8, 32, 33, 64, 300])
@pytest.mark.parametrize("N,K", [(256, 2048), (4096, 14336)])
def test_ksplit_kernel_matches_plain(dev, M, N, K):
    """#5 (the planes decode tile: 32 rows a block, more in row chunks)
    equals its plain version bit for bit, the TPU kernel's order; the two
    halves' atomic adds give the same bits run after run."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(M + N)
    w = _random_planes(gen, dev, N, K)
    xq, xs = W.quantize_act_per_token(
        torch.randn((M, K), generator=gen, device=dev))
    W.reset_launch_counts()
    got = W.w4a8_matmul_planes_ksplit(xq, xs, *w)
    again = W.w4a8_matmul_planes_ksplit(xq, xs, *w)
    ref = W.w4a8_matmul_planes_ksplit_plain(xq, xs, *w)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
    assert [k.launches for k in W.KERNELS] == [0, 0, 0, 0, 0, 0, 2, 0, 0]


def _kv8_case(dev, B, S, G, scales, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, D = 8, 128
    q = torch.randn((B, H, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    kq, vq = (torch.randint(-127, 128, (B, H, S, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand((B, H, S), generator=gen, device=dev) * 0.02
               + 1e-3).to(scales) for _ in range(2))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("scales", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 17, 129, 2049, 4097])
@pytest.mark.parametrize("B", [1, 4, 8, 32])
def test_kv8_kernel_matches_plain(dev, B, S, G, scales):
    """#22 at ragged S, on the cluster size ``kv8_parts`` picks for B: the
    normalized context within 1e-3 of the largest |ctx| (a bf16 step of one
    probability times a code), and a second call the same bits."""
    from lightcompress_tpu_torch.ops import attention as T

    args = _kv8_case(dev, B, S, G, scales, S + G + B)
    T.reset_launch_counts()
    got = T.decode_attention_kv8(*args)
    again = T.decode_attention_kv8(*args)
    ref = T.decode_attention_kv8_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    assert torch.equal(got, again)
    assert [k.launches for k in T.KERNELS] == [0, 0, 0, 0, 0, 2]


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 3, 129, 1000])
@pytest.mark.parametrize("G", [4, 8])
def test_kv8_kernel_each_split_matches_its_schedule(dev, parts, S, G):
    """#22 on each cluster size: within 1e-3 of its split schedule's plain
    rendering, the same bits on a second call; at S 1 (parts past the
    first empty) exactly bf16(vs) * v."""
    from lightcompress_tpu_torch.ops import attention as T

    args = _kv8_case(dev, 2, S, G, torch.bfloat16, S + parts)
    got = T._kv8_launch(*args, parts)
    again = T._kv8_launch(*args, parts)
    ref = T.decode_attention_kv8_parts_plain(*args, parts)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    assert torch.equal(got, again)
    if S == 1:
        q, _, _, vq, vs = args
        want = vs.float()[..., None] * vq.float()
        assert torch.equal(got, want.expand_as(got))


def test_kv8_kernel_rejects_what_it_cannot_take(dev):
    from lightcompress_tpu_torch.ops import attention as T

    B, H, G, D = 1, 1, 4, 128
    # one column past a CTA's shared memory at G 4 on the widest split
    S = 81281
    assert T.kv8_smem_bytes(G, S) > T.SMEM_MAX >= T.kv8_smem_bytes(G, S - 1)
    q = torch.zeros((B, H, G, D), dtype=torch.bfloat16, device=dev)
    kq = torch.zeros((B, H, S, D), dtype=torch.int8, device=dev)
    ks = torch.ones((B, H, S), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        T.decode_attention_kv8(q, kq, ks, kq, ks)
    with pytest.raises(ValueError):  # scales of two types
        T.decode_attention_kv8(q, kq[:, :, :8], ks[..., :8], kq[:, :, :8],
                               ks[..., :8].float())


@pytest.mark.parametrize("B,H,I,Nq,cap", [
    (32, 4096, 14336, 6144, 0),  # the bench: 448 gate|up work items
    (32, 4096, 14336, 6144, 3),  # the bench's shapes on three blocks
    (5, 1024, 2048, 1536, 3),    # a ragged row chunk, three blocks
    (1, 1024, 1024, 1024, 0),    # one row
    (33, 1024, 2048, 1536, 0)])  # a second row chunk of one row
def test_layer_fused_kernels_match_plain(dev, B, H, I, Nq, cap):
    """#15 and #16 on their cooperative grid (which the gate|up phase's
    work items outnumber in the bench's and the capped cases): outputs
    within a bf16 ulp of the largest |y| of the plain version, at most one
    act-code flip in a thousand per prologue, and the same bits on a
    second call."""
    from lightcompress_tpu_torch.ops import layer_fused as LF

    gen = torch.Generator(device=dev)
    gen.manual_seed(B + H + I)
    ws = [_random_planes(gen, dev, n, k)
          for n, k in ((H, H), (2 * I, H), (H, I), (Nq, H))]
    ctx, x = (torch.randn((B, H), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    args = [t for w in ws for t in w]
    for kern, nxt in ((LF.w4a8_attn_tail_fused, False),
                      (LF.w4a8_layer_fused, True)):
        grid = LF.grid_blocks(B, H, I, Nq, nxt, cap)
        # a gate|up work item: 32 gate and the same 32 up channels by up
        # to 32 rows, before its group range is split
        tiles = I // 32 * ((B + 31) // 32)
        assert 0 < grid <= tiles
        if cap or (H, I) == (4096, 14336):
            assert grid < tiles
        LF.reset_launch_counts()
        y, q, acts = LF._with_act(kern, ctx, x, *args[:12 if nxt else 9],
                                  max_blocks=cap)
        y2, q2, acts2 = LF._with_act(kern, ctx, x, *args[:12 if nxt else 9],
                                     max_blocks=cap)
        ry, rq, racts = LF._plain(ctx, x, *ws[:3], ws[3] if nxt else None,
                                  1e-6)
        torch.cuda.synchronize()
        assert [k.launches for k in LF.KERNELS] == [2 * int(not nxt),
                                                    2 * int(nxt)]
        for got, again, ref in (((y, y2, ry), (q, q2, rq)) if nxt
                                else ((y, y2, ry),)):
            assert bool(torch.isfinite(got.float()).all())
            err = float((got.float() - ref.float()).abs().max())
            assert err <= bf16_ulp(float(ref.float().abs().max()))
            assert torch.equal(got, again)
        assert len(acts) == len(racts) == (4 if nxt else 3)
        for (codes, scales), (codes2, scales2), (rcodes, _) in zip(
                acts, acts2, racts):
            assert int((codes != rcodes).sum()) <= 1e-3 * codes.numel()
            assert torch.equal(codes, codes2) and torch.equal(scales, scales2)


@pytest.mark.parametrize("nxt", [False, True])
def test_layer_fused_plan_and_phase_times(dev, nxt):
    """The plan at the bench's shapes (the grid within the co-resident
    blocks and the finest work, the splits within each group range, the
    shared memory within a block's 227 KB) and the phase stamps of a
    launch: every segment read, in order, within the launch."""
    from lightcompress_tpu_torch.ops import layer_fused as LF

    B, H, I, Nq = 32, 4096, 14336, 6144
    pl = LF.plan(B, H, I, Nq, nxt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 0 < pl["grid"] <= sms * (232448 // pl["smem_bytes"])
    assert pl["smem_bytes"] <= 232448
    gpp = {"o": H // 1024, "gateup": H // 1024, "down": I // 1024,
           "qkv": H // 1024}
    for name, s in pl["splits"].items():
        assert 1 <= s <= gpp[name]
    assert LF.plan(B, H, I, Nq, nxt, 3)["grid"] == 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ws = [t for n, k in ((H, H), (2 * I, H), (H, I), (Nq, H))[:4 if nxt
                                                               else 3]
          for t in _random_planes(gen, dev, n, k)]
    ctx, x = (torch.randn((B, H), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    kern = LF.w4a8_layer_fused if nxt else LF.w4a8_attn_tail_fused
    stamps = []
    LF._with_act(kern, ctx, x, *ws, stamps=stamps)
    torch.cuda.synchronize()
    st = [int(v) for v in stamps[0].tolist()]
    segs = 8 if nxt else 6
    edges = [st[0]] + [v for s in range(segs) for v in
                       (st[2 + 3 * s], st[3 + 3 * s])][:-1]
    assert all(e > 0 for e in edges)
    assert edges == sorted(edges)
    times = LF.phase_times(stamps[0], nxt)
    assert times["total_us"] > 0
    assert all(times[f"{n}_us"] >= 0 for n in LF.SEGMENTS[:segs])


def test_layer_fused_kernels_reject_what_they_cannot_take(dev):
    from lightcompress_tpu_torch.ops import layer_fused as LF

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ws = [t for n, k in ((1024, 1024), (2048, 1024), (1024, 1024))
          for t in _random_planes(gen, dev, n, k)]
    x = torch.zeros((2, 1024), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # f32 activations
        LF.w4a8_attn_tail_fused(x.float(), x.float(), *ws)
    with pytest.raises(ValueError):  # gate|up rows for I = 1024, down K 512
        LF.w4a8_attn_tail_fused(x, x, *ws[:6], ws[6][:, :64], ws[7][:, :4],
                                ws[8][:, :4])


# ---------------------------------------------------------------------------
# #4 (masked planes) and #11 (natural s4 bytes)
# ---------------------------------------------------------------------------

# the root bench's fused entries (N, K) at Llama-3-8B width: q|k|v, o,
# gate|up, down
MASKED_SHAPES = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)]


def _random_codes(dev, N, K, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                      dtype=torch.int32)
    s = torch.rand((N, K // 128), generator=gen, device=dev) * 0.02 + 0.005
    z = torch.randint(0, 16, (N, K // 128), generator=gen,
                      device=dev).float()
    return u, s, z, gen


@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", MASKED_SHAPES)
def test_masked_kernel_matches_plain(dev, N, K, sdtype):
    u, s, z, gen = _random_codes(dev, N, K, N + K)
    wp = W.pack_int4_planes_masked(u)
    sm = W.masked_scales(s).to(sdtype)
    zm = W.masked_zero_scales(z, s).to(sdtype)
    x = torch.randn((32, K), generator=gen, device=dev).to(torch.bfloat16)
    W.reset_launch_counts()
    got = W.w4a16_matmul_planes_masked(x, wp, sm, zm)
    ref = W.w4a16_matmul_planes_masked_plain(x, wp, sm, zm)
    torch.cuda.synchronize()
    # f32 outputs: summation-order noise
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert W.w4a16_matmul_planes_masked.launches == 1
    if sdtype == torch.float32:
        # the same product through #1's unpack, on scales and zero points
        # that both storages hold exactly (bf16 s, z = 8: zs = 8*s)
        sb = s.to(torch.bfloat16)
        z8 = torch.full_like(z, 8.0)
        y1 = W.w4a16_matmul(x.float(), W.pack_int4_planes(u), sb,
                            (z8 * sb.float()).to(torch.bfloat16)).float()
        y4 = W.w4a16_matmul_planes_masked(
            x, wp, W.masked_scales(sb), W.masked_zero_scales(z8, sb))
        torch.cuda.synchronize()
        assert (y4 - y1).abs().max() <= 1e-4 * y1.abs().max()


# #1 and #4 on their bf16 tensor-core tile (csrc/w4a16_tile.cu): K 14336
# is 112 groups in uneven splits of a cluster, N 1024 under one wave, M
# across the 8-, 16- and 32-token instances and token chunks
TILE_M = [1, 3, 8, 16, 33, 256]
TILE_CASES = {"w4a16_bf16": ("w4a16", torch.bfloat16),
              "w4a16_f32": ("w4a16", torch.float32),
              "masked_f32": ("masked", torch.float32),
              "masked_bf16": ("masked", torch.bfloat16)}


@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("N", [1024, 14336])
@pytest.mark.parametrize("M", TILE_M)
def test_w4a16_tile_matches_plain(dev, M, N, case):
    """#1 (bf16 x stored in bf16, f32 x in f32) and #4 (f32 and bf16
    pre-divided scales, f32 out) against their plain versions: one bf16
    ulp at max|y| for a bf16 output, 1e-4 of max|y| for f32; a second call
    gives the same bits."""
    kind, dtype = TILE_CASES[case]
    K = 14336
    u, s, z, gen = _random_codes(dev, N, K, N + M)
    x = torch.randn((M, K), generator=gen, device=dev)
    if kind == "w4a16":
        sb = s.to(torch.bfloat16)
        args = (W.pack_int4_planes(u), sb,
                (z * sb.float()).to(torch.bfloat16))
        x = x.to(torch.bfloat16).to(dtype)
        kernel, plain = W.w4a16_matmul, W.w4a16_matmul_plain
    else:
        args = (W.pack_int4_planes_masked(u), W.masked_scales(s).to(dtype),
                W.masked_zero_scales(z, s).to(dtype))
        x = x.to(torch.bfloat16)
        kernel = W.w4a16_matmul_planes_masked
        plain = W.w4a16_matmul_planes_masked_plain
    W.reset_launch_counts()
    got, again = kernel(x, *args), kernel(x, *args)
    ref = plain(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches == 2
    assert got.dtype == (dtype if kind == "w4a16" else torch.float32)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    scale = float(ref.abs().max())
    if got.dtype == torch.bfloat16:
        err = (got.float() - ref.to(torch.bfloat16).float()).abs().max()
        assert err <= bf16_ulp(scale)
    else:
        assert (got - ref).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("K", [50176, 58368])
def test_planes_tile_past_the_shared_row_sums(dev, K):
    """#3 (M 300, f32 and bf16) and #9 (two experts of 128 rows) at K past
    ROWSUM_SMEM_K_MAX: the row sums in a global scratch, the zero
    corrections staged in one chunk (K 50176) or two (K 58368); bit for
    bit with their plain versions."""
    assert K > W.ROWSUM_SMEM_K_MAX
    N = 256
    qp, gen = _weights(dev, N, K)
    args = (qp.codes, qp.scales, qp.zeros)
    xq, xs = W.quantize_act_per_token(
        torch.randn((300, K), generator=gen, device=dev))
    for dt in (torch.float32, torch.bfloat16):
        got = W.w4a8_matmul_prefill(xq, xs, *args, out_dtype=dt)
        ref = W.w4a8_matmul_prefill_plain(xq, xs, *args, dt)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, ref)
    st = QM.quantize_linear_stacked(
        (torch.randn((2, N, K), generator=gen, device=dev)
         * 0.02).to(torch.bfloat16), WSPEC)
    xq, xs = W.quantize_act_per_token(
        torch.randn((256, K), generator=gen, device=dev))
    be = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    sargs = (st.codes, st.scales, st.zeros)
    got = MM.w4a8_grouped_matmul(xq, xs, *sargs, be)
    ref = MM.w4a8_grouped_matmul_plain(xq, xs, *sargs, be)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, ref)


@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 33, 256])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", [(4096, 4096), (1024, 4096),
                                 (14336, 4096), (4096, 14336), (96, 384)])
def test_s4_natural_kernel_matches_plain(dev, M, N, K, sdtype):
    """#11 on its int8 tensor-core tile equals its plain version bit for
    bit (the TPU's four accumulators, the correction in ascending g) with
    f32 and bf16 scales, at a Llama-3-8B block's shapes, an odd G (K 384)
    and N 96, over the 16- and 32-row tiles and row tiles past 32; a
    second call gives the same bits."""
    u, s, z, gen = _random_codes(dev, N, K, N + 3 * K)
    wb = W.pack_s4_bytes(u)
    sb, zb = s.to(sdtype), ((z - 8) * s).to(sdtype)
    x = torch.randn((M, K), generator=gen, device=dev)
    xq, xs = W.quantize_act_per_token(x)
    W.reset_launch_counts()
    got = W.w4a8_matmul_s4_bytes(xq, xs, wb, sb, zb)
    again = W.w4a8_matmul_s4_bytes(xq, xs, wb, sb, zb)
    ref = W.w4a8_matmul_s4_plain(xq, xs, wb, sb, zb)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert W.w4a8_matmul_s4_bytes.launches == 2


def test_masked_and_s4_kernels_reject_what_they_cannot_take(dev):
    x = torch.zeros((4, 1000), device=dev, dtype=torch.bfloat16)
    s = torch.zeros((64, 7), device=dev)
    with pytest.raises(ValueError):  # K % 1024
        W.w4a16_matmul_planes_masked(
            x, torch.zeros((64, 125), dtype=torch.int32, device=dev), s, s)
    with pytest.raises(ValueError):  # K % 128
        W.w4a8_matmul_s4_bytes(
            x.to(torch.int8), torch.ones((4, 1), device=dev),
            torch.zeros((64, 500), dtype=torch.int8, device=dev), s, s)
    with pytest.raises(ValueError):  # N % 32 on the card
        W.w4a16_matmul_planes_masked(
            torch.zeros((4, 1024), device=dev),
            torch.zeros((48, 128), dtype=torch.int32, device=dev),
            torch.zeros((48, 8), device=dev), torch.zeros((48, 8), device=dev))
    with pytest.raises(ValueError):  # s and zs of two dtypes
        W.w4a8_matmul_s4_bytes(
            torch.zeros((4, 1024), dtype=torch.int8, device=dev),
            torch.ones((4, 1), device=dev),
            torch.zeros((64, 512), dtype=torch.int8, device=dev),
            torch.zeros((64, 8), device=dev),
            torch.zeros((64, 8), device=dev, dtype=torch.bfloat16))
