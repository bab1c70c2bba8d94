"""Port parity: the bench's decode stack (``lightcompress_tpu_torch.bench``)
against the root ``bench.py``, and the K-split ``planes_ks`` layout with
the plain version of #5 (``w4a8_matmul_planes_ksplit``) against the JAX
Pallas kernel in interpret mode (CPU).

The root bench is shrunk through its module globals and run op by op.  On
the CPU the JAX ``qlinear_apply`` skips Pallas (it runs the XLA bf16
dequant path, whatever ``act_bits``), so the tests hand it the TPU
dispatch with the Pallas kernels in interpret mode, and the fused tail and
attention kernels likewise; nothing of the JAX package or the root bench
is edited.  Both get the same weights (the root bench's, read by
``convert``), activations and random caches."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as RB
import lightcompress_tpu.ops as jops
from lightcompress_tpu.ops import pallas_attention as jpa
from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.ops.qlinear import QLinearParams as JQLinearParams
from lightcompress_tpu_torch import bench as TB
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.ops import qlinear as tq
from lightcompress_tpu_torch.ops import w4_matmul as tw
from test_torch_serving import one_torch_thread  # noqa: F401

G128 = 128
# narrow widths: K % 1024 for every linear, the down's I % 2048 for the
# K-split, B a multiple of the JAX #22's 4-slot block
DIMS = dict(hidden=1024, inter=2048, n_heads=8, n_kv=2, head_dim=128,
            layers=2, batch=4, ctx=16)
ROOT_GLOBALS = dict(HIDDEN=1024, INTER=2048, N_HEADS=8, N_KV=2,
                    HEAD_DIM=128, LAYERS=2, BATCH=4, CTX=16)
# the decode step's output against the root bench's: each side rounds
# its bf16 ops where JAX does, but sums (matmuls, RMSNorm, softmax) in
# other orders, and the per-token act quant turns last bits into code steps
CORR_MIN = 0.999
# #5's plain version against the interpret kernel: the same exact integer
# group dots, f32 sums of the scaled groups in another order
TOL_KSPLIT = 1e-4

CONFIGS = {
    # name: (port config fields, root bench globals, BENCH_KSPLIT)
    "default": ({}, {}, False),
    "tail1": (dict(tail=1, scales="bf16"), dict(TAIL=1, SCALES="bf16"),
              False),
    "tail2": (dict(tail=2, scales="bf16"), dict(TAIL=2, SCALES="bf16"),
              False),
    "pallas": (dict(attn="pallas"), dict(ATTN_IMPL="pallas"), False),
    # the fully-int8 attention of ops/scaled_matmul.py, both dots exact
    "i8full": (dict(attn="i8full"), dict(ATTN_IMPL="i8full"), False),
    "ksplit": (dict(ksplit=True), {}, True),
    "act16": (dict(act_bits=16), dict(ACT_BITS=16), False),
    "kv16": (dict(kv_bits=16), dict(KV_BITS=16), False),
    "unfused": (dict(fused=False), dict(FUSED=False), False),
    # #4 on the masked entries: f32 pre-divided scales (the root bench's
    # default), bf16 ones, the masked down winning over BENCH_KSPLIT, the
    # W4A16 bench, and the unfused entry names
    "masked": (dict(masked=("o", "qkv")), dict(MASKED={"qkv", "o"}), False),
    "masked_bf16_ksplit": (dict(masked=("down",), scales="bf16",
                                ksplit=True),
                           dict(MASKED={"down"}, SCALES="bf16"), True),
    "masked_act16": (dict(masked=("gateup",), act_bits=16),
                     dict(MASKED={"gateup"}, ACT_BITS=16), False),
    "masked_unfused": (dict(masked=("k", "up"), fused=False),
                       dict(MASKED={"k", "up"}, FUSED=False), False),
}


def _jax_qlinear_apply(x, qp, use_pallas=True, act_bits=16):
    """The JAX ``qlinear_apply`` dispatch as it runs on a TPU for the
    bench's linears, with the Pallas kernels in interpret mode."""
    if qp.layout == "planes_ks":
        return jpm.w4a8_matmul_ks(x, qp, interpret=True)
    if act_bits == 8:
        return jpm.w4a8_matmul(x, qp, interpret=True)
    if qp.scales.ndim == 3:  # the combined slab, split as on a TPU
        nb, rows, nt = qp.scales.shape
        comb = qp.scales.reshape(nb, 2, rows // 16, 8, nt)
        qp = JQLinearParams(qp.codes, comb[:, 0].transpose(1, 0, 2, 3),
                            comb[:, 1].transpose(1, 0, 2, 3), qp.bias, 4,
                            qp.group_size, False, "planes")
    return jpm.w4a16_matmul(x, qp, interpret=True)


@pytest.fixture
def root_bench(monkeypatch):
    """The root bench shrunk to DIMS, its kernels in interpret mode."""
    monkeypatch.setattr(jops, "qlinear_apply", _jax_qlinear_apply)
    for mod, name in ((jpm, "w4a8_attn_tail_fused"),
                      (jpm, "w4a8_layer_fused"),
                      (jpm, "w4a16_matmul_planes_masked"),
                      (jpa, "decode_attention_kv8")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))
    for k, v in dict(ROOT_GLOBALS, FUSED=True, TAIL=0, ATTN_IMPL="xla",
                     ACT_BITS=8, KV_BITS=8, SCALES="contig",
                     FUSEDLIN=False, WLAYOUT="planes",
                     MASKED=set()).items():
        monkeypatch.setattr(RB, k, v)
    monkeypatch.delenv("BENCH_KSPLIT", raising=False)
    return monkeypatch


def _root_layers(monkeypatch, over, ksplit):
    for k, v in over.items():
        monkeypatch.setattr(RB, k, v)
    if ksplit:
        monkeypatch.setenv("BENCH_KSPLIT", "1")
    keys = jax.random.split(jax.random.PRNGKey(0), ROOT_GLOBALS["LAYERS"])
    return [RB.make_layer_qweights(k) for k in keys]


def _port_layers(layers):
    def conv(qp):
        return convert.qlinear_from_numpy(
            np.asarray(qp.codes), np.asarray(qp.scales),
            None if qp.zeros is None else np.asarray(qp.zeros), None, 4,
            qp.group_size, qp.layout, device="cpu")
    return [{n: conv(qp) for n, qp in lw.items()} for lw in layers]


def _root_bytes(layers):
    """The root bench's ``_qp_bytes`` summed over the layers."""
    return sum(int(np.prod(qp.codes.shape)) * qp.codes.dtype.itemsize
               + qp.scales.size * qp.scales.dtype.itemsize
               + (qp.zeros.size * qp.zeros.dtype.itemsize
                  if qp.zeros is not None else 0)
               for lw in layers for qp in lw.values())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_matches_root_bench(one_torch_thread,  # noqa: F811
                                        root_bench, name):
    over, root_over, ksplit = CONFIGS[name]
    layers = _root_layers(root_bench, root_over, ksplit)
    cfg = TB.BenchConfig(**DIMS, **over)
    TB.validate(cfg)
    rng = np.random.RandomState(1)
    L, B, NKV, CTX, D = (cfg.layers, cfg.batch, cfg.n_kv, cfg.ctx,
                         cfg.head_dim)

    def cache():
        if cfg.kv_bits == 16:
            return jnp.asarray(rng.randn(B, NKV, CTX, D), jnp.bfloat16)
        return jnp.asarray(rng.randint(-127, 128, (B, NKV, CTX, D)),
                           jnp.int8)

    kc = [cache() for _ in range(L)]
    vc = [cache() for _ in range(L)]
    scales = [[jnp.asarray(rng.rand(B, NKV, CTX) * 0.02 + 1e-3,
                           jnp.bfloat16) for _ in range(2)]
              if cfg.kv_bits == 8 else None for _ in range(L)]
    x = jnp.asarray(rng.randn(B, cfg.hidden), jnp.bfloat16)
    ref = RB.decode_step(layers, x, kc, vc, scales)

    def t(a):
        return convert.tensor_from_numpy(a, "cpu")

    got = TB.decode_step(cfg, _port_layers(layers), t(x),
                         [t(a) for a in kc], [t(a) for a in vc],
                         [None if p is None else (t(p[0]), t(p[1]))
                          for p in scales])
    assert got.dtype == torch.bfloat16 and got.shape == (B, cfg.hidden)
    a = np.asarray(ref.astype(jnp.float32)).ravel()
    b = got.float().numpy().ravel()
    assert np.isfinite(b).all()
    assert np.corrcoef(a, b)[0, 1] >= CORR_MIN


@pytest.mark.parametrize("name", ["default", "tail1", "ksplit", "masked",
                                  "masked_bf16_ksplit"])
def test_weight_bytes_match_root_formula(root_bench, name):
    """The roofline's bytes: the port's count of the converted layers and
    of its own ``make_layer_qweights`` equal the root bench's formula on
    its layers; the KV bytes its 2*L*B*N_KV*CTX*(D + 2)."""
    over, root_over, ksplit = CONFIGS[name]
    layers = _root_layers(root_bench, root_over, ksplit)
    cfg = TB.BenchConfig(**DIMS, **over)
    want = _root_bytes(layers)
    assert TB.weight_bytes(_port_layers(layers)) == want
    gen = torch.Generator()
    gen.manual_seed(0)
    own = [TB.make_layer_qweights(cfg, gen, torch.device("cpu"))
           for _ in range(cfg.layers)]
    assert TB.weight_bytes(own) == want
    assert TB.kv_bytes(cfg) == 2 * 2 * 4 * 2 * 16 * (128 + 2)
    assert TB.kv_bytes(TB.BenchConfig(**DIMS, kv_bits=16)) == \
        2 * 2 * 4 * 2 * 16 * 256


def test_make_layer_qweights_like_root_bench(root_bench):
    """The port's random layer: the root bench's shapes, layouts and bf16
    scale and zero-correction values (0.01 and 8 * 0.01)."""
    root = _root_layers(root_bench, {}, True)[0]
    conv = _port_layers([root])[0]
    gen = torch.Generator()
    gen.manual_seed(0)
    own = TB.make_layer_qweights(TB.BenchConfig(**DIMS, ksplit=True), gen,
                                 torch.device("cpu"))
    assert sorted(own) == sorted(conv) == ["down", "gateup", "o", "qkv"]
    for n in own:
        assert own[n].layout == conv[n].layout
        assert own[n].layout == ("planes_ks" if n == "down" else "planes")
        for a, b in ((own[n].codes, conv[n].codes),
                     (own[n].scales, conv[n].scales),
                     (own[n].zeros, conv[n].zeros)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(own[n].scales, conv[n].scales)
        assert torch.equal(own[n].zeros, conv[n].zeros)


@pytest.mark.parametrize("env", [
    dict(BENCH_KV_APPEND="nocopy"), dict(BENCH_KV_APPEND="dus"),
    dict(BENCH_KV_APPEND="dusl"), dict(BENCH_ATTN="i8app"),
    dict(BENCH_ATTN="bd4"), dict(BENCH_ATTN="bd"),
    dict(BENCH_ATTN="bds"), dict(BENCH_ATTN="bd4", BENCH_KV_BITS="4"),
    dict(BENCH_ATTN="bds4", BENCH_KV_BITS="4"), dict(BENCH_KV_BITS="4"),
    dict(BENCH_WLAYOUT="s4"),
    dict(BENCH_FUSEDLIN="1"), dict(BENCH_DOWNSPLIT="1"),
    dict(BENCH_KV_STACKED="1"), dict(BENCH_ENGINE="1"),
    dict(BENCH_SCALES="f32"), dict(BENCH_SCALES="raw")])
def test_deferred_knobs_raise(env):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.validate(TB.BenchConfig.from_env(env))


@pytest.mark.parametrize("env", [
    dict(BENCH_TAIL="1"), dict(BENCH_TAIL="2", BENCH_FUSED="0",
                               BENCH_SCALES="bf16"),
    dict(BENCH_ATTN="pallas", BENCH_KV_BITS="16"),
    dict(BENCH_KSPLIT="1", BENCH_ACT_BITS="16"),
    dict(BENCH_MASKED="qkv", BENCH_TAIL="1", BENCH_SCALES="bf16"),
    dict(BENCH_MASKED="down", BENCH_TAIL="2", BENCH_SCALES="bf16"),
    dict(BENCH_MASKED="q,o"),
    dict(BENCH_ATTN="i8full", BENCH_KV_BITS="16")])
def test_root_asserts_raise(env):
    """The root bench's ``main()`` asserts (TAIL on the contiguous scale
    slab), and configs whose kernels cannot take their layout."""
    with pytest.raises(ValueError):
        TB.validate(TB.BenchConfig.from_env(env))


def test_config_from_env_and_card_rates():
    cfg = TB.BenchConfig.from_env({})
    assert cfg == TB.BenchConfig()
    assert (cfg.act_bits, cfg.kv_bits, cfg.attn, cfg.fused, cfg.tail,
            cfg.scales, cfg.batch, cfg.ctx, cfg.layers) == (
        8, 8, "xla", True, 0, "contig", 32, 2048, 32)
    TB.validate(cfg)
    env = dict(BENCH_TAIL="2", BENCH_SCALES="bf16", BENCH_BATCH="8",
               BENCH_CTX="512", BENCH_KSPLIT="0")
    assert TB.BenchConfig.from_env(env) == TB.BenchConfig(
        tail=2, scales="bf16", batch=8, ctx=512)
    assert TB.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError):
        TB.hbm_bytes_per_s("TPU v5 lite")
    with pytest.raises(ValueError):  # the bench measures the card only
        TB.run(TB.BenchConfig(**DIMS), device="cpu")


# ---------------------------------------------------------------------------
# planes_ks and #5
# ---------------------------------------------------------------------------

def _ksplit_case(N, K, seed):
    """Random planes with random per-group scales and zero points, in the
    JAX ``planes_ks`` tiles (bf16 combined slabs per half, as the bench
    casts them) and read back by ``convert``."""
    rng = np.random.RandomState(seed)
    codes = jnp.asarray(rng.randint(0, 16, (N, K)), jnp.int32)
    s = jnp.asarray(rng.rand(N, K // G128) * 0.02 + 0.005, jnp.float32)
    z = jnp.asarray(rng.randint(0, 16, (N, K // G128)), jnp.float32)
    packed = jpm.pack_int4_planes(codes)
    wp5 = jpm.tile_packed_ksplit(packed, 128, G128)
    szs = jpm.tile_scales_combined_ksplit(s, z * s, 128, K // 8 // G128)
    return packed, s, z, wp5, szs.astype(jnp.bfloat16)


def test_planes_ks_readers_invert_the_tiling():
    packed, s, z, wp5, szs = _ksplit_case(256, 6144, seed=0)
    np.testing.assert_array_equal(convert.untile_codes_ksplit(
        convert.tensor_from_numpy(wp5, "cpu")).numpy(), np.asarray(packed))
    f32 = jpm.tile_scales_combined_ksplit(s, z * s, 128, 6144 // 8 // G128)
    rs, rzs = convert.split_combined_ksplit(
        convert.tensor_from_numpy(f32, "cpu"))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(s))
    np.testing.assert_array_equal(rzs.numpy(), np.asarray(z * s))
    qp = convert.qlinear_from_numpy(np.asarray(wp5), np.asarray(szs), None,
                                    None, 4, G128, "planes_ks", device="cpu")
    assert (qp.layout, qp.tiled, qp.codes.dtype) == ("planes_ks", True,
                                                     torch.int32)
    np.testing.assert_array_equal(qp.codes.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(
        qp.scales.float().numpy(),
        np.asarray(s.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("K", [2048, 6144])
def test_ksplit_plain_matches_pallas(M, K):
    _, _, _, wp5, szs = _ksplit_case(256, K, seed=K + M)
    rng = np.random.RandomState(M)
    xq, xs = jpm.quantize_act_per_token(jnp.asarray(
        rng.randn(M, K).astype(np.float32)))
    ref = np.asarray(jpm.w4a8_matmul_planes_ksplit(xq, xs, wp5, szs,
                                                   group=G128,
                                                   interpret=True))
    qp = convert.qlinear_from_numpy(np.asarray(wp5), np.asarray(szs), None,
                                    None, 4, G128, "planes_ks", device="cpu")
    got = tw.w4a8_matmul_planes_ksplit(torch.from_numpy(np.array(xq)),
                                       torch.from_numpy(np.array(xs)),
                                       qp.codes, qp.scales, qp.zeros)
    assert got.dtype == torch.float32 and got.shape == (M, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL_KSPLIT * float(np.abs(ref).max()))


def test_planes_ks_routes_like_jax(monkeypatch):
    """``qlinear_apply`` sends planes_ks to #5 at act_bits 8 (any M), the
    JAX ``w4a8_matmul_ks`` order: act quant, #5, cast; raises at 16."""
    calls = []
    fn = tw.w4a8_matmul_planes_ksplit_plain
    monkeypatch.setattr(tw, "w4a8_matmul_planes_ksplit_plain",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    _, _, _, wp5, szs = _ksplit_case(256, 2048, seed=3)
    qp = convert.qlinear_from_numpy(np.asarray(wp5), np.asarray(szs), None,
                                    None, 4, G128, "planes_ks", device="cpu")
    x = np.random.RandomState(4).randn(300, 2048).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tq.qlinear_apply(convert.tensor_from_numpy(xb, "cpu"), qp,
                           act_bits=8)
    assert calls == [1] and got.dtype == torch.bfloat16
    jqp = JQLinearParams(wp5, szs, None, None, 4, G128, False, "planes_ks")
    ref = np.asarray(jpm.w4a8_matmul_ks(xb, jqp, interpret=True).astype(
        jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))
    with pytest.raises(NotImplementedError, match="planes_ks"):
        tq.qlinear_apply(torch.from_numpy(x), qp, act_bits=16)
    with pytest.raises(ValueError):  # K % 2048
        tw.w4a8_matmul_planes_ksplit_plain(
            torch.zeros((1, 1024), dtype=torch.int8), torch.ones((1, 1)),
            qp.codes[:, :128], qp.scales[:, :8], qp.zeros[:, :8])


def test_masked_config_from_env():
    """``BENCH_MASKED`` reads the root bench's comma list."""
    cfg = TB.BenchConfig.from_env(dict(BENCH_MASKED="qkv,o"))
    assert cfg.masked == ("o", "qkv")
    TB.validate(cfg)
    assert TB.BenchConfig.from_env(dict(BENCH_MASKED="")).masked == ()


def test_make_layer_qweights_masked_like_root_bench(root_bench):
    """The port's masked entries: the root bench's layout, shapes, dtypes
    and pre-divided scale and zero-correction values; ``masked`` wins
    over ``ksplit`` for the down projection."""
    for over, root_over in ((dict(masked=("down", "o")), {}),
                            (dict(masked=("down", "o"), scales="bf16"),
                             dict(SCALES="bf16"))):
        root = _root_layers(root_bench, dict(root_over,
                                             MASKED={"down", "o"}), True)[0]
        conv = _port_layers([root])[0]
        gen = torch.Generator()
        gen.manual_seed(0)
        own = TB.make_layer_qweights(
            TB.BenchConfig(**DIMS, ksplit=True, **over), gen,
            torch.device("cpu"))
        for n in ("down", "o"):
            assert own[n].layout == conv[n].layout == "masked"
            for a, b in ((own[n].codes, conv[n].codes),
                         (own[n].scales, conv[n].scales),
                         (own[n].zeros, conv[n].zeros)):
                assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(own[n].scales, conv[n].scales)
            assert torch.equal(own[n].zeros, conv[n].zeros)
            codes = tw.unpack_int4_planes_masked(own[n].codes,
                                                 own[n].codes.shape[1] * 8)
            assert int(codes.min()) == 0 and int(codes.max()) == 15
        assert own["qkv"].layout == "planes"
