"""Port parity: the quantizer core of lightcompress_tpu_torch (every
granularity, integer bits 2-8, the float formats, the mse / hqq /
learnable ranges, W48, static act qparams and the histogram search)
against lightcompress_tpu on the same numpy inputs (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightcompress_tpu.quant as J
from lightcompress_tpu.quant import quantizer as JQ
from lightcompress_tpu_torch import quant as T
from lightcompress_tpu_torch.quant import quantizer as TQ

GRANS = {
    "per_tensor": {},
    "per_channel": {},
    "per_group": {"group_size": 32},
    "per_head": {"head_num": 8},
    "per_block": {"block_size": 48},  # 64 x 256 pads to 96 x 288
}
FLOATS = ("e4m3", "e5m2", "e3m2", "e2m1", "e4m7")


def _weight(seed=0, shape=(64, 256), scale=0.05):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale).astype(np.float32)


def _specs(**kw):
    return J.QuantSpec(**kw), T.QuantSpec(**kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("gran", list(GRANS))
@pytest.mark.parametrize("bit", range(2, 9))
def test_integer_qdq_bit_for_bit(gran, bit):
    """Fake quant and, where the store is defined (not per head: JAX's
    per-row view of the qparams refuses it), real quant codes and qparams:
    bit for bit, symmetric and asymmetric (per block: symmetric only, its
    defined case)."""
    w = _weight(seed=bit)
    for sym in ((True,) if gran == "per_block" else (True, False)):
        js, ts = _specs(bit=bit, symmetric=sym, granularity=gran,
                        **GRANS[gran])
        jq = np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js))
        tq = T.fake_quant_weight_dynamic(torch.from_numpy(w), ts).numpy()
        np.testing.assert_array_equal(tq, jq)
        if gran == "per_head":
            continue
        jc, jsc, jz = J.real_quant_weight(jnp.asarray(w), js)
        tc, tsc, tz = T.real_quant_weight(torch.from_numpy(w), ts)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        assert (tz is None) == (jz is None)
        if tz is not None:
            np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_reshape_padding_and_restore():
    w = _weight(shape=(8, 40))
    js, ts = _specs(bit=4, symmetric=False, granularity="per_group",
                    group_size=16)
    jr = np.asarray(J.reshape_tensor(jnp.asarray(w), js, allow_padding=True))
    tr = T.reshape_tensor(torch.from_numpy(w), ts, allow_padding=True)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(
        T.restore_tensor(tr, (8, 40), ts).numpy(),
        np.asarray(J.restore_tensor(jnp.asarray(jr), (8, 40), js)))
    with pytest.raises(ValueError):
        T.reshape_tensor(torch.from_numpy(w), ts)


def test_float_round_every_format():
    """Exact arithmetic: zero, subnormals, ties, saturation, bit for
    bit."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        np.array([0.0, -0.0, 1e-45, -1e-40, 1e-30, 2.0 ** -9, 2.0 ** -10,
                  0.0234375, 100.5, 447.0, 449.0, 57344.0, 6e4, -1e6, 3.3],
                 np.float32),
        (rng.randn(4096) * 10.0 ** rng.uniform(-4, 3, 4096)).astype(
            np.float32)])
    for name in FLOATS:
        e, m, qmax = J.FLOAT_FORMATS[name]
        want = np.asarray(J.float_round(jnp.asarray(x), e, m, qmax))
        got = T.float_round(torch.from_numpy(x), e, m, qmax).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fmt", FLOATS)
@pytest.mark.parametrize("gran", ["per_channel", "per_group", "per_tensor"])
def test_float_hw_qdq_bit_for_bit(fmt, gran):
    w = _weight(seed=3)
    js, ts = _specs(bit=fmt, symmetric=True, granularity=gran,
                    **GRANS[gran])
    np.testing.assert_array_equal(
        T.fake_quant_weight_dynamic(torch.from_numpy(w), ts).numpy(),
        np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js)))
    x = _weight(seed=4, shape=(2, 8, 64), scale=3.0)
    np.testing.assert_array_equal(
        T.fake_quant_act_dynamic(torch.from_numpy(x), ts).numpy(),
        np.asarray(J.fake_quant_act_dynamic(jnp.asarray(x), js)))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_float_real_quant_and_block_fp8(fmt):
    w = _weight(seed=5)
    js, ts = _specs(bit=fmt, symmetric=True, granularity="per_channel")
    jc, jsc, _ = J.real_quant_weight(jnp.asarray(w), js)
    tc, tsc, tz = T.real_quant_weight(torch.from_numpy(w), ts)
    assert tz is None
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc).astype(np.float32))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    # the 128 x 128 block round trip, at a ragged shape
    w = _weight(seed=6, shape=(200, 300))
    jq, jsb = J.weight_cast_to_fp8(jnp.asarray(w))
    tq, tsb = T.weight_cast_to_fp8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq).astype(np.float32))
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(jsb))
    np.testing.assert_array_equal(
        T.weight_cast_to_bf16(tq, tsb).float().numpy(),
        np.asarray(J.weight_cast_to_bf16(jq, jsb)).astype(np.float32))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e3m2"])
def test_float_ref_manual(fmt):
    """``ref_manual``: the two packages' log2 and non-integer power of two
    differ by an ulp (XLA's polynomial log), so a row's scale may differ
    by ulps (a bias near 20 moves by 1.9e-6, its power of two by 1.3e-6
    relative): values on the same grid point (within 1e-5 relative; the
    formats' steps are 2^-m >= 2^-7 relative) in >= 99.9%, the rest one
    grid step apart."""
    w = _weight(seed=7, shape=(128, 256))
    m = J.FLOAT_FORMATS[fmt][1]
    js, ts = _specs(bit=fmt, symmetric=True, granularity="per_channel",
                    float_mode="ref_manual")
    want = np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js),
                      np.float64)
    got = T.fake_quant_weight_dynamic(torch.from_numpy(w), ts).numpy() \
        .astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    same = np.abs(got - want) <= 1e-5 * mag
    assert same.mean() >= 0.999, same.mean()
    assert (np.abs(got - want) <= 2.0 ** -m * mag * (1 + 1e-6)).all()


MSE_CASES = [
    dict(bit=4, symmetric=False, granularity="per_group", group_size=32),
    dict(bit=4, symmetric=False, granularity="per_group", group_size=128),
    dict(bit=4, symmetric=True, granularity="per_channel"),
    dict(bit=2, symmetric=False, granularity="per_group", group_size=128),
    dict(bit=8, symmetric=True, granularity="per_tensor"),
]


@pytest.mark.parametrize("case", MSE_CASES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_mse_range(case):
    """The shrink grid: the ranges equal in >= 99% of rows; where one
    differs (|q - t|^2.4 by XLA's pow against torch's), the port's chosen
    error within 1e-6 relative of JAX's."""
    w = _weight(seed=8, shape=(256, 256))
    js, ts = _specs(calib_algo="mse", **case)
    jt = JQ.reshape_tensor(jnp.asarray(w), js)
    tt = TQ.reshape_tensor(torch.from_numpy(w), ts)
    jmn, jmx = (np.asarray(a) for a in JQ.mse_range(jt, js))
    tmn, tmx = (a.numpy() for a in TQ.mse_range(tt, ts))
    same = (jmn == tmn) & (jmx == tmx)
    assert same.mean() >= 0.99, same.mean()

    def err(mn, mx):
        qp = TQ.qparams_from_range((torch.from_numpy(np.array(mn)),
                                    torch.from_numpy(np.array(mx))), ts)
        q = TQ.quant_dequant(tt, qp, ts)
        e = ((q - tt).abs() ** 2.4).sum(dim=-1, keepdim=True)
        return (e.sum() if case["granularity"] == "per_tensor" else e)\
            .numpy()

    e_t, e_j = err(tmn, tmx), err(jmn, jmx)
    assert (np.abs(e_t - e_j) <= 1e-6 * np.abs(e_j)).all()
    # the dynamic fake quant through the mse range
    jq = np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js))
    tq = T.fake_quant_weight_dynamic(torch.from_numpy(w), ts).numpy()
    assert (jq == tq).mean() >= 0.99


@pytest.mark.parametrize("case", [
    dict(bit=4, symmetric=False, granularity="per_group", group_size=32),
    dict(bit=3, symmetric=False, granularity="per_channel", iters=50),
    dict(bit=4, symmetric=False, granularity="per_group", group_size=64,
         lp_norm=1.0)], ids=["g32", "per_channel", "lp1"])
def test_hqq_optimize(case):
    """Proximal zero points: the minmax scales bit for bit, the zeros
    within 1e-5 relative (XLA's pow and fused multiply-adds)."""
    w = _weight(seed=9, shape=(128, 256))
    js, ts = _specs(calib_algo="hqq", **case)
    _, jqp = J.get_tensor_qparams(jnp.asarray(w), js)
    _, tqp = T.get_tensor_qparams(torch.from_numpy(w), ts)
    np.testing.assert_array_equal(tqp.scales.numpy(), np.asarray(jqp.scales))
    assert _rel(tqp.zeros.numpy(), np.asarray(jqp.zeros)) < 1e-5


@pytest.mark.parametrize("sym", [True, False])
def test_learnable_range_with_factors(sym):
    """The learnable range of given clip factors.  ``jax.nn.sigmoid``
    (XLA's exp) and ``torch.sigmoid`` differ by an ulp in about 0.3% of
    inputs, so the ranges agree within 1e-6 relative (equal where the
    sigmoids are), and the fake-quant values in >= 99% of entries, the
    rest one step apart."""
    w = _weight(seed=10)
    rng = np.random.RandomState(11)
    up = rng.randn(64 * 8, 1).astype(np.float32)
    low = rng.randn(64 * 8, 1).astype(np.float32)
    js, ts = _specs(bit=4, symmetric=sym, granularity="per_group",
                    group_size=32, calib_algo="learnable")
    jw, tw = JQ.reshape_tensor(jnp.asarray(w), js), \
        TQ.reshape_tensor(torch.from_numpy(w), ts)
    jr = JQ.learnable_range(jw, js, jnp.asarray(low), jnp.asarray(up))
    tr = TQ.learnable_range(tw, ts, torch.from_numpy(low),
                            torch.from_numpy(up))
    sig_same = np.asarray(jax.nn.sigmoid(jnp.asarray(up))) == \
        torch.sigmoid(torch.from_numpy(up)).numpy()
    if not sym:
        sig_same &= np.asarray(jax.nn.sigmoid(jnp.asarray(low))) == \
            torch.sigmoid(torch.from_numpy(low)).numpy()
    for j, t in zip(jr, tr):
        j, t = np.asarray(j), t.numpy()
        assert _rel(t, j) < 1e-6
        np.testing.assert_array_equal(t[sig_same], j[sig_same])
    jargs = {"upbound_factor": jnp.asarray(up),
             "lowbound_factor": jnp.asarray(low)}
    targs = {"upbound_factor": torch.from_numpy(up),
             "lowbound_factor": torch.from_numpy(low)}
    jq = np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js,
                                                args=jargs))
    tq = T.fake_quant_weight_dynamic(torch.from_numpy(w), ts,
                                     args=targs).numpy()
    assert (jq == tq).mean() >= 0.99
    step = np.asarray(J.get_tensor_qparams(jnp.asarray(w), js, jargs)[1]
                      .scales).max()
    assert np.abs(jq - tq).max() <= step * (1 + 1e-5)


def test_w48_and_static_weight_qdq():
    w = _weight(seed=12)
    kw8 = dict(bit=8, symmetric=True, granularity="per_channel")
    kw4 = dict(bit=4, symmetric=False, granularity="per_group",
               group_size=32)
    (j8, t8), (j4, t4) = _specs(**kw8), _specs(**kw4)
    np.testing.assert_array_equal(
        T.fake_quant_weight_w48(torch.from_numpy(w), t8, t4).numpy(),
        np.asarray(J.fake_quant_weight_w48(jnp.asarray(w), j8, j4)))
    # static qparams along the input channels (dim_ic)
    _, jqp = J.get_tensor_qparams(jnp.asarray(w.T), j4)
    tqp = T.QParams(torch.from_numpy(np.array(jqp.scales)),
                    torch.from_numpy(np.array(jqp.zeros)))
    np.testing.assert_array_equal(
        T.fake_quant_weight_static(torch.from_numpy(w), t4, tqp,
                                   dim_ic=True).numpy(),
        np.asarray(J.fake_quant_weight_static(jnp.asarray(w), j4, jqp,
                                              dim_ic=True)))


@pytest.mark.parametrize("algo,sym", [
    ("static_minmax", True), ("static_minmax", False),
    ("static_moving_minmax", True), ("static_moving_minmax", False),
    ("static_hist", True)])  # the histogram search is symmetric only
def test_static_act_qparams(algo, sym):
    """Static per-tensor act qparams over calibration batches (three
    batches, the histogram re-binned as its range grows): bit for bit, and
    the static act fake quant with them."""
    batches = [_weight(seed=20 + i, shape=(2, 16, 64), scale=1.0 + i)
               for i in range(3)]
    js, ts = _specs(bit=8, symmetric=sym, granularity="per_tensor",
                    calib_algo=algo)
    jqp = J.static_act_qparams([jnp.asarray(b) for b in batches], js)
    tqp = T.static_act_qparams([torch.from_numpy(b) for b in batches], ts)
    np.testing.assert_array_equal(tqp.scales.numpy(), np.asarray(jqp.scales))
    np.testing.assert_array_equal(tqp.zeros.numpy(), np.asarray(jqp.zeros))
    x = batches[1]
    np.testing.assert_array_equal(
        T.fake_quant_act_static(torch.from_numpy(x), ts, tqp).numpy(),
        np.asarray(J.fake_quant_act_static(jnp.asarray(x), js, jqp)))


@pytest.mark.parametrize("gran", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("sym", [True, False])
def test_dynamic_act_qdq(gran, sym):
    x = _weight(seed=30, shape=(2, 16, 64), scale=2.0)
    js, ts = _specs(bit=8, symmetric=sym, granularity=gran)
    np.testing.assert_array_equal(
        T.fake_quant_act_dynamic(torch.from_numpy(x), ts).numpy(),
        np.asarray(J.fake_quant_act_dynamic(jnp.asarray(x), js)))


def test_spec_from_config_and_checks():
    for cfg in ({"bit": 4, "symmetric": False, "granularity": "per_group",
                 "group_size": 128, "calib_algo": "mse", "mse_grid": 50,
                 "layer_names": ["attn.o"]},
                {"bit": "e4m3", "granularity": "per_token",
                 "use_qtorch": False},
                {"bit": 8, "granularity": "per_head", "head_num": 4,
                 "int_range": [-100, 100]},
                {"bit": 8, "granularity": "per_block", "block_size": 128}):
        j, t = J.spec_from_config(cfg), T.spec_from_config(cfg)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.qmin, t.qmax, t.dst_nbins) == (j.qmin, j.qmax, j.dst_nbins)
    for bad in ({"granularity": "per_head"}, {"granularity": "per_block"},
                {"granularity": "per_block", "block_size": 4,
                 "symmetric": False}, {"bit": "e9m9"}):
        with pytest.raises(ValueError):
            T.QuantSpec(**bad)
    with pytest.raises(NotImplementedError, match="TesseraQ.*A8"):
        T.spec_from_config({"bit": 4, "ste": True})
    assert T.FLOAT_FORMATS == J.FLOAT_FORMATS


def test_outlier_columns_and_rounding_mask():
    """``int_indices`` / ``fp_indices`` keep outlier columns in float
    (weights and acts); ``rounding`` replaces round() by floor() plus a
    mask; bit for bit."""
    w = _weight(seed=40)
    fp = [3, 17, 100, 255]
    ii = [c for c in range(256) if c not in fp]
    js, ts = _specs(bit=4, symmetric=False, granularity="per_group",
                    group_size=36)
    np.testing.assert_array_equal(
        T.fake_quant_weight_dynamic(torch.from_numpy(w), ts, int_indices=ii,
                                    fp_indices=fp).numpy(),
        np.asarray(J.fake_quant_weight_dynamic(jnp.asarray(w), js,
                                               int_indices=ii,
                                               fp_indices=fp)))
    x = _weight(seed=41, shape=(2, 8, 256), scale=2.0)
    js8, ts8 = _specs(bit=8, symmetric=True, granularity="per_channel")
    np.testing.assert_array_equal(
        T.fake_quant_act_dynamic(torch.from_numpy(x), ts8, int_indices=ii,
                                 fp_indices=fp).numpy(),
        np.asarray(J.fake_quant_act_dynamic(jnp.asarray(x), js8,
                                            int_indices=ii, fp_indices=fp)))
    js, ts = _specs(bit=4, symmetric=False, granularity="per_group",
                    group_size=32)
    mask = (np.random.RandomState(42).rand(64 * 8, 32) > 0.5).astype(
        np.float32)
    _, jqp = J.get_tensor_qparams(jnp.asarray(w), js)
    tqp = T.QParams(torch.from_numpy(np.array(jqp.scales)),
                    torch.from_numpy(np.array(jqp.zeros)))
    np.testing.assert_array_equal(
        T.fake_quant_weight_static(torch.from_numpy(w), ts, tqp,
                                   rounding=torch.from_numpy(mask)).numpy(),
        np.asarray(J.fake_quant_weight_static(jnp.asarray(w), js, jqp,
                                              rounding=jnp.asarray(mask))))
