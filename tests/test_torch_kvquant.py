"""Port parity: the KV-cache fake quant (``compression/quantization/
kvquant.py``), its deployment through the model's KV hooks, the static KV
calibration in the block loop and the decode PPL (``eval/ppl.py``'s
``DecodePerplexityEval``) against the JAX package on the same inputs
(CPU, f32): the hooks bit for bit (both packages run them eagerly), the
static qparams within 1e-6 (the K/V sums of two frameworks' matmuls), the
PPLs within 1e-5 relative (1e-4 with static act quant), and
``configs/methods/rtn_w8_kv8.yml`` through both pipelines with a prefill
and a decode PPL."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from a8_helpers import (make_ckpt, method_quant, pipeline_config, rel,
                        run_algo_both, run_both_pipelines)
from lightcompress_tpu.eval import DecodePerplexityEval as JDecodePPL
from lightcompress_tpu.registry import KV_REGISTRY as J_KV
from lightcompress_tpu_torch.eval import DecodePerplexityEval, PerplexityEval
from lightcompress_tpu_torch.registry import KV_REGISTRY
from test_torch_serving import one_torch_thread  # noqa: F401

# PPLs of the same f32 model: summation-order noise
TOL_PPL = 1e-5
# with static act quant: the frameworks' sums move an act code at a
# rounding tie now and then (the act-quant tests' gate)
TOL_PPL_ACT = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_ckpt(tmp_path_factory)


def _kv(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("cfg", [
    {"bit": 4, "symmetric": False, "granularity": "per_token",
     "round_zp": False},
    {"bit": 4, "symmetric": False, "granularity": "per_group",
     "group_size": 16, "round_zp": False},
    {"bit": 8, "symmetric": True, "granularity": "per_token"},
    {"bit": 8, "symmetric": True, "granularity": "per_tensor"}],
    ids=["tok_a4", "group_a4", "tok_s8", "tensor_s8"])
def test_naive_hook_bit_for_bit(cfg):
    k, v = _kv(31, (2, 4, 10, 32))  # tests/test_kvquant_parity.py's
    jk, jv = J_KV["Naive"]("int-quant", dict(cfg), 1).make_hook(0)(
        jnp.asarray(k), jnp.asarray(v))
    tk, tv = KV_REGISTRY["Naive"]("int-quant", dict(cfg), 1).make_hook(0)(
        torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kivi_hook_bit_for_bit():
    k, v = _kv(37, (1, 2, 24, 16))
    cfg = {"bit": 4, "symmetric": False, "granularity": "per_token",
           "round_zp": False, "residual_length": 8}
    jk, jv = J_KV["Kivi"]("int-quant", dict(cfg), 1).make_hook(0)(
        jnp.asarray(k), jnp.asarray(v))
    tk, tv = KV_REGISTRY["Kivi"]("int-quant", dict(cfg), 1).make_hook(0)(
        torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert torch.equal(tk[:, :, 16:], torch.from_numpy(k[:, :, 16:]))
    assert not torch.equal(tk[:, :, :16], torch.from_numpy(k[:, :, :16]))
    # a window no longer than the residual stays in float
    short = torch.from_numpy(k[:, :, :8])
    assert KV_REGISTRY["Kivi"]("int-quant", dict(cfg), 1).make_hook(0)(
        short, short)[0] is short
    with pytest.raises(ValueError, match="dynamic"):
        KV_REGISTRY["Kivi"]("int-quant", dict(cfg, static=True), 1)


RTN8 = {"method": "RTN",
        "weight": {"bit": 8, "symmetric": True, "granularity": "per_channel"}}


def test_static_kv_calibration(ckpt):
    """Static per-tensor act quant makes the KV quant static: qparams from
    each block's calibration K/V, the hooks' PPL, and none under
    ``fake_quant_wo_kv``."""
    quant = dict(RTN8, act={"bit": 8, "symmetric": True,
                            "granularity": "per_tensor", "static": True,
                            "calib_algo": "static_minmax"},
                 kvcache={"method": "Naive", "bit": 8, "symmetric": True,
                          "granularity": "per_tensor"})
    jm, jalgo, tm, talgo = run_algo_both(ckpt, quant)
    assert talgo.kv_module.static
    for jq, tq in zip(jalgo.kv_module.k_qparams + jalgo.kv_module.v_qparams,
                      talgo.kv_module.k_qparams + talgo.kv_module.v_qparams):
        assert rel(tq.scales.numpy(), np.asarray(jq.scales)) < 1e-6
    enc = np.random.RandomState(0).randint(0, 256, (1, 64)).astype(np.int32)
    jalgo.deploy("fake_quant")
    talgo.deploy("fake_quant")
    assert len(tm.kv_hooks) == 2
    from lightcompress_tpu.eval import PerplexityEval as JPPL

    want = JPPL(enc, seq_len=16).eval(jm)
    assert abs(PerplexityEval(enc, seq_len=16).eval(tm) - want) \
        <= TOL_PPL_ACT * want
    talgo.restore_float()
    talgo.deploy("fake_quant_wo_kv")
    assert tm.kv_hooks is None


@pytest.mark.parametrize("kv", [
    {"method": "Naive", "bit": 8, "symmetric": True,
     "granularity": "per_token"},
    {"method": "Naive", "bit": 4, "symmetric": False,
     "granularity": "per_group", "group_size": 16},
    {"method": "Kivi", "bit": 4, "symmetric": False,
     "granularity": "per_token", "residual_length": 4},
    None], ids=["naive8", "naive4_group", "kivi4", "float"])
def test_decode_ppl_matches_jax(ckpt, kv):
    quant = dict(RTN8, kvcache=kv) if kv else dict(RTN8)
    jm, jalgo, tm, talgo = run_algo_both(ckpt, quant)
    jalgo.deploy("fake_quant")
    talgo.deploy("fake_quant")
    enc = np.random.RandomState(1).randint(0, 256, (1, 25)).astype(np.int32)
    want = JDecodePPL(enc, num_eval_tokens=24).eval(jm)
    got = DecodePerplexityEval(enc, num_eval_tokens=24).eval(tm)
    assert abs(got - want) <= TOL_PPL * want
    if kv is None:
        # without KV quant the decode PPL is the prefill PPL of the same
        # 24 predictions
        pre = PerplexityEval(enc, seq_len=25).eval(tm)
        assert abs(got - pre) <= 1e-4 * pre


def test_rtn_w8_kv8_config_through_both_pipelines(ckpt):
    quant = method_quant("rtn_w8_kv8")
    assert quant["kvcache"]["method"] == "Naive"
    ev = {"name": "synthetic", "seq_len": 16, "bs": 1, "n_tokens": 64,
          "eval_pos": ["fake_quant", "fake_quant_wo_kv"]}
    cfg = pipeline_config(ckpt, quant, [
        ev, dict(ev, type="decode_ppl", num_eval_tokens=32)])
    want, got, talgo = run_both_pipelines(cfg)
    assert sorted(got) == sorted(want) and len(got) == 4
    for key in want:
        assert abs(got[key] - want[key]) <= TOL_PPL * want[key], (key, got,
                                                                 want)
    # the KV quant moves the decode PPL (kv8 per token: a little)
    assert got["decode_ppl_synthetic_fake_quant"] != \
        got["decode_ppl_synthetic_fake_quant_wo_kv"]
