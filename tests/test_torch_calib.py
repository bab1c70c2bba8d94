"""Port parity: the calibration path (config, synthetic calibration data,
the blockwise engine, RTN and AWQ with the v1 weight clip, the fake-quant
deployment, ``build_serving_weights(algo=)``) against the JAX package on
the same tiny checkpoints and data (CPU, f32 unless stated)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightcompress_tpu.compression  # noqa: F401  (registers the algos)
from helpers import make_tiny_hf_llama
from lightcompress_tpu.config import DotDict as JDotDict
from lightcompress_tpu.data import CalibDataset as JCalibDataset
from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.models import init_params as j_init_params
from lightcompress_tpu.models.hf_loader import load_model as j_load_model
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.registry import ALGO_REGISTRY as J_ALGOS
from lightcompress_tpu.serving.quantized_model import (
    build_serving_weights as j_build_serving_weights)
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.compression.quantization import Awq
from lightcompress_tpu_torch.config import DotDict, check_config
from lightcompress_tpu_torch.data import CalibDataset, batch_samples
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.models.hf_loader import load_model
from lightcompress_tpu_torch.ops.qlinear import dequant_weight
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.registry import ALGO_REGISTRY
from lightcompress_tpu_torch.serving import build_serving_weights

# f32 logits of the same weights: summation-order noise
TOL = 1e-5
# AWQ scales of the same grid index: mean|x| ** ratio and the weight
# statistics summed in another order
TOL_SCALES = 1e-5

RTN = {"method": "RTN", "weight": {"bit": 4, "symmetric": False,
                                   "granularity": "per_group",
                                   "group_size": 128}}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _entry_models(dtype):
    """``__graft_entry__.entry``'s flagship Llama at a small width: random
    JAX weights carried into the port."""
    jarch = JArchSpec(family="llama", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=64, dtype=dtype)
    jm = JLlama(jarch, j_init_params(jax.random.PRNGKey(0), jarch))
    fields = {f: getattr(jarch, f) for f in jarch.__dataclass_fields__
              if f != "dtype"}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tarch = convert.arch_from_fields(fields, tdt)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a), jm.params)
    return jm, Llama(tarch, convert.params_from_numpy(params, "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_rtn_fake_quant_forward_matches_jax(dtype):
    """The driver entry's computation: RTN W4 g128 asymmetric baked into
    the weights, then the forward."""
    jm, tm = _entry_models(getattr(jnp, dtype))
    ids = np.random.RandomState(0).randint(0, 512, (1, 128)).astype(
        np.int32)
    jalgo = J_ALGOS["RTN"](jm, JDotDict(RTN),
                           jm.collect_first_block_input([jnp.asarray(ids)]),
                           None, JDotDict({}))
    jalgo.deploy("fake_quant")
    talgo = ALGO_REGISTRY["RTN"](
        tm, DotDict(RTN), tm.collect_first_block_input(
            [torch.from_numpy(ids)]), None, DotDict({}))
    talgo.deploy("fake_quant")
    for jb, tb in zip(jm.params["blocks"], tm.params["blocks"]):
        for name in tm.get_block_linear_names(0):
            jw = np.asarray(JA._resolve(jb, name)["weight"].astype(
                jnp.float32))
            tw = TA.resolve(tb, name)["weight"].float().numpy()
            np.testing.assert_array_equal(tw, jw)  # bit for bit
    want = np.asarray(JA.model_forward(jm.arch, jm.params, jnp.asarray(ids),
                                       linear_fns=jm.linear_fns))
    got = tm.forward(torch.from_numpy(ids)).numpy()
    if dtype == "float32":
        assert _rel(got, want) < TOL
    else:  # bf16 activations rounded op by op in other orders
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    talgo.restore_float()
    jalgo.restore_float()
    # the model-level bake of per-block qdq fns gives the same weights
    _, tm2 = _entry_models(getattr(jnp, dtype))
    tm2.deploy_fake_quant([{n: (lambda w, n, i=i: talgo.w_qdq(w, i, n))
                            for n in tm2.get_block_linear_names(i)}
                           for i in range(tm2.num_blocks)])
    assert torch.equal(tm2.forward(torch.from_numpy(ids)),
                       torch.from_numpy(got))


def test_rtn_quant_out_block_loop_matches_jax(tiny_ckpt):
    """``quant_out``: each block's fake-quant outputs (``fq_linear_fn``)
    feed the next; the last block's outputs against JAX's."""
    quant = dict(RTN, quant_out=True,
                 weight=dict(RTN["weight"], group_size=16))
    jm = j_load_model(tiny_ckpt, dtype=jnp.float32, with_tokenizer=False)
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    ids = np.random.RandomState(5).randint(0, 256, (2, 16)).astype(np.int32)
    jalgo = J_ALGOS["RTN"](jm, JDotDict(quant),
                           jm.collect_first_block_input([jnp.asarray(ids)]),
                           None, JDotDict({}))
    jalgo.run_block_loop()
    talgo = ALGO_REGISTRY["RTN"](
        tm, DotDict(quant), tm.collect_first_block_input(
            [torch.from_numpy(ids)]), None, DotDict({}))
    talgo.run_block_loop()
    want = np.asarray(jalgo.input_batches[0])
    assert _rel(talgo.input_batches[0].numpy(), want) < TOL


AWQ = {"method": "Awq",
       "weight": {"bit": 4, "symmetric": False, "granularity": "per_group",
                  "group_size": 16},
       "special": {"trans": True, "trans_version": "v2",
                   "weight_clip": True, "clip_sym": False,
                   "save_scale": True}}
CALIB = {"name": "synthetic", "n_samples": 4, "bs": -1, "seq_len": 16,
         "preproc": "synthetic_random", "seed": 42}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")))[0]


def _calibrated(tiny_ckpt, tmp_path, **special):
    quant = copy.deepcopy(AWQ)
    quant["special"].update(special, scale_path=str(tmp_path / "scales"))
    cfg = {"calib": CALIB, "model": {"path": tiny_ckpt}}
    jm = j_load_model(tiny_ckpt, dtype=jnp.float32, with_tokenizer=False)
    jb, _ = JCalibDataset(None, CALIB).get_calib_dataset()
    jalgo = J_ALGOS["Awq"](
        jm, JDotDict(quant),
        jm.collect_first_block_input([jnp.asarray(b) for b in jb]), None,
        JDotDict(cfg))
    jalgo.run_block_loop()
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    tb, _ = CalibDataset(None, CALIB).get_calib_dataset()
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
    talgo = ALGO_REGISTRY["Awq"](
        tm, DotDict(quant),
        tm.collect_first_block_input([torch.from_numpy(b) for b in tb]),
        None, DotDict(cfg))
    talgo.run_block_loop()
    return jm, jalgo, tm, talgo


@pytest.mark.parametrize("special", [
    {}, {"trans_version": "v1"}, {"weight_clip": False},
    {"true_sequential": True}])
def test_awq_blocks_match_jax(tiny_ckpt, tmp_path, special):
    """Per block and subset: the same grid index (the same scales), the
    same clipped weights (so the same per-group clip max/min), and the
    transformed model's logits."""
    jm, jalgo, tm, talgo = _calibrated(tiny_ckpt, tmp_path, **special)
    assert isinstance(talgo, Awq)
    assert sorted(jalgo.act_scales) == sorted(talgo.act_scales)
    margins = []
    for key, js in jalgo.act_scales.items():
        ts = talgo.act_scales[key].numpy()
        assert _rel(ts, np.asarray(js)) < TOL_SCALES, key
    for (block, _), (losses, best) in talgo.search_log.items():
        ls = np.sort(losses.numpy())
        margins.append((ls[1] - ls[0]) / ls[0])
    # the two best losses of every search stand apart by far more than the
    # two frameworks' f32 summation noise (~1e-7 relative), so the argmin
    # cannot flip between them: measured least margins 5.2e-3 (v2) and
    # 1.5e-4 (v1, block 1's q/k/v subset), relative to the best loss
    assert min(margins) > 1e-5, margins
    for jbp, tbp in zip(jm.params["blocks"], tm.params["blocks"]):
        for name in tm.get_block_linear_names(0):
            jw = np.asarray(JA._resolve(jbp, name)["weight"])
            tw = TA.resolve(tbp, name)["weight"].numpy()
            assert _rel(tw, jw) < TOL_SCALES, name
            g = 16
            for red in (np.max, np.min):  # the per-group clip ranges
                assert _rel(red(tw.reshape(-1, g), axis=1),
                            red(jw.reshape(-1, g), axis=1)) < TOL_SCALES
        for ln in ("ln1", "ln2"):
            assert _rel(tbp[ln]["weight"].numpy(),
                        np.asarray(jbp[ln]["weight"])) < TOL_SCALES
    ids = np.random.RandomState(3).randint(0, 256, (2, 16)).astype(np.int32)
    jalgo.deploy("transformed")
    talgo.deploy("transformed")
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    assert _rel(tm.forward(torch.from_numpy(ids)).numpy(), want) < TOL
    # fake quant of the transformed weights
    jalgo.deploy("fake_quant")
    talgo.deploy("fake_quant")
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    assert _rel(tm.forward(torch.from_numpy(ids)).numpy(), want) < 1e-4
    talgo.restore_float()
    assert not hasattr(tm, "_fp_blocks")


def test_serving_weights_from_algo_match_jax(tiny_ckpt, tmp_path):
    """``build_serving_weights(algo=)``: the calibrated weights through
    ``w_qdq``, re-coded: codes bit for bit, scales and zero corrections as
    JAX's."""
    jm, jalgo, tm, talgo = _calibrated(tiny_ckpt, tmp_path)
    wspec = dict(bit=4, symmetric=False, granularity="per_group",
                 group_size=16)
    jsw = j_build_serving_weights(jm, JQuantSpec(**wspec), algo=jalgo,
                                  act_bits=16)
    tsw = build_serving_weights(tm, QuantSpec(**wspec), algo=talgo,
                                device="cpu")
    for jb, tb, tbp, idx in zip(jsw.blocks, tsw.blocks,
                                tm.params["blocks"], range(tm.num_blocks)):
        for name, qp in jb.items():
            if name in ("ln1", "ln2"):
                continue
            got = convert.qlinear_from_numpy(
                np.asarray(qp.codes), np.asarray(qp.scales),
                None if qp.zeros is None else np.asarray(qp.zeros), None,
                qp.bits, qp.group_size, qp.layout, device="cpu")
            assert torch.equal(tb[name].codes, got.codes), name
            assert _rel(tb[name].scales.float().numpy(),
                        got.scales.float().numpy()) < TOL_SCALES
            assert _rel(tb[name].zeros.float().numpy(),
                        got.zeros.float().numpy()) < TOL_SCALES
            # the re-code is lossless: the served weight is w_qdq's
            want = talgo.w_qdq(TA.resolve(tbp, name)["weight"], idx, name)
            assert _rel(dequant_weight(tb[name], torch.float32).numpy(),
                        want.numpy()) < TOL_SCALES


def test_config_and_data_pieces():
    cfg = DotDict({"model": {"path": "x"}, "quant": AWQ, "calib": CALIB})
    check_config(cfg)
    assert cfg.quant.special.trans_version == "v2"
    with pytest.raises(ValueError):
        check_config(DotDict({"model": {}, "quant": {
            "weight": {"granularity": "per_group"}}}))
    with pytest.raises(ValueError):
        check_config(DotDict({"model": {}, "calib": {"n_samples": 0}}))
    s = [np.full((1, 4), i) for i in range(5)]
    b, m = batch_samples(s, 2)
    assert [x.shape for x in b] == [(2, 4), (2, 4), (1, 4)] and m is None
    b, m = batch_samples([np.ones((1, 3)), np.ones((1, 5))], -1)
    assert b[0].shape == (2, 5) and m[0].tolist() == [[0, 0, 1, 1, 1],
                                                      [1] * 5]
    with pytest.raises(NotImplementedError, match="A4"):
        CalibDataset(None, dict(CALIB, name="pileval"))
    # the text preprocs are ported (tests/test_torch_dataset_text.py); a
    # model without a tokenizer cannot run them
    with pytest.raises(ValueError, match="tokenizer"):
        CalibDataset(None, dict(CALIB, preproc="pileval_awq")).get_samples()


@pytest.mark.parametrize("change,item", [
    ({"token_reduction": {"method": "ToMe"}}, "A12"),
    ({"weight": {"bit": 4, "ste": True}}, "A8")])
def test_unported_options_raise(tiny_ckpt, change, item):
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    quant = copy.deepcopy(AWQ)
    quant.update(change)
    with pytest.raises(NotImplementedError, match=item):
        ALGO_REGISTRY["Awq"](tm, DotDict(quant), [], None, DotDict({}))
