"""Port parity: GPTQ (``compression/quantization/gptq.py``) against the JAX
package on the same numpy inputs (CPU): the column step fed JAX's Cholesky
factor, the whole layer over its options, the numpy reference of
``tests/test_gptq.py``, the GPTQ CI config through ``run_pipeline``, and
JAX's searched state deployed through the port's ``w_qdq`` and serving
build."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightcompress_tpu.compression  # noqa: F401  (registers the algos)
from helpers import make_tiny_hf_llama
from test_gptq import np_gptq_reference
from lightcompress_tpu.compression.quantization.gptq import \
    gptq_quantize_layer as j_gptq_layer
from lightcompress_tpu.config import DotDict as JDotDict
from lightcompress_tpu.config import load_config as j_load_config
from lightcompress_tpu.data import CalibDataset as JCalibDataset
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.models.hf_loader import load_model as j_load_model
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.registry import ALGO_REGISTRY as J_ALGOS
from lightcompress_tpu.serving.quantized_model import (
    build_serving_weights as j_build_serving_weights)
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.compression.quantization.gptq import (
    gptq_columns, gptq_factor, gptq_quantize_layer)
from lightcompress_tpu_torch.config import DotDict, load_config
from lightcompress_tpu_torch.data import CalibDataset
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.models.hf_loader import load_model
from lightcompress_tpu_torch.ops.qlinear import dequant_weight
from lightcompress_tpu_torch.pipeline import run_pipeline
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.registry import ALGO_REGISTRY
from lightcompress_tpu_torch.serving import build_serving_weights

ROOT = Path(__file__).resolve().parents[1]
CI = ROOT / "configs" / "ci" / "gptq_w_only_tiny_synthetic.yml"
OC, IC = 32, 128
# the fake-quant PPL of the CI config's model in the two packages
TOL_PPL = 1e-3


def _layer_inputs(seed=0):
    """W (OC, IC) and H = 2/4 X^T X from 512 tokens whose channels have
    spread scales; channel 5 is dead (H_55 = 0)."""
    rng = np.random.RandomState(seed)
    W = rng.randn(OC, IC).astype(np.float32)
    X = (rng.randn(512, IC) * (0.2 + 2 * rng.rand(IC))).astype(np.float32)
    X[:, 5] = 0
    return W, X, (2 * X.T @ X / 4).astype(np.float32)


def _spec(gs, calib="minmax"):
    kw = dict(bit=4, symmetric=False, granularity="per_group", group_size=gs,
              calib_algo=calib)
    return JQuantSpec(**kw), QuantSpec(**kw)


def _codes(W, scales, zeros, perm, gs):
    """The integer codes of W with per-group qparams in the permuted
    column order."""
    W = np.asarray(W, np.float32)[:, np.asarray(perm)]
    s = np.repeat(np.asarray(scales), gs, axis=1)
    z = np.repeat(np.asarray(zeros), gs, axis=1)
    return np.clip(np.round(W / s) + z, 0, 15), (np.clip(
        np.round(W / s) + z, 0, 15) - z) * s


def _jax_factor(W, H, actorder, percdamp=0.01):
    """JAX's permutation and U, by the layer's own steps."""
    Hj = jnp.asarray(H)
    dead = jnp.diagonal(Hj) == 0
    Hj = Hj + jnp.diag(jnp.where(dead, 1.0, 0.0))
    Wj = jnp.asarray(W) * (~dead)[None, :]
    perm = jnp.argsort(-jnp.diagonal(Hj)) if actorder else jnp.arange(IC)
    Wj, Hj = Wj[:, perm], Hj[perm][:, perm]
    Hj = Hj + percdamp * jnp.mean(jnp.diagonal(Hj)) * jnp.eye(IC)
    L = jnp.linalg.cholesky(Hj)
    Hinv = jax.scipy.linalg.cho_solve((L, True), jnp.eye(IC))
    U = jnp.linalg.cholesky(Hinv).T
    return np.asarray(Wj), np.asarray(U), np.asarray(perm)


@pytest.mark.parametrize("actorder,gs,bs", [(True, 16, 16), (False, 32, 64)])
def test_column_step_fed_jax_u(actorder, gs, bs):
    """The column loop alone, on JAX's permuted W and U: codes equal in
    >= 99.9% of entries, W_new within 1e-5 relative."""
    W, _, H = _layer_inputs(1)
    js, ts = _spec(gs)
    jw, jsc, jz, jperm = (np.asarray(a) for a in j_gptq_layer(
        jnp.asarray(W), jnp.asarray(H), js, blocksize=bs, group_size=gs,
        actorder=actorder))
    Wp, U, perm = _jax_factor(W, H, actorder)
    np.testing.assert_array_equal(perm, jperm)
    tw, tsc, tz = gptq_columns(torch.from_numpy(Wp), torch.from_numpy(U),
                               ts, blocksize=bs, group_size=gs)
    tw = tw.numpy()[:, np.argsort(perm)]
    assert np.abs(tw - jw).max() <= 1e-5 * np.abs(jw).max()
    jc, _ = _codes(jw, jsc, jz, perm, gs)
    tc, _ = _codes(tw, tsc.numpy(), tz.numpy(), perm, gs)
    assert (jc == tc).mean() >= 0.999


LAYER_CASES = [
    # actorder, static_groups, n_out, group, blocksize, range
    (True, False, 0, 16, 16, "minmax"),
    (True, True, 0, 32, 128, "mse"),
    (False, False, 8, 16, 128, "minmax"),
    (True, False, 8, 128, 16, "mse"),
    (False, True, 0, 128, 128, "minmax"),
    (False, False, 0, 32, 16, "mse"),
    (True, False, 0, 128, 128, "minmax"),
    (False, True, 8, 32, 16, "mse"),
]


@pytest.mark.parametrize("actorder,static,n_out,gs,bs,calib", LAYER_CASES)
def test_whole_layer_matches_jax(actorder, static, n_out, gs, bs, calib):
    """The factor (Cholesky in torch against JAX's, 1e-6 apart) then the
    column step: perm identical, codes equal in >= 99%, scales within 1e-4
    relative, the output error |X (W - W_q)| within 1% of JAX's."""
    W, X, H = _layer_inputs(2)
    js, ts = _spec(gs, calib)
    kw = dict(blocksize=bs, group_size=gs, actorder=actorder,
              static_groups=static, n_out=n_out)
    jw, jsc, jz, jperm = (np.asarray(a) for a in j_gptq_layer(
        jnp.asarray(W), jnp.asarray(H), js, **kw))
    seconds = {}
    tw, tsc, tz, tperm = (a.numpy() for a in gptq_quantize_layer(
        torch.from_numpy(W), torch.from_numpy(H), ts, seconds=seconds, **kw))
    assert sorted(seconds) == ["columns", "factor"]
    np.testing.assert_array_equal(tperm, jperm)
    jc, jq = _codes(jw, jsc, jz, jperm, gs)
    tc, tq = _codes(tw, tsc, tz, tperm, gs)
    keep = np.arange(IC) < IC - n_out  # OWQ's trailing columns stay float
    assert (jc == tc)[:, keep].mean() >= 0.99
    assert np.abs(tsc - jsc).max() <= 1e-4 * np.abs(jsc).max()
    inv = np.argsort(jperm)

    def out_err(Wq, Wn):
        Wq = np.where(keep[None, :], Wq, np.asarray(Wn)[:, jperm])[:, inv]
        return np.linalg.norm(X.astype(np.float64) @ (W - Wq).T)

    e_j, e_t = out_err(jq, jw), out_err(tq, tw)
    assert abs(e_t - e_j) <= 0.01 * e_j, (e_t, e_j)


@pytest.mark.parametrize("actorder", [False, True])
def test_layer_matches_numpy_reference(actorder):
    """``tests/test_gptq.py``'s float64 numpy OBQ loop, at its tolerance."""
    rng = np.random.RandomState(0)
    W = rng.randn(8, 64).astype(np.float32)
    X = rng.randn(256, 64).astype(np.float32)
    H = 2 * X.T @ X / 4
    _, ts = _spec(16)
    tw, _, _, tperm = gptq_quantize_layer(
        torch.from_numpy(W), torch.from_numpy(H), ts, blocksize=16,
        group_size=16, actorder=actorder)
    W_ref, _, _, perm_ref = np_gptq_reference(W, H, ts.qmin, ts.qmax, 16,
                                              16, actorder=actorder)
    np.testing.assert_allclose(tw.numpy(), W_ref, rtol=1e-3, atol=1e-3)
    if actorder:
        np.testing.assert_array_equal(tperm.numpy(), perm_ref)


def test_factor_is_the_inverse_cholesky():
    """U is upper with H_damped^-1 = U^T U, in the permuted order."""
    W, _, H = _layer_inputs(3)
    Wp, U, perm = gptq_factor(torch.from_numpy(W), torch.from_numpy(H),
                              actorder=True)
    Hp = H.astype(np.float64).copy()
    Hp[5, 5] = 1.0
    Hp = Hp[perm.numpy()][:, perm.numpy()]
    Hp += 0.01 * np.mean(np.diag(Hp)) * np.eye(IC)
    U = U.double().numpy()
    assert np.allclose(np.triu(U), U)
    assert np.abs(U.T @ U @ Hp - np.eye(IC)).max() < 1e-3
    assert (Wp.numpy()[:, np.argsort(perm.numpy())][:, 5] == 0).all()


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")))[0]


def test_ci_config_run_pipeline_matches_jax(tiny_ckpt):
    """``configs/ci/gptq_w_only_tiny_synthetic.yml`` end to end (actorder,
    true_sequential, quant_out, groups and blocks of 16)."""
    jcfg = j_load_config(str(CI))
    jcfg.model.path = tiny_ckpt
    tcfg = load_config(str(CI))
    tcfg.model.path = tiny_ckpt
    timings = {}
    got, talgo = run_pipeline(tcfg, device="cpu", timings=timings,
                              return_algo=True)
    want = j_run_pipeline(jcfg)
    assert sorted(got) == sorted(want) == ["ppl_fake_quant"]
    assert abs(got["ppl_fake_quant"] - want["ppl_fake_quant"]) \
        <= TOL_PPL * want["ppl_fake_quant"], (got, want)
    assert len(timings["blocks"]) == 2
    assert sorted(talgo.seconds) == ["columns", "factor", "hessian"]


def test_jax_search_deployed_through_the_port(tiny_ckpt):
    """JAX's GPTQ search (the CI config's options) carried into the port
    (``convert.layer_state_from_numpy``, its transformed weights by
    ``convert.params_from_numpy``): the port's ``w_qdq`` gives JAX's
    weights bit for bit, and ``build_serving_weights(algo=)`` JAX's codes
    (the static qparams reach serving through ``w_qdq``, as in JAX)."""
    cfg = load_config(str(CI))
    quant = dict(cfg.quant)
    calib = dict(cfg.calib)
    jm = j_load_model(tiny_ckpt, dtype=jnp.float32, with_tokenizer=False)
    jb, _ = JCalibDataset(None, calib).get_calib_dataset()
    jalgo = J_ALGOS["GPTQ"](
        jm, JDotDict(quant),
        jm.collect_first_block_input([jnp.asarray(b) for b in jb]), None,
        JDotDict({"calib": calib}))
    jalgo.run_block_loop()
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    tb, _ = CalibDataset(None, calib).get_calib_dataset()
    talgo = ALGO_REGISTRY["GPTQ"](
        tm, DotDict(quant),
        tm.collect_first_block_input([torch.from_numpy(b) for b in tb]),
        None, DotDict({"calib": calib}))
    tm.params["blocks"] = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params["blocks"]), "cpu")
    talgo.layer_state = convert.layer_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jalgo.layer_state), "cpu")
    for idx in range(tm.num_blocks):
        for name in tm.get_block_linear_names(idx):
            jw = JA._resolve(jm.params["blocks"][idx], name)["weight"]
            tw = TA.resolve(tm.params["blocks"][idx], name)["weight"]
            np.testing.assert_array_equal(
                talgo.w_qdq(tw, idx, name).numpy(),
                np.asarray(jalgo.w_qdq(jw, idx, name)))
    wspec = dict(bit=4, symmetric=False, granularity="per_group",
                 group_size=16)
    jsw = j_build_serving_weights(jm, JQuantSpec(**wspec), algo=jalgo,
                                  act_bits=16)
    tsw = build_serving_weights(tm, QuantSpec(**wspec), algo=talgo,
                                device="cpu")
    for jblock, tblock in zip(jsw.blocks, tsw.blocks):
        for name, qp in jblock.items():
            if name in ("ln1", "ln2"):
                continue
            got = convert.qlinear_from_numpy(
                np.asarray(qp.codes), np.asarray(qp.scales),
                None if qp.zeros is None else np.asarray(qp.zeros), None,
                qp.bits, qp.group_size, qp.layout, device="cpu")
            assert torch.equal(tblock[name].codes, got.codes), name
    # with actorder GPTQ's groups run in the permuted order, so the re-code
    # in natural groups is not lossless (as in JAX; ROADMAP C): the served
    # weights differ from w_qdq's
    served = dequant_weight(tsw.blocks[0]["attn.q"], torch.float32)
    want = talgo.w_qdq(TA.resolve(tm.params["blocks"][0], "attn.q")
                       ["weight"], 0, "attn.q")
    assert not torch.equal(served, want)


def test_stacked_experts_raise_naming_a9(tiny_ckpt):
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    algo = ALGO_REGISTRY["GPTQ"](tm, DotDict(dict(load_config(str(CI))
                                                  .quant)), [], None,
                                 DotDict({}))
    subset = dataclasses.replace(tm.get_subsets_in_block(0)[0],
                                 layers=("attn.q",))
    bp = {"attn": {"q": {"weight": torch.zeros(2, 8, 64)}}}
    with pytest.raises(NotImplementedError, match="A9"):
        algo.subset_transform(0, bp, subset, {})
