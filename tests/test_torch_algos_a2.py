"""Port parity: the algorithms and options that ride on the quantizer core
(HQQ along either axis, SmoothQuant with static per-tensor act quant, RTN
in e4m3 weights and acts) through ``run_pipeline`` in the JAX package and
the port on the same tiny checkpoint (CPU, f32), and the adapters'
``deploy_fake_quant`` with act qdq functions."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightcompress_tpu.quant as JQ
from helpers import make_tiny_hf_llama
from lightcompress_tpu.config import DotDict as JDotDict
from lightcompress_tpu.models.hf_loader import load_model as j_load
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu_torch import quant as TQ
from lightcompress_tpu_torch.config import DotDict, check_config
from lightcompress_tpu_torch.models.hf_loader import load_model
from lightcompress_tpu_torch.pipeline import run_pipeline

# PPL of the same f32 model and quantization in the two frameworks
TOL_PPL = 1e-4

W4 = {"bit": 4, "symmetric": False, "granularity": "per_group",
      "group_size": 16}
W8 = {"bit": 8, "symmetric": True, "granularity": "per_channel"}

CASES = {
    "hqq": {"quant": {"method": "HQQ", "weight": dict(W4,
                                                      calib_algo="hqq")}},
    "hqq_axis0": {"quant": {"method": "HQQ",
                            "weight": dict(W4, calib_algo="hqq"),
                            "special": {"axis": 0, "iters": 10}}},
    "smoothquant": {"quant": {
        "method": "SmoothQuant", "weight": W8,
        "act": {"bit": 8, "symmetric": True, "granularity": "per_tensor",
                "static": True, "calib_algo": "static_minmax"},
        "special": {"alpha": 0.5}}},
    "rtn_e4m3": {"quant": {
        "method": "RTN",
        "weight": {"bit": "e4m3", "symmetric": True,
                   "granularity": "per_channel", "use_qtorch": False},
        "act": {"bit": "e4m3", "symmetric": True,
                "granularity": "per_token", "use_qtorch": False}}},
}


def config(path, case, cases=CASES):
    cfg = {"base": {"seed": 42},
           "model": {"type": "Llama", "path": path,
                     "torch_dtype": "float32"},
           "calib": {"name": "synthetic", "n_samples": 4, "bs": -1,
                     "seq_len": 16, "preproc": "synthetic_random",
                     "seed": 42},
           "eval": {"eval_pos": ["fake_quant"], "name": "synthetic",
                    "seq_len": 16, "bs": 1, "n_tokens": 128}}
    cfg.update(copy.deepcopy(cases[case]))
    return cfg


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")))[0]


def run_both(path, case, cases=CASES):
    cfg = config(path, case, cases)
    check_config(DotDict(cfg))
    got, algo = run_pipeline(DotDict(cfg), device="cpu", return_algo=True)
    want = j_run_pipeline(JDotDict(cfg))
    assert sorted(got) == sorted(want) == ["ppl_fake_quant"]
    assert abs(got["ppl_fake_quant"] - want["ppl_fake_quant"]) \
        <= TOL_PPL * want["ppl_fake_quant"], (got, want)
    return algo


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(tiny_ckpt, case):
    algo = run_both(tiny_ckpt, case)
    st = algo.layer_state
    if case.startswith("hqq"):
        assert all("qparams" in st[i][n] for i in range(2)
                   for n in algo.model.get_block_linear_names(i))
        assert st[0]["attn.q"]["dim_ic"] == (case == "hqq_axis0")
    if case == "smoothquant":
        # static per-tensor act qparams for every linear
        assert all(st[i][n]["act_qparams"].scales.numel() == 1
                   for i in range(2)
                   for n in algo.model.get_block_linear_names(i))


def test_model_deploy_with_act_qdq(tiny_ckpt):
    """``deploy_fake_quant`` with per-block act qdq functions (the
    adapters' deployment API), against JAX's on the same weights.  The two
    forwards' f32 sums differ in order, which moves an act code at a
    rounding tie by one step now and then: the logits within 1e-2 of
    max |logit|, their mean difference within 1e-4."""
    jm = j_load(tiny_ckpt, dtype=jnp.float32, with_tokenizer=False)
    tm = load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    w4 = dict(W4)
    a8 = {"bit": 8, "symmetric": True, "granularity": "per_channel"}
    jw, ja = JQ.QuantSpec(**w4), JQ.QuantSpec(**a8)
    tw, ta = TQ.QuantSpec(**w4), TQ.QuantSpec(**a8)
    names = tm.get_block_linear_names(0)
    for m, Q, ws, aspec in ((jm, JQ, jw, ja), (tm, TQ, tw, ta)):
        m.deploy_fake_quant(
            [{n: (lambda w, n, Q=Q, ws=ws: Q.fake_quant_weight_dynamic(
                w, ws)) for n in names}] * 2,
            [{n: (lambda x, Q=Q, aspec=aspec: Q.fake_quant_act_dynamic(
                x, aspec)) for n in names}] * 2)
    ids = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    got = tm.forward(torch.from_numpy(ids)).numpy()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= 1e-2 * top and diff.mean() <= 1e-4 * top
    # the KV hooks (the KV-cache fake quant) are installed and run, one
    # call a block
    calls = []
    tm.deploy_fake_quant(
        [], [{n: (lambda x: TQ.fake_quant_act_dynamic(x, ta))
              for n in names}] * 2,
        kv_hooks=[lambda k, v: (calls.append(k.shape), (k, v))[1]] * 2)
    assert torch.equal(tm.forward(torch.from_numpy(ids)),
                       torch.from_numpy(got))
    assert len(calls) == 2
