"""export.py against the JAX package (CPU): the int4 packers bit for bit;
every format's files from the same RTN algorithm (a dense tiny Llama and a
Mixtral-shaped block, whose experts are written per expert) byte for byte
with equal quant-config JSON; the AWQ CI config with every ``save_*`` key,
calibrated on text, run through both pipelines; ``trtllm-build``'s command recorded where it is
absent."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcompress_tpu import export as J
from lightcompress_tpu.config import DotDict as JDotDict
from lightcompress_tpu.config import load_config as j_load_config
from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import init_params as j_init
from lightcompress_tpu.models.arch import MoESpec as JMoESpec
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu.registry import ALGO_REGISTRY as J_ALGOS
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch import export as P
from lightcompress_tpu_torch.config import DotDict, load_config
from lightcompress_tpu_torch.models import Llama, st_io
from lightcompress_tpu_torch.pipeline import run_pipeline
from lightcompress_tpu_torch.registry import ALGO_REGISTRY
from test_torch_checkpoint import MOE_DIMS
from test_torch_dataset_text import (  # noqa: F401
    text_calib_config, text_dir, tiny_ckpt, tokenized_ckpt)
from test_torch_pipeline import TOL_PPL
from test_torch_serving import one_torch_thread  # noqa: F401

FORMATS = ("vllm", "sgl", "lightllm", "autoawq", "mlcllm", "lightx2v",
           "native", "trtllm")
SAVE_KEYS = {f"save_{f}": True for f in FORMATS}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("signed", [False, True])
def test_pack_unpack_int4_bit_for_bit(signed):
    rng = np.random.RandomState(0)
    lo, hi = (-8, 8) if signed else (0, 16)
    codes = rng.randint(lo, hi, size=(24, 64)).astype(np.int32)
    jp = np.asarray(J.pack_int4(jnp.asarray(codes)))
    tp = P.pack_int4(_t(codes))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(
        np.asarray(J.unpack_int4(jnp.asarray(jp), signed=signed)),
        P.unpack_int4(tp, signed=signed).numpy())
    if signed:
        np.testing.assert_array_equal(P.unpack_int4(tp, True).numpy(),
                                      codes)


def test_awq_gemm_pack_bit_for_bit():
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 16, size=(40, 64)).astype(np.int8)
    scales = (rng.rand(40, 4) * 0.01).astype(np.float32)
    zeros = rng.randint(0, 16, size=(40, 4)).astype(np.float32)
    jo = J.awq_gemm_pack(jnp.asarray(codes), jnp.asarray(scales),
                         jnp.asarray(zeros))
    to = P.awq_gemm_pack(_t(codes), _t(scales), _t(zeros))
    for a, b, dt in zip(jo, to, (torch.int32, torch.float16, torch.int32)):
        assert b.dtype == dt
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the [0, 2, 4, 6, 1, 3, 5, 7] order: word 0 of row 0 holds oc 0, 2,
    # 4, 6, 1, 3, 5, 7 in nibbles 0-7
    nib = [(int(to[0][0, 0]) >> (4 * i)) & 0xF for i in range(8)]
    assert nib == [int(codes[j, 0]) for j in (0, 2, 4, 6, 1, 3, 5, 7)]


def _read(path):
    """name -> (dtype, shape, bytes) of a safetensors file."""
    h, off = st_io.read_header(path)
    blob = open(path, "rb").read()
    return {k: (v["dtype"], v["shape"],
                blob[off + v["data_offsets"][0]:off + v["data_offsets"][1]])
            for k, v in h.items()}


_NP = {"F32": np.float32, "F16": np.float16, "I32": np.int32,
       "I8": np.int8, "U8": np.uint8}


def _values(dtype, shape, raw):
    return np.frombuffer(raw, _NP[dtype]).reshape(shape)


def _dirs_equal(d1, d2):
    """Every file under d1 equals d2's: safetensors tensor by tensor, JSON
    parsed, text as is."""
    files = sorted(os.listdir(d1))
    assert files == sorted(os.listdir(d2))
    for f in files:
        a, b = os.path.join(d1, f), os.path.join(d2, f)
        if os.path.isdir(a):
            _dirs_equal(a, b)
        elif f.endswith(".safetensors"):
            assert _read(a) == _read(b), a
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), a
        else:
            assert open(a).read().replace(d1, "") == \
                open(b).read().replace(d2, ""), a


RTN = {"method": "RTN", "weight": {"bit": 4, "symmetric": False,
                                   "granularity": "per_group",
                                   "group_size": 32}}


def _rtn_algos(jmodel, tmodel, quant):
    ja = J_ALGOS["RTN"](jmodel, JDotDict(quant), [], None, JDotDict({}))
    ta = ALGO_REGISTRY["RTN"](tmodel, DotDict(quant), [], None, DotDict({}))
    return ja, ta


def _tiny_models(moe=None, seed=2):
    dims = dict(MOE_DIMS, hidden_size=256, intermediate_size=256)
    jarch = JArchSpec(**dims, moe=None if moe is None else JMoESpec(**moe),
                      dtype=jnp.float32)
    jparams = j_init(jax.random.PRNGKey(seed), jarch)
    tarch = convert.arch_from_fields(dict(dims, moe=moe),
                                     dtype=torch.float32)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return JLlama(jarch, jparams), Llama(tarch, tparams)


@pytest.mark.parametrize("moe", [None, dict(num_experts=8, top_k=2,
                                            moe_intermediate_size=128)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_rtn_export_matches_jax(tmp_path, moe, fmt):
    """The same float weights, RTN W4 g32 asymmetric: each format's tensor
    file and quant config equal JAX's; a MoE block's experts go out per
    expert (``.experts.<e>``)."""
    jm, tm = _tiny_models(moe)
    ja, ta = _rtn_algos(jm, tm, RTN)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    J.export_real_quant(ja, dj, fmt=fmt)
    P.export_real_quant(ta, dp, fmt=fmt)
    _dirs_equal(dj, dp)
    names = _read(os.path.join(dp, "quant_model.safetensors"))
    if moe is not None:
        assert "blocks.0.mlp.gate.experts.7" + (
            ".qweight" if fmt in ("autoawq",) else
            ".weight_packed" if fmt in ("vllm", "sgl") else
            ".qweight_packed") in names


@pytest.mark.parametrize("weight", [
    {"bit": 8, "symmetric": True, "granularity": "per_channel"},
    {"bit": "e4m3", "symmetric": True, "granularity": "per_channel"},
    {"bit": 4, "symmetric": True, "granularity": "per_channel"}])
def test_other_widths_export_matches_jax(tmp_path, weight):
    """W8, e4m3 (F8_E4M3 codes) and symmetric W4 per channel (no zeros;
    AutoAWQ falls back to the native layout) in the vllm, autoawq and
    native layouts."""
    jm, tm = _tiny_models(seed=4)
    quant = dict(RTN, weight=weight)
    ja, ta = _rtn_algos(jm, tm, quant)
    for fmt in ("vllm", "autoawq", "native"):
        dj, dp = str(tmp_path / f"j{fmt}"), str(tmp_path / f"p{fmt}")
        J.export_real_quant(ja, dj, fmt=fmt)
        P.export_real_quant(ta, dp, fmt=fmt)
        _dirs_equal(dj, dp)


def test_ci_config_exports_through_both_pipelines(tiny_ckpt, text_dir,
                                                  tmp_path, monkeypatch):
    """The AWQ CI config with every save_* key, calibrated on a custom_txt
    directory through the toy tokenizer: both pipelines give the same
    fake-quant PPL and write the same files (names, dtypes, shapes; JSON),
    the trtllm engine's build_cmd.txt; the AWQ searches' float sums differ
    in order, so the scales agree within 1e-4 (fp16: one ulp) and the
    int32 words (8 codes each) and int codes in >= 99% of entries."""
    ckpt = tokenized_ckpt(tiny_ckpt, tmp_path, monkeypatch)
    outs, ppl = {}, {}
    for who, load, run in (("jax", j_load_config, j_run_pipeline),
                           ("port", load_config, run_pipeline)):
        cfg = text_calib_config(load, ckpt, text_dir)
        cfg.save.update(SAVE_KEYS)
        cfg.save["save_path"] = str(tmp_path / who)
        ppl[who] = run(cfg) if who == "jax" else run(cfg, device="cpu")
        outs[who] = str(tmp_path / who)
    assert sorted(ppl["port"]) == sorted(ppl["jax"]) == ["ppl_fake_quant"]
    assert abs(ppl["port"]["ppl_fake_quant"] - ppl["jax"]["ppl_fake_quant"]
               ) <= TOL_PPL * ppl["jax"]["ppl_fake_quant"]
    dj, dp = outs["jax"], outs["port"]
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp)) == sorted(
        [f"{f}_quant_model" for f in FORMATS] + ["trtllm_engine"])
    cmd = open(os.path.join(dp, "trtllm_engine", "build_cmd.txt")).read()
    assert cmd.startswith("trtllm-build --checkpoint_dir " + os.path.join(
        dp, "trtllm_quant_model"))
    for f in FORMATS:
        a = _read(os.path.join(dj, f"{f}_quant_model",
                               "quant_model.safetensors"))
        b = _read(os.path.join(dp, f"{f}_quant_model",
                               "quant_model.safetensors"))
        assert {k: v[:2] for k, v in a.items()} == \
            {k: v[:2] for k, v in b.items()}
        for k in a:
            x, y = _values(*a[k]), _values(*b[k])
            if x.dtype.kind == "f":
                # f32 within 1e-4; AutoAWQ's fp16 scales within one ulp
                rtol = 2.0 ** -10 if x.dtype == np.float16 else 1e-4
                np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-6,
                                           err_msg=f"{f} {k}")
            else:
                assert (x == y).mean() >= 0.99, (f, k, (x == y).mean())
        for cfg in ("quantization_config.json",):
            assert json.load(open(os.path.join(dj, f"{f}_quant_model",
                                               cfg))) == \
                json.load(open(os.path.join(dp, f"{f}_quant_model", cfg)))
