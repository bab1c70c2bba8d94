"""Shared set-up of the port's A8 parity tests (``test_torch_quarot.py``,
``test_torch_kvquant.py``, ``test_torch_algos_a8.py``): one tiny Llama
checkpoint (hidden 128, intermediate 384 = 2^5 * 12, so QuaRot's online
down rotation takes a Paley factor; 4 heads of 32, 2 KV heads), loaded by
both packages in f32, the same calibration batches for both, and a method
config's ``quant`` section put on that model with synthetic calibration
and eval data, the way ``configs/ci/gptq_w_only_tiny_synthetic.yml`` is."""

from pathlib import Path

import numpy as np
import torch
import yaml

import jax.numpy as jnp

import lightcompress_tpu.compression  # noqa: F401  (registers the algos)
from helpers import make_tiny_hf_llama
from lightcompress_tpu.config import DotDict as JDotDict
from lightcompress_tpu.models.hf_loader import load_model as j_load_model
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu.registry import ALGO_REGISTRY as J_ALGOS
from lightcompress_tpu_torch.config import DotDict
from lightcompress_tpu_torch.models.hf_loader import load_model
from lightcompress_tpu_torch.pipeline import run_pipeline
from lightcompress_tpu_torch.registry import ALGO_REGISTRY

ROOT = Path(__file__).resolve().parents[1]
METHODS = ROOT / "configs" / "methods"
TINY = dict(vocab=256, hidden=128, inter=384, layers=2, heads=4, kv_heads=2)


def make_ckpt(tmp_path_factory) -> str:
    return make_tiny_hf_llama(str(tmp_path_factory.mktemp("a8")), **TINY)[0]


def load_both(ckpt):
    return (j_load_model(ckpt, dtype=jnp.float32, with_tokenizer=False),
            load_model(ckpt, dtype=torch.float32, device="cpu"))


def calib_ids(n=4, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab"], (1, seq)).astype(np.int32)
            for _ in range(n)]


def run_algo_both(ckpt, quant: dict, config=None, ids=None):
    """The algorithm ``quant['method']`` calibrated in both packages on the
    same batches: (jax model, jax algo, port model, port algo)."""
    jm, tm = load_both(ckpt)
    ids = ids or calib_ids()
    jalgo = J_ALGOS[quant["method"]](
        jm, JDotDict(quant),
        jm.collect_first_block_input([jnp.asarray(i) for i in ids]), None,
        JDotDict(config or {}))
    jalgo.run_block_loop()
    talgo = ALGO_REGISTRY[quant["method"]](
        tm, DotDict(quant),
        tm.collect_first_block_input([torch.from_numpy(i) for i in ids]),
        None, DotDict(config or {}))
    talgo.run_block_loop()
    return jm, jalgo, tm, talgo


def method_quant(name: str) -> dict:
    return yaml.safe_load((METHODS / f"{name}.yml").read_text())["quant"]


def pipeline_config(ckpt, quant: dict, evals=None, seed=0) -> dict:
    """``quant`` on the tiny model with synthetic calibration (4 x 16
    tokens) and eval data."""
    return {
        "base": {"seed": seed},
        "model": {"type": "Llama", "path": ckpt, "torch_dtype": "float32"},
        "calib": {"name": "synthetic", "n_samples": 4, "bs": 1,
                  "seq_len": 16, "preproc": "synthetic_random",
                  "seed": seed},
        "eval": evals or {"eval_pos": ["fake_quant"], "name": "synthetic",
                          "seq_len": 16, "bs": 1, "n_tokens": 64},
        "quant": quant,
        "save": {"save_path": "/nonexistent/unused"},
    }


def run_both_pipelines(cfg: dict):
    """(JAX results, port results, port algo) of one config on the CPU."""
    want = j_run_pipeline(JDotDict(cfg))
    got, talgo = run_pipeline(DotDict(cfg), device="cpu", return_algo=True)
    return want, got, talgo


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
