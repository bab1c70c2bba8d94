"""The compression pipeline (port of lightcompress_tpu/pipeline.py):
load -> pretrain eval -> calibrate -> ``transformed`` eval -> ``fake_quant``
eval -> token consistency against a freshly loaded origin model.

    python -m lightcompress_tpu_torch --config x.yml [--device cpu]

runs on the card unless ``--device cpu`` asks for the CPU, and prints
``RESULT <name> = <value>`` per eval result.

Ported: the ``ppl`` and ``decode_ppl`` evals on ``synthetic`` data
(``n_tokens`` random ids from the eval ``seed``) and the token
consistency; ``save_trans`` and
``save_fake``; ``base.profile_out``, the JSON of the run's phase timer
(``utils.profiling.PhaseTimer``: ``load_model``, ``eval/<pos>``,
``calib_data``, ``block_loop/<method>`` and ``block_loop/<method>/block``,
each ``{count, total_s, mean_s}``, and ``__wall__``, as JAX's), and
``base.trace_dir``, a ``torch.profiler`` Chrome trace of the block loop
(``utils.profiling.device_trace``); the real-quant exports of the
``save_*`` keys (``export.run_exports``: vllm, sgl, lightllm, autoawq,
mlcllm, lightx2v, native, trtllm) after ``save_fake``; calibration on text
(``data.dataset``: ``custom_txt`` files and the preprocs over a
tokenizer's ids).  The text eval sets and the ``load_from_disk`` datasets
(ROADMAP A4), the other eval types and the OpenCompass bridge (ROADMAP
A13) raise ``NotImplementedError`` when a config asks for them.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import compression  # noqa: F401  (registers the algorithms)
from .config import DotDict, get_compress_config, get_modalities, load_config
from .data import CalibDataset
from .device import DeviceLike, resolve_device
from .eval import (DecodePerplexityEval, PerplexityEval,
                   TokenConsistencyEval)
from .export import run_exports
from .models.hf_loader import load_model
from .registry import ALGO_REGISTRY
from .utils.profiling import PhaseTimer, device_trace

log = logging.getLogger("lightcompress_tpu_torch")

def _model_dtype(config: DotDict) -> torch.dtype:
    return (torch.bfloat16 if config.model.get("torch_dtype") == "bfloat16"
            else torch.float32)


def _load_testenc(model, ec, name) -> np.ndarray:
    if name != "synthetic":
        raise NotImplementedError(f"eval dataset {name!r}: ROADMAP A4 (the "
                                  f"text datasets and the tokenizer)")
    seq_len = ec.get("seq_len", 2048)
    rng = np.random.RandomState(ec.get("seed", 0))
    n_tok = ec.get("n_tokens", seq_len * 8)
    return rng.randint(0, model.arch.vocab_size,
                       size=(1, n_tok)).astype(np.int32)


def _build_one_eval(model, ec, name):
    etype = ec.get("type", "ppl")
    if etype == "decode_ppl":
        # the first num_eval_tokens + 1 ids, one token a step
        n = ec.get("num_eval_tokens", 256)
        return DecodePerplexityEval(_load_testenc(model, ec, name)[:, :n + 1],
                                    num_eval_tokens=n), etype
    if etype != "ppl":
        raise NotImplementedError(f"eval type {etype!r} is not ported: "
                                  f"ROADMAP A13")
    return PerplexityEval(
        _load_testenc(model, ec, name), seq_len=ec.get("seq_len", 2048),
        bs=ec.get("bs", 1),
        inference_per_block=ec.get("inference_per_block", False)), etype


def build_eval(model, config) -> Optional[Dict]:
    """The eval list of ``config.eval`` (one dict or a list; ``name`` one
    dataset or a list), its positions and the token-consistency eval."""
    ec_all = config.get("eval", None)
    if not ec_all:
        return None
    evals, positions, token_consist = [], set(), None
    for ec in (ec_all if isinstance(ec_all, list) else [ec_all]):
        if not ec.get("eval_pos"):
            continue
        pos = list(ec.get("eval_pos", []))
        positions.update(pos)
        names = ec.get("name", "wikitext2")
        names = [names] if isinstance(names, str) else list(names)
        for name in names:
            sub = DotDict(dict(ec))
            sub["name"] = name
            if len(names) > 1:
                sub["path"] = os.path.join(ec["path"], name)
            obj, etype = _build_one_eval(model, sub, name)
            evals.append((obj, etype, name, pos))
            if ec.get("eval_token_consist", False) and token_consist is None:
                token_consist = TokenConsistencyEval(
                    _load_testenc(model, sub, name),
                    seq_len=ec.get("seq_len", 2048), bs=ec.get("bs", 1))
    if not evals:
        return None
    return {"list": evals, "token_consist": token_consist,
            "positions": sorted(positions)}


def _run_evals(evals, model, pos: str, results: Dict[str, float]) -> None:
    multi = len(evals["list"]) > 1
    for obj, etype, name, poss in evals["list"]:
        if pos not in poss:
            continue
        res = obj.eval(model)
        key = f"{etype}_{name}_{pos}" if multi else f"{etype}_{pos}"
        results[key] = float(res)
        log.info("EVAL: %s on %s (%s) is %s", etype, name, pos, res)


def _check_unported(config: DotDict) -> None:
    if config.get("opencompass", None):
        raise NotImplementedError("the OpenCompass bridge is not ported: "
                                  "ROADMAP A13")


def _fill_timings(timings: Optional[Dict], timer: PhaseTimer, algo,
                  tc_s: float) -> None:
    """The ``timings`` of ``run_pipeline`` from the run's phases."""
    if timings is None:
        return
    for name in timer.report():
        if name == "load_model" or name.startswith("eval/"):
            timings["load" if name == "load_model" else name] = \
                timer.total(name)
    if algo is not None:
        # the calibration data and every block loop (one a modality)
        timings["calibration"] = sum(
            timer.total(n) for n in timer.report()
            if n == "calib_data" or n.count("/") == 1
            and n.startswith("block_loop/"))
        timings["blocks"] = list(algo.block_seconds)
    if tc_s:
        timings["token_consistency"] = tc_s


def run_pipeline(config: DotDict, device: DeviceLike = None,
                 timings: Optional[Dict[str, float]] = None,
                 return_algo: bool = False):
    """Run load -> calibrate -> evals on ``device`` (the card unless the
    caller asks for the CPU); returns the eval results, and with
    ``return_algo`` also the calibrated algorithm (its ``model`` holds the
    float transformed params).  ``timings``, if given, receives the
    seconds of each phase (``load``, ``eval/<pos>``, ``calibration``,
    ``token_consistency``) and ``blocks``, the seconds of each block.
    ``base.profile_out`` and ``base.trace_dir``: module docstring."""
    _check_unported(config)
    dev = resolve_device(device)
    timer = PhaseTimer(dev)
    base = config.get("base", {}) or {}
    dtype = _model_dtype(config)
    results: Dict[str, float] = {}
    tc_s = 0.0

    with timer.phase("load_model"):
        model = load_model(config.model.path, dtype=dtype, device=dev)
    evals = build_eval(model, config)
    if evals and "pretrain" in evals["positions"]:
        with timer.phase("eval/pretrain"):
            _run_evals(evals, model, "pretrain", results)

    algo = None
    for modality in get_modalities(config):
        ccfg = get_compress_config(config, modality)
        if not ccfg or "method" not in ccfg:
            continue
        with timer.phase("calib_data"):
            ds = CalibDataset(model.tokenizer, config.calib)
            calib_batches, padding_masks = ds.get_calib_dataset()
            first = model.collect_first_block_input(
                [torch.from_numpy(b) for b in calib_batches])
        algo = ALGO_REGISTRY[ccfg.method](model, ccfg, first, padding_masks,
                                          config)
        del first
        algo.timer = timer
        with device_trace(base.get("trace_dir"), dev):
            algo.run_block_loop()
        algo.input_batches = []  # the last block's outputs
    if algo is None:
        _fill_timings(timings, timer, algo, tc_s)
        return (results, None) if return_algo else results

    if evals and "transformed" in evals["positions"]:
        algo.deploy("transformed")
        with timer.phase("eval/transformed"):
            _run_evals(evals, model, "transformed", results)

    save_cfg = config.get("save", {}) or {}
    if save_cfg.get("save_trans", False):
        algo.deploy("transformed")
        algo.save_model(os.path.join(save_cfg["save_path"],
                                     "transformed_model"))

    for pos in ("fake_quant", "fake_quant_wo_kv"):
        if not (evals and pos in evals["positions"]):
            continue
        algo.deploy(pos)
        with timer.phase(f"eval/{pos}"):
            _run_evals(evals, model, pos, results)
        if evals["token_consist"] is not None:
            t0 = time.time()
            origin = load_model(config.model.path, dtype=dtype, device=dev,
                                with_tokenizer=False)
            results["token_consistency"] = evals["token_consist"].eval(
                model, origin)
            log.info("EVAL: token consistency = %.4f",
                     results["token_consistency"])
            del origin
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.synchronize(dev)
            tc_s += time.time() - t0
        algo.restore_float()

    if save_cfg.get("save_fake", False):
        algo.deploy("fake_quant")
        algo.save_model(os.path.join(save_cfg["save_path"],
                                     "fake_quant_model"))
        algo.restore_float()
    run_exports(algo, config)
    if base.get("profile_out"):
        timer.dump(base["profile_out"])
    timer.log_report()
    _fill_timings(timings, timer, algo, tc_s)
    return (results, algo) if return_algo else results


def _mkdirs(path: str) -> None:
    """Refuse to overwrite an existing save dir (the reference's only
    run-collision guard)."""
    if os.path.exists(path):
        raise FileExistsError(f"{path} existed before. Please delete it or "
                              f"pick another save_path")
    os.makedirs(path)


def main(argv=None) -> int:
    import argparse
    import random

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("lightcompress_tpu_torch")
    p.add_argument("--config", required=True)
    p.add_argument("--task_id", default="0")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU; the card by default")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    seed = cfg.get("base", {}).get("seed", 42)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    save_cfg = cfg.get("save", {}) or {}
    # a save flag that is on (the JAX check also counts ``save_path``
    # itself, so it makes the directory when nothing is saved)
    if any(str(k).startswith("save_") and k != "save_path" and v
           for k, v in save_cfg.items()) and save_cfg.get("save_path"):
        _mkdirs(save_cfg["save_path"])
    results = run_pipeline(cfg, device=args.device)
    for k, v in results.items():
        print(f"RESULT {k} = {v}")
    return 0
