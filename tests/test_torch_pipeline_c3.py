"""Port parity: the three config keys of ROADMAP C3 on the AWQ CI config
(``configs/ci/awq_w4a16_tiny_synthetic.yml`` with the v2 clip) in the JAX
package and the port on the same tiny checkpoint (CPU):
``quant.special.save_clip``/``clip_path`` (``clips.pkl``, JAX's keys and
nesting, numpy factors), ``base.profile_out`` (the phase timer's JSON,
JAX's phase names and fields) and ``base.trace_dir`` (the port's
``torch.profiler`` Chrome trace of the block loop)."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from helpers import make_tiny_hf_llama
from lightcompress_tpu.config import load_config as j_load_config
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu.utils import profiling as j_profiling
from lightcompress_tpu_torch.config import load_config
from lightcompress_tpu_torch.pipeline import run_pipeline
from lightcompress_tpu_torch.utils.profiling import PhaseTimer, device_trace
from test_torch_serving import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CI = ROOT / "configs" / "ci" / "awq_w4a16_tiny_synthetic.yml"
# the clip factors (logits of the clip ratios, up to 13.8 at the clamp's
# 1 - 1e-6, where an f32 ulp is 9.5e-7) within 1e-6 relative, as the
# learnable range's tolerance (ROADMAP C: sigmoid and logit differ by an
# ulp between the frameworks)
TOL_CLIP = 1e-6


def _config(load, ckpt, out: Path, clip_version="v2", trace=True):
    cfg = load(str(CI))
    cfg.model.path = ckpt
    cfg.quant.special["clip_version"] = clip_version
    cfg.quant.special["save_clip"] = True
    cfg.quant.special["clip_path"] = str(out / "clips")
    cfg.base["profile_out"] = str(out / "profile.json")
    cfg["eval"]["eval_pos"] = ["pretrain", "fake_quant"]
    cfg["eval"]["eval_token_consist"] = False
    if trace:
        cfg.base["trace_dir"] = str(out / "trace")
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")))[0]
    jout, tout = (tmp_path_factory.mktemp(n) for n in ("jax", "port"))
    # JAX's timer is its module's: a fresh one holds this run alone
    j_profiling.timer.__init__()
    want = j_run_pipeline(_config(j_load_config, ckpt, jout, trace=False))
    got = run_pipeline(_config(load_config, ckpt, tout), device="cpu")
    return ckpt, (want, jout), (got, tout)


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_clips_pkl_matches_jax(runs):
    """Both pipelines write ``<clip_path>/clips.pkl``: {block: {"<linear>.
    upbound_factor" | ".lowbound_factor": numpy factors}} for every linear
    but q and k, the factors within TOL_CLIP; the PPLs as the pipeline
    test holds them (1e-4)."""
    _, (want, jout), (got, tout) = runs
    jc, tc = _load(jout / "clips" / "clips.pkl"), _load(
        tout / "clips" / "clips.pkl")
    assert sorted(tc) == sorted(jc) == [0, 1]
    for b in jc:
        assert sorted(tc[b]) == sorted(jc[b])
        assert {k.rsplit(".", 1)[0] for k in jc[b]} == {
            "attn.v", "attn.o", "mlp.gate", "mlp.up", "mlp.down"}
        for k, a in jc[b].items():
            t = tc[b][k]
            assert isinstance(t, np.ndarray) and t.dtype == np.float32
            assert t.shape == np.asarray(a).shape, k
            np.testing.assert_allclose(t, np.asarray(a), rtol=TOL_CLIP,
                                       atol=TOL_CLIP, err_msg=k)
    for k, v in want.items():
        if k.startswith("ppl_"):
            assert abs(got[k] - v) <= 1e-4 * v, (k, got[k], v)


def test_profile_out_matches_jax(runs):
    """``base.profile_out``: the same phase names (``load_model``,
    ``eval/<pos>``, ``calib_data``, ``block_loop/Awq`` and its ``block``,
    ``__wall__``), each with ``count``, ``total_s`` and ``mean_s``, and the
    same counts."""
    _, (_, jout), (_, tout) = runs
    jp = json.loads((jout / "profile.json").read_text())
    tp = json.loads((tout / "profile.json").read_text())
    assert sorted(tp) == sorted(jp)
    assert set(tp) == {"load_model", "calib_data", "block_loop/Awq",
                       "block_loop/Awq/block", "eval/pretrain",
                       "eval/fake_quant", "__wall__"}
    for name, rec in tp.items():
        assert sorted(rec) == ["count", "mean_s", "total_s"]
        assert rec["count"] == jp[name]["count"], name
        assert rec["total_s"] >= 0
    assert tp["block_loop/Awq/block"]["count"] == 2
    assert tp["__wall__"]["total_s"] >= tp["block_loop/Awq"]["total_s"]


def test_trace_dir_writes_a_chrome_trace(runs):
    """``base.trace_dir``: one Chrome trace of the block loop (CPU
    activity on the CPU) that parses and holds the loop's torch ops."""
    _, _, (_, tout) = runs
    files = list((tout / "trace").glob("block_loop.*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_without_the_keys_nothing_is_written(runs, tmp_path):
    """No ``trace_dir``: no trace; a v1 clip records no factors, so
    ``save_clip`` writes no ``clips.pkl`` (as JAX's ``save_artifacts``
    skips an empty dict); ``device_trace`` of a falsy directory and a
    ``PhaseTimer`` without a dump write nothing."""
    ckpt = runs[0]
    cfg = _config(load_config, ckpt, tmp_path, clip_version="v1",
                  trace=False)
    cfg["eval"]["eval_pos"] = []
    del cfg.base["profile_out"]
    run_pipeline(cfg, device="cpu")
    for d in (None, ""):
        with device_trace(d):
            timer = PhaseTimer()
            with timer.phase("x"):
                pass
    assert timer.report()["x"]["count"] == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == []
