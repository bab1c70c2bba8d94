"""Port parity: ``configs/ci/awq_w4a16_tiny_synthetic.yml`` end to end
(load, pretrain PPL, AWQ with the v1 clip, transformed and fake-quant PPL,
token consistency against a freshly loaded origin) in the JAX package and
the port on the same tiny checkpoint (CPU), and the port's command line
``python -m lightcompress_tpu_torch --config ... --device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from helpers import make_tiny_hf_llama
from lightcompress_tpu.config import load_config as j_load_config
from lightcompress_tpu.pipeline import run_pipeline as j_run_pipeline
from lightcompress_tpu_torch.config import load_config
from lightcompress_tpu_torch.pipeline import run_pipeline

ROOT = Path(__file__).resolve().parents[1]
CI = ROOT / "configs" / "ci" / "awq_w4a16_tiny_synthetic.yml"
# PPL of the same f32 model in the two frameworks: summation order
TOL_PPL = 1e-4


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")))[0]


@pytest.fixture(scope="module")
def results(tiny_ckpt):
    jcfg = j_load_config(str(CI))
    jcfg.model.path = tiny_ckpt
    tcfg = load_config(str(CI))
    tcfg.model.path = tiny_ckpt
    timings = {}
    got = run_pipeline(tcfg, device="cpu", timings=timings)
    return j_run_pipeline(jcfg), got, timings


@pytest.mark.parametrize("pos", ["pretrain", "transformed", "fake_quant"])
def test_ppl_matches_jax(results, pos):
    want, got, _ = results
    key = f"ppl_{pos}"
    assert abs(got[key] - want[key]) <= TOL_PPL * want[key], (got, want)


def test_token_consistency_matches_jax(results):
    want, got, timings = results
    assert 0.0 <= got["token_consistency"] <= 1.0
    assert got["token_consistency"] == want["token_consistency"]
    assert sorted(got) == sorted(want)
    assert len(timings["blocks"]) == 2 and timings["calibration"] > 0


def test_command_line_on_the_cpu(tiny_ckpt, tmp_path):
    cfg = yaml.safe_load(CI.read_text())
    cfg["model"]["path"] = tiny_ckpt
    cfg["save"]["save_path"] = str(tmp_path / "save")
    path = tmp_path / "ci.yml"
    path.write_text(yaml.safe_dump(cfg))
    r = subprocess.run(
        [sys.executable, "-m", "lightcompress_tpu_torch", "--config",
         str(path), "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    assert [x.split()[1] for x in lines] == [
        "ppl_pretrain", "ppl_transformed", "ppl_fake_quant",
        "token_consistency"]
    # no save flag is on: nothing is written
    assert not (tmp_path / "save").exists()


def test_unported_exports_raise(tiny_ckpt):
    """The real-quant exports are ported (tests/test_torch_export.py); the
    OpenCompass bridge and the text eval sets still raise."""
    cfg = load_config(str(CI))
    cfg.model.path = tiny_ckpt
    cfg["opencompass"] = {"cfg_path": "x.py"}
    with pytest.raises(NotImplementedError, match="A13"):
        run_pipeline(cfg, device="cpu")
    cfg = load_config(str(CI))
    cfg.model.path = tiny_ckpt
    cfg.eval["name"] = "wikitext2"
    with pytest.raises(NotImplementedError, match="A4"):
        run_pipeline(cfg, device="cpu")
