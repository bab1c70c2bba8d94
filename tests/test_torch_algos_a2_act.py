"""Port parity: the quantizer core's mixed configurations through
``run_pipeline`` in the JAX package and the port on the same tiny
checkpoint (CPU, f32): mixed bits (``quant.w_1``/``w_2`` by layer name)
with ignored layers (a block, a layer name, a per-instance name), W48 with
dynamic per-token act quant inside the attention (``quant_attn``,
``quant_softmax``), and AWQ's v2 clip (learnable clip factors) in a W4A8
config; and the GPTQ CI config by the port's command line on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from test_torch_algos_a2 import W4, W8, run_both, tiny_ckpt  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

ACT8 = {"bit": 8, "symmetric": True, "granularity": "per_token"}

CASES = {
    "mix_bits_ignored": {
        "quant": {"method": "RTN", "weight": W4, "w_1": W4,
                  "w_2": dict(W8, layer_names=["o_proj", "mlp.down"])},
        "ignored_layers": {
            "block_ids": [0], "layer_names": ["k_proj"],
            "speical_names": ["model.layers.1.mlp.gate_proj"]}},
    "w48_act_attn": {
        "quant": {"method": "RTN",
                  "weight": {"bit": 48, "w_1": W4, "w_2": W8},
                  "act": dict(ACT8, quant_attn=True, quant_softmax=True)}},
    "awq_clip_v2_w4a8": {
        "quant": {"method": "Awq", "weight": W4, "act": ACT8,
                  "special": {"trans": True, "trans_version": "v2",
                              "weight_clip": True, "clip_version": "v2",
                              "clip_sym": False}}},
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(tiny_ckpt, case):  # noqa: F811
    algo = run_both(tiny_ckpt, case, CASES)
    if case == "mix_bits_ignored":
        assert algo.is_ignored(0, "mlp.up") and algo.is_ignored(1, "attn.k")
        assert algo.is_ignored(1, "mlp.gate")
        assert not algo.is_ignored(1, "mlp.up")
        assert algo.wspec_for(1, "mlp.down").bit == 8
        assert algo.wspec_for(1, "mlp.up").bit == 4
    if case == "awq_clip_v2_w4a8":
        st = algo.layer_state[0]["mlp.down"]
        assert st["upbound_factor"].shape == st["lowbound_factor"].shape


def test_gptq_ci_config_command_line_on_the_cpu(  # noqa: F811
        tiny_ckpt, tmp_path):
    cfg = yaml.safe_load((ROOT / "configs" / "ci" /
                          "gptq_w_only_tiny_synthetic.yml").read_text())
    cfg["model"]["path"] = tiny_ckpt
    cfg["save"]["save_path"] = str(tmp_path / "save")
    path = tmp_path / "gptq.yml"
    path.write_text(yaml.safe_dump(cfg))
    r = subprocess.run(
        [sys.executable, "-m", "lightcompress_tpu_torch", "--config",
         str(path), "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    assert [x.split()[1] for x in lines] == ["ppl_fake_quant"]
    assert float(lines[0].split()[-1]) > 0

