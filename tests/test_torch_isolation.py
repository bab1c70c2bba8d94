"""The port stands alone: it imports with JAX, ``triton``, the JAX package
and the packages the machine with the card lacks (``safetensors``,
``transformers``, ``datasets``, PyYAML) blocked, names none of the first
three in any import, and runs on the card unless asked for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lightcompress_tpu_torch
from lightcompress_tpu_torch import resolve_device
from lightcompress_tpu_torch.models import ArchSpec, Llama, init_params
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lightcompress_tpu_torch"
BLOCKED = ("jax", "jaxlib", "lightcompress_tpu", "triton", "safetensors",
           "transformers", "datasets", "yaml")

_BLOCKER = """
import importlib.abc, sys
BLOCKED = {blocked!r}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
for b in BLOCKED:
    sys.modules.pop(b, None)
import importlib
for mod in {modules!r}:
    importlib.import_module(mod)
print("imported", len({modules!r}))
"""


def _port_modules():
    mods = ["lightcompress_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG)], "lightcompress_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_imports_with_jax_blocked():
    mods = _port_modules() + ["chip_smoke"]
    for mod in ("ops.w4_matmul", "ops.qlinear", "ops.attention",
                "serving.engine", "serving.quantized_model", "convert",
                "pipeline", "models.hf_loader", "models.st_io",
                "compression.quantization.awq", "eval.ppl", "data.dataset",
                "ops.scaled_matmul", "serving.checkpoint", "export",
                "__main__", "ops.hadamard",
                "compression.quantization.quarot",
                "compression.quantization.kvquant",
                "compression.quantization.osplus",
                "compression.quantization.llmint8",
                "compression.quantization.quik",
                "compression.quantization.adadim",
                "compression.quantization.spqr",
                "compression.quantization.dgq"):
        assert f"lightcompress_tpu_torch.{mod}" in mods
    code = _BLOCKER.format(blocked=BLOCKED, modules=mods)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(mods)}" in r.stdout


def test_blocker_blocks_the_jax_package():
    code = _BLOCKER.format(blocked=BLOCKED, modules=["lightcompress_tpu"])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "blocked: lightcompress_tpu" in r.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|lightcompress_tpu|"
                     r"triton)\b(?!_)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    assert not _IMPORT.findall((ROOT / path).read_text())


def _tiny(device):
    arch = ArchSpec("llama", vocab_size=64, hidden_size=1024,
                    intermediate_size=1024, num_layers=1, num_heads=8,
                    num_kv_heads=2, head_dim=128)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return Llama(arch, init_params(gen, arch))


WSPEC = QuantSpec(bit=4, symmetric=False, granularity="per_group",
                  group_size=128)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model = _tiny("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving_weights(model, WSPEC)
    sw = build_serving_weights(model, WSPEC, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(sw, max_slots=1, max_len=32, prefill_buckets=(8,))


def test_runs_on_cpu_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    sw = build_serving_weights(_tiny("cpu"), WSPEC, act_bits=8, device="cpu")
    eng = LLMEngine(sw, max_slots=2, max_len=32, prefill_buckets=(8,),
                    device="cpu")
    out = eng.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=3))
    assert [len(o) for o in out] == [3, 3]
    assert lightcompress_tpu_torch.__name__ == "lightcompress_tpu_torch"
