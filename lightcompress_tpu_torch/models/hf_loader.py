"""Hugging Face checkpoint I/O (port of the dense llama path of
lightcompress_tpu/models/hf_loader.py): a model directory (``config.json``
and ``model.safetensors``, or shards with ``model.safetensors.index.json``)
into an adapter's parameter tree on a device, and back.

The tensors go through the port's own safetensors reader and writer
(``st_io``): BF16, F16 and F32, one tensor at a time from a mapped file
onto the requested device.  ``pytorch_model.bin`` checkpoints, the MoE
checkpoints (Mixtral, Qwen3-MoE; their config reader exists) and the other
families raise ``NotImplementedError`` naming ROADMAP A12.
``load_model(with_tokenizer=True)`` also reads the directory's tokenizer
through ``transformers.AutoTokenizer`` (local files only) where that
package is installed, and takes ``None`` where it is not or finds none, as
JAX's loader does; the synthetic calibration and eval data need none.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..registry import MODEL_REGISTRY
from . import arch as A
from . import st_io
from .hf_config import arch_from_hf_config

__all__ = ["arch_from_hf_config", "load_model", "load_params",
           "save_params", "ShardReader"]

# the adapter class of each model_type the loader reads
ADAPTERS = {"llama": "Llama", "mistral": "Mistral", "qwen2": "Qwen2",
            "qwen3": "Qwen3"}


def _llama_key_map(i: int) -> Dict[str, str]:
    p = f"model.layers.{i}."
    return {
        "ln1.weight": p + "input_layernorm.weight",
        "ln2.weight": p + "post_attention_layernorm.weight",
        "attn.q.weight": p + "self_attn.q_proj.weight",
        "attn.q.bias": p + "self_attn.q_proj.bias",
        "attn.k.weight": p + "self_attn.k_proj.weight",
        "attn.k.bias": p + "self_attn.k_proj.bias",
        "attn.v.weight": p + "self_attn.v_proj.weight",
        "attn.v.bias": p + "self_attn.v_proj.bias",
        "attn.o.weight": p + "self_attn.o_proj.weight",
        "attn.q_norm.weight": p + "self_attn.q_norm.weight",
        "attn.k_norm.weight": p + "self_attn.k_norm.weight",
        "mlp.gate.weight": p + "mlp.gate_proj.weight",
        "mlp.up.weight": p + "mlp.up_proj.weight",
        "mlp.down.weight": p + "mlp.down_proj.weight",
    }


def _top_key_map(arch: A.ArchSpec) -> Dict[str, str]:
    m = {"embed.weight": "model.embed_tokens.weight",
         "norm.weight": "model.norm.weight"}
    if not arch.tie_word_embeddings:
        m["lm_head.weight"] = "lm_head.weight"
    return m


class ShardReader:
    """The tensors of a model directory by HF key: a single
    ``model.safetensors`` or the shards an index names, each file mapped
    when first read."""

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self._files: Dict[str, st_io.SafetensorsFile] = {}
        idx = os.path.join(model_dir, "model.safetensors.index.json")
        single = os.path.join(model_dir, "model.safetensors")
        if os.path.exists(idx):
            with open(idx) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        elif os.path.exists(single):
            self.weight_map = {k: "model.safetensors"
                               for k in st_io.read_header(single)[0]}
        elif any(f.startswith("pytorch_model") and f.endswith(".bin")
                 for f in os.listdir(model_dir)):
            raise NotImplementedError(
                "pytorch_model.bin checkpoints are not read: ROADMAP A12")
        else:
            raise FileNotFoundError(f"no checkpoint found in {model_dir}")

    def get(self, key: str, device: torch.device,
            dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
        shard = self.weight_map.get(key)
        if shard is None:
            return None
        if shard not in self._files:
            self._files[shard] = st_io.SafetensorsFile(
                os.path.join(self.dir, shard))
        return self._files[shard].get(key, device, dtype)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def load_params(model_dir: str, arch: A.ArchSpec,
                device: DeviceLike = None) -> Dict:
    """The parameter tree of a dense llama-topology checkpoint on
    ``device``, floating tensors cast to ``arch.dtype``."""
    if arch.moe is not None:
        raise NotImplementedError(
            "MoE checkpoints (stacked experts) are not read: ROADMAP A12")
    dev = resolve_device(device)
    reader = ShardReader(model_dir)
    try:
        def fill(key_map: Dict[str, str]) -> Dict:
            out: Dict[str, Any] = {}
            for canon, hf_key in key_map.items():
                t = reader.get(hf_key, dev)
                if t is None:
                    continue
                if t.is_floating_point():
                    t = t.to(arch.dtype)
                parts = canon.split(".")
                node = out
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = t
            return out

        params = fill(_top_key_map(arch))
        params["blocks"] = [fill(_llama_key_map(i))
                            for i in range(arch.num_layers)]
    finally:
        reader.close()
    return params


# the files a transformers tokenizer is read from; a directory with none of
# them has no tokenizer, and the (slow) import of transformers is skipped
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "tokenizer.model", "vocab.json", "vocab.txt",
                   "spiece.model")


def load_tokenizer(model_dir: str):
    """The directory's ``transformers`` tokenizer, or None (no tokenizer
    files, no package, any failure), as JAX's loader takes it."""
    if not any(os.path.exists(os.path.join(model_dir, f))
               for f in TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_dir,
                                             local_files_only=True)
    except Exception:
        return None


def load_model(model_dir: str, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None, with_tokenizer: bool = True):
    """The registered adapter of an HF model directory, its params on
    ``device`` (the card unless the caller asks for the CPU), with its
    tokenizer (``load_tokenizer``) unless ``with_tokenizer`` is False."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    arch = arch_from_hf_config(cfg, dtype=dtype)
    mt = cfg.get("model_type", "llama")
    if mt not in ADAPTERS:
        raise NotImplementedError(f"loading model_type {mt!r} is not "
                                  f"ported: ROADMAP A12")
    params = load_params(model_dir, arch, device)
    tok = load_tokenizer(model_dir) if with_tokenizer else None
    return MODEL_REGISTRY[ADAPTERS[mt]](arch, params, tokenizer=tok,
                                        config=cfg)


def save_params(model, save_dir: str,
                hf_config: Optional[Dict] = None) -> int:
    """Write the params as one ``model.safetensors`` (+ ``config.json``),
    each tensor in its own dtype (the JAX writer widens to f32), one at a
    time.  Returns the bytes of the tensor file."""
    os.makedirs(save_dir, exist_ok=True)
    arch, params = model.arch, model.params
    tensors: Dict[str, torch.Tensor] = {}

    def put(key_map: Dict[str, str], tree: Dict) -> None:
        for canon, hf_key in key_map.items():
            node = tree
            for p in canon.split("."):
                if not isinstance(node, dict) or p not in node:
                    break
                node = node[p]
            else:
                tensors[hf_key] = node

    put(_top_key_map(arch), params)
    for i, bp in enumerate(params["blocks"]):
        put(_llama_key_map(i), bp)
    n = st_io.write(os.path.join(save_dir, "model.safetensors"), tensors,
                    metadata={"format": "pt"})
    if hf_config is not None:
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)
    return n
