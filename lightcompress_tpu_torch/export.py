"""Real-quant checkpoint exporters (port of lightcompress_tpu/export.py).

Every block linear is quantized with its algorithm's searched qparams and
written as safetensors (``models/st_io.py``, no ``safetensors`` package)
with a quant-config JSON, in the layout of the backend that reads it:

* ``autoawq``: the AutoAWQ GEMM pack (``awq_gemm_pack``: transposed, 8
  nibbles an int32 along the output channels in the order
  [0, 2, 4, 6, 1, 3, 5, 7]; fp16 scales);
* ``vllm``/``sgl``: compressed-tensors names (``weight_packed``,
  ``weight_scale``, ``weight_zero_point``), nibbles in plain order;
* every other format (``native``, ``lightllm``, ``mlcllm``, ``lightx2v``,
  ``trtllm``): ``qweight_packed`` (4 bits) or ``qweight``, f32 ``scales``
  and ``zeros``.

Stacked MoE experts are written per expert (``.experts.<e>``).  The tensor
names, dtypes and bytes and the JSON are the JAX package's for the same
weights.  ``save_trtllm`` also runs ``trtllm-build`` where it is installed,
else writes the command to ``trtllm_engine/build_cmd.txt``, as JAX does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from .models import st_io
from .models.base import resolve
# unpack_int4 is part of this module's API, as in the JAX package
from .ops.w4_matmul import (pack_int4, pack_nibbles,  # noqa: F401
                            unpack_int4)
from .quant import QParams, real_quant_weight

FORMATS = (("save_vllm", "vllm"), ("save_sgl", "sgl"),
           ("save_lightllm", "lightllm"), ("save_autoawq", "autoawq"),
           ("save_mlcllm", "mlcllm"), ("save_lightx2v", "lightx2v"),
           ("save_native", "native"))

_AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # the AutoAWQ kernel's register order


def awq_gemm_pack(codes: torch.Tensor, scales: torch.Tensor,
                  zeros: torch.Tensor, bits: int = 4):
    """AutoAWQ GEMM layout: (qweight (ic, oc/8) int32, scales_t (G, oc)
    fp16, qzeros (G, oc/8) int32), 8 nibbles a word along oc in the order
    [0, 2, 4, 6, 1, 3, 5, 7]."""
    if bits != 4:
        raise ValueError("the AutoAWQ GEMM pack is 4-bit only")

    def pack_oc(u: torch.Tensor) -> torch.Tensor:
        rows, oc = u.shape
        if oc % 8:
            raise ValueError(f"oc {oc} is not a multiple of 8")
        u = u.to(torch.int32).reshape(rows, oc // 8, 8)
        return pack_nibbles(u[:, :, list(_AWQ_ORDER)])

    qweight = pack_oc(codes.t())
    qzeros = pack_oc(torch.round(zeros).to(torch.int32).t())
    return qweight, scales.t().to(torch.float16), qzeros


def _emit_linear(tensors: Dict[str, torch.Tensor], base: str, codes, scales,
                 zeros, spec, awq_layout: bool, ct_layout: bool) -> None:
    """One 2-D linear's tensors in the backend layout."""
    if awq_layout and zeros is not None and codes.dim() == 2:
        qw, sc, qz = awq_gemm_pack(codes, scales, zeros, spec.bit)
        tensors[base + ".qweight"] = qw
        tensors[base + ".scales"] = sc
        tensors[base + ".qzeros"] = qz
    elif ct_layout and spec.bit == 4 and codes.dim() == 2:
        tensors[base + ".weight_packed"] = pack_int4(codes)
        tensors[base + ".weight_scale"] = scales.float()
        if zeros is not None:
            tensors[base + ".weight_zero_point"] = zeros.float()
    else:
        if spec.bit == 4 and not spec.is_float:
            tensors[base + ".qweight_packed"] = pack_int4(codes)
        else:
            tensors[base + ".qweight"] = codes
        tensors[base + ".scales"] = scales.float()
        if zeros is not None:
            tensors[base + ".zeros"] = zeros.float()


def _qp_expert_slice(qp: Optional[QParams], E: int, e: int):
    """Expert e's qparams of qparams searched on a stacked (E, oc, ic)
    weight: grouped-view qparams lead with E*rows, so expert e owns rows
    [e*rows, (e+1)*rows)."""
    if qp is None:
        return None
    s = qp.scales
    if s.dim() == 0 or s.shape[0] % E != 0:
        return qp  # per tensor, or already per expert
    rows = s.shape[0] // E
    z = qp.zeros
    return type(qp)(
        s[e * rows:(e + 1) * rows],
        z[e * rows:(e + 1) * rows] if getattr(z, "dim", lambda: 0)() else z)


def _float_blocks(model):
    return getattr(model, "_fp_blocks", None) or model.params["blocks"]


def export_real_quant(algo, save_dir: str, fmt: str = "native") -> int:
    """Quantize every block linear with the algorithm's searched qparams
    (``layer_state[idx][name]["qparams"]``) and write
    ``quant_model.safetensors`` and ``quantization_config.json`` under
    ``save_dir``.  Returns the bytes of the tensor file."""
    os.makedirs(save_dir, exist_ok=True)
    model, spec = algo.model, algo.wspec
    awq_layout = fmt == "autoawq" and spec.bit == 4 and not spec.is_float
    ct_layout = fmt in ("vllm", "sgl") and not spec.is_float
    tensors: Dict[str, torch.Tensor] = {}
    blocks = _float_blocks(model)
    for idx in range(model.num_blocks):
        bp = blocks[idx]
        for name in model.get_block_linear_names(idx):
            node = resolve(bp, name)
            w = node["weight"].float()
            qp = algo.layer_state[idx].get(name, {}).get("qparams")
            bias = node.get("bias")
            if w.dim() == 3:
                # stacked experts: per-expert 2-D tensors, so that every
                # backend layout applies unchanged
                E = w.shape[0]
                for e in range(E):
                    ce, se, ze = real_quant_weight(
                        w[e], spec, qp=_qp_expert_slice(qp, E, e))
                    _emit_linear(tensors, f"blocks.{idx}.{name}.experts.{e}",
                                 ce, se, ze, spec, awq_layout, ct_layout)
            else:
                codes, scales, zeros = real_quant_weight(w, spec, qp=qp)
                _emit_linear(tensors, f"blocks.{idx}.{name}", codes, scales,
                             zeros, spec, awq_layout, ct_layout)
            if bias is not None:
                tensors[f"blocks.{idx}.{name}.bias"] = bias.float()
    n = st_io.write(os.path.join(save_dir, "quant_model.safetensors"),
                    tensors)
    with open(os.path.join(save_dir, "quantization_config.json"), "w") as f:
        json.dump(make_quant_config(algo, fmt), f, indent=2)
    return n


def make_quant_config(algo, fmt: str) -> Dict[str, Any]:
    """The backend's quant-config JSON: compressed-tensors
    ``config_groups`` (vllm, sgl), AutoAWQ's ``quantization_config``
    (autoawq), or the native schema."""
    spec = algo.wspec
    has_act = not algo.w_only and algo.aspec is not None
    if fmt in ("vllm", "sgl"):
        is_float = bool(spec.is_float)
        qt = "float" if is_float else "int"
        if is_float and has_act and algo.act_static:
            return {"activation_scheme": "static", "quant_method": "fp8",
                    "ignored_layers": []}
        if is_float and spec.granularity == "per_block":
            return {"activation_scheme": "dynamic", "fmt": "e4m3",
                    "quant_method": "fp8",
                    "weight_block_size": [spec.block_size, spec.block_size]}
        acts = None
        if has_act:
            acts = {
                "dynamic": not algo.act_static,
                "group_size": None,
                "num_bits": algo.aspec.bit if not algo.aspec.is_float else 8,
                "observer": "minmax",
                "observer_kwargs": {},
                "strategy": ("token"
                             if algo.aspec.granularity == "per_token"
                             else "tensor"),
                "symmetric": algo.aspec.symmetric,
                "type": qt,
            }
        packed = spec.bit == 4 and not is_float
        return {
            "config_groups": {
                "group_0": {
                    "targets": ["Linear"],
                    "input_activations": acts,
                    "weights": {
                        "dynamic": False,
                        "group_size": (spec.group_size
                                       if spec.granularity == "per_group"
                                       else None),
                        "num_bits": 8 if is_float else spec.bit,
                        "observer": "minmax",
                        "observer_kwargs": {},
                        "strategy": ("group"
                                     if spec.granularity == "per_group"
                                     else "channel"),
                        "symmetric": spec.symmetric,
                        "type": qt,
                    },
                }
            },
            "format": "pack-quantized" if packed else f"{qt}-quantized",
            "ignore": [],
            "quant_method": "compressed-tensors",
        }
    if fmt == "autoawq":
        return {
            "bits": spec.bit,
            "group_size": (spec.group_size
                           if spec.granularity == "per_group" else -1),
            "modules_to_not_convert": None,
            "quant_method": "awq",
            "version": "gemm",
            "zero_point": not spec.symmetric,
        }
    cfg: Dict[str, Any] = {
        "format": fmt,
        "quant_method": algo.quant_config.get("method", "RTN"),
        "weight": {
            "bits": spec.bit,
            "symmetric": spec.symmetric,
            "granularity": spec.granularity,
            "group_size": spec.group_size or None,
        },
    }
    if has_act:
        cfg["act"] = {
            "bits": algo.aspec.bit,
            "symmetric": algo.aspec.symmetric,
            "granularity": algo.aspec.granularity,
            "static": algo.act_static,
        }
    return cfg


def cvt_trtllm_engine(quant_dir: str, engine_dir: str,
                      cfg: Optional[Dict[str, Any]] = None) -> str:
    """The TensorRT-LLM engine build: ``trtllm-build`` where it is
    installed, else the command (and ``cfg``) in ``build_cmd.txt``."""
    import shutil
    import subprocess

    cfg = cfg or {"tp_size": 1, "pp_size": 1}
    os.makedirs(engine_dir, exist_ok=True)
    cmd = ["trtllm-build", "--checkpoint_dir", quant_dir,
           "--output_dir", engine_dir, "--gemm_plugin", "float16"]
    if shutil.which("trtllm-build") is not None:
        subprocess.run(cmd, check=True)
        return engine_dir
    with open(os.path.join(engine_dir, "build_cmd.txt"), "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.write(json.dumps(cfg) + "\n")
    return engine_dir


def run_exports(algo, config) -> Dict[str, int]:
    """Every export the config's ``save`` section asks for, each under
    ``<save_path>/<fmt>_quant_model``; returns the bytes written by
    format."""
    save_cfg = config.get("save", {}) or {}
    written: Dict[str, int] = {}
    for key, fmt in FORMATS:
        if save_cfg.get(key, False):
            out = os.path.join(save_cfg["save_path"], f"{fmt}_quant_model")
            written[fmt] = export_real_quant(algo, out, fmt=fmt)
    if save_cfg.get("save_trtllm", False):
        out = os.path.join(save_cfg["save_path"], "trtllm_quant_model")
        written["trtllm"] = export_real_quant(algo, out, fmt="trtllm")
        cvt_trtllm_engine(
            out, os.path.join(save_cfg["save_path"], "trtllm_engine"),
            save_cfg.get("trtllm_cfg"))
    return written
