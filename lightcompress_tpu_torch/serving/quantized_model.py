"""Serving weights: adapter params -> packed W4 serving weights (port of the
dense part of lightcompress_tpu/serving/quantized_model.py: RTN with the
``layout``, ``fused_rms`` and ``fuse_qkv`` options, the int8 per-channel
head, ``head_logits`` and ``apply_qlinear``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..device import DeviceLike, div, resolve_device
from ..models import arch as A
from ..models.base import resolve
from ..ops.qlinear import QLinearParams, qlinear_apply, quantize_linear
from ..quant import QuantSpec

# vocab rows per head matmul: bounds the f32 copy of the head codes that
# exact f32 logits need (8192 x 4096 x 4 B = 128 MiB at Llama-3-8B width)
HEAD_CHUNK = 8192


@dataclasses.dataclass
class ServingWeights:
    arch: A.ArchSpec
    embed: torch.Tensor  # bf16 (vocab, hidden)
    norm: Dict[str, torch.Tensor]
    lm_head: torch.Tensor  # int8 per-channel codes (vocab, hidden)
    lm_head_scale: torch.Tensor  # (vocab,) f32
    blocks: List[Dict[str, Any]]  # linear name -> QLinearParams; ln1/ln2
    act_bits: int = 16  # 16 = W4A16; 8 = W4A8 (per-token dynamic int8 acts)
    # True: the RMSNorm gammas are folded into the pre-norm linears'
    # weights (W' = W * gamma, before quantization) and the stored ln
    # weights are ones; the plain path stays exact and the decode step
    # takes the fused linears (#13, #14) where the engine allows
    fused_rms: bool = False


_LLAMA_NORMS = ("ln1", "ln2")
# the consumers of each RMSNorm, whose weights absorb its gamma
_LN1_LINEARS = ("attn.q", "attn.k", "attn.v")
_LN2_LINEARS = ("mlp.gate", "mlp.up")
# merged entries of fuse_qkv: name -> the linears concatenated along N
_FUSED = {"attn.qkv": ("attn.q", "attn.k", "attn.v"),
          "mlp.gateup": ("mlp.gate", "mlp.up")}


def build_serving_weights(model, wspec: QuantSpec, act_bits: int = 16,
                          layout: str = "planes", fused_rms: bool = False,
                          fuse_qkv: bool = False,
                          device: DeviceLike = None) -> ServingWeights:
    """RTN real-quant of every block linear to the W4 ``layout`` ("planes",
    or "s4" with the JAX fallback to planes where its shapes do not fit);
    the embedding stays bf16 and the head is int8 per channel.  The
    quantization runs on ``device`` and the weights stay there.

    ``fused_rms`` folds each RMSNorm gamma into its consumer linears in the
    weight's own dtype before quantization and stores ones as the ln
    weights.  ``fuse_qkv`` concatenates q/k/v into ``attn.qkv`` and
    gate/up into ``mlp.gateup`` along the output channels (exact: the
    quantization is per output row)."""
    dev = resolve_device(device)
    if wspec.bit != 4:
        raise ValueError("the ported serving path is W4")
    if act_bits not in (8, 16):
        raise ValueError("act_bits is 8 or 16")
    arch, params = model.arch, model.params
    blocks_out = []
    for idx in range(model.num_blocks):
        bp = params["blocks"][idx]
        gammas = {}
        if fused_rms:
            for ln, names in (("ln1", _LN1_LINEARS), ("ln2", _LN2_LINEARS)):
                gammas.update(dict.fromkeys(names, bp[ln]["weight"].to(dev)))
        pend: Dict[str, tuple] = {}
        for name in model.get_block_linear_names(idx):
            node = resolve(bp, name)
            w = node["weight"].to(dev)
            if name in gammas:
                w = w * gammas[name][None, :].to(w.dtype)
            bias = node.get("bias")
            pend[name] = (w, None if bias is None else bias.to(dev))
        if fuse_qkv:
            for merged, names in _FUSED.items():
                ws, bs = zip(*(pend.pop(n) for n in names))
                bias = None
                if any(b is not None for b in bs):
                    bias = torch.cat([
                        b if b is not None else w.new_zeros(w.shape[0])
                        for w, b in zip(ws, bs)])
                pend[merged] = (torch.cat(ws), bias)
        entry: Dict[str, Any] = {
            name: quantize_linear(w.float(), wspec, bias=bias, layout=layout)
            for name, (w, bias) in pend.items()}
        for ln in _LLAMA_NORMS:
            entry[ln] = {k: t.to(dev) for k, t in bp[ln].items()}
            if fused_rms:
                entry[ln]["weight"] = torch.ones_like(entry[ln]["weight"])
        blocks_out.append(entry)
    head_w = (params["embed"]["weight"] if arch.tie_word_embeddings
              else params["lm_head"]["weight"])
    hw = head_w.to(dev).float()
    head_scale = div(hw.abs().amax(dim=1).clamp_min(1e-6), 127.0)
    head_w = torch.round(hw / head_scale[:, None]).clamp(-127, 127).to(
        torch.int8)
    return ServingWeights(
        arch=arch,
        embed=params["embed"]["weight"].to(dev, torch.bfloat16),
        norm={k: t.to(dev) for k, t in params["norm"].items()},
        lm_head=head_w,
        lm_head_scale=head_scale,
        blocks=blocks_out,
        act_bits=act_bits,
        fused_rms=fused_rms,
    )


def head_logits(sw: ServingWeights, xl: torch.Tensor) -> torch.Tensor:
    """lm_head matmul: bf16-rounded activations times the int8 head codes
    as bf16 operands, f32 accumulation, f32 logits (..., vocab) scaled per
    vocab row.  Done in vocab chunks so the f32 operand copy stays small."""
    x = xl.to(torch.bfloat16).float()
    parts = []
    for v0 in range(0, sw.lm_head.shape[0], HEAD_CHUNK):
        w = sw.lm_head[v0:v0 + HEAD_CHUNK].to(torch.bfloat16).float()
        parts.append(torch.matmul(x, w.t()))
    return torch.cat(parts, dim=-1) * sw.lm_head_scale.float()


def apply_qlinear(entry: QLinearParams, x: torch.Tensor,
                  act_bits: int = 16) -> torch.Tensor:
    """A serving linear (W4, planes or s4)."""
    return qlinear_apply(x, entry, act_bits=act_bits)
