"""Serving checkpoints (port of lightcompress_tpu/serving/checkpoint.py):
``export_serving`` writes a quantized model's serving weights and
``load_serving`` reads them back into ``ServingWeights`` without the float
checkpoint.  Files go through ``models/st_io.py`` (no ``safetensors``
package, no numpy dtype limits: e4m3 codes are read and written).

The format is the JAX package's: ``serving_model.safetensors`` with the
TPU tilings of its serving layouts and ``serving_config.json`` (``arch``:
every field of the JAX ``ArchSpec``; ``wbits``; ``blocks``: per entry its
kind, bit width, group size, float flag and layout).  A checkpoint written
by either package loads in the other:

* ``load_serving`` undoes the tilings through ``convert.py``'s reader
  (``planes``: codes (N/NT, gpp, NT, g),
  split scale tiles (gpp, N/NT, 8, NT) or the combined slab (N/NT,
  2*gpp*8, NT), or untiled (N, K/8) with f32 scales and raw zeros; ``s4``
  byte pairs (N/NT, NT, K/2) with (N/NT, G, NT) scales; ``rows`` of every
  width; ``stacked_planes`` per expert; ``stacked``), ``tiled`` inferred
  as JAX infers it (4-D planes codes);
* ``export_serving`` re-tiles the port's weights with JAX's tile choice
  (``pick_n_tile``, ``pick_n_tile_s4`` at their 4 MiB default) and the
  split scale layout of JAX's default ``scale_layout``, so that the same
  weights give the same tensor names, dtypes and bytes and the same JSON.

Neither file records ``act_bits`` or ``fused_rms``: ``load_serving`` leaves
their defaults, 16 and False, as JAX's loader does.
Embeddings and norms are stored f32 and the embedding comes back bf16; an
int8 head keeps its codes and scale, a bf16 head is stored f32.  JAX's own
``export_serving``/``load_serving`` fail on e4m3 codes (its
``safetensors.numpy`` has no ``float8_e4m3fn``; ROADMAP C, reference fault
4); the port reads and writes them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import torch

from ..convert import qlinear_from_arrays
from ..device import DeviceLike, resolve_device
from ..models import st_io
from ..models.arch import ArchSpec, MoESpec
from ..ops.qlinear import QLinearParams
from .quantized_model import ServingWeights

# the JAX ArchSpec's fields, in its order, with the defaults of those the
# port's ArchSpec lacks (a checkpoint must hold these defaults to load)
JAX_ARCH_FIELDS = (
    ("family", None), ("vocab_size", None), ("hidden_size", None),
    ("intermediate_size", None), ("num_layers", None), ("num_heads", None),
    ("num_kv_heads", None), ("head_dim", None),
    ("max_position_embeddings", None), ("rope_theta", None),
    ("rms_eps", None), ("attn_bias", None), ("mlp_bias", None),
    ("qk_norm", None), ("tie_word_embeddings", None), ("act_fn", None),
    ("do_layer_norm_before", True), ("norm_type", "default"), ("moe", None),
    ("mla", None), ("gemma_norm", False), ("sandwich_norms", False),
    ("attn_softcap", 0.0), ("final_softcap", 0.0), ("query_scale", 0.0),
    ("embed_scale", False), ("pos_offset", 2), ("alibi", False),
    ("use_rope", None), ("learned_pos", True), ("embed_norm", False),
    ("parallel_residual", False), ("parallel_two_norms", False),
    ("partial_rotary_factor", 1.0), ("rope_interleave", False),
    ("glm_rope", False), ("opt_bias", True), ("head_bias", False),
    ("residual_multiplier", 0.0), ("embed_multiplier", 0.0),
    ("logit_divisor", 0.0), ("rope_llama3", None), ("dtype", None))
_PORT_FIELDS = {f.name for f in dataclasses.fields(ArchSpec)}
MODEL_FILE = "serving_model.safetensors"
CONFIG_FILE = "serving_config.json"
TILE_MAX_BYTES = 4 << 20  # JAX's per-step DMA block (LCTPU_TILE_MAX_MB)


# ---------------------------------------------------------------------------
# the JAX serving tilings (their inverses are convert.py's readers)
# ---------------------------------------------------------------------------

def pick_n_tile(N: int, kp: int, group: int) -> int:
    """JAX's planes tile: the largest NT whose full-K block fits 4 MiB."""
    gpp = max(kp // group, 1)
    for nt in (4096, 2048, 1024, 512, 256, 128):
        if N % nt == 0 and gpp * nt * group * 4 <= TILE_MAX_BYTES:
            return nt
    return 128


def pick_n_tile_s4(N: int, K: int) -> int:
    """JAX's s4 tile: the largest NT whose (NT, K) s4 block fits 4 MiB."""
    for nt in (4096, 2048, 1024, 512, 256, 128):
        if N % nt == 0 and nt * K // 2 <= TILE_MAX_BYTES:
            return nt
    return 128


def tile_packed(wp: torch.Tensor, nt: int, group: int) -> torch.Tensor:
    """(N, K/8) -> (N/NT, gpp, NT, g)."""
    N, kp = wp.shape
    return wp.reshape(N // nt, nt, kp // group, group).permute(0, 2, 1, 3)


def tile_scales(s: torch.Tensor, nt: int) -> torch.Tensor:
    """(N, G) -> (gpp, N/NT, 8, NT), G = 8*gpp."""
    N, G = s.shape
    return s.reshape(N // nt, nt, 8, G // 8).permute(3, 0, 2, 1)


def tile_scales_combined(s: torch.Tensor, zs: torch.Tensor,
                         nt: int) -> torch.Tensor:
    """(N, G) x 2 -> one (N/NT, 2*gpp*8, NT) slab: scales, then zs."""
    def rows(t):
        r = tile_scales(t, nt)
        g, nb, _, n = r.shape
        return r.permute(1, 0, 2, 3).reshape(nb, g * 8, n)

    return torch.cat([rows(s), rows(zs)], dim=1)


def tile_pairs(s: torch.Tensor, nt: int) -> torch.Tensor:
    """(N, G) -> (N/NT, G, NT)."""
    N, G = s.shape
    return s.reshape(N // nt, nt, G).permute(0, 2, 1)


def raw_zeros(qp: QLinearParams) -> torch.Tensor:
    """The raw zero points z of an untiled planes linear, from its f32
    zs = z * s: z = round(zs / s), checked to give zs back exactly."""
    s, zs = qp.scales.float(), qp.zeros.float()
    z = torch.round(zs / s)
    if not torch.equal(z * s, zs):
        raise ValueError("untiled planes zero corrections are not integer "
                         "zero points times the scales")
    return z


# ---------------------------------------------------------------------------
# the JSON
# ---------------------------------------------------------------------------

def arch_to_json(arch: ArchSpec) -> Dict[str, Any]:
    """The JAX ``_arch_to_json`` of the same model: every JAX field, in
    its order."""
    d: Dict[str, Any] = {}
    for name, default in JAX_ARCH_FIELDS:
        if name == "dtype":
            d[name] = "bfloat16"
        elif name == "moe":
            d[name] = (None if arch.moe is None
                       else dataclasses.asdict(arch.moe))
        elif name == "rope_llama3":
            d[name] = (None if arch.rope_llama3 is None
                       else list(arch.rope_llama3))
        elif name in _PORT_FIELDS:
            d[name] = getattr(arch, name)
        else:
            d[name] = default
    return d


def arch_from_json(d: Dict[str, Any]) -> ArchSpec:
    """The port's ArchSpec of a checkpoint's ``arch`` (bf16, as JAX's
    loader takes it); a JAX field the port lacks must hold its default."""
    for name, default in JAX_ARCH_FIELDS:
        if name not in _PORT_FIELDS and name != "dtype" \
                and d.get(name, default) != default:
            raise NotImplementedError(
                f"a serving checkpoint with arch.{name}={d[name]!r} is not "
                f"ported (ROADMAP A9, A12)")
    kw = {k: v for k, v in d.items() if k in _PORT_FIELDS and k != "dtype"}
    if kw.get("moe"):
        kw["moe"] = MoESpec(**kw["moe"])
    if kw.get("rope_llama3") is not None:
        kw["rope_llama3"] = tuple(kw["rope_llama3"])
    return ArchSpec(**kw, dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# linears: the port's QLinearParams <-> JAX's stored arrays
# ---------------------------------------------------------------------------

def _jax_arrays(qp: QLinearParams) -> Dict[str, torch.Tensor]:
    """codes, scales and zeros as the JAX build holds them."""
    if qp.layout == "planes":
        if not qp.tiled:
            return {"codes": qp.codes, "scales": qp.scales.float(),
                    "zeros": raw_zeros(qp)}
        nt = pick_n_tile(qp.codes.shape[0], qp.codes.shape[1],
                         qp.group_size)
        return {"codes": tile_packed(qp.codes, nt, qp.group_size),
                "scales": tile_scales(qp.scales, nt),
                "zeros": tile_scales(qp.zeros, nt)}
    if qp.layout == "s4":
        N, kh = qp.codes.shape
        nt = pick_n_tile_s4(N, kh * 2)
        return {"codes": qp.codes.reshape(N // nt, nt, kh),
                "scales": tile_pairs(qp.scales, nt),
                "zeros": tile_pairs(qp.zeros, nt)}
    if qp.layout == "stacked_planes":
        E, N, kp = qp.codes.shape
        nt = pick_n_tile(N, kp, qp.group_size)
        return {"codes": torch.stack([tile_packed(c, nt, qp.group_size)
                                      for c in qp.codes]),
                "scales": torch.stack([
                    tile_scales_combined(s, zs, nt)
                    for s, zs in zip(qp.scales, qp.zeros)])}
    if qp.layout in ("rows", "stacked"):
        out = {"codes": qp.codes, "scales": qp.scales}
        if qp.zeros is not None:
            out["zeros"] = qp.zeros
        return out
    raise ValueError(f"a {qp.layout!r} linear has no serving checkpoint "
                     f"layout")


# ---------------------------------------------------------------------------
# export / load
# ---------------------------------------------------------------------------

def export_serving(sw: ServingWeights, save_dir: str) -> int:
    """Write ``sw`` under ``save_dir`` as the JAX ``export_serving`` writes
    the same weights; returns the bytes of the tensor file."""
    os.makedirs(save_dir, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {
        "embed": sw.embed.float(),
        "lm_head": (sw.lm_head if sw.lm_head_scale is not None
                    else sw.lm_head.float()),
    }
    if sw.lm_head_scale is not None:
        tensors["lm_head_scale"] = sw.lm_head_scale.float()
    for k, v in sw.norm.items():
        tensors[f"norm.{k}"] = v.float()
    meta: Dict[str, Any] = {"arch": arch_to_json(sw.arch), "wbits": sw.wbits,
                            "blocks": []}
    for i, entry in enumerate(sw.blocks):
        block_meta = {}
        for name, val in entry.items():
            base = f"blocks.{i}.{name}"
            if isinstance(val, QLinearParams):
                for k, a in _jax_arrays(val).items():
                    tensors[f"{base}.{k}"] = a
                if val.bias is not None:
                    tensors[base + ".bias"] = val.bias.float()
                block_meta[name] = {
                    "kind": "qlinear", "bits": val.bits,
                    "group_size": val.group_size,
                    "is_float": val.is_float, "layout": val.layout}
            elif isinstance(val, dict):
                for k, v in val.items():
                    tensors[f"{base}.{k}"] = v.float()
                block_meta[name] = {"kind": "params",
                                    "keys": list(val.keys())}
            else:
                # JAX's writer fails here too (it calls .items() on it)
                raise NotImplementedError(
                    f"{base}: a bare array entry (the router bias) has no "
                    f"serving checkpoint form in either package")
        meta["blocks"].append(block_meta)
    n = st_io.write(os.path.join(save_dir, MODEL_FILE), tensors)
    with open(os.path.join(save_dir, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return n


def load_serving(save_dir: str, device: DeviceLike = None) -> ServingWeights:
    """A serving checkpoint (written by either package) on ``device`` (the
    card unless the caller asks for the CPU), at JAX's loader defaults
    (``act_bits`` 16, no fused decode linears): a caller serving at W4A8
    or fused sets those fields itself (``dataclasses.replace``)."""
    dev = resolve_device(device)
    with open(os.path.join(save_dir, CONFIG_FILE)) as f:
        meta = json.load(f)
    sf = st_io.SafetensorsFile(os.path.join(save_dir, MODEL_FILE))
    try:
        def get(key, dtype=None):
            return sf.get(key, dev, dtype)

        keys = set(sf.keys())
        if "embed_pos" in keys:
            raise NotImplementedError("learned position embeddings (the "
                                      "opt family) are not ported: A12")
        blocks = []
        for i, block_meta in enumerate(meta["blocks"]):
            entry: Dict[str, Any] = {}
            for name, m in block_meta.items():
                base = f"blocks.{i}.{name}"
                if m["kind"] == "qlinear":
                    t = {k: get(f"{base}.{k}")
                         for k in ("codes", "scales", "zeros")
                         if f"{base}.{k}" in keys}
                    bias = (get(base + ".bias", torch.bfloat16)
                            if base + ".bias" in keys else None)
                    entry[name] = qlinear_from_arrays(t, m, bias)
                else:
                    entry[name] = {k: get(f"{base}.{k}") for k in m["keys"]}
            blocks.append(entry)
        head_scale = (get("lm_head_scale") if "lm_head_scale" in keys
                      else None)
        return ServingWeights(
            arch=arch_from_json(meta["arch"]),
            embed=get("embed", torch.bfloat16),
            norm={k.split(".", 1)[1]: get(k) for k in sorted(keys)
                  if k.startswith("norm.")},
            lm_head=(get("lm_head") if head_scale is not None
                     else get("lm_head", torch.bfloat16)),
            lm_head_scale=head_scale,
            blocks=blocks,
            act_bits=16,
            fused_rms=False,
            wbits=meta["wbits"])
    finally:
        sf.close()
