"""Carry weights from the JAX package into the port.

Inputs are numpy arrays (callers convert JAX arrays with ``np.asarray``),
so this module imports neither JAX nor the JAX package.  Two entry points:

- ``params_from_numpy``: a JAX parameter tree -> the port's tree;
- ``serving_weights_from_numpy``: a JAX ``ServingWeights`` (passed as its
  fields) -> the port's ``ServingWeights``, undoing the TPU-only layouts:
  the tiled codes (N/NT, gpp, NT, g) (``tile_packed``), the split pre-tiled
  scales (gpp, N/NT, 8, NT) (``tile_scales``), the combined scale slab
  (N/NT, 2*gpp*8, NT) (``tile_scales_combined``), and the s4 byte pairs
  (N/NT, NT, K/2) with their scales (N/NT, G, NT) (``pack_s4_pairs``,
  ``tile_scales_pairs``); for MoE blocks the stacked experts
  (``stacked_planes``: codes (E, N/NT, gpp, NT, g) with the combined slab
  (E, N/NT, 2*gpp*8, NT); the int8 ``stacked`` fallback), the bf16 router
  and its optional selection bias; the q/k norm gammas of ``qk_norm``; the
  bench's K-split ``planes_ks`` linear (codes (N/NT, 2, gpp/2, NT, g), one
  combined slab per half (N/NT, 2, 2*(gpp/2)*8, NT) in the half's group
  order; ``tile_packed_ksplit``, ``tile_scales_combined_ksplit``); the
  bench's masked linear (``BENCH_MASKED``: masked planes tiled as
  ``tile_packed``, pre-divided scales and zero corrections tiled as
  ``tile_scales``, f32 or bf16; layout ``masked``).

``s4_bytes_from_numpy`` reads #11's natural s4 bytes (N/NT, NT, K/2)
(``pack_s4_bytes``) and their (N/NT, NT, G) scales (``tile_scales_s4``).
``layer_state_from_numpy`` carries a calibration algorithm's searched
state (static qparams, GPTQ's groups and permutation, clip factors, act
qparams).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.arch import ArchSpec, MoESpec
from .ops.qlinear import QLinearParams
from .quant import QParams
from .serving.quantized_model import ServingWeights

# the entries of a serving block that are {"weight": array}, not linears
NORM_ENTRIES = ("ln1", "ln2", "q_norm", "k_norm", "mlp.router")


def tensor_from_numpy(a, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16, which torch cannot take: via float32 (exact)
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of arrays -> the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def untile_codes(codes: np.ndarray) -> np.ndarray:
    """(N/NT, gpp, NT, g) -> (N, K/8); inverse of ``tile_packed``."""
    nb, gpp, nt, g = codes.shape
    return codes.transpose(0, 2, 1, 3).reshape(nb * nt, gpp * g)


def untile_scales(sr: np.ndarray) -> np.ndarray:
    """(gpp, N/NT, 8, NT) -> (N, G); inverse of ``tile_scales``."""
    gpp, nb, eight, nt = sr.shape
    return sr.transpose(1, 3, 2, 0).reshape(nb * nt, eight * gpp)


def split_combined(slab: np.ndarray):
    """(N/NT, 2*gpp*8, NT) -> (s, zs), each (N, G); inverse of
    ``tile_scales_combined``."""
    nb, rows, nt = slab.shape
    gpp = rows // 16
    comb = slab.reshape(nb, 2, gpp, 8, nt)
    return (untile_scales(comb[:, 0].transpose(1, 0, 2, 3)),
            untile_scales(comb[:, 1].transpose(1, 0, 2, 3)))


def untile_codes_ksplit(codes: np.ndarray) -> np.ndarray:
    """(N/NT, 2, gpp/2, NT, g) -> (N, K/8); inverse of
    ``tile_packed_ksplit``: half h holds the word columns
    [h*K/16, (h+1)*K/16) of the planes."""
    return np.concatenate([untile_codes(codes[:, h])
                           for h in range(codes.shape[1])], axis=1)


def split_combined_ksplit(slab: np.ndarray):
    """(N/NT, 2, 2*(gpp/2)*8, NT) -> (s, zs), each (N, G) in natural group
    order; inverse of ``tile_scales_combined_ksplit``, whose half h holds
    the groups j*gpp + h*gpp/2 + gi in (j, gi) order."""
    nb, splits, rows, nt = slab.shape
    gpp2 = rows // 16
    gpp = gpp2 * splits
    s = np.empty((nb * nt, 8 * gpp), slab.dtype)
    zs = np.empty_like(s)
    for h in range(splits):
        idx = [j * gpp + h * gpp2 + gi for j in range(8)
               for gi in range(gpp2)]
        s[:, idx], zs[:, idx] = split_combined(slab[:, h])
    return s, zs


def untile_pairs(t: np.ndarray) -> np.ndarray:
    """(N/NT, G, NT) -> (N, G); inverse of ``tile_scales_pairs``."""
    nb, G, nt = t.shape
    return t.transpose(0, 2, 1).reshape(nb * nt, G)


def qlinear_from_numpy(codes, scales, zeros, bias, bits: int,
                       group_size: int, layout: str,
                       device: DeviceLike = None) -> QLinearParams:
    """One JAX ``QLinearParams`` (its fields as arrays) -> the port's.
    The layout decides how the arrays are read: a stacked slab is 4-D
    like the split tiled scales of a 2-D linear."""
    codes, scales = np.asarray(codes), np.asarray(scales)
    zeros = None if zeros is None else np.asarray(zeros)
    if layout == "stacked_planes" and bits == 4:
        parts = [split_combined(scales[e]) for e in range(codes.shape[0])]
        return QLinearParams(
            tensor_from_numpy(np.stack([untile_codes(c) for c in codes]),
                              device, torch.int32),
            tensor_from_numpy(np.stack([p[0] for p in parts]), device),
            tensor_from_numpy(np.stack([p[1] for p in parts]), device),
            None, group_size, "stacked_planes", True, 4)
    if layout == "stacked" and bits == 8:
        return QLinearParams(
            tensor_from_numpy(codes, device, torch.int8),
            tensor_from_numpy(scales, device, torch.float32), None, None, 0,
            "stacked", False, 8)
    if layout == "planes_ks" and bits == 4:
        s, zs = split_combined_ksplit(scales)
        return QLinearParams(
            tensor_from_numpy(untile_codes_ksplit(codes), device,
                              torch.int32),
            tensor_from_numpy(s, device), tensor_from_numpy(zs, device),
            None if bias is None else tensor_from_numpy(bias, device),
            group_size, "planes_ks", True)
    if layout == "masked" and bits == 4:
        return QLinearParams(
            tensor_from_numpy(untile_codes(codes), device, torch.int32),
            tensor_from_numpy(untile_scales(scales), device),
            tensor_from_numpy(untile_scales(zeros), device),
            None if bias is None else tensor_from_numpy(bias, device),
            group_size, "masked", True)
    if bits != 4 or layout not in ("planes", "s4"):
        raise ValueError(f"{bits}-bit {layout!r} linears are not ported")
    if layout == "s4":
        nb, nt, kh = codes.shape
        return QLinearParams(
            tensor_from_numpy(codes.reshape(nb * nt, kh), device),
            tensor_from_numpy(untile_pairs(scales), device),
            tensor_from_numpy(untile_pairs(zeros), device),
            None if bias is None else tensor_from_numpy(bias, device),
            group_size, "s4", True)
    wp = untile_codes(codes) if codes.ndim == 4 else codes
    if scales.ndim == 3:
        s, zs = split_combined(scales)
    elif scales.ndim == 4:
        s = untile_scales(scales)
        zs = untile_scales(zeros) if zeros is not None else np.zeros_like(s)
    else:
        # untiled f32 (N, G) scales with raw zero points
        s = scales.astype(np.float32)
        zs = (zeros.astype(np.float32) * s if zeros is not None
              else np.zeros_like(s))
    return QLinearParams(
        tensor_from_numpy(wp, device, torch.int32),
        tensor_from_numpy(s, device), tensor_from_numpy(zs, device),
        None if bias is None else tensor_from_numpy(bias, device),
        group_size, "planes", codes.ndim == 4)


def s4_bytes_from_numpy(codes, scales, zeros, device: DeviceLike = None):
    """#11's tiles -> (wb (N, K/2) int8, s (N, G), zs (N, G)): the natural
    s4 bytes (N/NT, NT, K/2) of ``pack_s4_bytes`` and the (N/NT, NT, G)
    scales and zero corrections of ``tile_scales_s4``, dtypes kept."""
    codes = np.asarray(codes)
    nb, nt, kh = codes.shape

    def flat(t):
        t = np.asarray(t)
        return tensor_from_numpy(t.reshape(nb * nt, t.shape[-1]), device)
    return (tensor_from_numpy(codes.reshape(nb * nt, kh), device,
                              torch.int8), flat(scales), flat(zeros))


def arch_from_fields(fields: Dict[str, Any],
                     dtype: torch.dtype = torch.bfloat16) -> ArchSpec:
    """The port's ArchSpec from a dict of the JAX ArchSpec's fields (only
    the fields the port has are read; ``moe`` as a dict of the MoESpec's
    fields, as ``dataclasses.asdict`` gives it).  MLA is refused."""
    if fields.get("mla") is not None:
        raise ValueError("MLA (arch.mla) is not ported")
    names = [f for f in ArchSpec.__dataclass_fields__ if f != "dtype"]
    kw = {k: fields[k] for k in names if k in fields}
    if isinstance(kw.get("moe"), dict):
        kw["moe"] = MoESpec(**kw["moe"])
    return ArchSpec(**kw, dtype=dtype)


def serving_weights_from_numpy(arch: ArchSpec, embed, norm: Dict[str, Any],
                               lm_head, lm_head_scale,
                               blocks, act_bits: int, fused_rms: bool = False,
                               device: DeviceLike = None) -> ServingWeights:
    """``blocks`` is a list of dicts: linear name (``attn.qkv`` and
    ``mlp.gateup`` for merged entries) -> dict with the JAX QLinearParams
    fields (codes, scales, zeros, bias, bits, group_size, layout);
    ``ln1``/``ln2``, ``q_norm``/``k_norm`` (``qk_norm``) and
    ``mlp.router`` -> {"weight": array};
    ``mlp.router_bias`` -> array.  ``fused_rms`` is the JAX
    field; a fused build with the combined scale slab is refused (JAX
    runs no fused linear on it, as it has no separate zeros)."""
    out_blocks = []
    for entry in blocks:
        e: Dict[str, Any] = {}
        for name, v in entry.items():
            if name in NORM_ENTRIES:
                e[name] = {k: tensor_from_numpy(a, device)
                           for k, a in v.items()}
            elif name == "mlp.router_bias":
                e[name] = tensor_from_numpy(v, device)
            else:
                if fused_rms and v["zeros"] is None:
                    raise ValueError(f"{name}: fused_rms weights without "
                                     f"zeros are not ported")
                e[name] = qlinear_from_numpy(device=device, **v)
        out_blocks.append(e)
    return ServingWeights(
        arch=arch,
        embed=tensor_from_numpy(embed, device, torch.bfloat16),
        norm={k: tensor_from_numpy(a, device) for k, a in norm.items()},
        lm_head=tensor_from_numpy(lm_head, device),
        lm_head_scale=tensor_from_numpy(lm_head_scale, device),
        blocks=out_blocks,
        act_bits=act_bits,
        fused_rms=fused_rms,
    )


def layer_state_from_numpy(layer_state, device: DeviceLike = None):
    """A JAX algorithm's searched state (its ``layer_state``: a list of
    {linear name: state}, the arrays as numpy) -> the port's: the static
    ``qparams`` and ``act_qparams`` (a (scales, zeros) tuple) as the
    port's ``QParams``, GPTQ's ``gptq`` entry (scales,
    zeros, perm, group_size, n_out), the clip factors
    (``upbound_factor``, ``lowbound_factor``), ``dim_ic``.  Assign it to
    an algorithm's ``layer_state`` to deploy the JAX search through the
    port's ``w_qdq``."""
    def conv(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, tuple):  # QParams, a named tuple in JAX too
            return QParams(*(conv(x) for x in v))
        return tensor_from_numpy(v, device)

    return [conv(dict(block)) for block in layer_state]
