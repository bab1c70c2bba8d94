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
  ``tile_scales``, f32 or bf16; layout ``masked``); the ``rows`` of every
  width and float format.

``qlinear_from_arrays`` is the one reader of these layouts, on tensors:
``qlinear_from_numpy`` hands it arrays, ``serving/checkpoint.py``'s
``load_serving`` a checkpoint's tensors.

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
from .ops.qlinear import QLinearParams, reference_fault
from .quant import QParams
from .serving.quantized_model import ServingWeights

# the entries of a serving block that are {"weight": array}, not linears
NORM_ENTRIES = ("ln1", "ln2", "q_norm", "k_norm", "mlp.router")
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}


def tensor_from_numpy(a, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16, which torch cannot take: via float32 (exact)
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype.name in _FP8:
        # ml_dtypes e4m3/e5m2 codes: their bytes, reinterpreted
        t = torch.from_numpy(a.view(np.uint8)).view(_FP8[a.dtype.name])
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


def untile_codes(codes: torch.Tensor) -> torch.Tensor:
    """(N/NT, gpp, NT, g) -> (N, K/8); inverse of ``tile_packed``."""
    nb, gpp, nt, g = codes.shape
    return codes.permute(0, 2, 1, 3).reshape(nb * nt, gpp * g)


def untile_scales(sr: torch.Tensor) -> torch.Tensor:
    """(gpp, N/NT, 8, NT) -> (N, G); inverse of ``tile_scales``."""
    gpp, nb, eight, nt = sr.shape
    return sr.permute(1, 3, 2, 0).reshape(nb * nt, eight * gpp)


def split_combined(slab: torch.Tensor):
    """(N/NT, 2*gpp*8, NT) -> (s, zs), each (N, G); inverse of
    ``tile_scales_combined``."""
    nb, rows, nt = slab.shape
    comb = slab.reshape(nb, 2, rows // 16, 8, nt)
    return (untile_scales(comb[:, 0].permute(1, 0, 2, 3)),
            untile_scales(comb[:, 1].permute(1, 0, 2, 3)))


def untile_codes_ksplit(codes: torch.Tensor) -> torch.Tensor:
    """(N/NT, 2, gpp/2, NT, g) -> (N, K/8); inverse of
    ``tile_packed_ksplit``: half h holds the word columns
    [h*K/16, (h+1)*K/16) of the planes."""
    return torch.cat([untile_codes(codes[:, h])
                      for h in range(codes.shape[1])], dim=1)


def split_combined_ksplit(slab: torch.Tensor):
    """(N/NT, 2, 2*(gpp/2)*8, NT) -> (s, zs), each (N, G) in natural group
    order; inverse of ``tile_scales_combined_ksplit``, whose half h holds
    the groups j*gpp + h*gpp/2 + gi in (j, gi) order."""
    nb, splits, rows, nt = slab.shape
    gpp2 = rows // 16
    gpp = gpp2 * splits
    s = slab.new_empty((nb * nt, 8 * gpp))
    zs = torch.empty_like(s)
    for h in range(splits):
        idx = [j * gpp + h * gpp2 + gi for j in range(8)
               for gi in range(gpp2)]
        s[:, idx], zs[:, idx] = split_combined(slab[:, h])
    return s, zs


def untile_pairs(t: torch.Tensor) -> torch.Tensor:
    """(N/NT, G, NT) -> (N, G); inverse of ``tile_scales_pairs``."""
    nb, G, nt = t.shape
    return t.permute(0, 2, 1).reshape(nb * nt, G)


def _served_rows(codes, scales, zeros, m: Dict[str, Any]) -> None:
    """Refuse the 2-D ``rows`` weights JAX's serving path fails on."""
    if m["bits"] == 4:
        return
    N = codes.shape[0]
    if m["is_float"]:
        if scales.dim() != 2 or scales.shape[0] != N:
            raise reference_fault(3, "per-block or per-tensor float "
                                     "serving weights")
        return
    if scales.numel() not in (1, N):
        raise reference_fault(2, f"{m['bits']}-bit per-group serving "
                                 f"weights")
    if zeros is not None:
        raise reference_fault(1, "asymmetric 8-bit serving weights")


def qlinear_from_arrays(t: Dict[str, torch.Tensor], m: Dict[str, Any],
                        bias: Optional[torch.Tensor]) -> QLinearParams:
    """One linear as the JAX build holds it (``t``: codes, scales and
    optional zeros as tensors; ``m``: bits, group_size, layout, is_float)
    -> the port's QLinearParams, the TPU tilings undone.  The layout
    decides how the arrays are read: a stacked slab is 4-D like the split
    tiled scales of a 2-D linear; planes are tiled iff their codes are 4-D
    (JAX's rule).  ``rows`` (every width, floats) and ``stacked`` keep
    JAX's arrays and raw zeros; the ``rows`` weights JAX's serving path
    fails on raise naming the reference fault."""
    codes, scales, zeros = t["codes"], t["scales"], t.get("zeros")
    bits, gs, lay = m["bits"], m["group_size"], m["layout"]
    is_float = m.get("is_float", False)
    if lay == "rows":
        _served_rows(codes, scales, zeros, m)
        return QLinearParams(codes, scales, zeros, bias,
                             gs if bits == 4 else 0, lay, False, bits,
                             is_float)
    if lay == "stacked":
        return QLinearParams(codes, scales, zeros, None, gs, lay, False,
                             bits, is_float)
    if bits != 4:
        raise NotImplementedError(f"{bits}-bit {lay!r} linears are not "
                                  f"ported")
    if lay == "stacked_planes":
        parts = [split_combined(s) for s in scales]
        return QLinearParams(
            torch.stack([untile_codes(c) for c in codes]).to(torch.int32),
            torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]), None, gs, lay, True, 4)
    if lay == "planes_ks":
        s, zs = split_combined_ksplit(scales)
        return QLinearParams(untile_codes_ksplit(codes).to(torch.int32),
                             s, zs, bias, gs, lay, True)
    if lay == "masked":
        return QLinearParams(untile_codes(codes).to(torch.int32),
                             untile_scales(scales), untile_scales(zeros),
                             bias, gs, lay, True)
    if lay == "s4":
        nb, nt, kh = codes.shape
        return QLinearParams(codes.reshape(nb * nt, kh), untile_pairs(scales),
                             untile_pairs(zeros), bias, gs, lay, True)
    if lay == "planes":
        tiled = codes.dim() == 4
        wp = untile_codes(codes) if tiled else codes
        if scales.dim() == 3:
            s, zs = split_combined(scales)
        elif scales.dim() == 4:
            s = untile_scales(scales)
            zs = (untile_scales(zeros) if zeros is not None
                  else torch.zeros_like(s))
        else:
            # untiled f32 (N, G) scales with raw zero points
            s = scales.float()
            zs = (zeros.float() * s if zeros is not None
                  else torch.zeros_like(s))
        return QLinearParams(wp.to(torch.int32), s, zs, bias, gs, lay, tiled)
    raise NotImplementedError(f"{bits}-bit {lay!r} linears are not ported")


def qlinear_from_numpy(codes, scales, zeros, bias, bits: int,
                       group_size: int, layout: str,
                       device: DeviceLike = None,
                       is_float: bool = False) -> QLinearParams:
    """One JAX ``QLinearParams`` (its fields as arrays) -> the port's,
    through ``qlinear_from_arrays``."""
    t = {"codes": tensor_from_numpy(codes, device),
         "scales": tensor_from_numpy(scales, device)}
    if zeros is not None:
        t["zeros"] = tensor_from_numpy(zeros, device)
    return qlinear_from_arrays(
        t, {"bits": bits, "group_size": group_size, "layout": layout,
            "is_float": is_float},
        None if bias is None else tensor_from_numpy(bias, device))


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
                               device: DeviceLike = None,
                               wbits: int = 4) -> ServingWeights:
    """``blocks`` is a list of dicts: linear name (``attn.qkv`` and
    ``mlp.gateup`` for merged entries) -> dict with the JAX QLinearParams
    fields (codes, scales, zeros, bias, bits, group_size, layout);
    ``ln1``/``ln2``, ``q_norm``/``k_norm`` (``qk_norm``) and
    ``mlp.router`` -> {"weight": array};
    ``mlp.router_bias`` -> array.  ``fused_rms`` and ``wbits`` are the
    JAX fields; ``lm_head_scale`` None is a bf16 head; a fused build with
    the combined scale slab is refused (JAX runs no fused linear on it, as
    it has no separate zeros)."""
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
        lm_head_scale=(None if lm_head_scale is None
                       else tensor_from_numpy(lm_head_scale, device)),
        blocks=out_blocks,
        act_bits=act_bits,
        fused_rms=fused_rms,
        wbits=wbits,
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
