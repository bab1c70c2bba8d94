"""Serving weights: adapter params -> packed serving weights (port of
lightcompress_tpu/serving/quantized_model.py: RTN with the ``layout``,
``fused_rms`` and ``fuse_qkv`` options, or a calibrated model's weights
through its algorithm's ``w_qdq`` (``algo=``); W4 in the planes, s4 or
rows layouts, every other width and the float formats in ``rows`` (W8A8
through ``scaled_matmul.int8_matmul_dynamic``, float dequant-then-matmul);
the int8 per-channel or bf16 head, ``head_logits`` and ``apply_qlinear``;
for MoE blocks the stacked experts (``quantize_linear_stacked``), their
dense, gathered and grouped linears and the selection grouping of the
grouped route; the q/k norm gammas of ``qk_norm``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..device import DeviceLike, div, resolve_device
from ..models import arch as A
from ..models.base import resolve
from ..ops.moe_matmul import (M_TILE, w4a8_grouped_matmul,
                              w4a8_stacked_matmul,
                              w4a8_stacked_matmul_smallm,
                              w8a8_grouped_matmul)
from ..ops.qlinear import (QLinearParams, qlinear_apply, qlinear_plain,
                           quantize_linear, reference_fault)
from ..ops.scaled_matmul import int8_matmul_dynamic
from ..ops.w4_matmul import (DECODE_M_MAX, quantize_act_per_token,
                             unpack_int4, unpack_int4_planes)
from ..quant import QuantSpec, real_quant_weight

# vocab rows per head matmul: bounds the f32 copy of the head codes that
# exact f32 logits need (8192 x 4096 x 4 B = 128 MiB at Llama-3-8B width)
HEAD_CHUNK = 8192


@dataclasses.dataclass
class ServingWeights:
    arch: A.ArchSpec
    embed: torch.Tensor  # bf16 (vocab, hidden)
    norm: Dict[str, torch.Tensor]
    lm_head: torch.Tensor  # int8 per-channel codes or bf16 (vocab, hidden)
    lm_head_scale: Optional[torch.Tensor]  # (vocab,) f32; None: bf16 head
    blocks: List[Dict[str, Any]]  # linear name -> QLinearParams; ln1/ln2
    act_bits: int = 16  # 16 = W4A16; 8 = W4A8 (per-token dynamic int8 acts)
    # True: the RMSNorm gammas are folded into the pre-norm linears'
    # weights (W' = W * gamma, before quantization) and the stored ln
    # weights are ones; the plain path stays exact and the decode step
    # takes the fused linears (#13, #14) where the engine allows
    fused_rms: bool = False
    # the weights' bit width as JAX records it (8 for the float formats)
    wbits: int = 4


_LLAMA_NORMS = ("ln1", "ln2")
# the consumers of each RMSNorm, whose weights absorb its gamma
_LN1_LINEARS = ("attn.q", "attn.k", "attn.v")
_LN2_LINEARS = ("mlp.gate", "mlp.up")
# merged entries of fuse_qkv: name -> the linears concatenated along N
_FUSED = {"attn.qkv": ("attn.q", "attn.k", "attn.v"),
          "mlp.gateup": ("mlp.gate", "mlp.up")}


# ---------------------------------------------------------------------------
# stacked MoE experts
# ---------------------------------------------------------------------------

def quantize_linear_stacked(w3: torch.Tensor, spec: QuantSpec,
                            layout: str = "auto") -> QLinearParams:
    """Per-expert quantization of a stacked (E, oc, ic) expert weight.

    ``stacked_planes`` (W4 planes per expert: codes (E, oc, ic/8) int32,
    bf16 s and zs (E, oc, G), the layout the MoE kernels take) where
    ``ic % (8*group) == 0 and oc % 128 == 0``; elsewhere, with
    ``layout="auto"``, the JAX package's int8 per-channel symmetric
    fallback ``stacked`` (codes (E, oc, ic) int8, f32 scales (E, oc, 1),
    ``bits`` 8: the effective bit width is recorded, not hidden).  Each
    expert is quantized on its own, as JAX quantizes them, through
    ``device.div``: both quantizations work row by row, so the experts'
    rows go through one call as an (E*oc, ic) weight.

    ``layout="rows"`` at 4 bits (JAX's ``rows``, or its
    ``LCTPU_STACKED_INT8_FALLBACK=0``), and every other width or float
    format, store JAX's ``rows`` per expert in ``stacked``: 4 bits as
    ``w4_matmul.pack_int4`` nibbles (E, oc, ic/8) int32 with f32 scales and
    raw zeros (E, oc, G); other widths' codes with their scales and zeros
    (``bits`` 8, ``is_float`` for e4m3/e5m2), one expert at a time.  Scales
    that JAX's stacked dequant cannot reshape (per tensor, per block, a
    float per group) raise naming reference fault 3."""
    E, oc, ic = w3.shape
    gs = spec.group_size if spec.granularity == "per_group" else 0
    rows = w3.reshape(E * oc, ic).float()
    if (layout in ("auto", "planes") and spec.bit == 4 and gs
            and ic % (8 * gs) == 0 and oc % 128 == 0):
        qp = quantize_linear(rows, spec, layout="planes")
        assert qp.tiled
        return QLinearParams(
            qp.codes.reshape(E, oc, -1), qp.scales.reshape(E, oc, -1),
            qp.zeros.reshape(E, oc, -1), None, gs, "stacked_planes", True, 4)
    if layout == "auto" and spec.bit == 4:
        spec8 = QuantSpec(bit=8, symmetric=True, granularity="per_channel")
        codes, scales, _ = real_quant_weight(rows, spec8)
        return QLinearParams(
            codes.reshape(E, oc, ic), scales.float().reshape(E, oc, 1),
            None, None, 0, "stacked", False, 8)
    if layout not in ("auto", "rows"):
        raise ValueError(f"stacked layout {layout!r}: 'auto' or 'rows'")
    if (spec.granularity in ("per_tensor", "per_block")
            or (spec.is_float and gs)):
        raise reference_fault(
            3, f"stacked {spec.bit} {spec.granularity} experts (JAX's "
               f"dequant_weight_stacked reshape)")
    parts = [quantize_linear(w3[e].float(), spec, layout="rows")
             if spec.bit == 4 else _stacked_rows(w3[e], spec)
             for e in range(E)]
    p0 = parts[0]
    return QLinearParams(
        torch.stack([p.codes for p in parts]),
        torch.stack([p.scales for p in parts]),
        None if p0.zeros is None else torch.stack([p.zeros for p in parts]),
        None, p0.group_size, "stacked", False, p0.bits, p0.is_float)


def _stacked_rows(w: torch.Tensor, spec: QuantSpec) -> QLinearParams:
    """One expert's JAX ``rows`` entry of any width but 4: the codes, f32
    scales and zeros as JAX's ``quantize_linear`` keeps them (a float's
    group size 0)."""
    codes, scales, zeros = real_quant_weight(w.float(), spec)
    gs = (spec.group_size if spec.granularity == "per_group"
          and not spec.is_float else 0)
    return QLinearParams(codes, scales.float(),
                         None if zeros is None else zeros.float(), None, gs,
                         "rows", False, 8, spec.is_float)


def dequant_weight_stacked(qp: QLinearParams,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """(E, oc, ic) weights of a stacked expert entry: c*s - zs per group
    (planes), or JAX's ``(u - z) * s`` per group (``stacked``: int8, the
    int4 nibbles, other widths, floats), in f32, then ``dtype``."""
    E, N = qp.codes.shape[:2]
    if qp.layout == "stacked_planes":
        K = qp.codes.shape[2] * 8
        G = qp.scales.shape[2]
        u = unpack_int4_planes(qp.codes.reshape(E * N, -1), K).float()
        w = (u.reshape(E, N, G, K // G) * qp.scales.float()[..., None]
             - qp.zeros.float()[..., None])
        return w.reshape(E, N, K).to(dtype)
    if qp.layout != "stacked":
        raise ValueError(f"not a stacked expert entry: {qp.layout!r}, "
                         f"{qp.bits} bits")
    if qp.bits == 4:
        u = unpack_int4(qp.codes.reshape(E * N, -1)).float().reshape(
            E, N, -1)
    else:
        u = qp.codes.float()
    K = u.shape[2]
    G = qp.scales.shape[2]
    u = u.reshape(E, N, G, K // G)
    if qp.zeros is not None:
        u = u - qp.zeros.float()[..., None]
    return (u * qp.scales.float()[..., None]).reshape(E, N, K).to(dtype)


def _bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` (w batched (..., oc, ic)) of bf16-rounded operands with
    f32 accumulation and an f32 result (JAX's einsum with
    ``preferred_element_type=f32``): the bf16 values are exact in f32."""
    return torch.matmul(x.to(torch.bfloat16).float(),
                        w.to(torch.bfloat16).float().transpose(-1, -2))


def apply_qlinear_stacked(qp: QLinearParams, x: torch.Tensor,
                          pair: bool = False, smallm: int = 0
                          ) -> torch.Tensor:
    """Stacked-expert linear: x (n, ic) -> (E, n, oc); ``pair`` means x
    carries the expert dim ((E, n, ic), the down projection's input).

    ``stacked_planes`` at n <= 256 runs kernel #6 after the per-token int8
    act quant (as on a TPU; here on any device, the plain version on the
    CPU), or kernel #7 at n <= ``smallm`` (the JAX package's
    ``LCTPU_MOE_SMALLM``, default 0: never); otherwise the dequantized bf16
    experts in a matmul."""
    if qp.layout == "stacked_planes" and x.shape[-2] <= DECODE_M_MAX:
        if pair:
            E, n, ic = x.shape
            xq, xs = quantize_act_per_token(x.reshape(E * n, ic))
            xq, xs = xq.reshape(E, n, ic), xs.reshape(E, n, 1)
        else:
            xq, xs = quantize_act_per_token(x)
        kernel = (w4a8_stacked_matmul_smallm if x.shape[-2] <= smallm
                  else w4a8_stacked_matmul)
        return kernel(xq, xs, qp.codes, qp.scales, qp.zeros, pair=pair)
    return _bf16_matmul_f32(x if pair else x[None],
                            dequant_weight_stacked(qp))


def apply_qlinear_gathered(qp: QLinearParams, x: torch.Tensor,
                           e_idx: torch.Tensor) -> torch.Tensor:
    """Per-token expert-gathered linear: x (n, ic) and e_idx (n,) -> (n,
    oc), through each token's dequantized bf16 expert (the JAX engine's
    small-batch route where the gathered kernel does not apply)."""
    w = dequant_weight_stacked(dataclasses.replace(
        qp, codes=qp.codes[e_idx], scales=qp.scales[e_idx],
        zeros=None if qp.zeros is None else qp.zeros[e_idx]))
    return _bf16_matmul_f32(x[:, None, :], w)[:, 0]


def moe_group_selections(topi: torch.Tensor, num_experts: int,
                         m_tile: int = M_TILE):
    """Dropless grouping of the (n, top_k) selections by expert, each
    expert's run padded to an ``m_tile`` boundary, so that every M block
    of the grouped rows belongs to one expert; Mp = (ceil(S/m_tile) + E)
    * m_tile rows bound the worst padding.  Returns int32 ``(gather_row``
    (Mp,): the source token of each grouped row, n for padding rows;
    ``sel_pos`` (S,): the grouped row of selection s in token-major
    order; ``block_eid`` (Mp/m_tile,): the expert of each M block)``, equal
    to the JAX package's bit for bit (a stable argsort, searchsorted to
    the right, clamped to E - 1)."""
    n, top_k = topi.shape
    S = n * top_k
    E = num_experts
    dev = topi.device
    Mp = (-(-S // m_tile) + E) * m_tile
    e_flat = topi.reshape(-1).long()
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    padded = -(-counts // m_tile) * m_tile
    start = torch.cumsum(counts, 0) - counts
    pstart = torch.cumsum(padded, 0) - padded
    pos_sorted = (torch.arange(S, device=dev) - start[e_sorted]
                  + pstart[e_sorted])
    gather_row = torch.full((Mp,), n, dtype=torch.long, device=dev)
    gather_row[pos_sorted] = order // top_k
    sel_pos = torch.zeros((S,), dtype=torch.long, device=dev)
    sel_pos[order] = pos_sorted
    pend = torch.cumsum(padded, 0)
    block_eid = torch.searchsorted(
        pend, torch.arange(Mp // m_tile, device=dev) * m_tile, right=True)
    return (gather_row.to(torch.int32), sel_pos.to(torch.int32),
            block_eid.clamp_max(E - 1).to(torch.int32))


def moe_mlp_grouped(entry: Dict[str, Any], x2: torch.Tensor,
                    topi: torch.Tensor, topw: torch.Tensor, act_fn: str,
                    m_tile: int = M_TILE, kernel_route: bool = False
                    ) -> torch.Tensor:
    """MoE MLP through the capacity-grouped kernel #9: (n, H) tokens and
    (n, top_k) routing -> (n, H) f32.  Each token is quantized once and
    its int8 row gathered into the expert-sorted layout (padding rows:
    the zero dummy row with scale 1); gate, up and down run as three
    grouped calls over the live experts only; the result is unsorted and
    weighted by the router.  An int8 ``stacked`` down projection takes
    the per-token int8 act quant of ``mid`` and kernel #10
    (``w8a8_grouped_matmul``) on the card; on the CPU the JAX package's
    CPU fallback, a block-gathered bf16 matmul without act quant, unless
    ``kernel_route`` asks for the card's route (act quant and #10's plain
    version: JAX's ``interpret=True``)."""
    gp, up, dp = entry["mlp.gate"], entry["mlp.up"], entry["mlp.down"]
    E = gp.codes.shape[0]
    n, H = x2.shape
    top_k = topi.shape[1]
    gather_row, sel_pos, block_eid = moe_group_selections(topi, E, m_tile)
    gather_row, sel_pos = gather_row.long(), sel_pos.long()
    xq_t, xs_t = quantize_act_per_token(x2)
    xq = torch.cat([xq_t, xq_t.new_zeros((1, H))])[gather_row]
    xs = torch.cat([xs_t, xs_t.new_ones((1, 1))])[gather_row]
    g = w4a8_grouped_matmul(xq, xs, gp.codes, gp.scales, gp.zeros,
                            block_eid, m_tile)
    u = w4a8_grouped_matmul(xq, xs, up.codes, up.scales, up.zeros,
                            block_eid, m_tile)
    mid = A._act(g, act_fn) * u
    if dp.layout == "stacked_planes":
        mq, ms = quantize_act_per_token(mid.to(torch.bfloat16))
        d = w4a8_grouped_matmul(mq, ms, dp.codes, dp.scales, dp.zeros,
                                block_eid, m_tile)
    elif kernel_route or x2.device.type != "cpu":
        mq, ms = quantize_act_per_token(mid.to(torch.bfloat16))
        d = w8a8_grouped_matmul(mq, ms, dp.codes, dp.scales, block_eid,
                                m_tile)
    else:
        n_mb = block_eid.shape[0]
        midb = mid.to(torch.bfloat16).reshape(n_mb, m_tile, -1)
        be = block_eid.long()
        d = _bf16_matmul_f32(midb, dp.codes[be].to(torch.bfloat16))
        d = (d * dp.scales[be].reshape(n_mb, 1, H)).reshape(n_mb * m_tile,
                                                            H)
    y_sel = d[sel_pos].reshape(n, top_k, H)
    return torch.einsum("nkh,nk->nh", y_sel, topw)


def build_serving_weights(model, wspec: QuantSpec, act_bits: int = 16,
                          layout: Optional[str] = None,
                          fused_rms: bool = False,
                          fuse_qkv: bool = False,
                          device: DeviceLike = None,
                          algo=None, head_bits: int = 8) -> ServingWeights:
    """RTN real-quant of every block linear: W4 to ``layout`` ("planes", the
    default, "s4" with the JAX fallback to planes where its shapes do not
    fit, or "rows"); any other ``wspec`` that JAX serves to ``rows``
    (``ops.qlinear``; the ones JAX fails on raise naming the reference
    fault).  The embedding stays bf16; the head is int8 per channel
    (``head_bits`` 8) or bf16 (16).  The quantization runs on ``device``
    and the weights stay there.

    With ``algo`` (a calibrated algorithm of ``compression``), each weight
    is first replaced by ``algo.w_qdq``'s fake-quantized weight, which the
    RTN real quant re-codes losslessly, so that what the algorithm
    searched (AWQ's clipped ranges) is what is served (the JAX
    ``build_serving_weights(algo=)``).

    ``fused_rms`` folds each RMSNorm gamma into its consumer linears in the
    weight's own dtype before quantization and stores ones as the ln
    weights.  ``fuse_qkv`` concatenates q/k/v into ``attn.qkv`` and
    gate/up into ``mlp.gateup`` along the output channels (exact: the
    quantization is per output row).

    ``qk_norm`` models keep their q/k norm gammas as ``q_norm`` and
    ``k_norm`` entries (with ``fuse_qkv`` the engine applies them after
    the split).

    A MoE block's stacked experts go through ``quantize_linear_stacked``
    whatever ``layout`` says, its router stays bf16, ``fuse_qkv`` never
    merges the stacked gate/up, and ``fused_rms`` is off for MoE models
    (the router and every expert hang off ln2), as in JAX."""
    dev = resolve_device(device)
    if act_bits not in (8, 16):
        raise ValueError("act_bits is 8 or 16")
    if head_bits not in (8, 16):
        raise ValueError("head_bits is 8 or 16")
    layout = layout or ("planes" if wspec.bit == 4 else "rows")
    arch, params = model.arch, model.params
    fused_rms = fused_rms and arch.moe is None
    blocks_out = []
    for idx in range(model.num_blocks):
        bp = params["blocks"][idx]
        gammas = {}
        if fused_rms:
            for ln, names in (("ln1", _LN1_LINEARS), ("ln2", _LN2_LINEARS)):
                gammas.update(dict.fromkeys(names, bp[ln]["weight"].to(dev)))
        pend: Dict[str, tuple] = {}
        for name in model.get_block_linear_names(idx):
            if name == "mlp.router":
                continue  # kept bf16 below
            node = resolve(bp, name)
            w = node["weight"].to(dev)
            if algo is not None:
                w = algo.w_qdq(w, idx, name)
            if name in gammas:
                w = w * gammas[name][None, :].to(w.dtype)
            bias = node.get("bias")
            pend[name] = (w, None if bias is None else bias.to(dev))
        if fuse_qkv:
            for merged, names in _FUSED.items():
                if pend[names[0]][0].dim() != 2:
                    continue  # stacked experts stay apart
                ws, bs = zip(*(pend.pop(n) for n in names))
                bias = None
                if any(b is not None for b in bs):
                    bias = torch.cat([
                        b if b is not None else w.new_zeros(w.shape[0])
                        for w, b in zip(ws, bs)])
                pend[merged] = (torch.cat(ws), bias)
        entry: Dict[str, Any] = {
            name: (quantize_linear_stacked(w, wspec) if w.dim() == 3 else
                   quantize_linear(w.float(), wspec, bias=bias,
                                   layout=layout))
            for name, (w, bias) in pend.items()}
        for ln in _LLAMA_NORMS:
            entry[ln] = {k: t.to(dev) for k, t in bp[ln].items()}
            if fused_rms:
                entry[ln]["weight"] = torch.ones_like(entry[ln]["weight"])
        if arch.qk_norm:  # applied per head after the q/k split
            for name in ("q_norm", "k_norm"):
                entry[name] = {k: t.to(dev)
                               for k, t in bp["attn"][name].items()}
        mp = bp["mlp"]
        if arch.moe is not None and "router" in mp:
            entry["mlp.router"] = {
                "weight": mp["router"]["weight"].to(dev, torch.bfloat16)}
            if "router_bias" in mp:
                entry["mlp.router_bias"] = mp["router_bias"].to(dev)
        blocks_out.append(entry)
    head_w = (params["embed"]["weight"] if arch.tie_word_embeddings
              else params["lm_head"]["weight"])
    head_scale = None
    if head_bits == 8:
        hw = head_w.to(dev).float()
        head_scale = div(hw.abs().amax(dim=1).clamp_min(1e-6), 127.0)
        head_w = torch.round(hw / head_scale[:, None]).clamp(-127, 127).to(
            torch.int8)
    else:
        head_w = head_w.to(dev, torch.bfloat16)
    return ServingWeights(
        arch=arch,
        embed=params["embed"]["weight"].to(dev, torch.bfloat16),
        norm={k: t.to(dev) for k, t in params["norm"].items()},
        lm_head=head_w,
        lm_head_scale=head_scale,
        blocks=blocks_out,
        act_bits=act_bits,
        fused_rms=fused_rms,
        wbits=wspec.bit if isinstance(wspec.bit, int) else 8,
    )


def head_logits(sw: ServingWeights, xl: torch.Tensor) -> torch.Tensor:
    """lm_head matmul: bf16-rounded activations times the head (int8 codes
    or bf16 weights) as bf16 operands, f32 accumulation, f32 logits (...,
    vocab), an int8 head's scaled per vocab row.  Done in vocab chunks so
    the f32 operand copy stays small."""
    x = xl.to(torch.bfloat16).float()
    parts = []
    for v0 in range(0, sw.lm_head.shape[0], HEAD_CHUNK):
        w = sw.lm_head[v0:v0 + HEAD_CHUNK].to(torch.bfloat16).float()
        parts.append(torch.matmul(x, w.t()))
    logits = torch.cat(parts, dim=-1)
    if sw.lm_head_scale is None:
        return logits
    return logits * sw.lm_head_scale.float()


def apply_qlinear(entry: QLinearParams, x: torch.Tensor,
                  act_bits: int = 16) -> torch.Tensor:
    """A serving linear (not a stacked expert entry), by stored format as
    the JAX dispatch: 4 bits through ``qlinear_apply``, integer codes of
    ``bits`` 8 through ``int8_matmul_dynamic`` (whatever ``act_bits`` says:
    W8A8), float codes dequant-then-matmul."""
    if entry.bits == 4:
        return qlinear_apply(x, entry, act_bits=act_bits)
    if not entry.is_float:
        return int8_matmul_dynamic(x, entry.codes, entry.scales,
                                   bias=entry.bias)
    return qlinear_plain(x, entry)
