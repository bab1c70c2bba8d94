"""SpQR, GPTQ with sparse float outliers (port of
lightcompress_tpu/compression/quantization/spqr.py).

Per linear, from GPTQ's Hessian: the columns sorted by H_ii (``actorder``),
H damped, the dead columns' diagonals set to 1 and their weights zeroed;
U, the upper Cholesky factor of H^-1; the outlier threshold
``relative_threshold`` * mean(var(W, rows) / U_ii^2).  Then group by group
(``group_size`` columns): each element's leave-one-out gain (the group's
U-weighted qdq error with and without it) marks the elements that fit the
group's asymmetric qparams only as the inliers' mean; then the column loop
quantizes each column with the group's qparams, keeps in float (and
propagates no error from) the entries whose squared scaled error passes
the threshold, and takes each column's error out of the group's later
columns, then the group's errors out of every later column.

``spqr_factor`` (the permutation and U) and ``spqr_columns`` (the threshold
and the column step) are separate so that a test can feed the column step
another package's U.

The JAX package compiles the layer (``jax.jit`` with ``lax.scan`` over the
groups and ``lax.fori_loop`` over the columns), so the port takes XLA's
arithmetic: divisions by constants as products with the reciprocal, the
means as sums times 1/n and the column update as one fused multiply-add.
The loop reads nothing back to the host; on the card each group's column
loop is one CUDA graph replay.  The JAX package keeps the
per-group scales and zeros exact (the reference's 3-bit double quant of
them is the identity as invoked); so does the port.
"""

from __future__ import annotations

import math

import torch

from ...models.base import Subset, resolve
from ...quant.quantizer import fma, mean_xla, recip
from ...registry import ALGO_REGISTRY
from .gptq import GPTQ


def _asym_qp(x: torch.Tensor, qmin: float, qmax: float, round_zp: bool):
    """Asymmetric minmax qparams along the last dim (compiled: the range
    times the reciprocal of qmax - qmin)."""
    mx = x.amax(dim=-1, keepdim=True)
    mn = x.amin(dim=-1, keepdim=True)
    scales = (mx - mn).clamp_min(1e-5) * recip(qmax - qmin)
    if round_zp:
        zeros = (qmin - torch.round(mn / scales)).clamp(qmin, qmax)
    else:
        zeros = qmin - mn / scales
    return scales, zeros


def _asym_qdq(x, scales, zeros, qmin: float, qmax: float,
              round_zp: bool) -> torch.Tensor:
    if round_zp:
        q = (torch.round(x / scales) + zeros).clamp(qmin, qmax)
    else:
        q = torch.round(x / scales.clamp_min(1e-9) + zeros).clamp(qmin, qmax)
    return (q - zeros) * scales


def _group_columns(G, s, z, Ug, threshold, Err, M, qmin: float,
                   qmax: float, round_zp: bool, have_thresh: bool) -> None:
    """One group's column loop, in place: each column quantized with the
    group's qparams, its entries whose squared scaled error passes the
    threshold kept in float (``M``) with no error, the error / U_ii into
    ``Err`` and out of the group's later columns (one fused multiply-add,
    as XLA's)."""
    for i in range(G.shape[1]):
        w = G[:, i]
        d = Ug[i, i]
        dq = _asym_qdq(w[:, None], s, z, qmin, qmax, round_zp)[:, 0]
        err = (w - dq) / d
        if have_thresh:
            m = err * err > threshold
            dq = torch.where(m, w, dq)
            err = (w - dq) / d
            M[:, i] = m
        if i + 1 < G.shape[1]:
            G[:, i + 1:] = fma(-err[:, None], Ug[i, i + 1:][None, :],
                               G[:, i + 1:])
        Err[:, i] = err


class _GraphedGroup:
    """``_group_columns`` captured once as a CUDA graph over static buffers
    and replayed a group at a time (GPTQ's ``_GraphedBlock``): the same
    kernels on the same values, so the eager loop's bits, without its
    twenty-odd launches a column from the host."""

    def __init__(self, oc: int, gs: int, qmin: float, qmax: float,
                 round_zp: bool, have_thresh: bool, dev: torch.device):
        self.bufs = [torch.zeros((oc, gs), device=dev),   # G
                     torch.ones((oc, 1), device=dev),     # s
                     torch.zeros((oc, 1), device=dev),    # z
                     torch.eye(gs, device=dev),           # Ug
                     torch.zeros((), device=dev),         # threshold
                     torch.zeros((oc, gs), device=dev),   # Err
                     torch.zeros((oc, gs), dtype=torch.bool, device=dev)]

        def run():
            _group_columns(*self.bufs, qmin, qmax, round_zp, have_thresh)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # the warm-up capture asks for
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()

    def __call__(self, G, s, z, Ug, threshold):
        """The group's loop on these inputs: (G, Err, M), static buffers
        that the next call overwrites."""
        for buf, t in zip(self.bufs, (G, s, z, Ug, threshold)):
            buf.copy_(t)
        self.graph.replay()
        return self.bufs[0], self.bufs[5], self.bufs[6]


def spqr_factor(W: torch.Tensor, H: torch.Tensor, actorder: bool,
                percdamp: float):
    """(W permuted and dead-zeroed (f32), U, perm): the Hessian step in
    SpQR's order (permute, damp, then the dead diagonals set to 1)."""
    cols = W.shape[1]
    W, H = W.float(), H.float()
    dev = W.device
    if actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]
    else:
        perm = torch.arange(cols, device=dev)
    dead = torch.diagonal(H) == 0
    eye = torch.eye(cols, device=dev)
    if percdamp > 0:
        H = H + percdamp * mean_xla(torch.diagonal(H).abs()) * eye
    H = torch.where(torch.diag(dead), torch.ones((), device=dev), H)
    W = W * (~dead)[None, :]
    L = torch.linalg.cholesky(H)
    Hinv = torch.cholesky_solve(eye, L)
    U = torch.linalg.cholesky((Hinv + Hinv.T) * 0.5).T.contiguous()
    return W, U, perm


def spqr_quantize_layer(W: torch.Tensor, H: torch.Tensor, qmin: float,
                        qmax: float, round_zp: bool, group_size: int = 16,
                        actorder: bool = True, percdamp: float = 0.01,
                        rel_threshold: float = 0.2,
                        simplified: bool = False):
    """(W_new, outlier mask, scales (oc, n_groups), zeros, perm): W_new and
    the mask in the original column order, the group qparams in the
    permuted order (``w_qdq`` permutes back)."""
    W, U, perm = spqr_factor(W, H, actorder, percdamp)
    W, mask, scales, zeros = spqr_columns(W, U, qmin, qmax, round_zp,
                                          group_size, rel_threshold,
                                          simplified)
    inv = torch.argsort(perm)
    return W[:, inv], mask[:, inv], scales, zeros, perm


def spqr_columns(W: torch.Tensor, U: torch.Tensor, qmin: float,
                 qmax: float, round_zp: bool, group_size: int = 16,
                 rel_threshold: float = 0.2, simplified: bool = False):
    """The outlier threshold and the group-by-group column step on a
    permuted W and its U: (W_new, mask, scales, zeros), all in the
    permuted order."""
    W = W.clone()
    oc, cols = W.shape
    dev = W.device
    dU = torch.diagonal(U)
    # torch.var's unbiased variance as XLA compiles jnp.var(ddof=1)
    var = ((W - mean_xla(W, 0, keepdim=True)) ** 2).sum(dim=0) \
        * recip(oc - 1)
    have_thresh = math.isfinite(rel_threshold)
    threshold = rel_threshold * mean_xla(var / dU ** 2) if have_thresh \
        else torch.tensor(math.inf, device=dev)
    gs = group_size
    n_groups = cols // gs
    ar = torch.arange(gs, device=dev)
    # row j: the group without element j
    loo_idx = ar[None, 1:] - (ar[:, None] >= ar[None, 1:]).long()
    scales = torch.zeros((oc, n_groups), device=dev)
    zeros = torch.zeros((oc, n_groups), device=dev)
    mask = torch.zeros((oc, cols), dtype=torch.bool, device=dev)
    graphed = _GraphedGroup(oc, gs, qmin, qmax, round_zp, have_thresh, dev) \
        if dev.type == "cuda" else None
    for g in range(n_groups):
        i1 = g * gs
        G = W[:, i1:i1 + gs].clone()
        du = dU[i1:i1 + gs]
        Ug = U[i1:i1 + gs, i1:i1 + gs]
        if have_thresh and not simplified:
            loo = G[:, loo_idx]  # (oc, gs, gs - 1)
            s_l, z_l = _asym_qp(loo, qmin, qmax, False)
            dq_l = _asym_qdq(loo, s_l, z_l, qmin, qmax, False)
            loo_err = (((dq_l - loo) / du[loo_idx][None]) ** 2).sum(-1)
            s_b, z_b = _asym_qp(G, qmin, qmax, False)
            dq_b = _asym_qdq(G, s_b, z_b, qmin, qmax, False)
            base_err = (((dq_b - G) / du[None, :]) ** 2).sum(-1,
                                                             keepdim=True)
            M = (base_err - loo_err > threshold).float()
            mean = (G * (1 - M)).sum(1, keepdim=True) / \
                (1 - M).sum(1, keepdim=True).clamp_min(1)
            fitG = G * (1 - M) + mean * M
        else:
            fitG = G
        s, z = _asym_qp(fitG, qmin, qmax, round_zp)  # (oc, 1)
        if graphed is not None:
            G, Err, M = graphed(G, s, z, Ug, threshold)
        else:
            Err = torch.zeros((oc, gs), device=dev)
            M = torch.zeros((oc, gs), dtype=torch.bool, device=dev)
            _group_columns(G, s, z, Ug, threshold, Err, M, qmin, qmax,
                           round_zp, have_thresh)
        mask[:, i1:i1 + gs] = M
        W[:, i1:i1 + gs] = G
        if i1 + gs < cols:
            W[:, i1 + gs:] -= Err @ U[i1:i1 + gs, i1 + gs:]
        scales[:, g:g + 1] = s
        zeros[:, g:g + 1] = z.expand(oc, 1)
    return W, mask, scales, zeros


@ALGO_REGISTRY
class SpQR(GPTQ):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        sp = self.special_config
        rt = sp.get("relative_threshold", 0.2)
        self.rel_threshold = math.inf if rt in ("inf", math.inf) else \
            float(rt)
        self.simplified_outliers = sp.get("simplified_outliers", False)
        if self.wspec.granularity != "per_group":
            raise ValueError("SpQR only supports per_group quantization")

    def subset_transform(self, block_idx, bp, subset: Subset, input_feat):
        for name in subset.layers:
            if self.is_ignored(block_idx, name):
                continue
            node = resolve(bp, name)
            W = node["weight"]
            H = self.compute_hessian(input_feat[name], name)
            W_new, mask, scales, zeros, perm = spqr_quantize_layer(
                W, H, float(self.wspec.qmin), float(self.wspec.qmax),
                self.wspec.round_zp, self.wspec.group_size, self.actorder,
                self.percdamp, self.rel_threshold, self.simplified_outliers)
            del H
            node["weight"] = W_new.to(W.dtype)
            st = self.state(block_idx, name)
            st["gptq"] = {"scales": scales, "zeros": zeros,
                          "perm": perm if self.actorder else None,
                          "group_size": self.wspec.group_size}
            st["outlier_mask"] = mask

    def w_qdq(self, w, block_idx, name):
        st = self.layer_state[block_idx].get(name, {})
        g = st.get("gptq")
        if g is None:
            return super().w_qdq(w, block_idx, name)
        gs = g["group_size"]
        oc, cols = w.shape
        wf = w.float()
        if g["perm"] is not None:
            wf = wf[:, g["perm"]]
        dq = _asym_qdq(wf.reshape(oc, cols // gs, gs),
                       g["scales"][:, :, None], g["zeros"][:, :, None],
                       float(self.wspec.qmin), float(self.wspec.qmax),
                       self.wspec.round_zp).reshape(oc, cols)
        if g["perm"] is not None:
            dq = dq[:, torch.argsort(g["perm"])]
        mask = st.get("outlier_mask")
        if mask is not None:
            dq = torch.where(mask, w.float(), dq)
        return dq.to(w.dtype)
