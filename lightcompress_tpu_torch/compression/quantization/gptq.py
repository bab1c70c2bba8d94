"""GPTQ, Hessian-based error-compensating column quantization (port of
lightcompress_tpu/compression/quantization/gptq.py).

Per linear, from the block's collected inputs X: H = 2/n · Σ XᵀX; dead
columns (H_ii = 0) zeroed; the OWQ outlier columns (``n_out``) moved last
and kept in float; ``actorder`` sorts the columns by H_ii, descending;
H += percdamp · mean(H_ii) · I; U, the upper Cholesky factor of H⁻¹
(H⁻¹ = UᵀU).  Then the column step: blocks of ``blocksize`` columns,
each column quantized with its group's qparams (``static_groups``: all
groups from the permuted weight before the loop; else refreshed at each
block start that begins a group, or, for groups smaller than a block,
every group of the block at its start), its error divided by U_ii and
taken out of the block's later columns (one rank-1 update a column),
then the block's errors out of every later column (``Err @ U_rows``).
The inverse permutation restores the column order.

``gptq_factor`` (the permutation and U) and ``gptq_columns`` (the column
step) are separate so that a test can feed the column step another
package's U; ``gptq_quantize_layer`` is the two in turn.

The column loop runs on the device with no host read: the qparams, U's
diagonal and the errors stay tensors.  On the card, where the blocks hold
whole groups and no column is OWQ's, each block's loop is one CUDA graph
replay (launched one by one, its nine launches a column hold the host).
Its matmuls (the Hessian, the trailing update) are
f32; TF32 (off in PyTorch by default) must stay off.
The stacked-MoE path (``_transform_experts``) raises naming ROADMAP A9.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from ...models import arch as A
from ...models.base import Subset, resolve
from ...quant import QParams, QuantSpec
from ...quant.quantizer import compiled_qparams, mean_xla, minmax_range, \
    mse_range
from ...registry import ALGO_REGISTRY
from ...utils.profiling import sync
from .base import BaseBlockwiseQuantization


def _group_qparams(Wg: torch.Tensor, spec: QuantSpec) -> QParams:
    """One group slice's (oc, gs) qparams, per row; zeros broadcast to
    the scales' shape.  JAX compiles this inside the layer's jit (its
    division by the format's range a product with the reciprocal)."""
    row = spec.with_(granularity="per_channel")
    rng = mse_range(Wg, row) if spec.calib_algo == "mse" else \
        minmax_range(Wg, row)
    qp = compiled_qparams(rng, spec)
    return QParams(qp.scales, qp.zeros.expand_as(qp.scales))


def gptq_factor(W: torch.Tensor, H: torch.Tensor, actorder: bool = False,
                percdamp: float = 0.01, n_out: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W permuted (f32, dead columns zeroed), U, perm): the Hessian step.
    U is the upper Cholesky factor of the permuted, damped H's inverse."""
    cols = W.shape[1]
    W = W.float()
    H = H.float()
    dead = torch.diagonal(H) == 0
    H = H + torch.diag(dead.float())
    W = W * (~dead)[None, :]
    dev = W.device
    if n_out > 0:
        # OWQ: the n_out columns of largest H_ii last, kept in float
        desc = torch.argsort(-torch.diagonal(H), stable=True)
        if actorder:
            perm = torch.cat([desc[n_out:], desc[:n_out]])
        else:
            mask = torch.ones(cols, dtype=torch.bool, device=dev)
            mask[desc[:n_out]] = False
            ar = torch.arange(cols, device=dev)
            kept = torch.argsort(torch.where(mask, ar, cols + ar),
                                 stable=True)[:cols - n_out]
            perm = torch.cat([kept, desc[:n_out]])
    elif actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
    else:
        perm = torch.arange(cols, device=dev)
    if actorder or n_out > 0:
        W = W[:, perm]
        H = H[perm][:, perm]
    damp = percdamp * mean_xla(torch.diagonal(H))
    H = H + damp * torch.eye(cols, device=dev)
    # H^-1 by two triangular solves on the lower factor (JAX's cho_solve),
    # symmetrized as ``jnp.linalg.cholesky`` takes its input, then
    # U = chol(H^-1)^T
    L = torch.linalg.cholesky(H)
    del H
    Hinv = torch.cholesky_solve(torch.eye(cols, device=dev), L)
    del L
    Hinv = (Hinv + Hinv.T) * 0.5
    U = torch.linalg.cholesky(Hinv).T.contiguous()
    return W, U, perm


def _block_step(W1: torch.Tensor, U1: torch.Tensor, S: torch.Tensor,
                Z: torch.Tensor, Err1: torch.Tensor, dq: torch.Tensor,
                groups, qmin: float, qmax: float) -> None:
    """One block's column loop, in place: column i quantized with the
    qparams S[:, groups[i]], Z[:, groups[i]] (None: an OWQ column, kept
    in float), its error / U_ii into Err1[i] and out of the later columns
    (a rank-1 update)."""
    bs = W1.shape[1]
    for i, g in enumerate(groups):
        if g is None:
            continue
        s, z = S[:, g], Z[:, g]
        w = W1[:, i]
        torch.div(w, s, out=dq)
        dq.round_().add_(z).clamp_(qmin, qmax).sub_(z).mul_(s)
        err = torch.sub(w, dq, out=Err1[i]).div_(U1[i, i])
        if i + 1 < bs:
            W1[:, i + 1:].addr_(err, U1[i, i + 1:], alpha=-1)


class _GraphedBlock:
    """``_block_step`` captured once as a CUDA graph over static buffers
    and replayed a block at a time: the same kernels on the same values,
    so the eager loop's bits.  The block's groups are local (0 to
    blocksize / gs - 1); the caller passes their slices of S and Z."""

    def __init__(self, oc: int, bs: int, gs: int, qmin: float, qmax: float,
                 dev: torch.device):
        self.W1 = torch.zeros((oc, bs), device=dev)
        self.U1 = torch.eye(bs, device=dev)
        self.S = torch.ones((oc, bs // gs), device=dev)
        self.Z = torch.zeros((oc, bs // gs), device=dev)
        self.Err1 = torch.zeros((bs, oc), device=dev)
        dq = torch.zeros(oc, device=dev)
        groups = [i // gs for i in range(bs)]

        def run():
            _block_step(self.W1, self.U1, self.S, self.Z, self.Err1, dq,
                        groups, qmin, qmax)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # the warm-up capture asks for
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()

    def __call__(self, W1, U1, S, Z) -> torch.Tensor:
        """The block's step on W1 (updated in place); returns Err1."""
        self.W1.copy_(W1)
        self.U1.copy_(U1)
        self.S.copy_(S)
        self.Z.copy_(Z)
        self.graph.replay()
        W1.copy_(self.W1)
        return self.Err1


def gptq_columns(W: torch.Tensor, U: torch.Tensor, spec: QuantSpec,
                 blocksize: int = 128, group_size: int = -1,
                 static_groups: bool = False, n_out: int = 0):
    """The column step on a permuted W (oc, cols) and its U: (W_new in
    the permuted order, scales (oc, n_groups), zeros (oc, n_groups)).  On
    the card, where gs divides the block size and no column is OWQ's, each
    block's loop replays one ``_GraphedBlock``."""
    oc, cols = W.shape
    W = W.float().clone()
    gs = group_size if group_size > 0 else cols
    n_groups = cols // gs
    n_nonout = cols - n_out
    dev = W.device
    if static_groups:
        qps = [_group_qparams(W[:, g * gs:(g + 1) * gs], spec)
               for g in range(n_groups)]
        scales = torch.cat([q.scales for q in qps], dim=1)
        zeros = torch.cat([q.zeros for q in qps], dim=1)
    else:
        scales = torch.zeros((oc, n_groups), device=dev)
        zeros = torch.zeros((oc, n_groups), device=dev)
    qmin, qmax = spec.qmin, spec.qmax
    dq = torch.empty(oc, device=dev)
    graphed = None
    if dev.type == "cuda" and n_out == 0 and blocksize % gs == 0:
        graphed = _GraphedBlock(oc, blocksize, gs, qmin, qmax, dev)
    for i1 in range(0, cols - cols % blocksize, blocksize):
        i2 = i1 + blocksize
        if not static_groups:
            if gs >= blocksize:
                if i1 % gs == 0:
                    g = i1 // gs
                    qp = _group_qparams(W[:, g * gs:(g + 1) * gs], spec)
                    scales[:, g:g + 1] = qp.scales
                    zeros[:, g:g + 1] = qp.zeros
            else:
                for si in range(blocksize // gs):
                    a = i1 + si * gs
                    qp = _group_qparams(W[:, a:a + gs], spec)
                    scales[:, a // gs:a // gs + 1] = qp.scales
                    zeros[:, a // gs:a // gs + 1] = qp.zeros
        if graphed is not None:
            g0, g1 = i1 // gs, i2 // gs
            Err1 = graphed(W[:, i1:i2], U[i1:i2, i1:i2], scales[:, g0:g1],
                           zeros[:, g0:g1])
        else:
            # the block's errors, a row a column (rows are contiguous)
            Err1 = torch.zeros((blocksize, oc), device=dev)
            groups = [(i1 + i) // gs if i1 + i < n_nonout else None
                      for i in range(blocksize)]
            _block_step(W[:, i1:i2], U[i1:i2, i1:i2], scales, zeros, Err1,
                        dq, groups, qmin, qmax)
        if i2 < cols:
            W[:, i2:] -= Err1.T @ U[i1:i2, i2:]
    return W, scales, zeros


def gptq_quantize_layer(W: torch.Tensor, H: torch.Tensor, spec: QuantSpec,
                        blocksize: int = 128, group_size: int = -1,
                        actorder: bool = False, static_groups: bool = False,
                        percdamp: float = 0.01, n_out: int = 0,
                        seconds: Dict[str, float] = None):
    """(W_new, scales (oc, n_groups), zeros, perm): quantizing W_new with
    the group qparams in the permuted order gives the loop's quantized
    values.  ``seconds``, if given, gains the factor and column seconds
    (synchronised on the card)."""
    t0 = time.time()
    Wp, U, perm = gptq_factor(W, H, actorder, percdamp, n_out)
    sync(Wp.device)
    t1 = time.time()
    W_new, scales, zeros = gptq_columns(Wp, U, spec, blocksize, group_size,
                                        static_groups, n_out)
    del U, Wp
    W_new = W_new[:, torch.argsort(perm)]
    if seconds is not None:
        sync(W_new.device)
        seconds["factor"] = seconds.get("factor", 0.0) + t1 - t0
        seconds["columns"] = seconds.get("columns", 0.0) + time.time() - t1
    return W_new, scales, zeros, perm


@ALGO_REGISTRY
class GPTQ(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        special = self.special_config
        self.actorder = special.get("actorder", False)
        self.static_groups = special.get("static_groups", False)
        self.percdamp = special.get("percdamp", 0.01)
        self.blocksize = special.get("blocksize", 128)
        self.owq = special.get("owq", False)  # outlier columns kept float
        self.n_out_ratio = special.get("n_out_ratio", 0.0)
        # OWQ's absolute outlier counts, by the linear's block position
        self.n_outs = special.get("n_outs", None)
        # seconds of the Hessians, the factors and the column loops
        self.seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def compute_hessian(self, x_batches: List[torch.Tensor],
                        name: str = "") -> torch.Tensor:
        """H = 2/n_seq · Σ XᵀX over the calibration tokens, in f32; a
        linear with an online rotation sees its rotated input."""
        n_seq = 0
        H = None
        for x in x_batches:
            if name:
                x = self.model.apply_online_rotate(name, x)
            n_seq += x.shape[0]
            x2 = x.reshape(-1, x.shape[-1]).float()
            h = x2.T @ x2
            H = h if H is None else H + h
            del x2, h
        return H * (2.0 / n_seq)

    # ------------------------------------------------------------------
    def subset_transform(self, block_idx, bp, subset: Subset, input_feat):
        gs = self.wspec.group_size if self.wspec.granularity == "per_group" \
            else -1
        for name in subset.layers:
            if self.is_ignored(block_idx, name):
                continue
            node = resolve(bp, name)
            W = node["weight"]
            if W.dim() == 3:
                self._transform_experts(block_idx, name, node, input_feat,
                                        gs)
                continue
            t0 = time.time()
            H = self.compute_hessian(input_feat[name], name)
            sync(H.device)
            self.seconds["hessian"] = self.seconds.get("hessian", 0.0) \
                + time.time() - t0
            n_out = 0
            if self.owq:
                if self.n_outs is not None:
                    order = self.model.get_block_linear_names(block_idx)
                    pos = order.index(name) if name in order else 0
                    n_out = int(self.n_outs[pos % len(self.n_outs)])
                else:
                    n_out = int(W.shape[1] * self.n_out_ratio)
                if gs > 0:
                    n_out = (n_out // gs) * gs  # keep the groups aligned
            W_new, scales, zeros, perm = gptq_quantize_layer(
                W, H, self.wspec, blocksize=min(self.blocksize, W.shape[1]),
                group_size=gs, actorder=self.actorder,
                static_groups=self.static_groups, percdamp=self.percdamp,
                n_out=n_out, seconds=self.seconds)
            del H
            node["weight"] = W_new.to(W.dtype)
            self.state(block_idx, name)["gptq"] = {
                "scales": scales, "zeros": zeros,
                "perm": perm if (self.actorder or n_out > 0) else None,
                "group_size": gs if gs > 0 else W.shape[1],
                "n_out": n_out}

    def _transform_experts(self, block_idx, name, node, input_feat, gs):
        raise NotImplementedError("GPTQ over stacked MoE experts is not "
                                  "ported: ROADMAP A9")

    # ------------------------------------------------------------------
    def w_qdq(self, w: torch.Tensor, block_idx: int,
              name: str) -> torch.Tensor:
        """The searched group qparams applied statically, in the permuted
        column order; OWQ's trailing columns kept in float."""
        st = self.layer_state[block_idx].get(name, {})
        if "gptq" not in st:
            return super().w_qdq(w, block_idx, name)
        g = st["gptq"]
        gs = g["group_size"]
        oc, cols = w.shape
        wf = w.float()
        if g["perm"] is not None:
            wf = wf[:, g["perm"]]
        wg = wf.reshape(oc, cols // gs, gs)
        s, z = g["scales"][:, :, None], g["zeros"][:, :, None]
        q = (torch.round(wg / s) + z).clamp(self.wspec.qmin,
                                            self.wspec.qmax)
        dq = ((q - z) * s).reshape(oc, cols)
        if g.get("n_out", 0):
            keep_fp = torch.arange(cols, device=w.device) >= cols - g["n_out"]
            dq = torch.where(keep_fp[None, :], wf, dq)
        if g["perm"] is not None:
            dq = dq[:, torch.argsort(g["perm"])]
        return dq.to(w.dtype)

    # ------------------------------------------------------------------
    def block_transform(self, block_idx, input_feat):
        """``true_sequential``: each subset's inputs re-collected through
        the already-quantized earlier subsets."""
        bp = self.model.blocks[block_idx]
        finalized: List[str] = []
        for subset in self.model.get_subsets_in_block(block_idx):
            if self.true_sequential and finalized:
                lf = self._partial_fq_linear(block_idx, finalized)
                input_feat.update(self.collect_block_io(block_idx,
                                                        linear_fn=lf)[0])
            self.subset_transform(block_idx, bp, subset, input_feat)
            finalized.extend(subset.layers)

    def _partial_fq_linear(self, block_idx: int, finalized: List[str]):
        names = set(finalized)

        def lf(name, w, b, x):
            if name in names:
                w = self.w_qdq(w, block_idx, name)
            return A.default_linear(name, w, b, x)

        return lf
