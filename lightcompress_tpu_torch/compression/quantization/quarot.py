"""QuaRot, a global orthogonal rotation of the residual stream (port of
lightcompress_tpu/compression/quantization/quarot.py).

Before the block loop: the head untied from the embedding, the embedding's
per-token mean removed, Q drawn (``rotate_mode``: ``hadamard``, a
randomised Hadamard, or ``random``, a QR orthogonal matrix), the embedding
and the head rotated (W @ Q) and the final norm's gamma folded into the
head.  Each block: every norm's gamma folded into the linears it feeds and
their input dims rotated (W @ Q); the output dims of o and down rotated
(Q^T @ W).  With ``online_rotate``, the exact Hadamard is baked into
down's input dim and, per head, into v's output dim, and the model's
``rotate_cfg`` rotates down's input (whole) and o's input (per head)
online.  In exact arithmetic the float forward is unchanged.

Q is drawn from a ``torch.Generator`` seeded with ``base.seed``; the JAX
package draws from ``jax.random`` (ROADMAP C, known differences).
``special.fp32_had`` is read and, as in the JAX package, unused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from ...models.base import resolve
from ...ops.hadamard import (apply_exact_had_to_linear, fwht,
                             random_hadamard_matrix, random_orthogonal_matrix)
from ...quant.quantizer import mean_xla
from ...registry import ALGO_REGISTRY
from .base import BaseBlockwiseQuantization


@ALGO_REGISTRY
class Quarot(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, input_batches,
                 padding_masks=None, config=None):
        super().__init__(model, quant_config, input_batches, padding_masks,
                         config)
        self.rotate_mode = self.special_config.get("rotate_mode", "hadamard")
        self.fp32_had = self.special_config.get("fp32_had", False)
        seed = ((config or {}).get("base", {}) or {}).get("seed", 0)
        self.gen = torch.Generator().manual_seed(int(seed))
        self.preprocess()

    # ------------------------------------------------------------------
    def preprocess(self) -> None:
        model = self.model
        params, arch = model.params, model.arch
        if arch.tie_word_embeddings:
            params["lm_head"] = {"weight": params["embed"]["weight"]}
            model.arch = arch = dataclasses.replace(
                arch, tie_word_embeddings=False)
        emb = params["embed"]
        W = emb["weight"].float()
        emb["weight"] = (W - mean_xla(W, -1, keepdim=True)).to(
            emb["weight"].dtype)
        n, dev = arch.hidden_size, model.device
        if self.rotate_mode == "hadamard":
            Q = random_hadamard_matrix(n, self.gen, dev)
        elif self.rotate_mode == "random":
            Q = random_orthogonal_matrix(n, self.gen, dev)
        else:
            raise ValueError(self.rotate_mode)
        self.Q = Q
        emb["weight"] = (emb["weight"].float() @ Q).to(emb["weight"].dtype)
        head = params["lm_head"]
        self._fuse_norm_into(params["norm"], [head])
        head["weight"] = (head["weight"].float() @ Q).to(head["weight"].dtype)

    @staticmethod
    def _fuse_norm_into(ln: Dict, fcs: List[Dict]) -> None:
        """The norm's gamma (and beta) folded into the linears it feeds;
        the norm left weightless."""
        lw = ln["weight"].float()
        lb = ln.get("bias")
        for fc in fcs:
            W = fc["weight"].float()
            fc["weight"] = (W * lw[None, :]).to(fc["weight"].dtype)
            if lb is not None:
                delta = W @ lb.float()
                if fc.get("bias") is not None:
                    fc["bias"] = (fc["bias"].float() + delta).to(
                        fc["bias"].dtype)
                else:
                    fc["bias"] = delta.to(fc["weight"].dtype)
        ln["weight"] = torch.ones_like(ln["weight"])
        if lb is not None:
            ln["bias"] = torch.zeros_like(lb)

    # ------------------------------------------------------------------
    def block_transform(self, block_idx, input_feat) -> None:
        bp = self.model.blocks[block_idx]
        hd = self.model.arch.head_dim
        Q = self.Q
        for subset in self.model.get_subsets_in_block(block_idx):
            layers = [resolve(bp, n) for n in subset.layers]
            if subset.prev_type == "norm":
                self._fuse_norm_into(resolve(bp, subset.prev_op), layers)
                for fc in layers:
                    fc["weight"] = (fc["weight"].float() @ Q).to(
                        fc["weight"].dtype)
                continue
            for fc in layers:
                fc["weight"] = (Q.T @ fc["weight"].float()).to(
                    fc["weight"].dtype)
                if fc.get("bias") is not None:
                    fc["bias"] = (Q.T @ fc["bias"].float()).to(
                        fc["bias"].dtype)
            if not self.online_rotate:
                continue
            name = subset.layers[0]
            if subset.is_mlp:
                # down: the exact Hadamard into the input dim, the whole
                # Hadamard online on its input
                layers[0]["weight"] = apply_exact_had_to_linear(
                    layers[0]["weight"], had_dim=-1, output=False)
                self.model.rotate_cfg[name] = ("full", 0)
            else:
                # o: the per-head Hadamard into v's output dim, online on
                # o's input head by head
                vp = resolve(bp, subset.prev_op)
                vp["weight"] = apply_exact_had_to_linear(
                    vp["weight"], had_dim=hd, output=True)
                if vp.get("bias") is not None:
                    b = fwht(vp["bias"].float().reshape(-1, hd)) * hd ** -0.5
                    vp["bias"] = b.reshape(-1).to(vp["bias"].dtype)
                self.model.rotate_cfg[name] = ("head", hd)
