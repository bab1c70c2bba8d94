"""Perplexity, decode perplexity and token consistency (port of
lightcompress_tpu/eval/ppl.py).

The model is an adapter (``models.base.BaseModel``); its forward runs on
its own device in the current deployment.  The decode PPL feeds one token
at a time through a fixed-length K/V buffer and the model's KV hooks.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Mean token cross entropy in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return float(-ll.mean())


def _windows(testenc: np.ndarray, seq_len: int, bs: int):
    """(i, j, ids (j - i, seq_len)) over the stride-``seq_len`` windows."""
    nsamples = testenc.size // seq_len
    for i in range(0, nsamples, bs):
        j = min(i + bs, nsamples)
        yield i, j, testenc[:, i * seq_len:j * seq_len].reshape(j - i,
                                                                 seq_len)


class PerplexityEval:
    """Stride-``seq_len`` PPL over a flat token stream (1, n)."""

    def __init__(self, testenc: np.ndarray, seq_len: int = 2048,
                 bs: int = 1, inference_per_block: bool = False):
        if inference_per_block:
            raise NotImplementedError("inference_per_block (the streamed "
                                      "forward) is not ported: ROADMAP A12")
        self.testenc = testenc
        self.seq_len = seq_len
        self.bs = bs

    @torch.no_grad()
    def eval(self, model) -> float:
        seq_len = self.seq_len
        nsamples = self.testenc.size // seq_len
        total_nll = 0.0
        for i, j, ids in _windows(self.testenc, seq_len, self.bs):
            ids = torch.from_numpy(np.ascontiguousarray(ids)).to(
                model.device)
            logits = model.forward(ids)
            nll = _cross_entropy(logits[:, :-1, :], ids[:, 1:])
            # the reference's weighting: the mean over seq_len - 1 tokens
            # times seq_len
            total_nll += nll * seq_len * (j - i)
        return math.exp(total_nll / (nsamples * seq_len))


class TokenConsistencyEval:
    """Argmax-token agreement between two deployments of one model."""

    def __init__(self, testenc: np.ndarray, seq_len: int = 2048,
                 bs: int = 1):
        self.testenc = testenc
        self.seq_len = seq_len
        self.bs = bs

    @torch.no_grad()
    def eval(self, model_quant, model_origin) -> float:
        consistent = total = 0
        for _, _, ids in _windows(self.testenc, self.seq_len, self.bs):
            ids = torch.from_numpy(np.ascontiguousarray(ids))
            p1 = model_origin.forward(ids).argmax(dim=-1)
            p2 = model_quant.forward(ids).argmax(dim=-1).to(p1.device)
            consistent += int((p1 == p2).sum())
            total += p1.numel()
        return consistent / total


class DecodePerplexityEval:
    """Token-by-token PPL through a K/V cache, the path the KV-cache fake
    quant changes: preallocated (1, Hkv, max_len, D) buffers a block and a
    position; every step writes its K/V at the position, runs the block's
    KV hook on the whole buffer and attends with the keys past the
    position masked.  As the JAX package's, the step takes the plain float
    linears (not the deployment's act quant or online rotations) and the
    model's ``kv_hooks``."""

    def __init__(self, testenc: np.ndarray, num_eval_tokens=None,
                 max_len=None, num_samples=None):
        self.testenc = testenc
        self.num_eval_tokens = num_eval_tokens
        self.max_len = max_len
        self.num_samples = num_samples  # texts (rows) of a 2-D testenc

    @torch.no_grad()
    def eval(self, model) -> float:
        from ..models import arch as A

        te = np.asarray(self.testenc)
        if te.ndim == 2 and te.shape[0] > 1 and self.num_samples is not None:
            te = te[:self.num_samples]
        ids = te.reshape(-1)
        n = len(ids) - 1
        if self.num_eval_tokens is not None:
            n = min(n, self.num_eval_tokens)
        max_len = self.max_len or (n + 1)
        arch, params, dev = model.arch, model.params, model.device
        nb, nkv, hd = model.num_blocks, arch.num_kv_heads, arch.head_dim
        nh = arch.num_heads
        hooks = model.kv_hooks or [None] * nb
        dtype = params["embed"]["weight"].dtype
        kc = torch.zeros((nb, 1, nkv, max_len, hd), dtype=dtype, device=dev)
        vc = torch.zeros_like(kc)
        tok = torch.from_numpy(ids.astype(np.int64)).to(dev)
        j_idx = torch.arange(max_len, device=dev)
        neg = torch.finfo(torch.float32).min
        lin = A.default_linear
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for pos in range(n):
            x = A.embed_forward(arch, params, tok[pos].reshape(1, 1))
            cos, sin = A.rope_cos_sin(arch, tok.new_full((1,), pos))
            mask = torch.where(j_idx <= pos, 0.0, neg).float()
            for i in range(nb):
                bp = params["blocks"][i]
                ap = bp["attn"]
                h1 = A.apply_norm(x, bp["ln1"], arch)
                q, k, v = (lin(w, ap[w]["weight"], ap[w].get("bias"), h1)
                           .reshape(1, 1, -1, hd).transpose(1, 2)
                           for w in ("q", "k", "v"))
                q, k = A.qk_normed(arch, ap, q, k)
                q, k = A.apply_rope(q, k, cos, sin)
                kc[i, :, :, pos] = k[:, :, 0].to(dtype)
                vc[i, :, :, pos] = v[:, :, 0].to(dtype)
                k_use, v_use = kc[i], vc[i]
                if hooks[i] is not None:
                    k_use, v_use = hooks[i](k_use, v_use)
                ctx = A.sdpa(q, k_use, v_use, mask, nh // nkv)
                ctx = ctx.transpose(1, 2).reshape(1, 1, nh * hd)
                h = x + lin("o", ap["o"]["weight"], ap["o"].get("bias"), ctx)
                x = h + A.mlp_forward(arch, bp["mlp"],
                                      A.apply_norm(h, bp["ln2"], arch))
            logits = A.head_forward(arch, params, x)[0, 0]
            logp = torch.log_softmax(logits.float(), dim=-1)
            # the f32 terms summed in f64 (JAX's Python float sum)
            total -= logp[tok[pos + 1]].double()
        return math.exp(float(total) / n)
