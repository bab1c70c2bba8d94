"""Perplexity and token consistency (port of lightcompress_tpu/eval/ppl.py).

The model is an adapter (``models.base.BaseModel``); its forward runs on
its own device in the current deployment.  ``DecodePerplexityEval`` (the
KV-cache decode PPL) raises ``NotImplementedError`` naming ROADMAP A13.
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
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the decode PPL (KV-cache path) is not "
                                  "ported: ROADMAP A13")
