"""Dense Llama architecture: spec, random init and forward passes (port of
lightcompress_tpu/models/arch.py, the ``llama`` family without MoE/MLA).

Parameters are nested dicts of tensors in the JAX package's layout:
weights are (out_features, in_features) and matmuls are ``x @ W.T``.
Prefill attention is plain torch ops, as it is plain XLA in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


def _linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T (+ b)`` with f32 accumulation, result in ``x.dtype``."""
    y = torch.matmul(x, p["weight"].to(x.dtype).t())
    if "bias" in p:
        y = y + p["bias"]
    return y


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    family: str  # 'llama' only in this slice
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    act_fn: str = "silu"
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.family != "llama":
            raise ValueError("only the dense llama family is ported")


# ---------------------------------------------------------------------------
# initialization (random models from a seeded generator; no download)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (t * scale).to(dtype)


def _lin(gen, out_f, in_f, bias, dtype):
    p = {"weight": _normal(gen, (out_f, in_f), (2.0 / (in_f + out_f)) ** 0.5,
                           dtype)}
    if bias:
        p["bias"] = torch.zeros((out_f,), dtype=dtype, device=gen.device)
    return p


def init_block_params(gen: torch.Generator, arch: ArchSpec) -> Dict:
    h, i = arch.hidden_size, arch.intermediate_size
    qd = arch.num_heads * arch.head_dim
    kvd = arch.num_kv_heads * arch.head_dim
    dt, dev = arch.dtype, gen.device
    return {
        "ln1": {"weight": torch.ones((h,), dtype=dt, device=dev)},
        "ln2": {"weight": torch.ones((h,), dtype=dt, device=dev)},
        "attn": {
            "q": _lin(gen, qd, h, arch.attn_bias, dt),
            "k": _lin(gen, kvd, h, arch.attn_bias, dt),
            "v": _lin(gen, kvd, h, arch.attn_bias, dt),
            "o": _lin(gen, h, qd, False, dt),
        },
        "mlp": {
            "gate": _lin(gen, i, h, arch.mlp_bias, dt),
            "up": _lin(gen, i, h, arch.mlp_bias, dt),
            "down": _lin(gen, h, i, arch.mlp_bias, dt),
        },
    }


def init_params(gen: torch.Generator, arch: ArchSpec) -> Dict:
    """Random parameters on ``gen.device``.  The numbers differ from the
    JAX package's ``jax.random`` ones; tests carry weights across with
    ``convert.params_from_numpy`` instead."""
    h, v, dt = arch.hidden_size, arch.vocab_size, arch.dtype
    params: Dict = {
        "embed": {"weight": _normal(gen, (v, h), 0.02, dt)},
        "blocks": [init_block_params(gen, arch)
                   for _ in range(arch.num_layers)],
        "norm": {"weight": torch.ones((h,), dtype=dt, device=gen.device)},
    }
    if not arch.tie_word_embeddings:
        params["lm_head"] = {"weight": _normal(gen, (v, h), 0.02, dt)}
    return params


# ---------------------------------------------------------------------------
# norms, activation, rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    xf = x.float()
    xn = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        xn = xn * w.float()
    return xn.to(x.dtype)


def apply_norm(x: torch.Tensor, np_: Dict, arch: ArchSpec) -> torch.Tensor:
    return rmsnorm(x, np_.get("weight"), arch.rms_eps)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        # jax.nn.silu's ops (x * 1/(1 + exp(-x))), each rounded to x's
        # dtype as JAX rounds them, jitted or not, on the CPU; F.silu
        # rounds once and differs in 39% of bf16 outputs.  Five launches
        # where F.silu takes one.
        return x * (1 + torch.exp(-x)).reciprocal()
    raise ValueError(f"activation {name!r} is not ported")


def rope_cos_sin(arch: ArchSpec, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-Llama rotary tables; positions (T,) or (B, T) -> (..., T, D)."""
    d = arch.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    inv_freq = 1.0 / (arch.rope_theta ** exps)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (B, H, T, D); cos/sin: (T, D) or (B, T, D)."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def causal_mask(t_q: int, t_k: int, device=None) -> torch.Tensor:
    i = torch.arange(t_q, device=device)[:, None]
    j = torch.arange(t_k, device=device)[None, :]
    neg = torch.finfo(torch.float32).min
    return torch.where(j <= i + (t_k - t_q), 0.0, neg).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], kv_groups: int = 1) -> torch.Tensor:
    """Grouped-query attention; q (B, H, Tq, D), k/v (B, Hkv, Tk, D).

    Products and sums in f32 (bf16 inputs are exact in f32), softmax in
    f32, probabilities cast to q's dtype (the JAX version's value dtype)
    before the second product.  The repeated K/V are never materialised:
    queries are grouped by their KV head instead."""
    B, H, Tq, D = q.shape
    nkv = H // kv_groups
    qg = q.float().reshape(B, nkv, kv_groups * Tq, D)
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) * D ** -0.5
    scores = scores.reshape(B, H, Tq, -1)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.matmul(probs.reshape(B, nkv, kv_groups * Tq, -1),
                       v.to(q.dtype).float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# block and model forwards
# ---------------------------------------------------------------------------

def block_forward(arch: ArchSpec, bp: Dict, x: torch.Tensor, cos, sin,
                  mask: Optional[torch.Tensor]):
    """One block on (B, T, H).  Returns (y, (k, v)) with k/v post-rope."""
    B, T, _ = x.shape
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    h1 = apply_norm(x, bp["ln1"], arch)
    ap, mp = bp["attn"], bp["mlp"]
    q, k, v = (_linear(ap[n], h1) for n in ("q", "k", "v"))
    q = q.reshape(B, T, nh, hd).transpose(1, 2)
    k = k.reshape(B, T, nkv, hd).transpose(1, 2)
    v = v.reshape(B, T, nkv, hd).transpose(1, 2)
    if cos is not None:
        q, k = apply_rope(q, k, cos, sin)
    ctx = sdpa(q, k, v, mask, kv_groups=nh // nkv)
    ctx = ctx.transpose(1, 2).reshape(B, T, nh * hd)
    h = x + _linear(ap["o"], ctx)
    h2 = apply_norm(h, bp["ln2"], arch)
    mid = _act(_linear(mp["gate"], h2), arch.act_fn) * _linear(mp["up"], h2)
    return h + _linear(mp["down"], mid), (k, v)


def head_forward(arch: ArchSpec, params: Dict, x: torch.Tensor
                 ) -> torch.Tensor:
    x = apply_norm(x, params["norm"], arch)
    w = (params["embed"]["weight"] if arch.tie_word_embeddings
         else params["lm_head"]["weight"])
    return torch.matmul(x.float(), w.float().t())


def embed_forward(arch: ArchSpec, params: Dict,
                  input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"]["weight"][input_ids]


def model_forward(arch: ArchSpec, params: Dict,
                  input_ids: torch.Tensor) -> torch.Tensor:
    """Full causal-LM forward returning float32 logits (B, T, V)."""
    T = input_ids.shape[1]
    dev = input_ids.device
    x = embed_forward(arch, params, input_ids)
    mask = causal_mask(T, T, device=dev)
    cos, sin = rope_cos_sin(arch, torch.arange(T, device=dev))
    for bp in params["blocks"]:
        x, _ = block_forward(arch, bp, x, cos, sin, mask)
    return head_forward(arch, params, x)
