"""Llama architecture: spec, random init and forward passes (port of
lightcompress_tpu/models/arch.py, the ``llama`` family, dense or with a
mixture-of-experts MLP (``MoESpec``), with Qwen3's per-head RMSNorm of q
and k (``qk_norm``) and the llama3 rope scaling (``rope_llama3``); no MLA).

Parameters are nested dicts of tensors in the JAX package's layout:
weights are (out_features, in_features) and matmuls are ``x @ W.T``.
Prefill attention is plain torch ops, as it is plain XLA in JAX.

Every linear goes through a ``LinearFn`` ``(name, w, b, x) -> y``
(``default_linear`` unless the caller swaps it, as calibration and fake
quant do), and the block forward returns the input of every linear by its
canonical name (``feats``), the inputs the calibration algorithms read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..device import div

# linear_fn(name, w, b, x) -> y: the swap point of calibration and fake
# quant (the JAX ``LinearFn``)
LinearFn = Callable[[str, torch.Tensor, Optional[torch.Tensor],
                     torch.Tensor], torch.Tensor]


def default_linear(name: str, w: torch.Tensor, b: Optional[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T (+ b)`` with f32 accumulation, result in ``x.dtype``.
    A stacked (E, out, in) expert weight (no bias) gives (E, ..., out):
    every expert on the same x, or on its own slice when x carries the
    expert dim first (the down projection's (E, B, T, in) input), as
    JAX's ``default_linear``."""
    w = w.to(x.dtype)
    if w.dim() == 3:
        E = w.shape[0]
        xe = x if x.dim() == 4 and x.shape[0] == E else x.unsqueeze(0)
        y = torch.matmul(xe.reshape(xe.shape[0], -1, x.shape[-1]),
                         w.transpose(1, 2))
        return y.reshape(E, *xe.shape[1:-1], w.shape[1])
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b
    return y


def _call(linear_fn: LinearFn, name: str, p: Dict,
          x: torch.Tensor) -> torch.Tensor:
    """``linear_fn`` on the linear ``p`` whose canonical name is ``name``."""
    return linear_fn(name, p["weight"], p.get("bias"), x)


def resolve(tree: Dict, dotted: str) -> Dict:
    """The node at a canonical path: ``attn.q`` is tree['attn']['q']."""
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts MLP config (mixtral, qwen2_moe, deepseek).
    Experts are stored stacked (E, out, in)."""

    num_experts: int
    top_k: int
    moe_intermediate_size: int
    num_shared_experts: int = 0
    gating: str = "softmax"  # 'softmax' (mixtral) | 'sigmoid' (deepseek-v3)
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # deepseek-v3 group-limited routing
    n_group: int = 1
    topk_group: int = 1


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
    # Qwen3: RMSNorm of each q and k head (gammas (head_dim,)) before rope
    qk_norm: bool = False
    tie_word_embeddings: bool = False
    act_fn: str = "silu"
    moe: Optional[MoESpec] = None
    # llama3 rope scaling (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = off
    rope_llama3: Optional[Tuple[float, float, float, int]] = None
    # the config's max_position_embeddings, recorded (serving checkpoints
    # write it); the forwards build their rope tables from the positions
    max_position_embeddings: int = 4096
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.family != "llama":
            raise ValueError("only the llama family is ported (dense or "
                             "MoE, no MLA)")


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


def _moe_params(gen: torch.Generator, arch: ArchSpec) -> Dict:
    """Router (E, H) * 0.02; stacked gate/up (E, I, H) and down (E, H, I)
    at scale sqrt(2 / (H + I)); shared experts of width I * shared."""
    m, h, dt = arch.moe, arch.hidden_size, arch.dtype
    mi, E = m.moe_intermediate_size, m.num_experts
    scale = (2.0 / (h + mi)) ** 0.5
    mp = {"router": {"weight": _normal(gen, (E, h), 0.02, dt)},
          "gate": {"weight": _normal(gen, (E, mi, h), scale, dt)},
          "up": {"weight": _normal(gen, (E, mi, h), scale, dt)},
          "down": {"weight": _normal(gen, (E, h, mi), scale, dt)}}
    if m.num_shared_experts > 0:
        si = mi * m.num_shared_experts
        mp["shared_gate"] = _lin(gen, si, h, False, dt)
        mp["shared_up"] = _lin(gen, si, h, False, dt)
        mp["shared_down"] = _lin(gen, h, si, False, dt)
    return mp


def init_block_params(gen: torch.Generator, arch: ArchSpec) -> Dict:
    h, i = arch.hidden_size, arch.intermediate_size
    qd = arch.num_heads * arch.head_dim
    kvd = arch.num_kv_heads * arch.head_dim
    dt, dev = arch.dtype, gen.device
    bp = {
        "ln1": {"weight": torch.ones((h,), dtype=dt, device=dev)},
        "ln2": {"weight": torch.ones((h,), dtype=dt, device=dev)},
        "attn": {
            "q": _lin(gen, qd, h, arch.attn_bias, dt),
            "k": _lin(gen, kvd, h, arch.attn_bias, dt),
            "v": _lin(gen, kvd, h, arch.attn_bias, dt),
            "o": _lin(gen, h, qd, False, dt),
        },
    }
    if arch.qk_norm:
        for name in ("q_norm", "k_norm"):
            bp["attn"][name] = {"weight": torch.ones(
                (arch.head_dim,), dtype=dt, device=dev)}
    if arch.moe is not None:
        bp["mlp"] = _moe_params(gen, arch)
    else:
        bp["mlp"] = {
            "gate": _lin(gen, i, h, arch.mlp_bias, dt),
            "up": _lin(gen, i, h, arch.mlp_bias, dt),
            "down": _lin(gen, h, i, arch.mlp_bias, dt),
        }
    return bp


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


def _llama3_inv_freq(inv_freq: torch.Tensor, rope: Tuple) -> torch.Tensor:
    """HF's ``llama3`` rope init: the low frequencies divided by ``factor``,
    a smooth ramp between the two wavelength cutoffs (every division a
    true f32 division, as JAX's)."""
    factor, lo_f, hi_f, orig_max = rope
    wavelen = torch.full_like(inv_freq, 2 * math.pi) / inv_freq
    lo_wl, hi_wl = orig_max / lo_f, orig_max / hi_f
    smooth = div(torch.full_like(wavelen, orig_max) / wavelen - lo_f,
                 hi_f - lo_f)
    smoothed = div((1 - smooth) * inv_freq, factor) + smooth * inv_freq
    return torch.where(wavelen > lo_wl, div(inv_freq, factor),
                       torch.where(wavelen < hi_wl, inv_freq, smoothed))


def rope_cos_sin(arch: ArchSpec, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-Llama rotary tables; positions (T,) or (B, T) -> (..., T, D)."""
    d = arch.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    inv_freq = 1.0 / (arch.rope_theta ** exps)
    if arch.rope_llama3 is not None:
        inv_freq = _llama3_inv_freq(inv_freq, arch.rope_llama3)
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def qk_normed(arch: ArchSpec, norms: Dict, q: torch.Tensor,
              k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (B, H, T, D) after the per-head RMSNorm of ``qk_norm``
    (``norms`` holds ``q_norm`` and ``k_norm``); unchanged without it."""
    if not arch.qk_norm:
        return q, k
    return (rmsnorm(q, norms["q_norm"]["weight"], arch.rms_eps),
            rmsnorm(k, norms["k_norm"]["weight"], arch.rms_eps))


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
         mask: Optional[torch.Tensor], kv_groups: int = 1,
         matmul_hook: Optional[Callable] = None,
         softmax_hook: Optional[Callable] = None) -> torch.Tensor:
    """Grouped-query attention; q (B, H, Tq, D), k/v (B, Hkv, Tk, D).

    Products and sums in f32 (bf16 inputs are exact in f32), softmax in
    f32, probabilities cast to q's dtype (the JAX version's value dtype)
    before the second product.  The repeated K/V are never materialised:
    queries are grouped by their KV head instead.  The act-quant hooks:
    ``matmul_hook(which, a, b) -> (a, b)`` on q and k ("qk") and on the
    probabilities and v ("pv"), ``softmax_hook(p)`` on the probabilities
    (the JAX ``sdpa``'s)."""
    B, H, Tq, D = q.shape
    nkv = H // kv_groups
    if matmul_hook is not None:
        q, k = matmul_hook("qk", q, k.to(q.dtype))
    qg = q.float().reshape(B, nkv, kv_groups * Tq, D)
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) * D ** -0.5
    scores = scores.reshape(B, H, Tq, -1)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    if softmax_hook is not None:
        probs = softmax_hook(probs)
    if matmul_hook is not None:
        probs, v = matmul_hook("pv", probs, v.to(q.dtype))
    probs = probs.to(q.dtype).float()
    out = torch.matmul(probs.reshape(B, nkv, kv_groups * Tq, -1),
                       v.to(q.dtype).float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# block and model forwards (each returns or records the input of every
# linear: the calibration's feats)
# ---------------------------------------------------------------------------

def _attention(arch: ArchSpec, ap: Dict, h1: torch.Tensor, cos, sin,
               mask: Optional[torch.Tensor], linear_fn: LinearFn,
               hooks: Tuple = (None, None),
               kv_hook: Optional[Callable] = None):
    """q/k/v, qk_norm, rope and attention on the normed x; returns the
    context (B, T, nh*hd) before ``attn.o`` and the post-rope (k, v).
    ``kv_hook(k, v) -> (k, v)`` (the KV-cache fake quant) changes the K/V
    the attention reads, not the returned ones."""
    B, T, _ = h1.shape
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    q, k, v = (_call(linear_fn, "attn." + n, ap[n], h1)
               .reshape(B, T, -1, hd).transpose(1, 2)
               for n in ("q", "k", "v"))
    q, k = qk_normed(arch, ap, q, k)
    if cos is not None:
        q, k = apply_rope(q, k, cos, sin)
    kv = (k, v)
    if kv_hook is not None:
        k, v = kv_hook(k, v)
    ctx = sdpa(q, k, v, mask, nh // nkv, *hooks)
    return ctx.transpose(1, 2).reshape(B, T, nh * hd), kv


def _mlp_tail(arch: ArchSpec, bp: Dict, h: torch.Tensor,
              linear_fn: LinearFn, feats: Dict[str, torch.Tensor]):
    """The MLP half of a block after the attention residual."""
    h2 = apply_norm(h, bp["ln2"], arch)
    feats["mlp.gate"] = h2
    feats["mlp.up"] = h2
    return h + mlp_forward(arch, bp["mlp"], h2, linear_fn, feats)


def block_forward(arch: ArchSpec, bp: Dict, x: torch.Tensor, cos, sin,
                  mask: Optional[torch.Tensor],
                  linear_fn: LinearFn = default_linear,
                  hooks: Tuple = (None, None),
                  kv_hook: Optional[Callable] = None):
    """One block on (B, T, H).  Returns (y, feats, (k, v)): ``feats`` maps
    each linear's canonical name to its input, k/v are post-rope.
    ``hooks``: the attention's (matmul_hook, softmax_hook); ``kv_hook``:
    the KV-cache fake quant."""
    feats: Dict[str, torch.Tensor] = {}
    h1 = apply_norm(x, bp["ln1"], arch)
    for n in ("attn.q", "attn.k", "attn.v"):
        feats[n] = h1
    ctx, kv = _attention(arch, bp["attn"], h1, cos, sin, mask, linear_fn,
                         hooks, kv_hook)
    feats["attn.o"] = ctx
    h = x + _call(linear_fn, "attn.o", bp["attn"]["o"], ctx)
    return _mlp_tail(arch, bp, h, linear_fn, feats), feats, kv


def mlp_forward(arch: ArchSpec, mp: Dict, x: torch.Tensor,
                linear_fn: LinearFn = default_linear,
                feats: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The block's MLP on the normed x: the MoE MLP where the block has a
    router, else the gated dense MLP (JAX's ``mlp_inspect``)."""
    if arch.moe is not None and "router" in mp:
        if feats is not None:
            feats["mlp.router"] = x
        return moe_mlp_forward(arch, mp, x, linear_fn, feats)
    mid = _act(_call(linear_fn, "mlp.gate", mp["gate"], x), arch.act_fn) \
        * _call(linear_fn, "mlp.up", mp["up"], x)
    if feats is not None:
        feats["mlp.down"] = mid
    return _call(linear_fn, "mlp.down", mp["down"], mid)


def attn_inspect(arch: ArchSpec, bp: Dict, x: torch.Tensor, cos, sin,
                 mask: Optional[torch.Tensor],
                 linear_fn: LinearFn = default_linear) -> torch.Tensor:
    """The attention sub-forward on the post-ln1 x, through ``attn.o``
    (AWQ's re-run of the q/k/v subset)."""
    ctx, _ = _attention(arch, bp["attn"], x, cos, sin, mask, linear_fn)
    return _call(linear_fn, "attn.o", bp["attn"]["o"], ctx)


def mlp_inspect(arch: ArchSpec, bp: Dict, x: torch.Tensor,
                linear_fn: LinearFn = default_linear) -> torch.Tensor:
    """The MLP sub-forward on the post-ln2 x."""
    return mlp_forward(arch, bp["mlp"], x, linear_fn)


def linear_inspect(bp: Dict, name: str, x: torch.Tensor,
                   linear_fn: LinearFn = default_linear) -> torch.Tensor:
    return _call(linear_fn, name, resolve(bp, name), x)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order for ties on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(m: MoESpec, lf: torch.Tensor,
              router_bias: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router selection from (n, E) f32 logits -> (topi (n, k) int64,
    topw (n, k) f32): softmax or sigmoid scores; the selection bias added
    to the selection scores only; group-limited top-k (the top
    ``topk_group`` of ``n_group`` groups, each scored by the sum of its
    two best); ``norm_topk_prob`` and ``routed_scaling_factor`` on the
    combination weights, which are the raw scores."""
    if m.gating == "sigmoid":
        scores = torch.sigmoid(lf)
    else:
        scores = torch.softmax(lf, dim=-1)
    sel = scores
    if router_bias is not None:
        sel = sel + router_bias.float()[None, :]
    if m.n_group > 1:
        n = sel.shape[0]
        gsize = m.num_experts // m.n_group
        grouped = sel.reshape(n, m.n_group, gsize)
        group_scores = _top_k(grouped, 2)[0].sum(dim=-1)
        gidx = _top_k(group_scores, m.topk_group)[1]
        gmask = torch.zeros((n, m.n_group), dtype=torch.float32,
                            device=sel.device).scatter_(1, gidx, 1.0)
        sel = torch.where(gmask.repeat_interleave(gsize, dim=1) > 0, sel,
                          float("-inf"))
    topi = _top_k(sel, m.top_k)[1]
    topw = torch.gather(scores, -1, topi)
    if m.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return topi, topw * m.routed_scaling_factor


def moe_mlp_forward(arch: ArchSpec, mp: Dict, x: torch.Tensor,
                    linear_fn: LinearFn = default_linear,
                    feats: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Mixture-of-experts MLP on (B, T, H): every expert computed on every
    token (stacked matmuls; the router logits rounded to x's dtype as a
    linear's are), then combined in f32 by the router's top-k weights;
    plus the shared experts where the block has them."""
    m = arch.moe
    B, T, H = x.shape

    def lin(name, t):
        return _call(linear_fn, "mlp." + name, mp[name], t)

    lf = lin("router", x).reshape(-1, m.num_experts).float()
    topi, topw = moe_route(m, lf, mp.get("router_bias"))
    g = lin("gate", x)  # (E, B, T, I)
    u = lin("up", x)
    mid = _act(g, arch.act_fn) * u
    if feats is not None:
        feats["mlp.down"] = mid
    d = lin("down", mid)  # (E, B, T, H)
    n = B * T
    w_full = torch.zeros((n, m.num_experts), dtype=torch.float32,
                         device=x.device).scatter_(1, topi, topw)
    y = torch.einsum("enh,ne->nh",
                     d.reshape(m.num_experts, n, H).float(),
                     w_full).reshape(B, T, H).to(x.dtype)
    if "shared_gate" in mp:
        smid = _act(lin("shared_gate", x), arch.act_fn) * lin("shared_up", x)
        if feats is not None:
            feats["mlp.shared_gate"] = feats["mlp.shared_up"] = x
            feats["mlp.shared_down"] = smid
        y = y + lin("shared_down", smid)
    return y


def head_forward(arch: ArchSpec, params: Dict, x: torch.Tensor
                 ) -> torch.Tensor:
    x = apply_norm(x, params["norm"], arch)
    w = (params["embed"]["weight"] if arch.tie_word_embeddings
         else params["lm_head"]["weight"])
    return torch.matmul(x.float(), w.float().t())


def embed_forward(arch: ArchSpec, params: Dict,
                  input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"]["weight"][input_ids]


def model_forward(arch: ArchSpec, params: Dict, input_ids: torch.Tensor,
                  linear_fns: Optional[List[LinearFn]] = None,
                  matmul_hook: Optional[Callable] = None,
                  softmax_hook: Optional[Callable] = None,
                  kv_hooks: Optional[List[Optional[Callable]]] = None
                  ) -> torch.Tensor:
    """Full causal-LM forward returning float32 logits (B, T, V);
    ``linear_fns`` gives each block its ``LinearFn``, ``kv_hooks`` each
    its KV-cache fake quant; the hooks quantize inside every attention
    (``sdpa``)."""
    T = input_ids.shape[1]
    dev = input_ids.device
    x = embed_forward(arch, params, input_ids)
    mask = causal_mask(T, T, device=dev)
    cos, sin = rope_cos_sin(arch, torch.arange(T, device=dev))
    for idx, bp in enumerate(params["blocks"]):
        lf = linear_fns[idx] if linear_fns is not None else default_linear
        kh = kv_hooks[idx] if kv_hooks is not None else None
        x = block_forward(arch, bp, x, cos, sin, mask, lf,
                          (matmul_hook, softmax_hook), kh)[0]
    return head_forward(arch, params, x)
