"""A Hugging Face ``config.json`` (as a dict) -> the port's ``ArchSpec``
(port of ``arch_from_hf_config`` in lightcompress_tpu/models/hf_loader.py,
for the dense llama-like types ``llama``, ``mistral``, ``qwen2`` (q/k/v
biases) and ``qwen3`` (``qk_norm``), with the llama3 rope scaling, and the
mixture-of-experts ``mixtral`` and ``qwen3_moe``).

Every other ``model_type`` raises ``NotImplementedError`` naming ROADMAP
A12, as do a non-SiLU activation, a config with ``kv_lora_rank`` (MLA) and
a Qwen3-MoE config whose layers are not all MoE (``mlp_only_layers``,
``decoder_sparse_step``): the JAX package reads neither field and would
build every layer as MoE.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .arch import ArchSpec, MoESpec

DENSE_TYPES = ("llama", "mistral", "qwen2", "qwen3")
MOE_TYPES = ("mixtral", "qwen3_moe")
MODEL_TYPES = DENSE_TYPES + MOE_TYPES


def llama3_rope(cfg: Dict[str, Any]) -> Optional[Tuple]:
    """(factor, low_freq_factor, high_freq_factor, original_max_position_
    embeddings) of a ``llama3`` ``rope_scaling``; None otherwise."""
    rs = cfg.get("rope_scaling") or {}
    if rs.get("rope_type", rs.get("type")) != "llama3":
        if rs:
            raise NotImplementedError(
                f"rope_scaling {rs} is not ported: ROADMAP A12")
        return None
    return (rs["factor"], rs["low_freq_factor"], rs["high_freq_factor"],
            rs["original_max_position_embeddings"])


def arch_from_hf_config(cfg: Dict[str, Any],
                        dtype: torch.dtype = torch.bfloat16) -> ArchSpec:
    mt = cfg.get("model_type", "llama")
    if mt not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported; the port reads "
            f"{MODEL_TYPES} (ROADMAP A12)")
    if cfg.get("kv_lora_rank"):
        raise NotImplementedError("MLA (kv_lora_rank) is not ported: "
                                  "ROADMAP A9")
    if cfg.get("mlp_only_layers") or cfg.get("decoder_sparse_step", 1) != 1:
        raise NotImplementedError(
            "dense layers among the MoE layers (mlp_only_layers, "
            "decoder_sparse_step) are not ported: ROADMAP A12")
    if cfg.get("hidden_act", "silu") != "silu":
        raise NotImplementedError(
            f"hidden_act {cfg['hidden_act']!r} is not ported: ROADMAP A12")
    n_heads = cfg["num_attention_heads"]
    moe = None
    if mt == "mixtral":
        moe = MoESpec(num_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      moe_intermediate_size=cfg["intermediate_size"],
                      gating="softmax", norm_topk_prob=True)
    elif mt == "qwen3_moe":
        moe = MoESpec(num_experts=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      moe_intermediate_size=cfg["moe_intermediate_size"],
                      gating="softmax",
                      norm_topk_prob=cfg.get("norm_topk_prob", False))
    return ArchSpec(
        family="llama",
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=n_heads,
        num_kv_heads=cfg.get("num_key_value_heads", n_heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // n_heads,
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        attn_bias=mt == "qwen2" or cfg.get("attention_bias", False),
        mlp_bias=cfg.get("mlp_bias", False),
        qk_norm=mt in ("qwen3", "qwen3_moe"),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        moe=moe,
        rope_llama3=llama3_rope(cfg),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        dtype=dtype,
    )
