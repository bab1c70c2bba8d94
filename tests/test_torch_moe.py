"""Port parity: the MoE parts of the Llama architecture (``MoESpec``,
``moe_route``, the stacked-expert init and the MoE block forward) and the
MoE linear names of the Llama adapter against lightcompress_tpu (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.models import arch as TA

DIMS = dict(family="llama", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, rope_theta=1e6, rms_eps=1e-5)
# Mixtral's routing; DeepSeek-V3's (sigmoid, selection bias, group-limited
# top-k, scaled); sigmoid without the normalisation; Qwen-MoE's softmax
# without it, with shared experts
MOES = {
    "mixtral": dict(num_experts=8, top_k=2, moe_intermediate_size=32),
    "deepseek_v3": dict(num_experts=8, top_k=2, moe_intermediate_size=32,
                        num_shared_experts=1, gating="sigmoid",
                        routed_scaling_factor=2.5, n_group=4, topk_group=2),
    "sigmoid_raw": dict(num_experts=6, top_k=3, moe_intermediate_size=32,
                        gating="sigmoid", norm_topk_prob=False),
    "softmax_shared": dict(num_experts=4, top_k=2, moe_intermediate_size=32,
                           num_shared_experts=2, norm_topk_prob=False),
}


def _route(name, lf, bias=None):
    jm, tm = JA.MoESpec(**MOES[name]), TA.MoESpec(**MOES[name])
    ji, jw = JA.moe_route(jm, jnp.asarray(lf),
                          None if bias is None else jnp.asarray(bias))
    ti, tw = TA.moe_route(tm, torch.from_numpy(lf),
                          None if bias is None else torch.from_numpy(bias))
    return np.asarray(ji), np.asarray(jw), ti.numpy(), tw.numpy()


@pytest.mark.parametrize("name", sorted(MOES))
def test_moe_route_matches_jax(name):
    """The same experts in the same order; combination weights within
    1e-6 (f32 softmax/sigmoid and sums in other orders)."""
    rng = np.random.RandomState(0)
    E = MOES[name]["num_experts"]
    lf = (rng.randn(37, E) * 2).astype(np.float32)
    bias = (rng.randn(E) * 0.1).astype(np.float32) \
        if name == "deepseek_v3" else None
    ji, jw, ti, tw = _route(name, lf, bias)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["mixtral", "deepseek_v3"])
def test_moe_route_ties_match_jax(name):
    """Exact ties among the logits (and, group-limited, among the group
    scores): the lower index first, as jax.lax.top_k orders them."""
    E = MOES[name]["num_experts"]
    lf = np.zeros((5, E), np.float32)
    lf[1, [2, 5, 6]] = 1.0       # three-way tie for the top two
    lf[2, :] = 0.5               # every expert tied
    lf[3, [7, 0]] = [3.0, 3.0]   # a tie at both ends
    lf[4, [1, 3, 4, 6]] = 2.0    # tied groups (DeepSeek: groups of 2)
    ji, jw, ti, tw = _route(name, lf)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    vals = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0]])
    assert TA._top_k(vals, 3)[1].tolist() == [[1, 2, 4]]


def _models(moe, dtype, seed=3, sharpen=8.0):
    dims = dict(DIMS, moe=JA.MoESpec(**MOES[moe]))
    jarch = JA.ArchSpec(**dims, dtype=dtype)
    jparams = JA.init_params(jax.random.PRNGKey(seed), jarch)
    for bp in jparams["blocks"]:
        # sharpened router logits keep the top-k away from near-ties
        bp["mlp"]["router"]["weight"] = bp["mlp"]["router"]["weight"] \
            * sharpen
        if MOES[moe].get("gating") == "sigmoid":
            bp["mlp"]["router_bias"] = jnp.asarray(
                np.random.RandomState(seed).randn(
                    MOES[moe]["num_experts"]).astype(np.float32) * 0.01)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(
        dict(DIMS, moe=dict(MOES[moe])),
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return JLlama(jarch, jparams), Llama(tarch, tparams)


@pytest.mark.parametrize("moe", ["mixtral", "deepseek_v3"])
def test_moe_forward_matches_jax_f32(moe):
    """The MoE block forward (every expert on every token, the router's
    top-k combine, the shared experts) on the same f32 weights."""
    jm, tm = _models(moe, jnp.float32)
    ids = np.random.RandomState(1).randint(0, 128, (2, 12))
    ref = np.asarray(JA.model_forward(jm.arch, jm.params, jnp.asarray(ids)))
    got = tm.forward(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_moe_forward_matches_jax_bf16():
    """bf16 (Mixtral's routing): the router logits are rounded to bf16 as
    a linear's are; sums run in other orders, so the bound is that of the
    dense bf16 test."""
    jm, tm = _models("mixtral", jnp.bfloat16)
    ids = np.random.RandomState(2).randint(0, 128, (2, 12))
    ref = np.asarray(JA.model_forward(jm.arch, jm.params, jnp.asarray(ids)),
                     np.float32)
    got = tm.forward(torch.from_numpy(ids)).float().numpy()
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.999


@pytest.mark.parametrize("moe", ["mixtral", "deepseek_v3"])
def test_moe_linear_names_and_init_match_jax(moe):
    """The adapter lists JAX's linear names in JAX's order (the router
    first, the shared experts where present), and init_params gives the
    JAX tree of shapes and dtypes, the stacked experts at scale
    sqrt(2 / (H + I))."""
    jm, tm = _models(moe, jnp.bfloat16)
    for i in range(jm.num_blocks):
        assert tm.get_block_linear_names(i) == jm.get_block_linear_names(i)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = TA.init_params(gen, tm.arch)
    jl = jax.tree_util.tree_leaves_with_path(JA.init_params(
        jax.random.PRNGKey(0), jm.arch))
    tl = jax.tree_util.tree_leaves_with_path(own)
    assert sorted((jax.tree_util.keystr(p), tuple(a.shape)) for p, a in jl) \
        == sorted((jax.tree_util.keystr(p), tuple(t.shape)) for p, t in tl)
    m = MOES[moe]
    gate = own["blocks"][0]["mlp"]["gate"]["weight"].float()
    want = (2.0 / (DIMS["hidden_size"] + m["moe_intermediate_size"])) ** 0.5
    assert abs(float(gate.std()) / want - 1) < 0.05
    assert abs(float(own["blocks"][0]["mlp"]["router"]["weight"].float()
                     .std()) / 0.02 - 1) < 0.1


def test_arch_refuses_mla():
    with pytest.raises(ValueError, match="MLA"):
        convert.arch_from_fields(dict(DIMS, mla=dict(kv_lora_rank=16)))
