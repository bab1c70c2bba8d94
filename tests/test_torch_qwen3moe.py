"""Port parity: Qwen3-MoE (``qwen3_moe``: qk_norm, 128 experts of width 768
whose down projection falls back to int8 per channel) against
lightcompress_tpu on the CPU: the config reader, the qk-norm block and
model forwards, the serving build, the grouped route with the int8 down
(kernel #10) and the dense route with the small-M kernel (#7), and the
reference fault that the gathered route reaches; the engine against the
JAX engine is in test_torch_qwen3moe_engine.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.models.base import Qwen3Moe as JQwen3Moe
from lightcompress_tpu.models.hf_loader import \
    arch_from_hf_config as j_arch_from_hf_config
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving import engine as j_engine
from lightcompress_tpu.serving import quantized_model as jqm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import (Qwen3Moe, arch_from_hf_config,
                                            init_params)
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.ops import moe_matmul as tm
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights)
from lightcompress_tpu_torch.serving import engine as t_engine
from lightcompress_tpu_torch.serving import quantized_model as tqm
from test_torch_serving_moe import _jax_dense, _jax_routing, _sw_to_port
from test_torch_serving import one_torch_thread  # noqa: F401

# Qwen/Qwen3-30B-A3B config.json
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 151643,
    "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 6144, "max_position_embeddings": 40960,
    "max_window_layers": 48, "mlp_only_layers": [],
    "model_type": "qwen3_moe", "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48,
    "num_key_value_heads": 4, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 151936}
# mistralai/Mixtral-8x7B-v0.1 config.json
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1e6, "router_aux_loss_coef": 0.02, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32000}


@pytest.mark.parametrize("cfg", [QWEN3_30B_A3B, MIXTRAL_8X7B],
                         ids=["qwen3_moe", "mixtral"])
def test_hf_config_matches_jax(cfg):
    """Every field of the port's ArchSpec equals the JAX reader's."""
    jarch = j_arch_from_hf_config(cfg)
    tarch = arch_from_hf_config(cfg)
    for f in dataclasses.fields(tarch):
        if f.name == "dtype":
            continue
        got, want = getattr(tarch, f.name), getattr(jarch, f.name)
        if f.name == "moe":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tarch.dtype == torch.bfloat16


def test_hf_config_qwen3_values():
    a = arch_from_hf_config(QWEN3_30B_A3B)
    assert (a.hidden_size, a.num_layers, a.num_heads, a.num_kv_heads,
            a.head_dim, a.vocab_size) == (2048, 48, 32, 4, 128, 151936)
    assert a.qk_norm and not a.attn_bias and not a.tie_word_embeddings
    assert (a.moe.num_experts, a.moe.top_k, a.moe.moe_intermediate_size,
            a.moe.norm_topk_prob) == (128, 8, 768, True)
    assert a.num_heads * a.head_dim == 4096 != a.hidden_size


@pytest.mark.parametrize("change", [
    dict(model_type="phi3"), dict(model_type="qwen2_moe"),
    dict(model_type="deepseek_v2", kv_lora_rank=512),
    dict(kv_lora_rank=512), dict(mlp_only_layers=[0]),
    dict(decoder_sparse_step=2)])
def test_hf_config_refuses_what_is_not_ported(change):
    with pytest.raises(NotImplementedError):
        arch_from_hf_config(dict(QWEN3_30B_A3B, **change))


# ---------------------------------------------------------------------------
# a small Qwen3-MoE: q wider than hidden (16 heads of 128), 4 experts of
# width 384, top-2: gate/up planes (ic 1024, oc 384), the down int8 per
# channel (ic 384)
# ---------------------------------------------------------------------------

DIMS = dict(family="llama", vocab_size=256, hidden_size=1024,
            intermediate_size=2048, num_layers=2, num_heads=16,
            num_kv_heads=2, head_dim=128, rope_theta=1e6, rms_eps=1e-6,
            qk_norm=True)
MOE = dict(num_experts=4, top_k=2, moe_intermediate_size=384)
WSPEC = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)


@functools.lru_cache(maxsize=None)
def _models(dtype=jnp.bfloat16):
    """The JAX model with its router sharpened x8 (random tiny routers
    have near-tied logits), ln and q/k norm gammas 1 + 0.1 N(0, 1) (ones
    would test nothing), and the port's on the same parameters."""
    jarch = JA.ArchSpec(**DIMS, moe=JA.MoESpec(**MOE), dtype=dtype)
    jparams = JA.init_params(jax.random.PRNGKey(21), jarch)
    rng = np.random.RandomState(0)
    for bp in jparams["blocks"]:
        bp["mlp"]["router"]["weight"] = bp["mlp"]["router"]["weight"] * 8.0
        for node, n in ((bp["ln1"], 1024), (bp["ln2"], 1024),
                        (bp["attn"]["q_norm"], 128),
                        (bp["attn"]["k_norm"], 128)):
            node["weight"] = jnp.asarray(
                (1 + 0.1 * rng.randn(n)).astype(np.float32), dtype)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(
        dict(DIMS, moe=MOE),
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return JQwen3Moe(jarch, jparams), Qwen3Moe(tarch, tparams)


@functools.lru_cache(maxsize=None)
def _weights(act_bits=8, **kw):
    jmodel, tmodel = _models()
    jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=act_bits, **kw)
    own = build_serving_weights(tmodel, QuantSpec(**WSPEC), act_bits=act_bits,
                                device="cpu", **kw)
    return jsw, _sw_to_port(jsw), own


def test_adapter_and_arch():
    jmodel, tmodel = _models()
    assert tmodel.arch.qk_norm and tmodel.arch.num_heads * 128 == 2048
    assert tmodel.get_block_linear_names(0) == \
        jmodel.get_block_linear_names(0)
    with pytest.raises(ValueError):
        Qwen3Moe(dataclasses.replace(tmodel.arch, qk_norm=False),
                 tmodel.params)
    a = dataclasses.replace(tmodel.arch, num_layers=1)
    bp = init_params(torch.Generator().manual_seed(0), a)["blocks"][0]
    assert bp["attn"]["q_norm"]["weight"].shape == (128,)
    assert bp["attn"]["k_norm"]["weight"].shape == (128,)


def _ids(seed, B=2, T=12):
    return np.random.RandomState(seed).randint(0, DIMS["vocab_size"], (B, T))


def _rel_close(got, ref, rel=1e-2):
    """bf16 activations round at other places in the two frameworks: max
    |err| within 1e-2 of the largest |ref|, corr >= 0.999."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.999


def test_qk_norm_block_matches_jax():
    """One block (qk_norm, then rope, then the MoE MLP) in bf16."""
    jmodel, tmodel = _models()
    T = 12
    x = np.random.RandomState(3).randn(2, T, 1024).astype(np.float32)
    jcos, jsin = JA.rope_cos_sin(jmodel.arch, jnp.arange(T))
    jmask = JA.causal_mask(T, T)
    ref = JA.block_forward(jmodel.arch, jmodel.params["blocks"][0],
                           jnp.asarray(x, jnp.bfloat16), jcos, jsin,
                           jmask)[0]
    tcos, tsin = TA.rope_cos_sin(tmodel.arch, torch.arange(T))
    got = TA.block_forward(tmodel.arch, tmodel.params["blocks"][0],
                           torch.from_numpy(x).to(torch.bfloat16), tcos,
                           tsin, TA.causal_mask(T, T))[0]
    _rel_close(got.float().numpy(), ref)
    # the gammas are not ones, so the norm changes the block's output
    no_norm = dataclasses.replace(tmodel.arch, qk_norm=False)
    other = TA.block_forward(no_norm, tmodel.params["blocks"][0],
                             torch.from_numpy(x).to(torch.bfloat16), tcos,
                             tsin, TA.causal_mask(T, T))[0]
    assert float((other.float() - got.float()).abs().max()) > 1e-2


def test_logits_match_jax():
    jmodel, tmodel = _models()
    ids = _ids(4)
    ref = JA.model_forward(jmodel.arch, jmodel.params, jnp.asarray(ids))
    got = tmodel.forward(torch.from_numpy(ids))
    _rel_close(got.float().numpy(), ref)


def test_build_matches_jax():
    """The port's own build equals the converted JAX build: gate/up
    stacked planes and the down int8 ``stacked`` (bits 8) bit for bit,
    the router bf16, the q/k norm gammas carried (also with fuse_qkv,
    where the engine splits q/k/v before them)."""
    for kw in ((), (("fuse_qkv", True),)):
        jsw, conv, own = _weights(8, **dict(kw))
        for je, ce, oe in zip(jsw.blocks, conv.blocks, own.blocks):
            assert set(oe) == set(ce) == set(je)
            assert {"q_norm", "k_norm"} <= set(oe)
            assert ("attn.qkv" in oe) == bool(kw)
            for name, a in oe.items():
                b = ce[name]
                if isinstance(a, dict):
                    assert a["weight"].dtype == b["weight"].dtype
                    np.testing.assert_array_equal(
                        a["weight"].float().numpy(),
                        b["weight"].float().numpy())
                    continue
                assert (a.layout, a.bits) == (b.layout, b.bits) == (
                    je[name].layout, je[name].bits)
                np.testing.assert_array_equal(a.codes.numpy(),
                                              b.codes.numpy())
                for f in ("scales", "zeros"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert x.dtype == y.dtype
                        np.testing.assert_array_equal(x.float().numpy(),
                                                      y.float().numpy())
            assert (oe["mlp.down"].layout, oe["mlp.down"].bits) == (
                "stacked", 8)
            assert oe["mlp.down"].codes.dtype == torch.int8
            assert oe["mlp.gate"].layout == oe["mlp.up"].layout == \
                "stacked_planes"
            assert not (oe["q_norm"]["weight"] == 1).all()


def _h2(shape, seed=5):
    rng = np.random.RandomState(seed)
    return jnp.asarray((rng.randn(*shape, 1024) * 0.5).astype(np.float32),
                       jnp.bfloat16)


def _close(got, ref):
    """Routing and codes are the same and the kernels' plain versions
    equal the interpret-mode kernels; the f32 SiLU and sum orders differ,
    which the int8 act quants turn into a few code steps: corr >= 0.9999,
    max |err| <= 2e-2 max |ref|."""
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.9999
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_moe_mlp_grouped_kernel_route_matches_jax(monkeypatch):
    """``moe_mlp_grouped`` asked for the kernel route (act quant of mid,
    then #10's plain version) against JAX's with ``interpret=True``, on
    the same routing; the default CPU route (JAX's bf16 fallback, no act
    quant) is another function."""
    jsw, tsw, _ = _weights()
    je, te = jsw.blocks[0], tsw.blocks[0]
    x2 = _h2((40,))
    topi, topw = _jax_routing(jsw, je, x2)
    ref = jqm.moe_mlp_grouped(je, x2, topi, topw, "silu", interpret=True)
    args = (te, convert.tensor_from_numpy(x2, "cpu"),
            torch.from_numpy(np.array(topi)).long(),
            torch.from_numpy(np.array(topw)), "silu")
    calls = []
    for name in ("w8a8_grouped_matmul_plain", "w4a8_grouped_matmul_plain"):
        def spy(*a, _fn=getattr(tm, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tm, name, spy)
    got = tqm.moe_mlp_grouped(*args, kernel_route=True)
    fallback = tqm.moe_mlp_grouped(*args)
    assert calls == ["w4a8_grouped_matmul_plain"] * 2 + [
        "w8a8_grouped_matmul_plain"] + ["w4a8_grouped_matmul_plain"] * 2
    _close(got, ref)
    assert not torch.equal(got, fallback)


@pytest.mark.parametrize("route", ["grouped", "dense_smallm", "dense"])
def test_moe_mlp_routes_match_jax(route, monkeypatch):
    """The engine's ``_moe_mlp`` on the routes this model serves on: the
    grouped route with the int8 down through #10 (JAX's own ``_moe_mlp``
    under ``LCTPU_MOE_GROUPED=interpret``), the dense route with gate/up
    through #7 (``moe_smallm``; JAX's composition with
    ``LCTPU_MOE_SMALLM``) and through #6; the int8 down on the dense
    route is the dequantized einsum in both."""
    jsw, tsw, _ = _weights()
    je, te = jsw.blocks[1], tsw.blocks[1]
    monkeypatch.setenv("LCTPU_MOE_GATHER_MAX", "0")
    if route == "grouped":
        h2 = _h2((2, 16))
        monkeypatch.setenv("LCTPU_MOE_GROUPED", "interpret")
        ref = j_engine._moe_mlp(jsw, je, h2, 16)
        opts = t_engine.MoEOptions(gather_max=0, grouped="interpret")
    else:
        h2 = _h2((8, 1))
        smallm = 8 if route == "dense_smallm" else 0
        monkeypatch.setenv("LCTPU_MOE_SMALLM", str(smallm))
        ref = _jax_dense(jsw, je, h2)
        opts = t_engine.MoEOptions(gather_max=0, smallm=smallm)
    n = h2.shape[0] * h2.shape[1]
    assert t_engine.pick_moe_route(te, n, tsw.arch.moe, opts) == \
        route.split("_")[0]
    tm.reset_launch_counts()
    got = t_engine._moe_mlp(tsw, te, convert.tensor_from_numpy(h2, "cpu"),
                            16, opts)
    assert all(k.launches == 0 for k in tm.KERNELS)
    _close(got, ref)


def _shell(layout, bits):
    return t_engine.QLinearParams(None, None, None, None, 128, layout,
                                  layout == "stacked_planes", bits)


def test_reference_fault_at_eight_slots():
    """Qwen3-30B-A3B has E / top_k = 16: with default knobs a decode of 8
    slots takes the gathered route, where the JAX engine hands the int8
    down to the W4 gathered kernel (ROADMAP C).  The port raises there;
    ``moe_gather_max=0`` (or 32 slots) avoids the branch.  The engine
    shows it on a small model of the same ratio (16 experts, top-2)."""
    moe = arch_from_hf_config(QWEN3_30B_A3B).moe
    entry = {"mlp.gate": _shell("stacked_planes", 4),
             "mlp.up": _shell("stacked_planes", 4),
             "mlp.down": _shell("stacked", 8)}
    route = functools.partial(t_engine.pick_moe_route, entry, moe=moe)
    assert route(8) == route(16) == "gathered"
    assert route(32) == "dense" and route(1024) == "grouped"
    assert route(8, opts=t_engine.MoEOptions(gather_max=0)) == "dense"
    arch = TA.ArchSpec(**dict(DIMS, num_layers=1), moe=TA.MoESpec(
        num_experts=16, top_k=2, moe_intermediate_size=384))
    model = Qwen3Moe(arch, init_params(torch.Generator().manual_seed(1),
                                       arch))
    sw = build_serving_weights(model, QuantSpec(**WSPEC), act_bits=8,
                               device="cpu")
    assert sw.blocks[0]["mlp.down"].bits == 8
    kw = dict(max_slots=8, max_len=64, prefill_buckets=(16,), device="cpu")
    prompts = [[1, 2, 3], [4, 5]]
    with pytest.raises(ValueError, match="reference"):
        LLMEngine(sw, **kw).generate(prompts,
                                     SamplingParams(max_new_tokens=2))
    out = LLMEngine(sw, moe_gather_max=0, **kw).generate(
        prompts, SamplingParams(max_new_tokens=2))
    assert [len(o) for o in out] == [2, 2]


def test_fuse_qkv_engine_applies_qk_norm_after_the_split():
    """With ``fuse_qkv`` the engine splits the merged q/k/v output before
    the per-head norms: its prefill logits equal the unmerged build's (the
    merge is exact, per output row)."""
    _, _, own = _weights()
    _, _, fused = _weights(fuse_qkv=True)
    assert "attn.qkv" in fused.blocks[0] and "q_norm" in fused.blocks[0]
    ids = torch.from_numpy(_ids(6, B=2, T=16)).long()
    out = []
    for sw in (own, fused):
        eng = LLMEngine(sw, max_slots=2, max_len=64, prefill_buckets=(16,),
                        moe_gather_max=0, device="cpu")
        out.append(eng._prefill_batch(ids, torch.arange(2),
                                      torch.tensor([16, 11]), 16))
    assert torch.equal(out[0], out[1])
