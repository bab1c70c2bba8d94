"""Port parity: MoE serving (the stacked-expert build, the engine's
``_moe_mlp`` on each expert route, the route choice and the engine) against
lightcompress_tpu on a small Mixtral-shaped model (CPU); the engine's
logits and greedy tokens against the JAX engine are in
test_torch_serving_moe_engine.py.

The JAX engine takes none of the kernel routes on the CPU, so each route is
held against a composition of the JAX package's own functions with its
Pallas kernels in interpret mode, as its engine composes them on a TPU
(``engine.py:104-122``, ``:165-188``), or against its ``_moe_mlp`` where the
CPU takes the same route (the grouped route with
``LCTPU_MOE_GROUPED=interpret``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.ops import pallas_matmul as jpm
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving import engine as j_engine
from lightcompress_tpu.serving import quantized_model as jqm
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.ops import moe_matmul as tm
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights)
from lightcompress_tpu_torch.serving import engine as t_engine
from test_torch_serving import one_torch_thread  # noqa: F401

WSPEC = dict(bit=4, symmetric=False, granularity="per_group", group_size=128)
# Mixtral's shape at a small size: every expert linear takes the planes
# layout (K % 1024, N % 128); "int8_down" has an expert width whose down
# projection (ic 768) falls back to int8 per channel
DIMS = dict(family="llama", vocab_size=256, hidden_size=1024,
            intermediate_size=1024, num_layers=2, num_heads=8, num_kv_heads=2,
            head_dim=128, rope_theta=1e6, rms_eps=1e-5)
MOE = dict(num_experts=4, top_k=2, moe_intermediate_size=1024)
VARIANTS = {"planes": MOE, "int8_down": dict(MOE, moe_intermediate_size=768)}


@functools.lru_cache(maxsize=None)
def _models(variant="planes", dtype=jnp.float32):
    """The JAX model with its router sharpened x8 (random tiny routers
    have near-tied logits; tests/test_serving_moe_mla.py does the same)
    and ln gammas 1 + 0.1 N(0, 1), and the port's on the same
    parameters."""
    moe = VARIANTS[variant]
    jarch = JA.ArchSpec(**DIMS, moe=JA.MoESpec(**moe), dtype=dtype)
    jparams = JA.init_params(jax.random.PRNGKey(11), jarch)
    rng = np.random.RandomState(0)
    for bp in jparams["blocks"]:
        bp["mlp"]["router"]["weight"] = bp["mlp"]["router"]["weight"] * 8.0
        for ln in ("ln1", "ln2"):
            g = 1 + 0.1 * rng.randn(DIMS["hidden_size"])
            bp[ln]["weight"] = jnp.asarray(g.astype(np.float32), dtype)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tarch = convert.arch_from_fields(
        dict(DIMS, moe=moe),
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return JLlama(jarch, jparams), Llama(tarch, tparams)


def _sw_to_port(jsw):
    arch = convert.arch_from_fields(dataclasses.asdict(jsw.arch))
    blocks = []
    for e in jsw.blocks:
        b = {}
        for name, v in e.items():
            if isinstance(v, dict):
                b[name] = {k: np.asarray(a) for k, a in v.items()}
            elif name == "mlp.router_bias":
                b[name] = np.asarray(v)
            else:
                b[name] = dict(
                    codes=np.asarray(v.codes), scales=np.asarray(v.scales),
                    zeros=None if v.zeros is None else np.asarray(v.zeros),
                    bias=None if v.bias is None else np.asarray(v.bias),
                    bits=v.bits, group_size=v.group_size, layout=v.layout)
        blocks.append(b)
    return convert.serving_weights_from_numpy(
        arch, np.asarray(jsw.embed),
        {k: np.asarray(a) for k, a in jsw.norm.items()},
        np.asarray(jsw.lm_head), np.asarray(jsw.lm_head_scale), blocks,
        jsw.act_bits, fused_rms=jsw.fused_rms, device="cpu")


@functools.lru_cache(maxsize=None)
def _weights(variant="planes", act_bits=16, dtype=jnp.float32, **kw):
    jmodel, tmodel = _models(variant, dtype)
    jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=act_bits, **kw)
    own = build_serving_weights(tmodel, QuantSpec(**WSPEC), act_bits=act_bits,
                                device="cpu", **kw)
    return jsw, _sw_to_port(jsw), own


@pytest.mark.parametrize("variant,kw", [
    ("planes", ()), ("planes", (("fuse_qkv", True), ("fused_rms", True))),
    ("int8_down", ())])
def test_build_matches_jax(variant, kw):
    """The port's own MoE build equals the converted JAX build: the same
    entries (q/k/v merged with fuse_qkv, the stacked gate/up never),
    stacked codes bit for bit with their layout and bit width, s and zs
    equal, the router in bf16; fused_rms is off for MoE (the ln weights
    keep their gammas)."""
    jsw, conv, own = _weights(variant, 8, jnp.bfloat16, **dict(kw))
    assert own.fused_rms is conv.fused_rms is jsw.fused_rms is False
    for je, ce, oe in zip(jsw.blocks, conv.blocks, own.blocks):
        assert set(oe) == set(ce) == set(je)
        assert "mlp.gateup" not in oe
        assert ("attn.qkv" in oe) == bool(kw)
        for name, a in oe.items():
            b = ce[name]
            if name in ("ln1", "ln2", "mlp.router"):
                assert a["weight"].dtype == b["weight"].dtype
                np.testing.assert_array_equal(a["weight"].float().numpy(),
                                              b["weight"].float().numpy())
                continue
            assert (a.layout, a.bits) == (b.layout, b.bits) == (
                je[name].layout, je[name].bits)
            np.testing.assert_array_equal(a.codes.numpy(), b.codes.numpy())
            for f in ("scales", "zeros"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x.float().numpy(),
                                                  y.float().numpy())
        want = "stacked" if variant == "int8_down" else "stacked_planes"
        assert oe["mlp.down"].layout == want
        assert oe["mlp.gate"].layout == "stacked_planes"
        assert not (oe["ln2"]["weight"] == 1).all()


# ---------------------------------------------------------------------------
# _moe_mlp on each route
# ---------------------------------------------------------------------------

def _jax_routing(jsw, entry, x2):
    logits = jnp.einsum(
        "nh,eh->ne", x2.astype(jnp.bfloat16),
        entry["mlp.router"]["weight"].astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)
    return JA.moe_route(jsw.arch.moe, logits, entry.get("mlp.router_bias"))


def _jax_gathered(jsw, entry, h2):
    """engine.py:104-122 with the kernel in interpret mode."""
    m, act = jsw.arch.moe, jsw.arch.act_fn
    H = h2.shape[-1]
    x2 = h2.reshape(-1, H)
    topi, topw = _jax_routing(jsw, entry, x2)
    n = x2.shape[0]
    e_flat = topi.reshape(-1).astype(jnp.int32)
    t_flat = jnp.repeat(jnp.arange(n, dtype=jnp.int32), m.top_k)
    xq, xs = jpm.quantize_act_per_token(x2)
    gp, upp, dp = entry["mlp.gate"], entry["mlp.up"], entry["mlp.down"]
    kw = dict(group=128, interpret=True)
    g = jpm.w4a8_gathered_matmul(xq, xs, gp.codes, gp.scales, e_flat,
                                 t_flat, **kw)
    u = jpm.w4a8_gathered_matmul(xq, xs, upp.codes, upp.scales, e_flat,
                                 t_flat, **kw)
    mq, ms = jpm.quantize_act_per_token(
        (JA._act(g, act) * u).astype(jnp.bfloat16))
    d = jpm.w4a8_gathered_matmul(
        mq, ms, dp.codes, dp.scales, e_flat,
        jnp.arange(n * m.top_k, dtype=jnp.int32), **kw)
    y = jnp.einsum("nkh,nk->nh", d.reshape(n, m.top_k, H), topw)
    return y.reshape(h2.shape).astype(h2.dtype)


def _jax_dense(jsw, entry, h2):
    """engine.py:165-188 at n <= 256, the stacked kernel in interpret
    mode."""
    m, act = jsw.arch.moe, jsw.arch.act_fn
    H = h2.shape[-1]
    x2 = h2.reshape(-1, H)
    topi, topw = _jax_routing(jsw, entry, x2)
    n = x2.shape[0]
    st = functools.partial(jqm.apply_qlinear_stacked, interpret=True)
    g = st(entry["mlp.gate"], x2)
    u = st(entry["mlp.up"], x2)
    d = st(entry["mlp.down"], (JA._act(g, act) * u).astype(jnp.bfloat16),
           pair=True)
    w_full = jnp.zeros((n, m.num_experts), jnp.float32).at[
        jnp.arange(n)[:, None], topi].set(topw)
    y = jnp.einsum("enh,ne->nh", d, w_full)
    return y.reshape(h2.shape).astype(h2.dtype)


# case -> (the route, tokens (S, T), the port's MoEOptions, the JAX side:
# a composition or the JAX engine's own _moe_mlp under these environment
# variables)
ROUTES = {
    "gathered": ("gathered", (2, 1), {}, _jax_gathered),
    "dense": ("dense", (8, 1), {}, _jax_dense),
    "grouped": ("grouped", (2, 16), dict(gather_max=0, grouped=True),
                dict(LCTPU_MOE_GATHER_MAX="0",
                     LCTPU_MOE_GROUPED="interpret")),
    "gathered_plain": ("gathered_plain", (4, 1), dict(gather_max=8),
                       dict(LCTPU_MOE_GATHER_MAX="8")),
    "dense_dequant": ("dense", (3, 100), dict(grouped=False),
                      dict(LCTPU_MOE_GROUPED="0")),
}


def _h2(shape, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, DIMS["hidden_size"]) * 0.5).astype(np.float32)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_moe_mlp_route_matches_jax(route, monkeypatch):
    """The port's ``_moe_mlp`` forced onto each route against JAX's
    composition of the same route.  Routing and the int8 expert codes are
    the same; the kernels' plain versions equal the interpret-mode
    kernels; what differs is the f32 SiLU and the sums' orders, which the
    int8 act quant of the down input turns into a few code steps: corr
    >= 0.9999 and max |err| <= 2e-2 max |ref| on bf16 outputs."""
    name, shape, opts, jside = ROUTES[route]
    jsw, tsw, _ = _weights("planes", 8, jnp.bfloat16)
    h2 = jnp.asarray(_h2(shape), jnp.bfloat16)
    je, te = jsw.blocks[0], tsw.blocks[0]
    opts = t_engine.MoEOptions(**opts)
    assert t_engine.pick_moe_route(te, shape[0] * shape[1], tsw.arch.moe,
                                   opts) == name
    if callable(jside):
        ref = jside(jsw, je, h2)
    else:
        for k, v in jside.items():
            monkeypatch.setenv(k, v)
        ref = j_engine._moe_mlp(jsw, je, h2, 16)
    tm.reset_launch_counts()
    got = t_engine._moe_mlp(tsw, te, convert.tensor_from_numpy(h2, "cpu"),
                            16, opts)
    assert all(k.launches == 0 for k in tm.KERNELS)
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.9999
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_grouped_int8_down_on_cpu(monkeypatch):
    """A down projection that fell back to int8 per channel: the grouped
    route serves it on the CPU by default through the plain block-gathered
    matmul (JAX's CPU fallback), against JAX's grouped route with #10 in
    interpret mode (bf16 against int8 down activations: corr >= 0.999);
    the gathered route refuses it (the reference fault, ROADMAP C)."""
    jsw, tsw, _ = _weights("int8_down", 8, jnp.bfloat16)
    je, te = jsw.blocks[0], tsw.blocks[0]
    h2 = jnp.asarray(_h2((2, 16)), jnp.bfloat16)
    monkeypatch.setenv("LCTPU_MOE_GATHER_MAX", "0")
    monkeypatch.setenv("LCTPU_MOE_GROUPED", "interpret")
    ref = np.asarray(j_engine._moe_mlp(jsw, je, h2, 16), np.float32)
    opts = t_engine.MoEOptions(gather_max=0, grouped=True)
    assert t_engine.pick_moe_route(te, 32, tsw.arch.moe, opts) == "grouped"
    got = t_engine._moe_mlp(tsw, te, convert.tensor_from_numpy(h2, "cpu"),
                            16, opts).float().numpy()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.999
    assert t_engine.pick_moe_route(te, 2, tsw.arch.moe,
                                   t_engine.MoEOptions()) == "gathered"
    with pytest.raises(ValueError, match="reference"):
        t_engine._moe_mlp(tsw, te, convert.tensor_from_numpy(
            h2[:, :1], "cpu"), 16)


def _jax_tpu_route(n, E, top_k, gate, up, down, down_bits, gather_max,
                   grouped, grouped_min):
    """The JAX engine's route conditions on a TPU, unsharded
    (engine.py:81-163, with ``jax.default_backend() != "cpu"``)."""
    thresh = gather_max if gather_max is not None else max(
        1, E // max(1, top_k))
    planes_gather = gate == "stacked_planes" and n * top_k <= E
    if n <= thresh and planes_gather:
        return "gathered"
    if n <= thresh:
        return "gathered_plain"
    ge = {True: "1", False: "0", "auto": "auto"}[grouped]
    if (gate == up == "stacked_planes"
            and (down == "stacked_planes"
                 or (down_bits == 8 and down == "stacked"))
            and ge != "0"
            and (ge in ("1", "interpret")
                 or (ge == "auto" and n >= grouped_min))):
        return "grouped"
    return "dense"


def _qp(layout, bits):
    return t_engine.QLinearParams(None, None, None, None, 128, layout,
                                  layout == "stacked_planes", bits)


def test_route_choice_matches_jax_conditions():
    """``pick_moe_route`` on a grid of token counts, expert counts, top-k,
    layouts and options against the JAX engine's TPU conditions."""
    layouts = [("stacked_planes", "stacked_planes", "stacked_planes", 4),
               ("stacked_planes", "stacked_planes", "stacked", 8),
               ("stacked", "stacked", "stacked", 8),
               ("stacked_planes", "stacked", "stacked_planes", 4)]
    opts = [(None, "auto", 257), (0, "auto", 257), (16, True, 257),
            (None, False, 257), (3, "auto", 100)]
    seen = set()
    for n in (1, 2, 3, 4, 5, 8, 16, 100, 256, 257, 300):
        for E, top_k in ((4, 2), (8, 2), (64, 6), (8, 1)):
            moe = t_engine.A.MoESpec(num_experts=E, top_k=top_k,
                                     moe_intermediate_size=1)
            for gate, up, down, bits in layouts:
                entry = {nm: _qp(lay, b) for nm, lay, b in (
                    ("mlp.gate", gate, 4 if gate == "stacked_planes" else 8),
                    ("mlp.up", up, 4 if up == "stacked_planes" else 8),
                    ("mlp.down", down, bits))}
                for o in opts:
                    want = _jax_tpu_route(n, E, top_k, gate, up, down, bits,
                                          *o)
                    got = t_engine.pick_moe_route(
                        entry, n, moe, t_engine.MoEOptions(*o))
                    assert got == want, (n, E, top_k, gate, up, down, o)
                    seen.add(got)
    assert seen == {"gathered", "gathered_plain", "grouped", "dense"}


# ---------------------------------------------------------------------------
# the engine (its parity with the JAX engine: test_torch_serving_moe_engine)
# ---------------------------------------------------------------------------

def test_engine_routes_and_refusals(monkeypatch):
    """A MoE engine takes the xla attention route whatever it is asked
    (as JAX forces it), so kv4 serves on the generic path of the kv4 hhd
    cache; the default routes a 2-slot decode through #8's plain version
    and a 32-row prefill through #6's."""
    _, tsw, _ = _weights("planes", 8, jnp.bfloat16)
    with pytest.warns(UserWarning, match="probe-only"):
        eng = LLMEngine(tsw, max_slots=2, max_len=64, attn_impl="pallas",
                        device="cpu")
    assert eng.attn_impl == "xla"
    for kw in (dict(kv_bits=4), dict(kv_bits="auto", max_len=4096)):
        eng = LLMEngine(tsw, max_slots=2, device="cpu", **kw)
        assert (eng.attn_impl, eng.kv_bits, eng.cache.layout, eng.body) \
            == ("xla", 4, "hhd", "generic")
    with pytest.raises(ValueError):
        LLMEngine(tsw, max_slots=2, device="cpu", moe_grouped="1")
    calls = []
    for name in ("w4a8_gathered_matmul_plain", "w4a8_stacked_matmul_plain",
                 "w4a8_grouped_matmul_plain"):
        def spy(*a, _fn=getattr(tm, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tm, name, spy)
    eng = LLMEngine(tsw, max_slots=2, max_len=64, prefill_buckets=(16,),
                    device="cpu")
    eng.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=2))
    L = DIMS["num_layers"]
    # one prefill batch (2 x 16 rows: dense, 3 stacked calls a layer) and
    # one decode step (2 slots: gathered, 3 calls a layer)
    assert calls.count("w4a8_stacked_matmul_plain") == 3 * L
    assert calls.count("w4a8_gathered_matmul_plain") == 3 * L
    assert "w4a8_grouped_matmul_plain" not in calls
