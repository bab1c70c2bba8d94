"""serving/checkpoint.py against the JAX package (CPU): a serving
checkpoint written by JAX's ``export_serving`` loads in the port equal to
the converted JAX build, the port's ``export_serving`` of it (and of the
port's own build of the same weights) writes JAX's tensors byte for byte
with an equal ``serving_config.json``, and JAX's ``load_serving`` reads the
port's files; greedy tokens agree across the packages.  Layouts: tiled
planes (bf16 scales), untiled planes, the combined scale slab, s4, the W8,
e4m3 and int4 ``rows``, ``stacked_planes``, stacked int8, stacked int4
``rows``, the int8 and bf16 heads, the fused builds.  e4m3: JAX writes it
but its reader fails (reference fault 4); the port round-trips it."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcompress_tpu.models import ArchSpec as JArchSpec
from lightcompress_tpu.models import Llama as JLlama
from lightcompress_tpu.models import init_params as j_init
from lightcompress_tpu.models.arch import MoESpec as JMoESpec
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu.serving import LLMEngine as JEngine
from lightcompress_tpu.serving import SamplingParams as JSampling
from lightcompress_tpu.serving import build_serving_weights as j_build
from lightcompress_tpu.serving.checkpoint import export_serving as j_export
from lightcompress_tpu.serving.checkpoint import load_serving as j_load
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import Llama
from lightcompress_tpu_torch.models import st_io
from lightcompress_tpu_torch.ops.qlinear import QLinearParams
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights)
from lightcompress_tpu_torch.serving.checkpoint import (export_serving,
                                                        load_serving)
from test_torch_serving import (DIMS, PROMPTS, N_NEW, WSPEC,  # noqa: F401
                                models, one_torch_thread)
from test_torch_serving_w8 import sw_to_port

W8 = dict(bit=8, symmetric=True, granularity="per_channel")
E4M3 = dict(bit="e4m3", symmetric=True, granularity="per_channel")
PER_CHANNEL = dict(bit=4, symmetric=True, granularity="per_channel")


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def _same_weights(a, b):
    """Two port ServingWeights hold the same tensors, layouts and flags."""
    _same(a.embed, b.embed)
    _same(a.lm_head, b.lm_head)
    _same(a.lm_head_scale, b.lm_head_scale)
    assert a.wbits == b.wbits
    assert a.arch == dataclasses.replace(b.arch, dtype=a.arch.dtype)
    for ea, eb in zip(a.blocks, b.blocks):
        assert list(ea) == list(eb) or set(ea) == set(eb)
        for name, va in ea.items():
            vb = eb[name]
            if isinstance(va, QLinearParams):
                for f in ("layout", "tiled", "bits", "is_float",
                          "group_size"):
                    assert getattr(va, f) == getattr(vb, f), (name, f)
                for f in ("codes", "scales", "zeros", "bias"):
                    _same(getattr(va, f), getattr(vb, f))
            else:
                for k in va:
                    np.testing.assert_array_equal(
                        va[k].float().numpy(), vb[k].float().numpy())


def _files_equal(d1, d2):
    """The same tensor names, dtypes, shapes and bytes, and equal JSON."""
    h1, o1 = st_io.read_header(os.path.join(d1, "serving_model.safetensors"))
    h2, o2 = st_io.read_header(os.path.join(d2, "serving_model.safetensors"))
    assert sorted(h1) == sorted(h2)
    b1 = open(os.path.join(d1, "serving_model.safetensors"), "rb").read()
    b2 = open(os.path.join(d2, "serving_model.safetensors"), "rb").read()
    for k in h1:
        assert (h1[k]["dtype"], h1[k]["shape"]) == (h2[k]["dtype"],
                                                   h2[k]["shape"]), k
        s1, e1 = h1[k]["data_offsets"]
        s2, e2 = h2[k]["data_offsets"]
        assert b1[o1 + s1:o1 + e1] == b2[o2 + s2:o2 + e2], k
    c1 = json.load(open(os.path.join(d1, "serving_config.json")))
    c2 = json.load(open(os.path.join(d2, "serving_config.json")))
    assert c1 == c2


def _roundtrip(jsw, tmp_path, act_bits, fused_rms=False, jax_reads=True):
    """JAX writes; the port reads (equal to convert.py's carry) and
    writes again (JAX's bytes); JAX reads the port's files."""
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    j_export(jsw, dj)
    got = dataclasses.replace(load_serving(dj, device="cpu"),
                              act_bits=act_bits, fused_rms=fused_rms)
    _same_weights(got, sw_to_port(jsw, act_bits))
    export_serving(got, dp)
    _files_equal(dj, dp)
    back = j_load(dp) if jax_reads else None
    return got, back


def _greedy_equal(jsw, tsw):
    kw = dict(max_slots=2, max_len=64, kv_bits=8, prefill_buckets=(16,))
    jout = JEngine(jsw, **kw).generate(PROMPTS,
                                        JSampling(max_new_tokens=N_NEW))
    tout = LLMEngine(tsw, device="cpu", **kw).generate(
        PROMPTS, SamplingParams(max_new_tokens=N_NEW))
    assert [list(map(int, o)) for o in jout] == [list(o) for o in tout]


@pytest.mark.parametrize("act_bits", [16, 8])
def test_planes_roundtrip_both_ways(models, tmp_path, act_bits):
    """Tiled planes (bf16 split scales), the int8 head: JAX -> port ->
    JAX; the port's greedy tokens on JAX's file equal JAX's own (act_bits
    16, the margins of PROMPTS); JAX's file of the port's write is the
    same bytes, so JAX serves it as its own."""
    jmodel, tmodel = models
    jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=act_bits)
    got, back = _roundtrip(jsw, tmp_path, act_bits)
    assert got.blocks[0]["attn.q"].tiled
    np.testing.assert_array_equal(np.asarray(back.blocks[0]["attn.q"].codes),
                                  np.asarray(jsw.blocks[0]["attn.q"].codes))
    if act_bits == 16:
        _greedy_equal(jsw, got)
    # the port's own build of the same weights writes JAX's bytes
    own = build_serving_weights(tmodel, QuantSpec(**WSPEC),
                                act_bits=act_bits, device="cpu")
    export_serving(own, str(tmp_path / "own"))
    _files_equal(str(tmp_path / "jax"), str(tmp_path / "own"))


@pytest.mark.parametrize("case", ["untiled", "contig", "rows4", "w8",
                                  "bf16_head"])
def test_other_layouts_roundtrip(models, tmp_path, case):
    """Untiled planes (per channel: f32 scales, raw zeros), the combined
    slab (read, not written: the port writes the split tiles), the dense
    int4 and W8 ``rows``, a bf16 head."""
    jmodel, tmodel = models
    spec, kw = WSPEC, {}
    if case == "untiled":
        spec = PER_CHANNEL
    elif case == "contig":
        kw = dict(scale_layout="contig")
    elif case == "rows4":
        kw = dict(layout="rows")
    elif case == "w8":
        spec = W8
    else:
        kw = dict(head_bits=16)
    jsw = j_build(jmodel, JQuantSpec(**spec), act_bits=8, **kw)
    if case == "contig":
        dj = str(tmp_path / "jax")
        j_export(jsw, dj)
        got = dataclasses.replace(load_serving(dj, device="cpu"),
                                  act_bits=8)
        _same_weights(got, sw_to_port(jsw, 8))
        assert got.blocks[0]["attn.q"].tiled
        return
    got, back = _roundtrip(jsw, tmp_path, 8)
    q = got.blocks[0]["attn.q"]
    assert (q.layout, q.tiled) == {
        "untiled": ("planes", False), "rows4": ("rows", False),
        "w8": ("rows", False), "bf16_head": ("planes", True)}[case]
    if case == "bf16_head":
        assert got.lm_head_scale is None and back.lm_head_scale is None
    own = build_serving_weights(tmodel, QuantSpec(**spec), act_bits=8,
                                device="cpu", **kw)
    export_serving(own, str(tmp_path / "own"))
    _files_equal(str(tmp_path / "jax"), str(tmp_path / "own"))


@pytest.mark.parametrize("layout", ["planes", "s4"])
def test_fused_builds_roundtrip(models, tmp_path, layout):
    """fused_rms + fuse_qkv (qkv and gateup entries, ones as ln weights),
    planes and s4: files both ways; the port's engine on the loaded build
    (fused_rms given back) gives its in-memory build's logits bit for
    bit."""
    jmodel, tmodel = models
    kw = dict(fused_rms=True, fuse_qkv=True, layout=layout)
    jsw = j_build(jmodel, JQuantSpec(**WSPEC), act_bits=8, **kw)
    got, _ = _roundtrip(jsw, tmp_path, 8, fused_rms=True)
    assert "attn.qkv" in got.blocks[0] and got.blocks[0]["attn.qkv"].tiled
    own = build_serving_weights(tmodel, QuantSpec(**WSPEC), act_bits=8,
                                device="cpu", **kw)
    export_serving(own, str(tmp_path / "own"))
    _files_equal(str(tmp_path / "jax"), str(tmp_path / "own"))
    loaded = dataclasses.replace(
        load_serving(str(tmp_path / "own"), device="cpu"), act_bits=8,
        fused_rms=True)
    eng = dict(max_slots=2, max_len=64, kv_bits=8, prefill_buckets=(16,),
               device="cpu")
    a = LLMEngine(own, **eng).generate(PROMPTS[:2],
                                       SamplingParams(max_new_tokens=3))
    b = LLMEngine(loaded, **eng).generate(PROMPTS[:2],
                                          SamplingParams(max_new_tokens=3))
    assert a == b


MOE_DIMS = dict(family="llama", vocab_size=128, hidden_size=1024,
                intermediate_size=256, num_layers=1, num_heads=8,
                num_kv_heads=2, head_dim=128, rope_theta=10000.0,
                rms_eps=1e-5)


@pytest.mark.parametrize("int8_fallback", ["1", "0"])
def test_moe_roundtrip(tmp_path, monkeypatch, int8_fallback):
    """A Mixtral-shaped block: gate/up ``stacked_planes`` (ic 1024), the
    down (ic 256) planes-ineligible: JAX's int8 per-channel fallback, or
    with ``LCTPU_STACKED_INT8_FALLBACK=0`` the int4 ``rows`` storage; the
    bf16 router."""
    monkeypatch.setenv("LCTPU_STACKED_INT8_FALLBACK", int8_fallback)
    moe = dict(num_experts=4, top_k=2, moe_intermediate_size=256)
    jarch = JArchSpec(**MOE_DIMS, moe=JMoESpec(**moe), dtype=jnp.float32)
    jm = JLlama(jarch, j_init(jax.random.PRNGKey(3), jarch))
    jsw = j_build(jm, JQuantSpec(**WSPEC), act_bits=8)
    got, back = _roundtrip(jsw, tmp_path, 8)
    down = got.blocks[0]["mlp.down"]
    assert got.blocks[0]["mlp.gate"].layout == "stacked_planes"
    assert (down.layout, down.bits) == ("stacked",
                                        8 if int8_fallback == "1" else 4)
    if int8_fallback == "1":
        tarch = convert.arch_from_fields(
            dict(MOE_DIMS, moe=moe), dtype=torch.float32)
        tm = Llama(tarch, convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jm.params), device="cpu"))
        own = build_serving_weights(tm, QuantSpec(**WSPEC), act_bits=8,
                                    device="cpu")
        export_serving(own, str(tmp_path / "own"))
        _files_equal(str(tmp_path / "jax"), str(tmp_path / "own"))


def test_e4m3_roundtrip_and_reference_fault_4(models, tmp_path):
    """e4m3 ``rows``: JAX writes the codes (F8_E4M3) and the port reads
    them; the port writes JAX's bytes; JAX's own reader fails on them
    (``safetensors.numpy``: numpy has no float8_e4m3fn; reference fault
    4).  The port's own build round-trips through its files exactly."""
    jmodel, tmodel = models
    jsw = j_build(jmodel, JQuantSpec(**E4M3), act_bits=16)
    _roundtrip(jsw, tmp_path, 16, jax_reads=False)
    with pytest.raises(AttributeError, match="float8_e4m3fn"):
        j_load(str(tmp_path / "port"))
    own = build_serving_weights(tmodel, QuantSpec(**E4M3), device="cpu")
    export_serving(own, str(tmp_path / "own"))
    _files_equal(str(tmp_path / "jax"), str(tmp_path / "own"))
    _same_weights(load_serving(str(tmp_path / "own"), device="cpu"), own)
