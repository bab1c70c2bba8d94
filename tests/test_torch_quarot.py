"""Port parity: QuaRot (``compression/quantization/quarot.py``), the online
rotation and the GQA transform of v and o against the JAX package (CPU,
f32).  The port draws Q from a ``torch.Generator``, JAX from
``jax.random``; the parity tests hand the port JAX's Q.  With the same Q:
the rotated parameters within 1e-6 of max|W| (f32 products summed in
other orders), the same online rotations, the transformed logits within
1e-5 and the e4m3 fake-quant logits within 1e-3 of max|logit| (a rotated
weight one ulp off moves an e4m3 code at a rounding tie now and then),
and ``configs/methods/quarot_fp8.yml`` through both pipelines.  The port's
own draws leave the float model with its embedding's mean removed
unchanged (corr >= 0.9999, the same argmax)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a8_helpers import (load_both, make_ckpt, method_quant, pipeline_config,
                        rel, run_algo_both, run_both_pipelines)
from lightcompress_tpu.compression.quantization.base import \
    BaseBlockwiseQuantization as JBase
from lightcompress_tpu.ops import hadamard as JH
from lightcompress_tpu_torch.compression.quantization import quarot as TQ
from lightcompress_tpu_torch.config import DotDict
from lightcompress_tpu_torch.quant.quantizer import mean_xla
from lightcompress_tpu_torch.registry import ALGO_REGISTRY
from test_torch_serving import one_torch_thread  # noqa: F401

TOL_W = 1e-6
TOL_LOGITS = 1e-5
TOL_FQ = 1e-3
# the fake-quant PPL of the two frameworks' e4m3 models
TOL_PPL = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_ckpt(tmp_path_factory)


def _jax_q(n, mode, seed=0):
    key = jax.random.PRNGKey(seed)
    f = JH.random_hadamard_matrix if mode == "hadamard" else \
        JH.random_orthogonal_matrix
    return torch.from_numpy(np.asarray(f(n, key).astype(jnp.float32)))


def _share_q(monkeypatch, mode, seed=0):
    q = _jax_q(128, mode, seed)
    monkeypatch.setattr(TQ, "random_hadamard_matrix",
                        lambda n, gen, device=None: q.to(device))
    monkeypatch.setattr(TQ, "random_orthogonal_matrix",
                        lambda n, gen, device=None: q.to(device))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, b in enumerate(v):
                yield from _leaves(b, f"{prefix}{k}.{i}.")
        elif v is not None:
            yield prefix + k, v


def _quarot(mode, online, quant=None):
    q = dict(quant or method_quant("quarot_fp8"))
    q["special"] = dict(q.get("special", {}), rotate_mode=mode,
                        online_rotate=online)
    return q


IDS = np.random.RandomState(9).randint(0, 256, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("mode,online", [("hadamard", True),
                                         ("hadamard", False),
                                         ("random", False)])
def test_rotation_and_fake_quant_match_jax(ckpt, monkeypatch, mode, online):
    _share_q(monkeypatch, mode)
    jm, jalgo, tm, talgo = run_algo_both(ckpt, _quarot(mode, online))
    assert tm.rotate_cfg == jm.rotate_cfg
    if online:
        assert tm.rotate_cfg == {"mlp.down": ("full", 0),
                                 "attn.o": ("head", 32)}
    assert not tm.arch.tie_word_embeddings
    jl, tl = dict(_leaves(jm.params)), dict(_leaves(tm.params))
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert rel(tl[k].numpy(), np.asarray(jl[k])) <= TOL_W, k
    for pos, tol in (("transformed", TOL_LOGITS), ("fake_quant", TOL_FQ)):
        jalgo.deploy(pos)
        talgo.deploy(pos)
        want = np.asarray(jm.jit_forward()(jnp.asarray(IDS)))
        got = tm.forward(torch.from_numpy(IDS)).numpy()
        assert rel(got, want) <= tol, pos
        jalgo.restore_float()
        talgo.restore_float()


@pytest.mark.parametrize("mode,online", [("hadamard", True),
                                         ("random", True),
                                         ("hadamard", False)])
def test_rotation_invariance_with_the_ports_draw(ckpt, mode, online):
    """The rotations leave the float model unchanged.  QuaRot's first step,
    the embedding's per-token mean removal, is no equivalence on an
    RMSNorm model (ROADMAP C): the reference is the model with that mean
    already removed, which the original's logits meet at corr 0.993 only."""
    _, tm = load_both(ckpt)
    orig = tm.forward(torch.from_numpy(IDS))
    emb = tm.params["embed"]
    emb["weight"] = emb["weight"] - mean_xla(emb["weight"], -1, keepdim=True)
    ref = tm.forward(torch.from_numpy(IDS))
    assert np.corrcoef(orig.ravel(), ref.ravel())[0, 1] < 0.999
    from a8_helpers import calib_ids

    algo = ALGO_REGISTRY["Quarot"](
        tm, DotDict(_quarot(mode, online)),
        tm.collect_first_block_input([torch.from_numpy(i)
                                      for i in calib_ids(n=2)]),
        None, DotDict({"base": {"seed": 3}}))
    algo.run_block_loop()
    Qd = algo.Q.double()
    assert (Qd @ Qd.T - torch.eye(128, dtype=torch.float64)).abs().max() \
        < 1e-5
    algo.deploy("transformed")
    got = tm.forward(torch.from_numpy(IDS))
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.9999
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert rel(got.numpy(), ref.numpy()) < 1e-4
    # every norm is weightless now
    assert all(torch.equal(b[n]["weight"], torch.ones(128))
               for b in tm.blocks for n in ("ln1", "ln2"))
    # the port's seeded draw: the same seed, the same Q
    again = ALGO_REGISTRY["Quarot"](
        load_both(ckpt)[1], DotDict(_quarot(mode, online)), [], None,
        DotDict({"base": {"seed": 3}}))
    assert torch.equal(again.Q, algo.Q)


def test_quarot_fp8_config_through_both_pipelines(ckpt, monkeypatch):
    _share_q(monkeypatch, "hadamard", seed=0)
    quant = method_quant("quarot_fp8")
    assert quant["special"]["online_rotate"] and quant["special"]["fp32_had"]
    cfg = pipeline_config(ckpt, quant, {
        "eval_pos": ["pretrain", "transformed", "fake_quant"],
        "name": "synthetic", "seq_len": 16, "bs": 1, "n_tokens": 64})
    want, got, talgo = run_both_pipelines(cfg)
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= TOL_PPL * want[key], (key, got,
                                                                 want)
    assert talgo.fp32_had is True  # read and unused, as in JAX


def test_gqa_transform_through_scale_fc_fc(ckpt):
    """``do_gqa_trans``: v's rows scaled by per-KV-head scales and o's
    columns by them repeated over each KV head's query heads, bit for bit
    JAX's; the model's output is unchanged."""
    jm, tm = load_both(ckpt)
    s = (0.5 + np.random.RandomState(2).rand(64)).astype(np.float32)
    special = {"special": {"do_gqa_trans": True}}
    jalgo = JBase.__new__(JBase)
    jalgo.model, jalgo.has_gqa, jalgo.do_gqa_trans = jm, True, True
    jalgo.scale_fc_fc(jm.blocks[0], "attn.v", "attn.o", jnp.asarray(s))
    talgo = ALGO_REGISTRY["RTN"](tm, DotDict(dict(
        method="RTN", weight={"bit": 8, "symmetric": True,
                              "granularity": "per_channel"}, **special)),
        [], None, DotDict({}))
    ref = tm.forward(torch.from_numpy(IDS))
    assert talgo.do_gqa_trans and talgo.has_gqa
    talgo.scale_fc_fc(tm.blocks[0], "attn.v", "attn.o", torch.from_numpy(s))
    for n in ("v", "o"):
        np.testing.assert_array_equal(
            tm.blocks[0]["attn"][n]["weight"].numpy(),
            np.asarray(jm.blocks[0]["attn"][n]["weight"]))
    assert rel(tm.forward(torch.from_numpy(IDS)).numpy(), ref.numpy()) < 1e-5
    rep = talgo.repeat_gqa_scales(torch.from_numpy(s))
    np.testing.assert_array_equal(
        rep.numpy(), np.repeat(s.reshape(2, 32), 2, axis=0).reshape(-1))
    # without the flag a GQA fc-fc pair cannot be scaled
    talgo.do_gqa_trans = False
    with pytest.raises(ValueError, match="cannot scale fc-fc"):
        talgo.scale_fc_fc(tm.blocks[0], "attn.v", "attn.o",
                          torch.from_numpy(s))


def test_awq_gqa_trans_is_a_reference_fault(ckpt):
    """JAX's AWQ searches o's scales over its hidden-wide input, then
    scales v's kv_dim rows by them: ``TypeError: div got incompatible
    shapes for broadcasting: (64, 128), (128, 1)``.  The port raises
    naming the fault."""
    quant = {"method": "Awq",
             "weight": {"bit": 4, "symmetric": False,
                        "granularity": "per_group", "group_size": 16},
             "special": {"trans": True, "trans_version": "v2",
                         "do_gqa_trans": True}}
    with pytest.raises(TypeError, match="incompatible shapes"):
        run_algo_both(ckpt, quant)
    _, tm = load_both(ckpt)
    from a8_helpers import calib_ids

    algo = ALGO_REGISTRY["Awq"](
        tm, DotDict(quant), tm.collect_first_block_input(
            [torch.from_numpy(i) for i in calib_ids(n=1)]), None,
        DotDict({}))
    with pytest.raises(NotImplementedError, match="reference fault"):
        algo.run_block_loop()
