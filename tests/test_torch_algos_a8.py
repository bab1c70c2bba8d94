"""Port parity: A8's untrained algorithms (OsPlus, LLM.int8, QUIK, AdaDim,
SpQR, DGQ) against the JAX package on the same inputs (CPU, f32), on the
inputs of the JAX package's parity tests (``tests/test_sq_llmint8_parity.py``,
``test_adadim_quik_parity.py``, ``test_spqr_dgq_parity.py``) and on the
tiny A8 model, and each method's config through both pipelines.

Bit for bit: LLM.int8's decomposition, QUIK's outlier columns and
split qdq, AdaDim's choices and qdq weights, DGQ's searched multipliers,
zeros and scale8 and its fake quant, and SpQR's masks and qparams on one
layer (their loops take XLA's arithmetic, ROADMAP C), its weights within
1e-6.
Within limits: OsPlus's transformed parameters within 1e-5 of max|W| (the
same grid point; the inspect forwards' f32 sums in other orders); the
pipelines' PPLs within 1e-4 (the act-quant tests' gate for fake-quant
PPLs), 1e-2 for SpQR and DGQ, whose loops are chaotic on the tiny model; each of their
layer steps is held on the port's own inputs instead (SpQR's column step
fed JAX's U: masks and deployed weights in >= 99.9% of entries; DGQ's
search: zeros bit for bit, multipliers and deployed weights in >= 99%)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from a8_helpers import (METHODS, make_ckpt, method_quant, pipeline_config,
                        rel, run_algo_both, run_both_pipelines)
from lightcompress_tpu.compression.quantization import dgq as JD
from lightcompress_tpu.compression.quantization import spqr as JS
from lightcompress_tpu.compression.quantization.llmint8 import \
    LlmInt8 as JLlmInt8
from lightcompress_tpu.quant import QuantSpec as JQuantSpec
from lightcompress_tpu_torch.compression.quantization import dgq as TD
from lightcompress_tpu_torch.compression.quantization import spqr as TS
from lightcompress_tpu_torch.compression.quantization.llmint8 import LlmInt8
from lightcompress_tpu_torch.models.arch import resolve
from lightcompress_tpu_torch.quant import QuantSpec
from test_torch_serving import one_torch_thread  # noqa: F401

TOL_PPL = 1e-4
# SpQR's and DGQ's loops on 64 calibration tokens are chaotic: inputs one
# ulp apart move JAX's own logits by 1.4% (SpQR) and 2.8% (DGQ); their
# per-layer steps are held on the same inputs instead
TOL_PPL_CHAOTIC = 1e-2


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_ckpt(tmp_path_factory)


def _weights_equal(jm, tm, tol=0.0):
    for i in range(tm.num_blocks):
        for name in tm.get_block_linear_names(i) + ["ln1", "ln2"]:
            got = resolve(tm.blocks[i], name)["weight"].numpy()
            want = np.asarray(resolve(jm.blocks[i], name)["weight"])
            assert rel(got, want) <= tol, (i, name)


@pytest.mark.parametrize("threshold", [1.5, 6.0])
def test_llmint8_decomposition_bit_for_bit(threshold):
    rng = np.random.RandomState(3)
    act = rng.randn(1, 12, 64).astype(np.float32)
    act[0, 3, 7] = 2.5  # an outlier column at threshold 1.5
    w = (rng.randn(48, 64) * 0.2).astype(np.float32)
    spec = {"bit": 8, "symmetric": True, "granularity": "per_channel"}
    outs = []
    for cls, Q, t in ((JLlmInt8, JQuantSpec, jnp.asarray),
                      (LlmInt8, QuantSpec, torch.from_numpy)):
        algo = object.__new__(cls)
        algo.threshold, algo.w_only, algo._col_mask = threshold, False, None
        algo.is_ignored = lambda *a: False
        algo.aspec = algo.wspec = Q(**spec)
        outs.append([np.asarray(cls.a_qdq(algo, t(act), 0, "q")),
                     np.asarray(cls.w_qdq(algo, t(w), 0, "q"))])
    for j, p in zip(*outs):
        np.testing.assert_array_equal(p, j)
    kept = (np.abs(act).max(axis=(0, 1)) >= threshold)
    np.testing.assert_array_equal(outs[1][0][..., kept], act[..., kept])


def test_quik_outlier_columns(ckpt):
    """QUIK with 16 float columns a linear (the config's
    ``fp_features_num`` is no key QUIK reads): the same columns, the same
    split qdq of weights and acts."""
    quant = method_quant("quik_w4a4")
    quant["special"] = {"fp_features": 16, "last_fc_bit": 8}
    jm, jalgo, tm, talgo = run_algo_both(ckpt, quant)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 128).astype(
        np.float32))
    for i in range(2):
        for name in tm.get_block_linear_names(i):
            js, ts = jalgo.layer_state[i][name], talgo.layer_state[i][name]
            np.testing.assert_array_equal(ts["fp_ids"], js["fp_ids"])
            np.testing.assert_array_equal(ts["int_ids"], js["int_ids"])
            assert ts.get("current_bit") == js.get("current_bit")
            w = resolve(tm.blocks[i], name)["weight"]
            np.testing.assert_array_equal(
                talgo.w_qdq(w, i, name).numpy(),
                np.asarray(jalgo.w_qdq(jnp.asarray(w.numpy()), i, name)))
        xn = x if name != "mlp.down" else torch.cat([x] * 3, -1)
        np.testing.assert_array_equal(
            talgo.a_qdq(xn, i, "attn.q").numpy(),
            np.asarray(jalgo.a_qdq(jnp.asarray(xn.numpy()), i, "attn.q")))


def test_adadim_choices_and_weights(ckpt):
    jm, jalgo, tm, talgo = run_algo_both(ckpt, method_quant("adadim_w4"))
    chosen = []
    for i in range(2):
        for name in tm.get_block_linear_names(i):
            assert talgo.layer_state[i][name]["dim_ic"] == \
                jalgo.layer_state[i][name]["dim_ic"]
            chosen.append(talgo.layer_state[i][name]["dim_ic"])
            w = resolve(tm.blocks[i], name)["weight"]
            np.testing.assert_array_equal(
                talgo.w_qdq(w, i, name).numpy(),
                np.asarray(jalgo.w_qdq(jnp.asarray(w.numpy()), i, name)))
    assert len(chosen) == 14


def test_osplus_transform(ckpt):
    jm, jalgo, tm, talgo = run_algo_both(ckpt, method_quant("osplus_w8a8"))
    _weights_equal(jm, tm, tol=1e-5)
    # the search moved the norms (a range below the acts' max was best)
    assert any(not torch.equal(b["ln1"]["weight"],
                               load_ln(ckpt, i))
               for i, b in enumerate(tm.blocks))


def load_ln(ckpt, i):
    from a8_helpers import load_both

    return load_both(ckpt)[1].blocks[i]["ln1"]["weight"]


def _rand_layer(seed, oc=8, cols=32, n=64):
    """tests/test_spqr_dgq_parity.py's layer: W and H = 2/n X X^T."""
    rng = np.random.RandomState(seed)
    W = rng.randn(oc, cols).astype(np.float32)
    X = rng.randn(cols, n).astype(np.float32)
    return W, (2.0 / n) * (X @ X.T)


@pytest.mark.parametrize("actorder,simplified,rel_t", [
    (False, False, 0.2), (True, False, 0.2), (False, True, 0.2),
    (False, False, float("inf"))])
def test_spqr_layer(actorder, simplified, rel_t):
    W, H = _rand_layer(3)
    W[3, 7] = 40.0  # a planted outlier
    kw = dict(qmin=0.0, qmax=15.0, round_zp=False, group_size=16,
              actorder=actorder, percdamp=1.0, rel_threshold=rel_t,
              simplified=simplified)
    want = JS.spqr_quantize_layer(jnp.asarray(W), jnp.asarray(H), **kw)
    got = TS.spqr_quantize_layer(torch.from_numpy(W), torch.from_numpy(H),
                                 **kw)
    # the masks and group qparams bit for bit; the compensated weights
    # within 1e-6 of max|W| (U's Cholesky factors from other LAPACK
    # builds differ by an ulp in ~40% of entries)
    for name, g, w in zip(("mask", "scales", "zeros", "perm"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert rel(got[0].numpy(), np.asarray(want[0])) <= 1e-6
    if rel_t < 1e9 and not simplified:
        assert bool(got[1][3, 7]) and float(got[1].float().mean()) < 0.2


def _recorded(monkeypatch, module, fn_name):
    """Wrap ``module.fn_name`` to record each call's arguments; returns
    (the calls, the unwrapped function)."""
    calls, fn = [], getattr(module, fn_name)

    def wrapped(*a, **k):
        calls.append(a)
        return fn(*a, **k)

    monkeypatch.setattr(module, fn_name, wrapped)
    return calls, fn


def _np(t):
    return t.float().numpy()


def _close_share(got, want) -> float:
    """The share of entries within 1e-5 of max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= 1e-5 * np.abs(want).max()).mean())


def _spqr_deployed(W, mask, scales, zeros, perm, gs):
    """SpQR's deployed weight from one layer's outputs (its ``w_qdq``)."""
    W, mask = np.asarray(W), np.asarray(mask)
    p = np.asarray(perm)
    s = np.repeat(np.asarray(scales), gs, axis=1)
    z = np.repeat(np.asarray(zeros), gs, axis=1)
    q = np.clip(np.round(W[:, p] / np.maximum(s, 1e-9) + z), 0, 7)
    return np.where(mask, W, ((q - z) * s)[:, np.argsort(p)])


def _jax_spqr_factor(W, H, actorder, percdamp):
    """JAX's SpQR factor by the layer's own steps (permute, damp, the dead
    diagonals set to 1; U the upper Cholesky factor of H^-1)."""
    cols = W.shape[1]
    if actorder:
        perm = jnp.argsort(-jnp.diagonal(H))
        W, H = W[:, perm], H[perm][:, perm]
    else:
        perm = jnp.arange(cols)
    dead = jnp.diagonal(H) == 0
    if percdamp > 0:
        H = H + percdamp * jnp.mean(jnp.abs(jnp.diagonal(H))) * jnp.eye(cols)
    H = jnp.where(jnp.diag(dead), 1.0, H)
    W = W * (~dead)[None, :]
    L = jnp.linalg.cholesky(H)
    Hinv = jax.scipy.linalg.cho_solve((L, True), jnp.eye(cols))
    return W, jnp.linalg.cholesky(Hinv).T, perm


def test_spqr_on_the_tiny_model(ckpt, monkeypatch):
    """Every layer's SpQR column step on the port's own (W, H), fed JAX's
    U, against JAX's layer on the same inputs: masks equal and deployed
    weights within 1e-5 of max|W| in >= 99.9% of entries (the column
    products summed in other orders).  Fed its own U (LAPACK builds an
    ulp apart), the loop is chaotic there, as GPTQ's (ROADMAP C): inputs
    one ulp apart move JAX's own logits by 1.4%."""
    calls, _ = _recorded(monkeypatch, TS, "spqr_quantize_layer")
    run_algo_both(ckpt, method_quant("spqr_w3"))
    assert len(calls) == 14
    for W, H, qmin, qmax, rzp, gs, ao, pd, rt, simp in calls:
        want = [np.asarray(t) for t in JS.spqr_quantize_layer(
            jnp.asarray(_np(W)), jnp.asarray(_np(H)), qmin=qmin, qmax=qmax,
            round_zp=rzp, group_size=gs, actorder=ao, percdamp=pd,
            rel_threshold=rt, simplified=simp)]
        Wp, U, perm = (np.asarray(t) for t in jax.jit(
            _jax_spqr_factor, static_argnums=(2, 3))(
                jnp.asarray(_np(W)), jnp.asarray(_np(H)), ao, pd))
        got = [t.numpy() for t in TS.spqr_columns(
            torch.from_numpy(Wp), torch.from_numpy(U), qmin, qmax, rzp, gs,
            rt, simp)]
        inv = np.argsort(perm)
        got = [got[0][:, inv], got[1][:, inv], got[2], got[3], perm]
        assert (got[1] == want[1]).mean() >= 0.999
        assert _close_share(_spqr_deployed(*got, gs),
                            _spqr_deployed(*want, gs)) >= 0.999


@pytest.mark.parametrize("seed,O,IN,L,w_only", [(9, 8, 32, 40, True),
                                                (13, 4, 32, 24, False)])
def test_dgq_search_bit_for_bit(seed, O, IN, L, w_only):
    rng = np.random.RandomState(seed)
    W = rng.randn(O, IN).astype(np.float32)
    if seed == 9:
        W[2, 5] *= 8
    X = rng.randn(L, IN).astype(np.float32)
    want = JD.dgq_search_scale_zero(jnp.asarray(W), jnp.asarray(X), gs=16,
                                    w_only=w_only)
    got = TD.dgq_search_scale_zero(torch.from_numpy(W), torch.from_numpy(X),
                                   16, w_only)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        TD.dgq_fake_quant(torch.from_numpy(W), *got).numpy(),
        np.asarray(JD.dgq_fake_quant(jnp.asarray(W), *want)))


DGQ_W48 = {"w_1": {"bit": 4, "symmetric": False, "granularity": "per_group",
                   "group_size": 128},
           "w_2": {"bit": 8, "symmetric": True,
                   "granularity": "per_channel"}}


def _dgq_quant():
    quant = method_quant("dgq_w4a8")
    quant["weight"] = DGQ_W48
    return quant


def test_dgq_on_the_tiny_model(ckpt, monkeypatch):
    """Every layer's search on the port's own (W, X) against JAX's on the
    same inputs: zeros bit for bit, multipliers equal in >= 99% and the
    fake-quant weights within 1e-5 of max|W| in >= 99% of entries (the
    losses' products summed in other orders flip near-equal argmins); the
    smoothed weights within 1e-5 of JAX's.  Inputs one ulp apart move
    JAX's own logits by 2.8%."""
    calls, fn = _recorded(monkeypatch, TD, "dgq_search_scale_zero")
    jm, _, tm, talgo = run_algo_both(ckpt, _dgq_quant())
    _weights_equal(jm, tm, tol=1e-5)
    assert len(calls) == 14
    for W, X, gs, w_only in calls:
        got = fn(W, X, gs, w_only)
        want = JD.dgq_search_scale_zero(jnp.asarray(_np(W)),
                                        jnp.asarray(_np(X)), gs=gs,
                                        w_only=w_only)
        assert (got[0].numpy() == np.asarray(want[0])).mean() >= 0.99
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert _close_share(
            TD.dgq_fake_quant(W, *got).numpy(),
            np.asarray(JD.dgq_fake_quant(jnp.asarray(_np(W)), *want))) \
            >= 0.99


def test_dgq_flat_config_is_a_reference_fault(ckpt):
    """``dgq_w4a8.yml`` gives DGQ a flat ``weight`` section; JAX's DGQ reads
    ``weight.w_1``: ``KeyError: 'w_1'``.  The port raises naming it."""
    cfg = pipeline_config(ckpt, method_quant("dgq_w4a8"))
    from lightcompress_tpu.config import DotDict as JDotDict
    from lightcompress_tpu.pipeline import run_pipeline as j_run
    from lightcompress_tpu_torch.config import DotDict
    from lightcompress_tpu_torch.pipeline import run_pipeline

    with pytest.raises(KeyError, match="w_1"):
        j_run(JDotDict(cfg))
    with pytest.raises(ValueError, match="reference fault"):
        run_pipeline(DotDict(cfg), device="cpu")


@pytest.mark.parametrize("name", ["osplus_w8a8", "llmint8_w8a8",
                                  "quik_w4a4", "adadim_w4", "spqr_w3",
                                  "dgq_w4a8"])
def test_config_through_both_pipelines(ckpt, name):
    quant = _dgq_quant() if name == "dgq_w4a8" else method_quant(name)
    want, got, talgo = run_both_pipelines(pipeline_config(ckpt, quant))
    assert sorted(got) == sorted(want) == ["ppl_fake_quant"]
    tol = TOL_PPL_CHAOTIC if name in ("spqr_w3", "dgq_w4a8") else TOL_PPL
    assert abs(got["ppl_fake_quant"] - want["ppl_fake_quant"]) \
        <= tol * want["ppl_fake_quant"], (got, want)
    assert type(talgo).__name__ == quant["method"]


def test_chip_smoke_specs_are_the_configs():
    """``chip_smoke.py`` (no PyYAML on the card) carries each config's
    ``quant`` section as a dict: the files' own, DGQ's weight as ``w_1``
    and ``w_2``."""
    import chip_smoke

    assert sorted(chip_smoke.A8_QUANT) == sorted(
        p.stem for p in METHODS.glob("*.yml") if p.stem in chip_smoke.A8_QUANT)
    assert len(chip_smoke.A8_QUANT) == 8
    for name, spec in chip_smoke.A8_QUANT.items():
        want = _dgq_quant() if name == "dgq_w4a8" else method_quant(name)
        assert spec == want, name
