"""Port parity: the checkpoint loader (``models/hf_loader.py`` with the
port's own safetensors reader and writer, ``models/st_io.py``) and the
llama3 rope tables, against the JAX loader and the ``safetensors``
package (CPU).

The tiny checkpoints come from the local ``transformers``
(``helpers.make_tiny_hf_llama``), untied and tied."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file

from helpers import make_tiny_hf_llama
from lightcompress_tpu.models import arch as JA
from lightcompress_tpu.models.hf_loader import (
    arch_from_hf_config as j_arch_from_hf_config)
from lightcompress_tpu.models.hf_loader import load_model as j_load_model
from lightcompress_tpu_torch import convert
from lightcompress_tpu_torch.models import arch as TA
from lightcompress_tpu_torch.models import hf_loader as TL
from lightcompress_tpu_torch.models import st_io
from lightcompress_tpu_torch.models.hf_config import arch_from_hf_config

# f32 logits of the same f32 weights: the two frameworks sum the matmuls,
# RMSNorm and softmax in other orders
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _ids(vocab=256, B=2, T=24, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def tiny_ckpt(request, tmp_path_factory):
    d, _ = make_tiny_hf_llama(str(tmp_path_factory.mktemp("ckpt")),
                              tie=request.param)
    return d


def test_loader_logits_match_jax_loader(tiny_ckpt):
    jm = j_load_model(tiny_ckpt, dtype=jnp.float32, with_tokenizer=False)
    tm = TL.load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    assert type(tm).__name__ == "Llama" and tm.tokenizer is None
    assert ("lm_head" in tm.params) == (not tm.arch.tie_word_embeddings)
    ids = _ids()
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    got = tm.forward(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and _rel(got, want) < TOL


def test_reader_matches_safetensors_package(tiny_ckpt):
    path = os.path.join(tiny_ckpt, "model.safetensors")
    ref = np_load_file(path)
    f = st_io.SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(ref)
    for k, a in ref.items():
        t = f.get(k, torch.device("cpu"))
        np.testing.assert_array_equal(t.numpy(), a)
    f.close()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_writer_read_by_safetensors_package(tmp_path, dtype):
    gen = torch.Generator()
    gen.manual_seed(1)
    tensors = {"b.w": torch.randn((3, 5), generator=gen).to(dtype),
               "a.v": torch.randn((7,), generator=gen).to(dtype)}
    path = str(tmp_path / "t.safetensors")
    n = st_io.write(path, tensors, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    got = torch_load_file(path)
    for k, t in tensors.items():
        assert got[k].dtype == dtype and torch.equal(got[k], t)
    f = st_io.SafetensorsFile(path)
    for k, t in tensors.items():
        r = f.get(k, torch.device("cpu"))
        # bf16 arrives as raw u16 and is reinterpreted, bit for bit
        assert r.dtype == dtype and torch.equal(r.view(torch.uint8),
                                                t.view(torch.uint8))
    f.close()


def test_save_params_read_by_jax_and_port(tiny_ckpt, tmp_path):
    tm = TL.load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    out = str(tmp_path / "saved")
    TL.save_params(tm, out, hf_config=tm.config)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == tm.config
    jm = j_load_model(out, dtype=jnp.float32, with_tokenizer=False)
    back = TL.load_model(out, dtype=torch.float32, device="cpu")
    ids = _ids(seed=1)
    want = tm.forward(torch.from_numpy(ids)).numpy()
    assert np.array_equal(back.forward(torch.from_numpy(ids)).numpy(), want)
    assert _rel(np.asarray(jm.forward(jnp.asarray(ids))), want) < TOL


def test_bf16_checkpoint_round_trip(tiny_ckpt, tmp_path):
    """A bf16 model written by the port (BF16 tensors) and read back by the
    JAX loader and the port: the same bits."""
    tm = TL.load_model(tiny_ckpt, dtype=torch.bfloat16, device="cpu")
    out = str(tmp_path / "bf16")
    TL.save_params(tm, out, hf_config=tm.config)
    raw = torch_load_file(os.path.join(out, "model.safetensors"))
    assert all(t.dtype == torch.bfloat16 for t in raw.values())
    back = TL.load_model(out, dtype=torch.bfloat16, device="cpu")
    jm = j_load_model(out, dtype=jnp.bfloat16, with_tokenizer=False)
    w = back.params["blocks"][1]["mlp"]["down"]["weight"]
    assert torch.equal(w, tm.params["blocks"][1]["mlp"]["down"]["weight"])
    jw = np.asarray(jm.params["blocks"][1]["mlp"]["down"]["weight"].astype(
        jnp.float32))
    np.testing.assert_array_equal(w.float().numpy(), jw)


def test_sharded_checkpoint_with_index(tiny_ckpt, tmp_path):
    src = st_io.SafetensorsFile(os.path.join(tiny_ckpt, "model.safetensors"))
    keys = sorted(src.keys())
    cpu = torch.device("cpu")
    out = tmp_path / "sharded"
    out.mkdir()
    halves = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    weight_map = {}
    for shard, ks in halves.items():
        st_io.write(str(out / shard), {k: src.get(k, cpu) for k in ks})
        weight_map.update(dict.fromkeys(ks, shard))
    src.close()
    with open(out / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(tiny_ckpt, "config.json")) as f:
        (out / "config.json").write_text(f.read())
    one = TL.load_model(tiny_ckpt, dtype=torch.float32, device="cpu")
    two = TL.load_model(str(out), dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(_ids(seed=2))
    assert torch.equal(one.forward(ids), two.forward(ids))


LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192}


def test_llama3_rope_tables_match_jax():
    cfg = {"model_type": "llama", "vocab_size": 128, "hidden_size": 512,
           "intermediate_size": 1024, "num_hidden_layers": 1,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
           "rope_scaling": LLAMA3_ROPE, "max_position_embeddings": 131072}
    tarch = arch_from_hf_config(cfg, dtype=torch.float32)
    jarch = j_arch_from_hf_config(cfg, dtype=jnp.float32)
    assert tarch.rope_llama3 == jarch.rope_llama3 == (8.0, 1.0, 4.0, 8192)
    pos = np.arange(0, 20000, 7)
    jc, js = JA.rope_cos_sin(jarch, jnp.asarray(pos))
    tc, ts = TA.rope_cos_sin(tarch, torch.from_numpy(pos))
    # the same inverse frequencies (checked through the tables at position
    # 1) and cos/sin of f32 angles up to 2e4 rad, each computed by its own
    # library's f32 cos and sin
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc[1]))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-5
    assert np.abs(ts.numpy() - np.asarray(js)).max() < 1e-5
    plain = arch_from_hf_config(dict(cfg, rope_scaling=None))
    assert not np.allclose(TA.rope_cos_sin(plain, torch.arange(64))[0],
                           TA.rope_cos_sin(tarch, torch.arange(64))[0])


@pytest.mark.parametrize("mt", ["mistral", "qwen2", "qwen3"])
def test_llama_like_configs_match_jax(mt):
    cfg = {"model_type": mt, "vocab_size": 128, "hidden_size": 256,
           "intermediate_size": 512, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 64, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
           "tie_word_embeddings": mt == "qwen3"}
    t, j = arch_from_hf_config(cfg), j_arch_from_hf_config(cfg)
    names = [f for f in t.__dataclass_fields__ if f != "dtype"]
    assert {n: getattr(t, n) for n in names} == \
        {n: getattr(j, n) for n in names}
    assert convert.arch_from_fields(
        {n: getattr(j, n) for n in names}) == t


def test_loader_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        arch_from_hf_config({"model_type": "gemma2"})
    with pytest.raises(NotImplementedError, match="A12"):
        arch_from_hf_config({"model_type": "llama", "hidden_act": "gelu",
                             "num_attention_heads": 2})
    with pytest.raises(FileNotFoundError):
        TL.ShardReader(str(tmp_path))
    (tmp_path / "pytorch_model.bin").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="A12"):
        TL.ShardReader(str(tmp_path))


def test_load_model_runs_on_the_card_by_default(tiny_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.load_model(tiny_ckpt)
