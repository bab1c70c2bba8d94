"""Text calibration data against the JAX package (CPU): every text preproc
returns JAX's samples bit for bit on the same seed, through a toy
tokenizer and a toy ``datasets.Dataset`` defined here over texts the test
writes; ``custom_txt`` files, ``_chat_wrap`` with ``add_answer``, the pad
id and batching; the tokenizer the loader finds; the AWQ CI config
calibrated on a ``custom_txt`` directory by the port's pipeline on its
own and on JAX's calibration data."""

import json
import random
import sys
import types

import numpy as np
import pytest

from lightcompress_tpu.config import load_config as j_load_config
from lightcompress_tpu.data import dataset as JD
from lightcompress_tpu_torch.config import load_config
from lightcompress_tpu_torch.data import dataset as PD
from lightcompress_tpu_torch.models.hf_loader import load_model, \
    load_tokenizer
from lightcompress_tpu_torch.pipeline import run_pipeline
from test_torch_pipeline import CI
from test_torch_serving import one_torch_thread  # noqa: F401

# the CI configs' tiny Llama, written by the port (no transformers import)
TINY_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 512, "model_type": "llama",
    "num_attention_heads": 4, "num_hidden_layers": 2,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "vocab_size": 256}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import torch

    from lightcompress_tpu_torch.models import (Llama, arch_from_hf_config,
                                                init_params)
    from lightcompress_tpu_torch.models.hf_loader import save_params

    arch = arch_from_hf_config(TINY_CONFIG, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    d = tmp_path_factory.mktemp("ckpt") / "tiny_llama"
    save_params(Llama(arch, init_params(gen, arch)), str(d),
                hf_config=TINY_CONFIG)
    return str(d)

WORDS = ("the quick brown fox jumps over a lazy dog while seven wizards "
         "quietly hex bold jumbo zebras under pale moonlight").split()


class ToyTokenizer:
    """Word-level ids from the letters (no hash seed): bos 1, eos 2, no pad
    id (the eos id pads); a chat template that tags each turn."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, None
    chat_template = "{% toy %}"

    @staticmethod
    def _ids(text, add_special_tokens=True):
        ids = [3 + sum(map(ord, w)) % 250 for w in text.split()]
        return ([1] if add_special_tokens else []) + ids

    def encode(self, text):
        return self._ids(text)

    def __call__(self, text, return_tensors=None, max_length=None,
                 truncation=False, padding=False, add_special_tokens=True):
        ids = self._ids(text, add_special_tokens)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return types.SimpleNamespace(input_ids=np.asarray([ids], np.int32))

    def apply_chat_template(self, msgs, tokenize=False,
                            add_generation_prompt=False):
        out = " ".join(f"<{m['role']}> {m['content']}" for m in msgs)
        return out + (" <assistant>" if add_generation_prompt else "")


class ToyDataset:
    """The ``datasets.Dataset`` calls the preprocs make: shuffle(seed),
    select, iteration, row and column indexing, map, len."""

    def __init__(self, rows):
        self.rows = [dict(r) for r in rows]

    def shuffle(self, seed):
        order = np.random.RandomState(seed).permutation(len(self.rows))
        return ToyDataset([self.rows[i] for i in order])

    def select(self, idx):
        return ToyDataset([self.rows[i] for i in idx])

    def map(self, fn):
        return ToyDataset([dict(r, **fn(r)) for r in self.rows])

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        if isinstance(i, str):
            return [r[i] for r in self.rows]
        return self.rows[i]


def _texts(n, seed, lo=3, hi=40):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi)))
            for _ in range(n)]


def _raw(preproc):
    texts = _texts(60, 0)
    if preproc == "ptb_gptq":
        return ToyDataset([{"sentence": t} for t in texts])
    if preproc == "random_truncate_txt":
        return texts
    if preproc == "ultrachat_general":
        return ToyDataset([{"messages": [
            {"role": "user", "content": t},
            {"role": "assistant", "content": t[::-1]}]} for t in texts])
    return ToyDataset([{"text": t} for t in texts])


PREPROCS = ("wikitext2_gptq", "ptb_gptq", "c4_gptq", "pileval_awq",
            "pileval_smooth", "pileval_omni", "random_truncate_txt",
            "txt_general_preproc", "ultrachat_general")


@pytest.mark.parametrize("preproc", PREPROCS)
def test_preproc_matches_jax(preproc):
    kw = {"key": "text"} if preproc == "txt_general_preproc" else {}
    out = []
    for mod in (JD, PD):
        random.seed(7)
        out.append(getattr(mod, preproc)(_raw(preproc), ToyTokenizer(), 6,
                                         12, **kw))
    want, got = out
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert b.dtype == np.int64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def text_dir(tmp_path):
    d = tmp_path / "texts"
    d.mkdir()
    (d / "a.txt").write_text("\n".join(_texts(20, 1)) + "\n")
    (d / "b.jsonl").write_text("\n".join(
        json.dumps({"text": t}) for t in _texts(20, 2)) + "\n")
    (d / "c.md").write_text("not read")
    return d


@pytest.mark.parametrize("chat,add_answer", [(False, False), (True, False),
                                             (True, True)])
@pytest.mark.parametrize("bs", [1, 2, -1])
def test_custom_txt_matches_jax(text_dir, chat, add_answer, bs):
    """A directory of .txt/.jsonl files (and one file alone), the chat
    template with and without the answer turn, batches with the pad id."""
    cfg = dict(name="custom_txt", path=str(text_dir), n_samples=5,
               seq_len=10, bs=bs, preproc="random_truncate_txt", seed=3,
               apply_chat_template=chat, add_answer=add_answer)
    tok = ToyTokenizer()
    jds, pds = JD.CalibDataset(tok, cfg), PD.CalibDataset(tok, cfg)
    assert jds.raw == pds.raw and len(pds.raw) == 40
    assert pds._pad_id() == jds._pad_id() == 2
    (jb, jm), (pb, pm) = jds.get_calib_dataset(), pds.get_calib_dataset()
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(a, b)
    assert (jm is None) == (pm is None)
    one = dict(cfg, path=str(text_dir / "b.jsonl"))
    assert PD.CalibDataset(tok, one).raw == JD.CalibDataset(tok, one).raw


def test_chat_wrap_on_a_dataset_with_answers():
    """add_answer keeps a sample's ``answer`` as the assistant turn."""
    tok = ToyTokenizer()
    raw = ToyDataset([{"text": "hello there", "answer": "general"},
                      {"text": "no answer here"}])
    wrap = []
    for mod in (JD, PD):
        ds = mod.CalibDataset.__new__(mod.CalibDataset)
        ds.tokenizer, ds.add_answer = tok, True
        wrap.append(list(ds._chat_wrap(raw, "text")))
    assert wrap[0] == wrap[1]
    assert wrap[1][0]["text"] == "<user> hello there <assistant> general"
    assert wrap[1][1]["text"].endswith("<assistant>")


def test_text_source_needs_a_tokenizer_and_disk_sets_raise(text_dir):
    cfg = dict(name="custom_txt", path=str(text_dir), n_samples=2,
               seq_len=8, preproc="random_truncate_txt")
    with pytest.raises(ValueError, match="no tokenizer"):
        PD.CalibDataset(None, cfg).get_samples()
    with pytest.raises(NotImplementedError, match="A4"):
        PD.CalibDataset(ToyTokenizer(), dict(cfg, name="pileval"))


def _fake_transformers(monkeypatch, tok):
    """A stand-in ``transformers`` whose AutoTokenizer returns ``tok`` (or
    raises when ``tok`` is an exception)."""
    def from_pretrained(path, **kw):
        if isinstance(tok, Exception):
            raise tok
        return tok

    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = types.SimpleNamespace(from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", mod)


def test_load_model_reads_the_tokenizer(tiny_ckpt, tmp_path, monkeypatch):
    """None without tokenizer files (transformers is not imported), the
    package's tokenizer where there are files, None where it fails."""
    import shutil

    assert load_tokenizer(tiny_ckpt) is None
    d = tmp_path / "ckpt"
    shutil.copytree(tiny_ckpt, d)
    (d / "tokenizer_config.json").write_text("{}")
    tok = ToyTokenizer()
    _fake_transformers(monkeypatch, tok)
    assert load_model(str(d), device="cpu").tokenizer is tok
    assert load_model(str(d), device="cpu",
                      with_tokenizer=False).tokenizer is None
    _fake_transformers(monkeypatch, OSError("no vocab"))
    assert load_model(str(d), device="cpu").tokenizer is None


def tokenized_ckpt(tiny_ckpt, tmp_path, monkeypatch):
    """A copy of the tiny checkpoint with a tokenizer file, the stand-in
    ``transformers`` returning the toy tokenizer for it."""
    import shutil

    d = tmp_path / "ckpt"
    shutil.copytree(tiny_ckpt, d)
    (d / "tokenizer_config.json").write_text("{}")
    _fake_transformers(monkeypatch, ToyTokenizer())
    return str(d)


def text_calib_config(load, ckpt, text_dir):
    """The AWQ CI config calibrated on a custom_txt directory, evaluated
    at fake_quant (PPL)."""
    cfg = load(str(CI))
    cfg.model.path = ckpt
    cfg.calib.update(name="custom_txt", path=str(text_dir),
                     preproc="random_truncate_txt", n_samples=4, seq_len=16,
                     bs=-1)
    cfg.eval["eval_pos"] = ["fake_quant"]
    cfg.eval["eval_token_consist"] = False
    return cfg


def test_pipeline_calibrates_on_custom_txt(tiny_ckpt, text_dir, tmp_path,
                                           monkeypatch):
    """The AWQ CI config calibrated on a custom_txt directory through the
    toy tokenizer: the port's pipeline gives the fake-quant PPL it gives
    when handed JAX's ``CalibDataset`` instead of its own, so it calibrates
    on JAX's samples.  (JAX's pipeline on the same directory is held to
    the port's in test_torch_export.py's CI config run.)"""
    import lightcompress_tpu_torch.pipeline as P

    ckpt = tokenized_ckpt(tiny_ckpt, tmp_path, monkeypatch)
    got = run_pipeline(text_calib_config(load_config, ckpt, text_dir),
                       device="cpu")
    used = []

    def jax_data(tokenizer, cfg):
        used.append(cfg["name"])
        return JD.CalibDataset(tokenizer, cfg)

    monkeypatch.setattr(P, "CalibDataset", jax_data)
    want = run_pipeline(text_calib_config(load_config, ckpt, text_dir),
                        device="cpu")
    assert used == ["custom_txt"]
    assert sorted(got) == sorted(want) == ["ppl_fake_quant"]
    assert got["ppl_fake_quant"] == want["ppl_fake_quant"]
