"""Calibration data (port of lightcompress_tpu/data/dataset.py): preprocs
return lists of int64 numpy arrays shaped (1, L), batched as the reference
batches them.

Sources: ``synthetic`` (deterministic random token ids, ``synthetic_
random``) and ``custom_txt`` (local ``.txt`` lines or ``.jsonl`` ``text``
fields, a file or a directory of them); the text preprocs (``wikitext2_
gptq``, ``ptb_gptq``, ``c4_gptq``, ``pileval_awq``, ``pileval_smooth``,
``pileval_omni``, ``random_truncate_txt``, ``txt_general_preproc``,
``ultrachat_general``) are functions of the raw texts and the model's
tokenizer (a ``transformers`` tokenizer or anything with its call,
``encode`` and ``apply_chat_template``), JAX's line for line, so that the
same seed gives the same samples; ``apply_chat_template`` (with
``add_answer``) wraps the texts in the tokenizer's chat template.  The
preprocs that ``shuffle`` take a ``datasets.Dataset``-like object, as in
JAX.  A text preproc without a tokenizer raises ``ValueError``.  The
datasets saved with ``save_to_disk`` (``load_from_disk``) raise
``NotImplementedError`` naming ROADMAP A4: they need the ``datasets``
package and files the repository does not hold; ``img_general`` waits for
the multimodal models (A12).
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..registry import PREPROC_REGISTRY

_DISK = ("ROADMAP A4 (the datasets saved with save_to_disk need the "
         "datasets package and files the repository does not hold)")


# ---------------------------------------------------------------------------
# preprocs
# ---------------------------------------------------------------------------

def _tok_ids(tokenizer, text: str) -> np.ndarray:
    ids = tokenizer(text, return_tensors="np").input_ids
    return np.asarray(ids).astype(np.int64)


def _windows(enc: np.ndarray, n_samples: int, seq_len: int):
    """``n_samples`` random windows of ``seq_len`` ids (Python's
    ``random``, seeded by the dataset)."""
    samples = []
    for _ in range(n_samples):
        i = random.randint(0, enc.shape[1] - seq_len - 1)
        samples.append(enc[:, i:i + seq_len])
    return samples


@PREPROC_REGISTRY
def wikitext2_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    enc = _tok_ids(tokenizer, "\n\n".join(calib_dataset["text"]))
    return _windows(enc, n_samples, seq_len)


@PREPROC_REGISTRY
def ptb_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    enc = _tok_ids(tokenizer, " ".join(calib_dataset["sentence"]))
    return _windows(enc, n_samples, seq_len)


@PREPROC_REGISTRY
def c4_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    samples = []
    for _ in range(n_samples):
        while True:
            i = random.randint(0, len(calib_dataset) - 1)
            enc = _tok_ids(tokenizer, calib_dataset[i]["text"])
            if enc.shape[1] >= seq_len:
                break
        i = random.randint(0, enc.shape[1] - seq_len - 1)
        samples.append(enc[:, i:i + seq_len])
    return samples


@PREPROC_REGISTRY
def pileval_awq(calib_dataset, tokenizer, n_samples, seq_len):
    dataset = calib_dataset.shuffle(seed=42)
    chunks, n_run = [], 0
    for data in dataset:
        line = data["text"].strip()
        ids = tokenizer.encode(line)
        if len(ids) > seq_len or len(ids) == 0:
            continue
        chunks.append(np.asarray([ids], dtype=np.int64))
        n_run += 1
        if n_run == n_samples:
            break
    cat = np.concatenate(chunks, axis=1)
    n_split = cat.shape[1] // seq_len
    return [cat[:, i * seq_len:(i + 1) * seq_len] for i in range(n_split)]


def _truncated_ids(tokenizer, text: str, seq_len: int) -> np.ndarray:
    ids = tokenizer(text, return_tensors="np", max_length=seq_len,
                    truncation=True).input_ids
    return np.asarray(ids).astype(np.int64)


@PREPROC_REGISTRY
def pileval_smooth(calib_dataset, tokenizer, n_samples, seq_len):
    dataset = calib_dataset.shuffle(seed=42)
    samples, n_run = [], 0
    for data in dataset:
        samples.append(_truncated_ids(tokenizer, data["text"], seq_len))
        n_run += 1
        if n_run == n_samples:
            break
    return samples


@PREPROC_REGISTRY
def pileval_omni(calib_dataset, tokenizer, n_samples, seq_len):
    enc = _tok_ids(tokenizer, "\n\n".join(calib_dataset["text"][:1000]))
    return _windows(enc, n_samples, seq_len)


@PREPROC_REGISTRY
def random_truncate_txt(calib_dataset, tokenizer, n_samples, seq_len):
    calib_dataset = list(calib_dataset)
    random.shuffle(calib_dataset)
    enc = _tok_ids(tokenizer, "\n\n".join(calib_dataset))
    return _windows(enc, n_samples, seq_len)


@PREPROC_REGISTRY
def txt_general_preproc(calib_dataset, tokenizer, n_samples, seq_len, key):
    dataset = calib_dataset.shuffle(seed=42)
    samples, n_run = [], 0
    for data in dataset:
        ids = _truncated_ids(tokenizer, data[key], seq_len)
        if ids.shape[1] < seq_len:
            continue
        samples.append(ids)
        n_run += 1
        if n_run == n_samples:
            break
    return samples


@PREPROC_REGISTRY
def ultrachat_general(calib_dataset, tokenizer, n_samples, seq_len):
    dataset = calib_dataset.shuffle(seed=42).select(range(n_samples))
    samples = []
    for ex in dataset:
        text = tokenizer.apply_chat_template(ex["messages"], tokenize=False)
        ids = tokenizer(text, padding=False, max_length=seq_len,
                        truncation=True, add_special_tokens=False,
                        return_tensors="np").input_ids
        samples.append(np.asarray(ids).astype(np.int64))
    return samples


@PREPROC_REGISTRY
def synthetic_random(calib_dataset, tokenizer, n_samples, seq_len):
    """Deterministic random ids in [0, vocab_size)."""
    vocab = calib_dataset.get("vocab_size", 256)
    rng = np.random.RandomState(calib_dataset.get("seed", 0))
    return [rng.randint(0, vocab, size=(1, seq_len)).astype(np.int64)
            for _ in range(n_samples)]


# ---------------------------------------------------------------------------
# dataset container
# ---------------------------------------------------------------------------

class CalibDataset:
    FIELD_MAP = {"pileval": "text", "c4": "text", "wikitext2": "text",
                 "ptb": "sentence"}

    def __init__(self, tokenizer, calib_cfg: Dict[str, Any]):
        self.tokenizer = tokenizer
        self.cfg = calib_cfg
        self.name = calib_cfg["name"]
        self.path = calib_cfg.get("path", None)
        self.n_samples = calib_cfg.get("n_samples", 128)
        self.bs = calib_cfg.get("bs", 1)
        self.seq_len = calib_cfg.get("seq_len", 512)
        self.preproc = calib_cfg.get("preproc", "txt_general_preproc")
        self.padding = calib_cfg.get("padding", False)
        self.seed = calib_cfg.get("seed", 42)
        self.apply_chat_template = calib_cfg.get("apply_chat_template",
                                                 False)
        self.add_answer = calib_cfg.get("add_answer", False)
        self.raw = self._load()

    def _load(self):
        if self.name == "synthetic":
            return {"vocab_size": self.cfg.get("vocab_size", 256),
                    "seed": self.seed}
        if self.name == "custom_txt":
            # a .txt file's lines or a .jsonl file's ``text`` fields, or
            # those of every such file of a directory in name order
            if os.path.isdir(self.path):
                files = [os.path.join(self.path, f)
                         for f in sorted(os.listdir(self.path))
                         if f.endswith((".txt", ".jsonl"))]
            else:
                files = [self.path]
            texts: List[str] = []
            for fp in files:
                with open(fp) as f:
                    if fp.endswith(".jsonl"):
                        texts += [json.loads(line).get("text", "")
                                  for line in f]
                    else:
                        texts += [line.rstrip("\n") for line in f]
            return texts
        raise NotImplementedError(
            f"calibration dataset {self.name!r}: {_DISK}")

    def _chat_wrap(self, raw, key: str):
        """Each text in the tokenizer's chat template (``add_answer`` keeps
        a sample's ``answer`` as the assistant turn); unchanged without a
        tokenizer or template."""
        tok = self.tokenizer
        if tok is None or not getattr(tok, "chat_template", None):
            return raw

        def wrap_text(text, ans=""):
            msgs = [{"role": "user", "content": str(text)}]
            if self.add_answer and ans:
                msgs.append({"role": "assistant", "content": str(ans)})
            return tok.apply_chat_template(
                msgs, tokenize=False,
                add_generation_prompt=not (self.add_answer and ans))

        if hasattr(raw, "map"):  # a Dataset: rewrite the text column
            return raw.map(lambda ex: {key: wrap_text(ex.get(key, ""),
                                                      ex.get("answer", ""))})
        if isinstance(raw, list):
            return [wrap_text(x) for x in raw]
        return raw

    def get_samples(self) -> List[np.ndarray]:
        random.seed(self.seed)
        fn = PREPROC_REGISTRY[self.preproc]
        if self.preproc != "synthetic_random" and self.tokenizer is None:
            raise ValueError(
                f"calibration preproc {self.preproc!r} tokenizes text and "
                f"the model has no tokenizer (load_model(with_tokenizer="
                f"True) found none in the model directory)")
        raw = self.raw
        key = self.FIELD_MAP.get(self.name, "text")
        if self.apply_chat_template:
            raw = self._chat_wrap(raw, key)
        kwargs = {"key": key} if self.preproc == "txt_general_preproc" \
            else {}
        return fn(raw, self.tokenizer, self.n_samples, self.seq_len,
                  **kwargs)

    def get_calib_dataset(self, shard: Tuple[int, int] = (0, 1)
                          ) -> Tuple[List[np.ndarray],
                                     Optional[List[np.ndarray]]]:
        """(batches, padding_masks); ``shard=(rank, world)`` strides the
        samples across data-parallel workers."""
        rank, world = shard
        samples = self.get_samples()[rank::world]
        if not samples:
            raise ValueError("no calib samples after sharding")
        return batch_samples(samples, self.bs, self.padding,
                             pad_id=self._pad_id())

    def _pad_id(self) -> int:
        """The tokenizer's pad id, else its eos id, else 0."""
        tok = self.tokenizer
        if tok is None:
            return 0
        pid = getattr(tok, "pad_token_id", None)
        if pid is None:
            pid = getattr(tok, "eos_token_id", 0) or 0
        return int(pid)


def batch_samples(samples: List[np.ndarray], bs: int, padding: bool = False,
                  pad_id: int = 0
                  ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
    """bs=-1 one batch, bs=1 singles, bs=n groups (left-padded where the
    lengths differ, with masks)."""
    if bs == -1:
        groups = [samples]
    elif bs == 1:
        return [s.astype(np.int32) for s in samples], None
    else:
        groups = [samples[i:i + bs] for i in range(0, len(samples), bs)]
    batches, masks = [], []
    any_pad = False
    for g in groups:
        max_len = max(s.shape[1] for s in g)
        if all(s.shape[1] == max_len for s in g):
            batches.append(np.concatenate(g, axis=0).astype(np.int32))
            masks.append(np.ones((len(g), max_len), dtype=np.int32))
        else:
            any_pad = True
            padded = np.full((len(g), max_len), pad_id, dtype=np.int32)
            mask = np.zeros((len(g), max_len), dtype=np.int32)
            for r, s in enumerate(g):
                L = s.shape[1]
                padded[r, max_len - L:] = s[0]
                mask[r, max_len - L:] = 1
            batches.append(padded)
            masks.append(mask)
    return batches, (masks if (padding or any_pad) else None)
