"""Calibration data (port of lightcompress_tpu/data/dataset.py, the
synthetic source): preprocs return lists of int64 numpy arrays shaped
(1, L), batched as the reference batches them.

Only ``synthetic`` data (deterministic random token ids, ``synthetic_
random``) is ported: the text datasets (pileval, wikitext2, c4, ptb,
custom text) need the ``datasets`` package and a tokenizer and raise
``NotImplementedError`` naming ROADMAP A4.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..registry import PREPROC_REGISTRY

_TEXT = "ROADMAP A4 (the text datasets and the tokenizer)"


@PREPROC_REGISTRY
def synthetic_random(calib_dataset, tokenizer, n_samples, seq_len):
    """Deterministic random ids in [0, vocab_size)."""
    vocab = calib_dataset.get("vocab_size", 256)
    rng = np.random.RandomState(calib_dataset.get("seed", 0))
    return [rng.randint(0, vocab, size=(1, seq_len)).astype(np.int64)
            for _ in range(n_samples)]


class CalibDataset:
    def __init__(self, tokenizer, calib_cfg: Dict[str, Any]):
        self.tokenizer = tokenizer
        self.cfg = calib_cfg
        self.name = calib_cfg["name"]
        self.n_samples = calib_cfg.get("n_samples", 128)
        self.bs = calib_cfg.get("bs", 1)
        self.seq_len = calib_cfg.get("seq_len", 512)
        self.preproc = calib_cfg.get("preproc", "txt_general_preproc")
        self.padding = calib_cfg.get("padding", False)
        self.seed = calib_cfg.get("seed", 42)
        if calib_cfg.get("apply_chat_template", False):
            raise NotImplementedError(f"apply_chat_template: {_TEXT}")
        self.raw = self._load()

    def _load(self):
        if self.name != "synthetic":
            raise NotImplementedError(
                f"calibration dataset {self.name!r}: {_TEXT}")
        return {"vocab_size": self.cfg.get("vocab_size", 256),
                "seed": self.seed}

    def get_samples(self) -> List[np.ndarray]:
        random.seed(self.seed)
        if self.preproc != "synthetic_random":
            raise NotImplementedError(f"preproc {self.preproc!r}: {_TEXT}")
        return PREPROC_REGISTRY[self.preproc](self.raw, self.tokenizer,
                                              self.n_samples, self.seq_len)

    def get_calib_dataset(self, shard: Tuple[int, int] = (0, 1)
                          ) -> Tuple[List[np.ndarray],
                                     Optional[List[np.ndarray]]]:
        """(batches, padding_masks); ``shard=(rank, world)`` strides the
        samples across data-parallel workers."""
        rank, world = shard
        samples = self.get_samples()[rank::world]
        if not samples:
            raise ValueError("no calib samples after sharding")
        return batch_samples(samples, self.bs, self.padding, pad_id=0)


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
