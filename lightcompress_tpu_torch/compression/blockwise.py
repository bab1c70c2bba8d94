"""The blockwise engine (port of lightcompress_tpu/compression/
blockwise.py): walk the blocks, run every calibration batch through each
to collect the inputs of its linears (the block forward returns them),
hand them to the algorithm's ``block_transform``, and feed the block's
outputs to the next.

One process: the port has no data-parallel calibration yet (ROADMAP A14),
so the JAX package's cross-rank means are the identity here.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import torch

from ..config import DotDict
from ..models import arch as A


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BlockwiseOpt:
    def __init__(self, model, compress_config: DotDict,
                 input_batches: List[torch.Tensor],
                 padding_masks: Optional[List] = None,
                 config: Optional[DotDict] = None):
        self.model = model
        self.compress_config = compress_config or DotDict()
        self.quant_config = self.compress_config  # reference naming
        self.config = config or DotDict()
        self.input_batches = list(input_batches)
        self.padding_masks = padding_masks
        self.block_idx: int = -1
        self.n_samples = sum(int(b.shape[0]) for b in input_batches)
        self.act_scales: Dict[str, torch.Tensor] = {}
        # seconds each block took (synchronised on the card)
        self.block_seconds: List[float] = []

    def run_block_loop(self) -> None:
        for idx in range(self.model.num_blocks):
            self.block_idx = idx
            t0 = time.time()
            self.block_opt(idx)
            _sync(self.model.device)
            self.block_seconds.append(time.time() - t0)
        self.save_artifacts()

    def save_artifacts(self) -> None:
        special = self.compress_config.get("special", {})
        if special.get("save_scale", False) and self.act_scales:
            path = special["scale_path"]
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "scales.pkl"), "wb") as f:
                pickle.dump({k: v.float().cpu().numpy()
                             for k, v in self.act_scales.items()}, f)

    def collect_block_io(self, block_idx: int,
                         linear_fn: Optional[A.LinearFn] = None):
        """Every calibration batch through block ``block_idx``: (feats:
        linear name -> list of its inputs, outputs)."""
        bp = self.model.blocks[block_idx]
        feats_acc: Dict[str, List[torch.Tensor]] = {}
        outs = []
        for x in self.input_batches:
            y, feats, _ = self.model.block_forward(
                block_idx, x, linear_fn=linear_fn, block_params=bp)
            outs.append(y)
            for k, v in feats.items():
                feats_acc.setdefault(k, []).append(v)
        return feats_acc, outs

    def block_forward_batches(self, block_idx: int,
                              linear_fn: Optional[A.LinearFn] = None
                              ) -> List[torch.Tensor]:
        bp = self.model.blocks[block_idx]
        return [self.model.block_forward(block_idx, x, linear_fn=linear_fn,
                                         block_params=bp)[0]
                for x in self.input_batches]

    def block_opt(self, block_idx: int):
        raise NotImplementedError

    def block_transform(self, block_idx: int, input_feat, *args):
        raise NotImplementedError
