"""The blockwise engine (port of lightcompress_tpu/compression/
blockwise.py): walk the blocks, run every calibration batch through each
to collect the inputs of its linears (the block forward returns them),
hand them to the algorithm's ``block_transform``, and feed the block's
outputs to the next.

The loop runs under the algorithm's ``timer`` (``utils.profiling``; the
pipeline hands it its own): phases ``block_loop/<method>`` and
``block_loop/<method>/block``, as JAX's.  ``save_artifacts`` writes the
act scales (``special.save_scale``) to ``<scale_path>/scales.pkl`` and the
v2 clip factors (``special.save_clip``) to ``<clip_path>/clips.pkl``, as
numpy arrays under JAX's keys, each only where there is something to
save.

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
from ..utils.profiling import PhaseTimer


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
        # block idx -> {"<linear>.upbound_factor" | "<linear>.lowbound_factor"
        # -> factors or None}: the v2 clip factors ``special.save_clip`` keeps
        self.weight_clips: Dict[int, Dict[str, Optional[torch.Tensor]]] = {}
        # seconds each block took (synchronised on the card)
        self.block_seconds: List[float] = []
        self.timer = PhaseTimer(model.device)

    def run_block_loop(self) -> None:
        method = self.compress_config.get("method", type(self).__name__)
        with self.timer.phase(f"block_loop/{method}"):
            for idx in range(self.model.num_blocks):
                self.block_idx = idx
                t0 = time.time()
                with self.timer.phase("block"):  # synchronised at its end
                    self.block_opt(idx)
                self.block_seconds.append(time.time() - t0)
        self.save_artifacts()

    def save_artifacts(self) -> None:
        special = self.compress_config.get("special", {})

        def dump(path, name, obj):
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, name), "wb") as f:
                pickle.dump(obj, f)

        if special.get("save_scale", False) and self.act_scales:
            dump(special["scale_path"], "scales.pkl",
                 {k: v.float().cpu().numpy()
                  for k, v in self.act_scales.items()})
        if special.get("save_clip", False) and self.weight_clips:
            dump(special["clip_path"], "clips.pkl",
                 {b: {k: None if v is None else v.float().cpu().numpy()
                      for k, v in clips.items()}
                  for b, clips in self.weight_clips.items()})

    def collect_block_io(self, block_idx: int,
                         linear_fn: Optional[A.LinearFn] = None):
        """Every calibration batch through block ``block_idx``: (feats:
        linear name -> list of its inputs, outputs).  Each batch's post-rope
        (k, v) is kept in ``_last_kv_states`` (the static KV calibration
        reads it)."""
        bp = self.model.blocks[block_idx]
        feats_acc: Dict[str, List[torch.Tensor]] = {}
        outs, kvs = [], []
        for x in self.input_batches:
            y, feats, kv = self.model.block_forward(
                block_idx, x, linear_fn=linear_fn, block_params=bp)
            outs.append(y)
            kvs.append(kv)
            for k, v in feats.items():
                feats_acc.setdefault(k, []).append(v)
        self._last_kv_states = kvs
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
