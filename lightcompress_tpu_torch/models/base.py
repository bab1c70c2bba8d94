"""Model adapters (port of the ``Llama`` and ``Qwen3Moe`` adapters in
lightcompress_tpu/models/base.py): arch + params + the block topology the
serving-weight builder walks."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import arch as A

# llama.py:52-91 topology, canonical names (the JAX LLAMA_SUBSETS layers)
LLAMA_LINEARS = ("attn.q", "attn.k", "attn.v", "attn.o",
                 "mlp.gate", "mlp.up", "mlp.down")
# a MoE block (the JAX MOE_SUBSETS layers): the router first, with the
# experts' gate/up (and the shared experts' where the block has them)
# under ln2, then the expert down projections, then the shared down
MOE_LINEARS = ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.router",
               "mlp.gate", "mlp.up", "mlp.shared_gate", "mlp.shared_up",
               "mlp.down", "mlp.shared_down")


def resolve(tree: Dict, dotted: str) -> Dict:
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


class Llama:
    """Holds an ArchSpec and its parameter tree."""

    def __init__(self, arch: A.ArchSpec, params: Dict):
        self.arch = arch
        self.params = params

    @property
    def num_blocks(self) -> int:
        return len(self.params["blocks"])

    def get_block_linear_names(self, block_idx: int) -> List[str]:
        mlp = self.params["blocks"][block_idx]["mlp"]
        if "router" not in mlp:
            return list(LLAMA_LINEARS)
        shared = "shared_gate" in mlp
        return [n for n in MOE_LINEARS
                if shared or not n.startswith("mlp.shared")]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return A.model_forward(self.arch, self.params, input_ids)


class Qwen3Moe(Llama):
    """Qwen3-MoE (``qwen3_moe``): the MoE llama family's linear names, with
    the per-head q/k RMSNorm of ``arch.qk_norm``."""

    def __init__(self, arch: A.ArchSpec, params: Dict):
        if arch.moe is None or not arch.qk_norm:
            raise ValueError("Qwen3Moe needs arch.moe and arch.qk_norm")
        super().__init__(arch, params)
