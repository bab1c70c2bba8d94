"""Model adapters and their subset tables (port of
lightcompress_tpu/models/base.py, the llama-topology adapters: ``Llama``,
``Mistral``, ``Qwen2``, ``Qwen3`` and the MoE ``Qwen3Moe``).

An adapter holds an ArchSpec and its parameter tree and exposes what the
calibration pipeline and the serving-weight builder walk: the subset table
(each equivalent-transform unit of a block: its linears, the op its scale
folds into, which collected input feeds it, which sub-forward re-runs it),
the first block's input (the embedding), one block's forward with its
feats, one subset's sub-forward, and the fake-quant deployment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..registry import MODEL_REGISTRY
from . import arch as A
from .arch import resolve


@dataclasses.dataclass(frozen=True)
class Subset:
    """One equivalent-transform unit inside a block."""

    layers: Tuple[str, ...]
    prev_op: Optional[str]  # canonical param path ('ln1', 'attn.v') or None
    prev_type: Optional[str]  # 'norm' | 'linear' | None
    input: str  # key into the collected feats
    inspect: str  # 'attn' | 'mlp' | a single linear name
    is_mlp: bool = False  # QuaRot: the down projection's online rotation


# llama.py:52-91 topology, canonical names
LLAMA_SUBSETS = (
    Subset(layers=("attn.q", "attn.k", "attn.v"), prev_op="ln1",
           prev_type="norm", input="attn.q", inspect="attn"),
    Subset(layers=("attn.o",), prev_op="attn.v", prev_type="linear",
           input="attn.o", inspect="attn.o"),
    Subset(layers=("mlp.gate", "mlp.up"), prev_op="ln2", prev_type="norm",
           input="mlp.gate", inspect="mlp", is_mlp=True),
    Subset(layers=("mlp.down",), prev_op="mlp.up", prev_type="linear",
           input="mlp.down", inspect="mlp.down", is_mlp=True),
)

# a MoE block: the router and every expert's gate/up (and the shared
# experts') scaled together under ln2, then the expert down projections,
# then the shared down
MOE_SUBSETS = LLAMA_SUBSETS[:2] + (
    Subset(layers=("mlp.router", "mlp.gate", "mlp.up", "mlp.shared_gate",
                   "mlp.shared_up"), prev_op="ln2", prev_type="norm",
           input="mlp.gate", inspect="mlp", is_mlp=True),
    LLAMA_SUBSETS[3],
    Subset(layers=("mlp.shared_down",), prev_op="mlp.shared_up",
           prev_type="linear", input="mlp.shared_down",
           inspect="mlp.shared_down", is_mlp=True),
)


class BaseModel:
    """Holds arch + params (+ the HF config it was loaded from) and exposes
    the pipeline-facing API, and the tokenizer ``load_model`` found (or
    None)."""

    subsets: Tuple[Subset, ...] = LLAMA_SUBSETS

    def __init__(self, arch: A.ArchSpec, params: Dict, tokenizer=None,
                 config: Optional[Dict] = None):
        self.arch = arch
        self.params = params
        self.tokenizer = tokenizer
        self.config = config
        # per-block deployed linear_fn (None = default_linear); the
        # weight-only deployments bake their weights instead
        self.linear_fns: Optional[List[A.LinearFn]] = None
        # per-block KV-cache fake quant ``(k, v) -> (k, v)``
        self.kv_hooks: Optional[List[Optional[Callable]]] = None
        # QuaRot's online rotations: linear name -> ("full", 0) or
        # ("head", head_dim)
        self.rotate_cfg: Dict[str, Tuple[str, int]] = {}
        # the act-quant hooks inside attention (``quant_attn``)
        self.attn_matmul_hook: Optional[Callable] = None
        self.attn_softmax_hook: Optional[Callable] = None

    # -- online rotation ---------------------------------------------------
    def apply_online_rotate(self, name: str, x: torch.Tensor
                            ) -> torch.Tensor:
        """The online Hadamard of ``name``'s input, if QuaRot set one."""
        cfg = self.rotate_cfg.get(name)
        if cfg is None:
            return x
        from ..ops.hadamard import online_rotate

        return online_rotate(x, *cfg)

    def default_linear_fn(self) -> Optional[A.LinearFn]:
        """The float linear with the online rotations (None without)."""
        if not self.rotate_cfg:
            return None

        def lf(name, w, b, x):
            return A.default_linear(name, w, b,
                                    self.apply_online_rotate(name, x))

        return lf

    # -- topology ----------------------------------------------------------
    @property
    def blocks(self) -> List[Dict]:
        return self.params["blocks"]

    def get_param_blocks(self) -> List[Dict]:
        return self.params["blocks"]

    def set_param_blocks(self, blocks: List[Dict]) -> None:
        self.params["blocks"] = blocks

    @property
    def num_blocks(self) -> int:
        return len(self.params["blocks"])

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["weight"].device

    def get_subsets_in_block(self, block_idx: int) -> Tuple[Subset, ...]:
        mlp = self.get_param_blocks()[block_idx].get("mlp", {})
        if self.arch.moe is None or "router" not in mlp:
            return self.subsets
        shared = "shared_gate" in mlp
        out = []
        for s in MOE_SUBSETS:
            layers = tuple(n for n in s.layers
                           if shared or not n.startswith("mlp.shared"))
            if layers:
                out.append(dataclasses.replace(s, layers=layers))
        return tuple(out)

    def get_block_linear_names(self, block_idx: int) -> List[str]:
        return [n for s in self.get_subsets_in_block(block_idx)
                for n in s.layers]

    def get_layernorm_names(self, block_idx: int) -> List[str]:
        return ["ln1", "ln2"]

    # -- forwards ----------------------------------------------------------
    def rope_tables(self, T: int, device):
        return A.rope_cos_sin(self.arch, torch.arange(T, device=device))

    def collect_first_block_input(self, calib_batches: List[torch.Tensor]
                                  ) -> List[torch.Tensor]:
        """The embedding of each calibration batch (the reference's
        Catcher), on the model's device."""
        return [A.embed_forward(self.arch, self.params,
                                b.to(self.device).long())
                for b in calib_batches]

    def block_forward(self, block_idx: int, x: torch.Tensor,
                      linear_fn: Optional[A.LinearFn] = None,
                      block_params: Optional[Dict] = None):
        """(y, feats, (k, v)) of block ``block_idx`` (or ``block_params``)
        on x (B, T, H)."""
        bp = block_params if block_params is not None else \
            self.blocks[block_idx]
        T = x.shape[1]
        cos, sin = self.rope_tables(T, x.device)
        mask = A.causal_mask(T, T, device=x.device)
        return A.block_forward(self.arch, bp, x, cos, sin, mask,
                               linear_fn or self.default_linear_fn()
                               or A.default_linear)

    def inspect_forward(self, block_idx: int, subset: Subset,
                        x: torch.Tensor,
                        linear_fn: Optional[A.LinearFn] = None,
                        block_params: Optional[Dict] = None
                        ) -> torch.Tensor:
        """Re-run one subset's sub-module on its input x (AWQ's
        ``inspect_module``)."""
        bp = block_params if block_params is not None else \
            self.blocks[block_idx]
        lf = linear_fn or self.default_linear_fn() or A.default_linear
        if subset.inspect == "attn":
            T = x.shape[1]
            cos, sin = self.rope_tables(T, x.device)
            return A.attn_inspect(self.arch, bp, x, cos, sin,
                                  A.causal_mask(T, T, device=x.device), lf)
        if subset.inspect == "mlp":
            return A.mlp_inspect(self.arch, bp, x, lf)
        return A.linear_inspect(bp, subset.inspect, x, lf)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """f32 logits of the current deployment."""
        lfs = self.linear_fns
        if lfs is None and self.rotate_cfg:
            lfs = [self.default_linear_fn()] * self.num_blocks
        return A.model_forward(self.arch, self.params,
                               input_ids.to(self.device).long(),
                               linear_fns=lfs,
                               matmul_hook=self.attn_matmul_hook,
                               softmax_hook=self.attn_softmax_hook,
                               kv_hooks=self.kv_hooks)

    # -- deploy ------------------------------------------------------------
    def deploy_float(self) -> None:
        self.linear_fns = None
        self.kv_hooks = None

    def deploy_fake_quant(self, w_qdq_fns: List[Dict[str, Callable]],
                          a_qdq_fns: Optional[List[Dict[str, Callable]]]
                          = None, kv_hooks=None) -> None:
        """Bake each block's weight qdq (``{name: fn(w, name)}``) into its
        params once, install each block's online rotations and act qdq
        (``{name: fn(x)}``) as its linear function and ``kv_hooks`` (one
        ``(k, v) -> (k, v)`` a block, or None) as its KV fake quant."""
        for idx, bp in enumerate(self.params["blocks"]):
            fns = w_qdq_fns[idx] if idx < len(w_qdq_fns) else {}
            for name, fn in fns.items():
                node = resolve(bp, name)
                node["weight"] = fn(node["weight"], name)
        self.kv_hooks = kv_hooks

        def make_fn(afns):
            def lf(name, w, b, x):
                x = self.apply_online_rotate(name, x)
                if name in afns:
                    x = afns[name](x)
                return A.default_linear(name, w, b, x)

            return lf

        a_qdq_fns = a_qdq_fns or []
        self.linear_fns = [make_fn((a_qdq_fns[i] if i < len(a_qdq_fns)
                                    else {}) or {})
                           for i in range(self.num_blocks)]


@MODEL_REGISTRY
class Llama(BaseModel):
    subsets = LLAMA_SUBSETS


@MODEL_REGISTRY
class Mistral(BaseModel):
    subsets = LLAMA_SUBSETS


@MODEL_REGISTRY
class Qwen2(BaseModel):
    subsets = LLAMA_SUBSETS


@MODEL_REGISTRY
class Qwen3(BaseModel):
    subsets = LLAMA_SUBSETS


@MODEL_REGISTRY
class Qwen3Moe(BaseModel):
    """Qwen3-MoE (``qwen3_moe``): the MoE llama family's linear names, with
    the per-head q/k RMSNorm of ``arch.qk_norm``."""

    subsets = LLAMA_SUBSETS

    def __init__(self, arch: A.ArchSpec, params: Dict, tokenizer=None,
                 config: Optional[Dict] = None):
        if arch.moe is None or not arch.qk_norm:
            raise ValueError("Qwen3Moe needs arch.moe and arch.qk_norm")
        super().__init__(arch, params, tokenizer, config)
