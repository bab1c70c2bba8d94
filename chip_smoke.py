"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints one JSON line with its seconds):
  1. device and build: the card's name and power limit, nvcc of every
     ``lightcompress_tpu_torch/ops/csrc/*.cu`` (all started together);
  2. every W4 kernel against its plain PyTorch version at the Llama-3-8B
     linear shapes and M of its engine phases (#1-#3 and #12 at a block's
     seven linears, #1 with a bf16 and an f32 store and the same bits on a
     second call, #2 bit for bit in f32 and bf16, also at M 256 over the
     attention linears; #2's two bodies at M 1-256 over a Llama-3-8B
     block, Mixtral-8x7B's and Qwen3-30B-A3B's attention linears
     (``planes_crossover``, a line of its own); #13 and #14 at the fused
     build's four, both also at M 32, #14 at 33, bit for bit their TPU
     orders on their own act codes and the same bits on a second call; #3
     bit for bit, also at M 300 and 1000, the fused q|k|v and gate|up, and
     once at K 50176, past the planes tile's shared-memory row sums; #12's
     two bodies at M 1-256), with device times (kernel, plain, a library
     matmul, the bound);
     then every decode-attention kernel against its plain version at the
     engine's shapes (8 slots, 8 KV heads of 4 query heads, head_dim 128,
     ragged lengths; #19 and #21 also at full lengths and at their engine
     phases' lengths, #19 also in 256-column blocks, against the plain
     rendering of their rank split: m bit for bit, the same bits on a
     second call; #17, #18 and #20 also at their engine phases' lengths,
     #20 also at S 512 and full lengths, with their cluster sizes, the
     chooser's against one CTA a pair), with times (kernel, plain, a
     library attention, the bound);
  3. the W4A8 engine at full Llama-3-8B width and depth (random weights from
     a seed): one batched prefill of 8 prompts (1024 rows) and 32 greedy
     tokens each;
  4. the W4A16 engine on the same packed weights: 4 prompts, 16 tokens,
     #1 on every decode linear (224 a step); then torch.profiler over four
     W4A8 decode steps and four W4A16 ones (device time by kernel, idle
     share);
  5. the kv4 engine (``kv_bits="auto"`` at max_len 4096: the bd4 nibble
     cache and kernel #20) on 8 prompts of 1500-2000 tokens, 32 tokens
     each, and torch.profiler over its decode steps; the kv4 engine at
     max_len 8192 (kernel #21) on 8 prompts of 3000-4000 tokens, 16 tokens
     each; the kv8 engine with ``attn_impl="pallas"`` (kernel #17) on the
     prompts of phase 3; the kv8 ``bd`` engine (kernel #18) on them, 32
     tokens; the kv8 ``bds`` engine at max_len 4096 (kernel #19) on the
     prompts of the kv4 engine, 16 tokens; the chunked kv8 engine
     (``decode_chunk=16``: the ring, no attention kernel) on the prompts
     of phase 3, 32 tokens, and torch.profiler over one ring chunk of 4
     steps; the chunked kv4 engine (``kv_bits="auto"`` at max_len 4096,
     ``decode_chunk=16``: the packed kv4 hhd cache on the ``xla4r`` ring)
     on the kv4 engine's prompts, 16 tokens, torch.profiler over one ring
     chunk of 2 steps; the kv16 engine (max_len 1024) and the kv8
     ``xla8`` concat engine on the prompts of phase 3, 16 tokens each (the
     generic and concat paths); for each of these three, the
     teacher-forced decode logits over the first prompt's continuation
     against the plain forward of the whole sequence
     (``decode_vs_plain``: kv16 corr >= 0.999 and an argmax that differs
     only where the kv8 route's, the witness, does; kv4 and xla8 the
     argmax equal at 90% of the steps);
     then the builds of the model with ln gammas
     1 + 0.1 N(0, 1): fused planes (``fused_rms``, ``fuse_qkv``: #3 at
     prefill, #14 at decode), fused s4 on the kv4 route (#13, #20; with
     torch.profiler over its decode steps) and unfused s4 (#12 at prefill
     and decode);
  6. the engine's prefill logits (the ``xla`` and ``bd`` engines)
     against a forward of the same serving weights through the plain
     versions; then the W8A8 build (W8 per channel, symmetric, ``rows``;
     ``int8_matmul_dynamic`` on every linear) and the e4m3 build (its
     first 8 blocks, dequant-then-matmul) through the kv8 ``xla`` engine
     (no W4 or attention kernel launched), each with torch.profiler over
     two decode steps and its teacher-forced decode logits against the
     plain forward over the dequantized weights (corr >= 0.999), and
     ``int8_matmul_dynamic`` at the q and down shapes, M 1, 8 and 256, bit
     for bit card vs CPU (``engine_w8a8``, ``engine_fp8``);
  7. MoE: the five expert kernels (#6 stacked on each of its bodies at B
     8, 32 and 256, bit for bit, at Mixtral-8x7B's and Qwen3-30B-A3B's
     gate/up shapes, #8 gathered at 1-4 tokens bit for bit, #9 grouped at
     Mixtral-8x7B's shapes; #7
     small-M stacked at Qwen3-30B-A3B's gate/up and Mixtral's down; #10
     int8 grouped at Qwen3-30B-A3B's down, and at a ragged N) against
     their plain versions, with times, and #6's two bodies at B 1-256
     (``stacked_crossover``, a line of its own); then, the Llama
     builds freed, Mixtral-8x7B at full width and depth (random weights
     from a seed, made and quantized one block at a time): 8 prompts
     through the grouped prefill (#9) and the dense decode (#6), 2 prompts
     on 4 slots through a 256-row dense prefill (#6) and the gathered
     decode (#8), 4 prompts of 700-1000 tokens on 4 slots at
     ``kv_bits="auto"``, max_len 4096 (the kv4 hhd cache on the generic
     path; a 4096-row grouped prefill (#9), the gathered decode (#8)) with
     torch.profiler over two decode steps and its teacher-forced decode
     against the plain forward (corr >= 0.99 at every step; the argmax
     shares reported beside the kv8 witness's), torch.profiler over the
     8-slot decode
     steps, and its prefill logits against the plain versions on the same
     routes;
  8. Qwen3-30B-A3B at full width and depth, the Mixtral weights freed
     (qk_norm; the int8 per-channel down of 768 inputs): 8 prompts on 32
     slots through the grouped prefill (#9 gate/up, #10 down) and the
     dense decode (#6 gate/up, the int8 down in torch), 2 prompts on 8
     slots through the dense prefill (#6) and the small-M decode (#7),
     torch.profiler over its decode steps, and its prefill logits against
     the plain versions;
  9. a small Llama through each engine route (the rings, the kv4 hhd
     cache's generic path, kv16 and xla8 among them; the last four handed
     the CPU's cache and ring before each decode step), its W8A8 and e4m3
     builds, and
     fused build, a small Mixtral-shaped model through each expert route,
     and a small Qwen3-MoE-shaped model through the grouped route with the
     int8 down and the small-M route, on the card against the same on the
     CPU (the paths the CPU tests hold to the JAX package); before its
     line, the 512-row fused s4 prefill's layers 0 and 1 op by op, card
     against CPU in bf16 ulps (ROADMAP C1);
  10. the kernel summary line (all 22 kernels; the run fails if one of
      them was never launched on the main path);
  11. the result line.
After the kernel phases of 2 and 7 come those of the bench's decode stack
(``lightcompress_tpu_torch.bench``): #5, #15, #16 and #22 against their
plain versions at the bench's shapes (B 32 at Llama-3-8B width, #22 over
2049 columns; #5 bit for bit, also at M 1, 7 and 300), with times; #4 (masked planes) at the bench's four fused
entries (with bf16 scales too at q|k|v and o, the same bits on a second
call) and #11 (natural s4 bytes) at a block's seven linears at M 8 and
32 against their plain versions, #4 against #1 on the same codes; the
bench itself at B 32, CTX 2048 and 32 layers in six configurations
(default, tail=1, tail=2, attn=pallas, ksplit, masked: #4 on q|k|v and
o), each kernel launched exactly as the configuration routes it; one
step of each at 2 layers with every kernel against its plain version;
and #11's entry point over a block's seven linears.
Between 8 and 9 come the quantizer core and the main path's front half.
``quant_core``: seeded bf16 weights at Llama-3-8B's q and down shapes and
8 x 512 x 4096 seeded activations through the quantizer's paths on the
card and on the CPU (int4 g128 with the minmax, mse and hqq ranges, per
head, per block, e4m3/e5m2 in both float modes, W48, the static act
qparams by minmax, moving minmax and the histogram search), each path's
seconds and gate (the mse and hqq searches over the whole weights), and
GPTQ's column step fed the same U on both, the card's graphed block loop
against the CPU's eager one (the CI config's linears: codes and W_new as
the CPU test holds them to JAX; Llama-3-8B's q at groups of 128 and 32:
the codes' disagreement beside a CPU run fed U moved by one ulp).  Then a random
Llama-3-8B
(full width and depth, bf16, seed 0) written as a safetensors checkpoint
by the port's ``save_params`` and read back (``calib_setup``); the
pipeline on it (``run_pipeline``: AWQ W4 g128, 16 x 512 synthetic
calibration tokens, PPL at pretrain, transformed and fake_quant, token
consistency; ``calib_awq``); the AWQ model's real-quant exports through
``run_exports`` (AutoAWQ over every block; vllm, native and trtllm over
two), each read back and every linear equal to ``real_quant_weight``'s
codes, scales and zeros (``export_real_quant``); the AWQ model's serving
weights (``algo=``) through the W4A8 engine with exact launches and
against the plain versions (``engine_calibrated``), then written by
``export_serving`` and read by ``load_serving`` (the same tensors, the
same greedy tokens and teacher-forced logits bit for bit, exact launches;
a fused s4 build of two blocks likewise through #13: ``serving_ckpt``);
the RTN pipeline's fake-quant PPL
(``calib_rtn``); the GPTQ pipeline (W4 g128, actorder, true_sequential,
quant_out, 16 x 512 calibration tokens, PPL at pretrain and fake_quant,
the seconds of its Hessians, factors and column loops, peak memory, and
block 0's output errors |X (W - W_q)| under GPTQ below RTN's:
``calib_gptq``); the GPTQ model served at W4A16, #1 on every decode
linear with exact launches, and against the plain versions
(``engine_gptq``); and the CI configs' tiny model calibrated (AWQ, and
GPTQ, its codes' disagreement held to that of a CPU run with its
Hessians moved by one ulp; AWQ with the v2 clip, ``save_clip``,
``profile_out`` and ``trace_dir``: the two ``clips.pkl`` with the same
keys and factors within 1e-6, the same phase names and counts, the card's
trace with CUDA kernel events) on the card and on the CPU
(``small_calib_vs_cpu``).
Before that tiny comparison come A8's untrained algorithms: the Hadamard
transforms (``matmul_hadU`` at 1024 rows of 4096 and 14336 in bf16 and
f32 against the CPU, the round trip, ms: ``hadamard``); QuaRot by the
pipeline on the Llama-3-8B checkpoint at full depth, in f32 the
transformed logits against the original's with its embedding's mean
removed (corr >= 0.9999, every argmax), then at bf16 with the e4m3
fake-quant PPL under the online rotations (``calib_quarot``); RTN W8
with the KV-cache fake quant (Naive kv8 dynamic and static, KIVI), its
decode PPL beside the prefill PPL of the same predictions
(``kv_quant``); AdaDim at full depth served at W4A8 (#3/#2 exact, corr
>= 0.999: ``calib_adadim``, ``engine_adadim_w4``); and OsPlus, LLM.int8,
QUIK, SpQR and DGQ over a 2-block Llama-3-8B-width checkpoint, OsPlus's
W8A8 build served on the kv8 ``xla`` route and DGQ's W4A8 build like
AdaDim's (``calib_algos``); ``small_calib_vs_cpu`` then also runs every
A8 config on the tiny model, card against CPU.
Each engine phase sets every launch count to 0 just before it runs and
reads the counts just after.
Any failure raises and the script exits non-zero.  Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pickle
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

from lightcompress_tpu_torch import bench as TB
from lightcompress_tpu_torch import quant as Q
from lightcompress_tpu_torch.compression.quantization import gptq as G
from lightcompress_tpu_torch.config import DotDict
from lightcompress_tpu_torch.data import CalibDataset
from lightcompress_tpu_torch.device import bf16_ulp
from lightcompress_tpu_torch.models import arch as A
from lightcompress_tpu_torch.models import (ArchSpec, Llama, Qwen3Moe,
                                            arch_from_hf_config, init_params)
from lightcompress_tpu_torch.models.arch import MoESpec
from lightcompress_tpu_torch.models.hf_loader import (ShardReader,
                                                      _llama_key_map,
                                                      load_model, save_params)
from lightcompress_tpu_torch.ops import _build
from lightcompress_tpu_torch.ops import attention as AT
from lightcompress_tpu_torch.ops import hadamard as HD
from lightcompress_tpu_torch.ops import layer_fused as LF
from lightcompress_tpu_torch.ops import moe_matmul as M
from lightcompress_tpu_torch.ops import w4_matmul as W
from lightcompress_tpu_torch.ops.qlinear import (QLinearParams,
                                                 dequant_weight, qlinear_plain,
                                                 quantize_linear)
from lightcompress_tpu_torch.export import (_AWQ_ORDER, run_exports,
                                           unpack_int4)
from lightcompress_tpu_torch.models import st_io
from lightcompress_tpu_torch.models.base import resolve
from lightcompress_tpu_torch.ops.scaled_matmul import int8_matmul_dynamic
from lightcompress_tpu_torch.pipeline import run_pipeline
from lightcompress_tpu_torch.quant import QuantSpec
from lightcompress_tpu_torch.quant.quantizer import mean_xla
from lightcompress_tpu_torch.serving import (LLMEngine, SamplingParams,
                                             build_serving_weights,
                                             head_logits)
from lightcompress_tpu_torch.serving import engine as EN
from lightcompress_tpu_torch.serving import quantized_model as QM
from lightcompress_tpu_torch.serving.checkpoint import (export_serving,
                                                        load_serving)
from lightcompress_tpu_torch.serving.engine import Request
from lightcompress_tpu_torch.serving.kv_cache import (
    KVCache, Ring, append_kv, append_kv_bd, append_slots,
    flush_ring_to_cache, quantize_kv, quantize_kv4, unpack_kv4)

SEED = 0
# meta-llama/Meta-Llama-3-8B config.json
LLAMA3_8B = ArchSpec(
    family="llama", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0,
    rms_eps=1e-5, dtype=torch.bfloat16)
# mistralai/Mixtral-8x7B-v0.1 config.json (no sliding window, untied head)
MIXTRAL_8X7B = arch_from_hf_config({
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1e6, "router_aux_loss_coef": 0.02, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32000})
# Qwen/Qwen3-30B-A3B config.json: 128 experts of width 768, top-8, head_dim
# 128 (q 2048 -> 4096), qk_norm; every layer MoE
QWEN3_30B_A3B = arch_from_hf_config({
    "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 151643,
    "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 6144, "max_position_embeddings": 40960,
    "max_window_layers": 48, "mlp_only_layers": [],
    "model_type": "qwen3_moe", "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48,
    "num_key_value_heads": 4, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.001, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 151936})
WSPEC = QuantSpec(bit=4, symmetric=False, granularity="per_group",
                  group_size=128)
# (name, N, K) of every linear of one Llama-3-8B block
SHAPES = [("q", 4096, 4096), ("k", 1024, 4096), ("v", 1024, 4096),
          ("o", 4096, 4096), ("gate", 14336, 4096), ("up", 14336, 4096),
          ("down", 4096, 14336)]
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and int8
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PAD = 64 << 20  # > the 50 MB L2: written between timed launches
TOL_ULP = "bf16_ulp"  # bf16 outputs: one bf16 ulp at the largest |y|
TOL_F32 = 1e-4        # f32 outputs: summation-order noise
# #7 against its plain version: the same bf16 weights and exact products,
# summed in f32 inside the tensor cores
TOL_SMALLM = 1e-5
KERNEL_INFO = {
    "w4a16_matmul": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4a16_tile.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:391"),
    "w4a8_matmul_decode": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_matmul.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1395"),
    "w4a8_matmul_prefill": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_matmul.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1332"),
    "decode_attention_bd4": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:564"),
    "decode_attention_bd4_flash": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:699"),
    "decode_attention_i8": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:118"),
    "decode_attention_bd": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:285"),
    "decode_attention_bd_flash": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:429"),
    "w4a8_matmul_bytes": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_bytes.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:2000"),
    "w4a8_linear_bytes_fused": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_bytes.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:2038"),
    "w4a8_linear_planes_fused": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_matmul.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:2151"),
    "w4a8_stacked_matmul": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_moe.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:796"),
    "w4a8_gathered_matmul": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_moe.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1046"),
    "w4a8_grouped_matmul": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_moe.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1170"),
    "w4a8_stacked_matmul_smallm": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_moe.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:920"),
    "w8a8_grouped_matmul": dict(
        source="lightcompress_tpu_torch/ops/csrc/w8_grouped.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1261"),
    "w4a8_matmul_planes_ksplit": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_ksplit.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:697"),
    "w4a8_attn_tail_fused": dict(
        source="lightcompress_tpu_torch/ops/csrc/layer_fused.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:2327"),
    "w4a8_layer_fused": dict(
        source="lightcompress_tpu_torch/ops/csrc/layer_fused.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:2494"),
    "decode_attention_kv8": dict(
        source="lightcompress_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="lightcompress_tpu/ops/pallas_attention.py:815"),
    "w4a16_matmul_planes_masked": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4a16_tile.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:283"),
    "w4a8_matmul_s4_bytes": dict(
        source="lightcompress_tpu_torch/ops/csrc/w4_bytes.cu",
        replaces="lightcompress_tpu/ops/pallas_matmul.py:1741"),
}
W4_KERNELS = W.KERNELS + M.KERNELS
KERNELS = W4_KERNELS + AT.KERNELS + LF.KERNELS
ATTN = [k.__name__ for k in AT.KERNELS]
# decode attention at the engine's shapes: 8 slots, Llama-3-8B's 8 KV heads
# of 4 query heads each, head_dim 128
ATT_B, ATT_H, ATT_G, ATT_D = 8, 8, 4, 128
# m and d: f32 sums in another order; the normalized context: an ulp of
# exp can flip one int8 probability code (a step of max(pv)/127)
TOL_MD = 1e-5
TOL_CTX = 2e-2


def limit(tol, scale: float) -> float:
    """The largest error a gate allows: one bf16 ulp at ``scale`` (the
    largest |y|) for TOL_ULP, else ``tol`` times it."""
    return bf16_ulp(scale) if tol == TOL_ULP else tol * scale


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# cycles the card spins before each timed launch (about a millisecond), so
# that the host has enqueued the call before its start event runs
HOLD_CYCLES = 2_000_000


def time_ms(fn, reps: int, pad: torch.Tensor) -> float:
    """Median of CUDA-event times over ``reps`` launches after a warm-up,
    with L2 flushed before each launch.  The card is held in a spin before
    the start event while the host enqueues ``fn``'s kernels, so the time
    is the device's, not the host's enqueue (a kernel shorter than its
    wrapper's Python would otherwise read as the wrapper)."""
    fn()
    times = []
    for _ in range(reps):
        pad.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_build() -> dict:
    t0 = time.time()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    reports = _build.build(names)
    for name in names:
        _build.load(name)
    notes = [line.strip() for r in reports.values() for line in r.splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    return {"phase": "build", "gpu": smi(), "sources": names,
            "ptxas": notes, "seconds": time.time() - t0}


def bound(M: int, N: int, K: int, x_bytes: int, out_bytes: int,
          kind: str, x_scale: bool = True):
    G = K // 128
    nbytes = N * K // 2 + 2 * N * G * 2 + M * K * x_bytes + M * N * out_bytes
    if kind == "int8" and x_scale:
        nbytes += M * 4  # x_scale
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2 * M * N * K / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# #3 beside its main-path M (a 1024-row prefill batch): ragged row tiles
PREFILL_M = (300, 1000, 1024)
# #2 at the rows of a 256-row prefill, over a block's attention linears
# (Mixtral-8x7B's are Llama-3-8B's shapes)
DECODE_256 = 256
ATTN_LINEARS = ("q", "k", "v", "o")
# #3 past the K up to which the planes tile keeps its row sums in shared
# memory (49 word blocks: the row sums in a global scratch), once
K_CAP_CASE = dict(M=300, N=256, K=50176)
# #3 at the fused build's prefill linears, M 1024
PREFILL_FUSED = [("qkv", 6144, 4096), ("gateup", 28672, 4096)]


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at every linear shape: #1
    (bf16 and f32 stores, the same bits on a second call) within its
    tolerance and #2 bit for bit (f32 and the engine's bf16 store, timed
    in bf16, the same bits on a second call) at M 8 and 32, #2 also at M
    256 over the attention linears (``engine_moe_small``'s 256-row prefill
    runs them there, on #3's planes tile), #3 bit for bit (bf16 at every M
    of PREFILL_M, f32 at 1024) and then at the fused build's q|k|v and
    gate|up (``prefill_fused``) and once past the shared-memory row sums
    (``k_cap``, K_CAP_CASE)."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    rows, fused_rows = [], []

    def check(kname, name, M, y, ref, tol, exact):
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        equal = bool(torch.equal(y, ref))
        if not (err <= limit(tol, scale) and torch.isfinite(y).all()
                and (equal or not exact)):
            raise AssertionError(f"{kname} {name} M={M}: max|err| {err} > "
                                 f"{tol} at {scale} or not bit-equal")
        return err, scale, equal

    def prefill_rows(name, N, K, qp, wd, ms, out):
        args = (qp.codes, qp.scales, qp.zeros)
        for M in ms:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            if M == 1024:
                check("w4a8_matmul_prefill", name, M,
                      W.w4a8_matmul_prefill(xq, xs, *args,
                                            out_dtype=torch.float32),
                      W.w4a8_matmul_prefill_plain(xq, xs, *args,
                                                  torch.float32),
                      TOL_F32, True)
            run = lambda: W.w4a8_matmul_prefill(xq, xs, *args)
            plain = lambda: W.w4a8_matmul_prefill_plain(xq, xs, *args)
            err, scale, equal = check("w4a8_matmul_prefill", name, M, run(),
                                      plain(), TOL_ULP, True)
            b_ms, b_by = bound(M, N, K, 1, 2, "int8")
            out.append({
                "kernel": "w4a8_matmul_prefill", "linear": name, "M": M,
                "N": N, "K": K, "max_abs_err": err, "max_abs_ref": scale,
                "tol": TOL_ULP, "bit_equal": equal,
                "kernel_ms": time_ms(run, 20, pad),
                "plain_ms": time_ms(plain, 3, pad),
                "library_ms": time_ms(lambda: torch.matmul(x, wd.t()), 20,
                                      pad),
                "bound_ms": b_ms, "bound_by": b_by})

    for name, N, K in SHAPES:
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        qp = quantize_linear(w, WSPEC)
        wd = dequant_weight(qp, torch.bfloat16)
        del w
        args = (qp.codes, qp.scales, qp.zeros)
        cases = []
        for M in (8, 32):
            cases.append(("w4a16_matmul", M, "bf16"))
            cases.append(("w4a16_matmul", M, "f32"))
            cases.append(("w4a8_matmul_decode", M, "int8"))
        if name in ATTN_LINEARS:
            cases.append(("w4a8_matmul_decode", DECODE_256, "int8"))
        for kname, M, kind in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            if kname == "w4a16_matmul":
                # the store in x's dtype: bf16 x, or its f32 values
                x = x if kind == "bf16" else x.float()
                run = lambda: W.w4a16_matmul(x, *args)
                plain = lambda: W.w4a16_matmul_plain(x, *args).to(x.dtype)
                tol, out_bytes = ((TOL_ULP, 2) if kind == "bf16"
                                  else (TOL_F32, 4))
                if not torch.equal(run(), run()):
                    raise AssertionError(f"#1 {name} M={M} {kind}: two "
                                         "calls differ")
            else:
                # the store in the engine's bf16, bit for bit the plain
                # version's; f32 too, once
                xq, xs = W.quantize_act_per_token(x)
                check(kname, name, M, W.w4a8_matmul_decode(xq, xs, *args),
                      W.w4a8_matmul_decode_plain(xq, xs, *args), TOL_F32,
                      True)
                run = lambda: W.w4a8_matmul_decode(xq, xs, *args,
                                                   torch.bfloat16)
                plain = lambda: W.w4a8_matmul_decode_plain(
                    xq, xs, *args, torch.bfloat16)
                tol, out_bytes = TOL_ULP, 2
                if not torch.equal(run(), run()):
                    raise AssertionError(f"#2 {name} M={M}: two calls "
                                         "differ")
            err, scale, _ = check(kname, name, M, run(), plain(), tol,
                                  kname == "w4a8_matmul_decode")
            kind_ops = "int8" if kind == "int8" else "bf16"
            b_ms, b_by = bound(M, N, K, 1 if kind == "int8" else 2,
                               out_bytes, kind_ops)
            rows.append({
                "kernel": kname, "linear": name, "M": M, "N": N, "K": K,
                "store": "bf16" if kind == "int8" else kind,
                "body": W.planes_body(M) if kind == "int8" else None,
                "max_abs_err": err, "max_abs_ref": scale,
                "err_ulps": err / bf16_ulp(scale), "tol": tol,
                "kernel_ms": time_ms(run, 20, pad),
                "plain_ms": time_ms(plain, 3, pad),
                "library_ms": time_ms(lambda: torch.matmul(
                    x.to(wd.dtype), wd.t()), 20, pad),
                "bound_ms": b_ms, "bound_by": b_by})
        prefill_rows(name, N, K, qp, wd, PREFILL_M, rows)
        del qp, wd
    for name, N, K in PREFILL_FUSED:
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        qp = quantize_linear(w, WSPEC)
        wd = dequant_weight(qp, torch.bfloat16)
        del w
        prefill_rows(name, N, K, qp, wd, (1024,), fused_rows)
        del qp, wd
    return {"phase": "kernels", "rows": rows, "prefill_fused": fused_rows,
            "k_cap": k_cap(dev, gen), "seconds": time.time() - t0}


def k_cap(dev, gen) -> dict:
    """#3 at K_CAP_CASE, past the K up to which the planes tile keeps its
    row sums in shared memory: bit for bit in bf16 and f32."""
    M, N, K = K_CAP_CASE["M"], K_CAP_CASE["N"], K_CAP_CASE["K"]
    qp = quantize_linear(torch.randn((N, K), generator=gen, device=dev)
                         * 0.02, WSPEC)
    args = (qp.codes, qp.scales, qp.zeros)
    xq, xs = W.quantize_act_per_token(
        torch.randn((M, K), generator=gen, device=dev))
    for dt in (torch.bfloat16, torch.float32):
        got = W.w4a8_matmul_prefill(xq, xs, *args, out_dtype=dt)
        ref = W.w4a8_matmul_prefill_plain(xq, xs, *args, dt)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.equal(got, ref)):
            raise AssertionError(f"#3 at K {K} ({dt}) is not bit-equal to "
                                 "its plain version")
    return dict(K_CAP_CASE, bit_equal=True,
                rowsum_k_max=W.ROWSUM_SMEM_K_MAX)



# (name, N, K, rms) of the fused build's decode linears at Llama-3-8B (q|k|v
# and gate|up merged), with the RMSNorm as the engine runs it
FUSED_SHAPES = [("qkv", 6144, 4096, True), ("o", 4096, 4096, False),
                ("gateup", 28672, 4096, True), ("down", 4096, 14336, False)]
FUSED_M = 8
# #13 and #14 are also held at a decode step of 32 slots (two m16 tiles),
# #14 at 33 too (a second row chunk)
FUSED_ROWS = {"w4a8_linear_bytes_fused": (FUSED_M, 32),
              "w4a8_linear_planes_fused": (FUSED_M, 32, 33)}
# the M at which engine_s4 launches #12 on SHAPES: decode (8 slots) and its
# prefill of 2 prompts x 128 rows
S4_M = (8, 256)
# the M at which both bodies of #12 are timed over SHAPES (the crossover)
BYTES_M_SCAN = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def phase_fused_kernels(dev) -> dict:
    """#12 against its plain version at the shapes ``engine_s4`` launches it
    (one block's seven linears at M = 8 and 256); #13 and #14 at the fused
    build's decode shapes, M = 8 (8 slots), both also at M = 32, #14 at 33
    (``FUSED_ROWS``).  Times (kernel, plain, a library matmul, the bound),
    the act codes the fused kernels flip against the plain prologue, and
    the cost of the prologue that every block of #13 and #14 recomputes:
    the fused kernel's time less that of the same matmul on pre-quantized
    x (#12, #2), beside the unfused path's torch act quant.  #13 and #14
    must also equal their TPU orders (``w4a8_matmul_pairs_tpu_order``,
    ``w4a8_rows_phase_dot``) on their own act codes and scales bit for bit
    and give the same bits on a second call; their distance from the plain
    versions (from x) in bf16 ulps is recorded.  Then #12's crossover: both of its bodies (the decode
    block and the tile) against the plain version and timed over the seven
    linears at each M of BYTES_M_SCAN; ``tile_min_m_measured`` is the
    least M of the scan from which the tile is faster at every larger M,
    beside the wrapper's ``BYTES_TILE_MIN_M``."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    rows = []

    def row(kname, name, M, N, K, y, ref, tol, flips, fused, run, plain,
            library):
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not (err <= limit(tol, scale) and torch.isfinite(y).all()
                and flips <= 1e-3 * M * K):
            raise AssertionError(f"{kname} {name} M={M}: max|err| {err} > "
                                 f"{tol} * {scale} or {flips} flips")
        b_ms, b_by = bound(M, N, K, 2 if fused else 1, 2 if fused else 4,
                           "int8", x_scale=not fused)
        return {"kernel": kname, "linear": name, "M": M, "N": N, "K": K,
                "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
                "kernel_ms": time_ms(run, 20, pad),
                "plain_ms": time_ms(plain, 3, pad),
                "library_ms": time_ms(library, 20, pad),
                "bound_ms": b_ms, "bound_by": b_by}

    for name, N, K in SHAPES:
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        s4 = quantize_linear(w, WSPEC, layout="s4")
        wd = dequant_weight(s4, torch.bfloat16)
        del w
        sa = (s4.codes, s4.scales, s4.zeros)
        for M in S4_M:
            x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(
                torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            run = lambda: W.w4a8_matmul_bytes(xq, xs, *sa)
            plain = lambda: W.w4a8_matmul_bytes_plain(xq, xs, *sa)
            rows.append(row("w4a8_matmul_bytes", name, M, N, K, run(),
                            plain(), TOL_F32, 0, False, run, plain,
                            lambda: torch.matmul(x, wd.t())))
        del s4, wd
    for name, N, K, rms in FUSED_SHAPES:
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        planes = quantize_linear(w, WSPEC)
        s4 = quantize_linear(w, WSPEC, layout="s4")
        wd = dequant_weight(planes, torch.bfloat16)
        del w
        fk = dict(rms=rms, eps=LLAMA3_8B.rms_eps)
        pa = (planes.codes, planes.scales, planes.zeros)
        sa = (s4.codes, s4.scales, s4.zeros)
        for M in sorted({m for ms in FUSED_ROWS.values() for m in ms}):
            x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(
                torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            for kname, wa, unfused, order in (
                    ("w4a8_linear_bytes_fused", sa,
                     lambda: W.w4a8_matmul_bytes(xq, xs, *sa),
                     W.w4a8_matmul_pairs_tpu_order),
                    ("w4a8_linear_planes_fused", pa,
                     lambda: W.w4a8_matmul_decode(xq, xs, *pa,
                                                  torch.bfloat16),
                     W.w4a8_rows_phase_dot)):
                if M not in FUSED_ROWS[kname]:
                    continue
                kern, kplain = getattr(W, kname), getattr(W, kname + "_plain")
                run = lambda: kern(x, *wa, **fk)
                plain = lambda: kplain(x, *wa, **fk)
                y, codes, scales = W._fused_with_act(kern, x, *wa, **fk)
                ref, rcodes, _ = plain()
                flips = int((codes != rcodes).sum())
                own = order(codes, scales, *wa).to(x.dtype)
                extra = dict(bit_equal_own_codes=torch.equal(y, own),
                             repeat_equal=torch.equal(y, run()),
                             err_ulps=bf16_ulps(y, ref))
                if not (extra["bit_equal_own_codes"]
                        and extra["repeat_equal"]):
                    raise AssertionError(
                        f"{kname} {name} M={M}: not its TPU order on its "
                        f"own codes bit for bit, or a second call differs")
                r = row(kname, name, M, N, K, y, ref, TOL_ULP, flips, True,
                        run, plain, lambda: torch.matmul(x, wd.t()))
                r.update(rms=rms, act_code_flips=flips,
                         unfused_kernel_ms=time_ms(unfused, 20, pad), **extra)
                r["prologue_ms"] = r["kernel_ms"] - r["unfused_kernel_ms"]
                r["torch_act_quant_ms"] = time_ms(
                    lambda: W.quantize_act_per_token(x), 20, pad)
                rows.append(r)
        del planes, s4, wd
    crossover = bytes_crossover(dev, pad)
    faster = [c["tile_ms"] < c["decode_ms"] for c in crossover]
    from_m = next((BYTES_M_SCAN[i] for i in range(len(faster))
                   if all(faster[i:])), None)
    return {"phase": "fused_kernels", "rows": rows,
            "bytes_crossover": crossover, "tile_min_m_measured": from_m,
            "tile_min_m_set": W.BYTES_TILE_MIN_M,
            "seconds": time.time() - t0}


def bytes_crossover(dev, pad) -> list:
    """Both bodies of #12 (the decode block and the tile) against the plain
    version and timed over one Llama-3-8B block's seven linears at each M
    of BYTES_M_SCAN, in s4 weights of their own (seed SEED + 5): one entry
    per M, the bodies' summed ms."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    scan = {M: {"M": M, "decode_ms": 0.0, "tile_ms": 0.0,
                "max_abs_err": 0.0} for M in BYTES_M_SCAN}
    for name, N, K in SHAPES:
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        s4 = quantize_linear(w, WSPEC, layout="s4")
        del w
        sa = (s4.codes, s4.scales, s4.zeros)
        for M in BYTES_M_SCAN:
            x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(
                torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            ref = W.w4a8_matmul_bytes_plain(xq, xs, *sa)
            scale = float(ref.abs().max())
            for body in ("decode", "tile"):
                run = lambda: W._w4a8_matmul_bytes(xq, xs, *sa, body)
                err = float((run() - ref).abs().max())
                if not err <= TOL_F32 * scale:
                    raise AssertionError(f"#12 {body} {name} M={M}: max|err| "
                                         f"{err} > {TOL_F32} * {scale}")
                c = scan[M]
                c[f"{body}_ms"] += time_ms(run, 20, pad)
                c["max_abs_err"] = max(c["max_abs_err"], err)
        del s4
    return [scan[M] for M in BYTES_M_SCAN]


# #2's bodies timed at each M (the crossover) over a Llama-3-8B block's
# seven linears (Mixtral-8x7B's attention linears are its q, k, v and o)
# and Qwen3-30B-A3B's attention linears (hidden 2048, 32 query and 4 KV
# heads of 128)
PLANES_SCAN_M = (1, 8, 16, 32, 64, 128, 256)
QWEN3_ATTN = [("q", 4096, 2048), ("k", 512, 2048), ("v", 512, 2048),
              ("o", 2048, 4096)]


def planes_crossover(dev) -> dict:
    """#2's bodies (the planes decode tile with 16 and with 32 channels a
    block, and #3's planes tile) bit for bit against the plain version and
    timed (the bf16 store) at each M of PLANES_SCAN_M over each model's
    linears, in random plane weights of their own (seed SEED + 9): per
    model and M the bodies' summed ms, the decode tile at ``decode_chan``'s
    channels; ``tile_min_m_measured``: per model, and for the three sets
    together (``all``, the wrapper's one threshold), the least M of the
    scan from which the tile is faster at every larger M, beside
    PLANES_TILE_MIN_M; ``chan_ms``: per linear shape the decode tile's
    time with 16 and with 32 channels summed over the scan's M below
    PLANES_TILE_MIN_M, beside DECODE_CHAN16_MAX_N."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    linears = {("llama3_8b", n): (N, K) for n, N, K in SHAPES}
    linears.update({("qwen3_attn", n): (N, K) for n, N, K in QWEN3_ATTN})
    models = {"llama3_8b": [n for n, _, _ in SHAPES],
              "mixtral_attn": list(ATTN_LINEARS),
              "qwen3_attn": [n for n, _, _ in QWEN3_ATTN]}
    bodies = {"decode16": ("decode", 16), "decode32": ("decode", 32),
              "tile": ("tile", None)}
    ms = {}  # (model, linear) -> body -> [ms at each M]
    for (model, name), (N, K) in linears.items():
        w = random_planes(gen, dev, N, K)
        ms[model, name] = {b: [] for b in bodies}
        for M in PLANES_SCAN_M:
            xq, xs = W.quantize_act_per_token(
                torch.randn((M, K), generator=gen, device=dev))
            ref = W.w4a8_matmul_decode_plain(xq, xs, *w, torch.bfloat16)
            for b, (body, chan) in bodies.items():
                run = lambda: W._w4a8_matmul_decode(xq, xs, *w,
                                                    torch.bfloat16, body,
                                                    chan)
                if not torch.equal(run(), ref):
                    raise AssertionError(f"#2 {b} {model} {name} M={M}: "
                                         "not bit for bit")
                ms[model, name][b].append(time_ms(run, 20, pad))
        del w
    out = {"phase": "planes_crossover", "M": list(PLANES_SCAN_M),
           "tile_min_m_set": W.PLANES_TILE_MIN_M,
           "chan16_max_n_set": W.DECODE_CHAN16_MAX_N, "bit_equal": True}
    from_m = {}
    sums = {}
    for model, names in models.items():
        src = "qwen3_attn" if model == "qwen3_attn" else "llama3_8b"
        dec = [sum(ms[src, n][f"decode{W.decode_chan(linears[src, n][0])}"]
                   [i] for n in names) for i in range(len(PLANES_SCAN_M))]
        tile = [sum(ms[src, n]["tile"][i] for n in names)
                for i in range(len(PLANES_SCAN_M))]
        sums[model] = (dec, tile)
        out[model] = {"decode_ms": dec, "tile_ms": tile}
    # "all": the three sets of linears together, the wrapper's one
    # threshold
    sums["all"] = tuple([sum(v[k][i] for v in list(sums.values()))
                         for i in range(len(PLANES_SCAN_M))] for k in (0, 1))
    for model, (dec, tile) in sums.items():
        faster = [t < d for t, d in zip(tile, dec)]
        from_m[model] = next((PLANES_SCAN_M[i] for i in range(len(faster))
                              if all(faster[i:])), None)
    out["tile_min_m_measured"] = from_m
    below = [i for i, M in enumerate(PLANES_SCAN_M)
             if M < W.PLANES_TILE_MIN_M]
    out["chan_ms"] = {
        f"{model}_{name}_{N}x{K}": {
            b: sum(ms[model, name][b][i] for i in below)
            for b in ("decode16", "decode32")}
        for (model, name), (N, K) in linears.items()}
    out["seconds"] = time.time() - t0
    return out


# the expert linears of one Mixtral-8x7B layer: (name, N, K, pair), the
# down projection reading each expert's own rows
MOE_SHAPES = [("gate", 14336, 4096, False), ("up", 14336, 4096, False),
              ("down", 4096, 14336, True)]
MOE_E, MOE_TOP_K = 8, 2
# #6 on each body at a decode step of 8 and 32 slots and a 256-row prefill
STACKED_ROWS_B = (8, 32, 256)
# #7's rows at Qwen3-30B-A3B's gate and up: the 8-slot decode and fewer
# live slots
SMALLM_ROWS_B = (1, 4, 8)
# #6's two bodies timed at each B of the dense route (the crossover)
STACKED_SCAN_B = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def expert_bytes(N: int, K: int) -> int:
    """Packed codes, s and zs of one expert linear."""
    return N * K // 2 + 2 * N * (K // 128) * 2


def bytes_ops_bound(nbytes: int, ops: int, kind: str = "int8"):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def seeded_topi(n: int, gen, dev, experts: int = MOE_E,
                arch: ArchSpec = MIXTRAL_8X7B) -> torch.Tensor:
    """(n, top_k) routing of n random tokens by a random router over the
    first ``experts`` experts (``arch``'s routing: Mixtral's softmax
    top-2 by default)."""
    H = arch.hidden_size
    x = torch.randn((n, H), generator=gen, device=dev)
    router = torch.randn((experts, H), generator=gen, device=dev) * 0.02
    return A.moe_route(arch.moe, x @ router.t())[0]


def padded_expert_rows(x, topi, experts: int, top_k: int):
    """The library's rows of a grouped call: each expert's tokens of x,
    padded with zeros to the largest segment, (experts, seg, K)."""
    flat = topi.reshape(-1)
    seg = int(torch.bincount(flat, minlength=experts).max())
    xpad = torch.zeros((experts, seg, x.shape[1]), dtype=torch.bfloat16,
                       device=x.device)
    for e in range(experts):
        sel = torch.nonzero(flat == e)[:, 0] // top_k
        xpad[e, :sel.numel()] = x[sel]
    return xpad


def grouped_operands(x, topi, experts: int):
    """x's per-token int8 rows gathered into the grouping of ``topi``, as
    ``moe_mlp_grouped`` gathers them, with the grouping's facts."""
    gr, _, be = QM.moe_group_selections(topi, experts)
    xq_t, xs_t = W.quantize_act_per_token(x)
    K = x.shape[1]
    xq = torch.cat([xq_t, xq_t.new_zeros((1, K))])[gr.long()]
    xs = torch.cat([xs_t, xs_t.new_ones((1, 1))])[gr.long()]
    counts = torch.bincount(topi.reshape(-1), minlength=experts)
    Mp = gr.shape[0]
    facts = dict(tokens=topi.shape[0], selections=topi.numel(), Mp=Mp,
                 live_experts=int((counts > 0).sum()),
                 padding_only_blocks=int(
                     Mp // M.M_TILE - (-(-counts // M.M_TILE)).sum()))
    return xq, xs, be, facts


# #8's token counts (2-8 selections at top-2; duplicate experts from 3 on)
GATHERED_N = (4, 1, 2, 3)


def gathered_bad_index(xq, xs, wa, e_idx, t_idx) -> dict:
    """#8's gate beyond its row's: a selection whose expert is out of range
    a NaN row, the others the same bits."""
    bad = e_idx.clone()
    bad[0] = wa[0].shape[0]
    got = M.w4a8_gathered_matmul(xq, xs, *wa, bad, t_idx)
    want = M.w4a8_gathered_matmul_plain(xq, xs, *wa, bad, t_idx)
    if not (got[0].isnan().all() and want[0].isnan().all()
            and torch.equal(got[1:], want[1:])):
        raise AssertionError("w4a8_gathered_matmul: an expert out of range "
                             "is not a NaN row, or moved other rows")
    return dict(bad_index_nan=True)


def phase_moe_kernels(dev) -> dict:
    """#6, #8 and #9 against their plain versions at the expert shapes of
    Mixtral-8x7B (8 experts; gate and up 14336 x 4096, down 4096 x 14336):
    #6 on each of its bodies at B = 8 (the dense decode of 8 slots), 32 and
    256 (a 2-prompt prefill), bit for bit, ``routed`` marking the body
    ``stacked_body`` picks, #8 at n = 4, 1, 2 and 3 tokens (8, 2, 4 and 6
    selections) bit for bit, a second call the same bits, an expert out
    of range a NaN row, #9 at the
    3072 grouped rows of 1024 tokens routed by a seeded router (every
    expert live) and at 300 tokens routed among 5 experts (3 absent,
    padding-only blocks), #7 at the down in pair mode (B = 8); then #6,
    #7, #9 and #10 at Qwen3-30B-A3B's shapes (``qwen3moe_kernel_rows``); #9
    must equal its plain version bit for bit.  Then #6's crossover
    (``stacked_crossover``), emitted on a line of its own.  Times
    (kernel, plain, library, bound); the library is torch.bmm of bf16 x
    over the pre-dequantized bf16 experts at the same rows (for #8 the
    selections' experts gathered before the timing; for #9 and #10 each
    expert's rows padded to the largest segment)."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    qps, wds = {}, {}
    for name, N, K, _ in MOE_SHAPES:
        w3 = (torch.randn((MOE_E, N, K), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        qps[name] = QM.quantize_linear_stacked(w3, WSPEC)
        del w3
        wds[name] = QM.dequant_weight_stacked(qps[name], torch.bfloat16)
    rows = []

    def row(kname, case, name, N, K, run, plain, library, nbytes, ops,
            tol=TOL_F32, kind="int8", exact=False, repeat=False, **extra):
        """``exact``: the kernel must equal its plain version bit for
        bit; ``repeat``: a second call must give the same bits."""
        y, ref = run(), plain()
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        equal = bool(torch.equal(y, ref))
        if not (err <= limit(tol, scale) and torch.isfinite(y).all()
                and (equal or not exact)):
            raise AssertionError(f"{kname} {case} {name}: max|err| {err} > "
                                 f"{tol} * {scale} or not bit-equal")
        if repeat:
            if not torch.equal(y, run()):
                raise AssertionError(f"{kname} {case} {name}: a second "
                                     "call gave other bits")
            extra["repeat_equal"] = True
        b_ms, b_by = bytes_ops_bound(nbytes, ops, kind)
        rows.append(dict(
            kernel=kname, case=case, linear=name, N=N, K=K, **extra,
            max_abs_err=err, max_abs_ref=scale, tol=tol, bit_equal=equal,
            kernel_ms=time_ms(run, 20, pad), plain_ms=time_ms(plain, 3, pad),
            library_ms=time_ms(library, 20, pad), bound_ms=b_ms,
            bound_by=b_by))

    for B in STACKED_ROWS_B:
        for name, N, K, pair in MOE_SHAPES:
            qp, wd = qps[name], wds[name]
            stacked_rows(row, f"B{B}", name, qp, wd, B, pair, gen, dev)
    for n in GATHERED_N:
        topi = seeded_topi(n, gen, dev)
        e_idx = topi.reshape(-1).to(torch.int32)
        n_sel = e_idx.shape[0]
        live = len(torch.unique(e_idx))
        for name, N, K, pair in MOE_SHAPES:
            qp, wd = qps[name], wds[name]
            wa = (qp.codes, qp.scales, qp.zeros)
            rows_x = n_sel if pair else n
            t_idx = (torch.arange(n_sel, device=dev) if pair else
                     torch.arange(n, device=dev).repeat_interleave(MOE_TOP_K)
                     ).to(torch.int32)
            x = torch.randn((rows_x, K), generator=gen, device=dev).to(
                torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            wsel = wd[e_idx.long()]
            xsel = x[t_idx.long()][:, None]
            row("w4a8_gathered_matmul", f"n{n}", name, N, K,
                lambda: M.w4a8_gathered_matmul(xq, xs, *wa, e_idx, t_idx),
                lambda: M.w4a8_gathered_matmul_plain(xq, xs, *wa, e_idx,
                                                     t_idx),
                lambda: torch.bmm(xsel, wsel.transpose(1, 2)),
                live * expert_bytes(N, K) + xq.numel() + rows_x * 4
                + n_sel * N * 4 + n_sel * 8, 2 * n_sel * N * K,
                exact=True, repeat=True, n_sel=n_sel, experts_read=live,
                **gathered_bad_index(xq, xs, wa, e_idx, t_idx))
            del wsel
    for case, n, experts in (("all_live", 1024, MOE_E), ("absent", 300, 5)):
        topi = seeded_topi(n, gen, dev, experts)
        counts = torch.bincount(topi.reshape(-1), minlength=MOE_E)
        if case == "all_live" and not bool((counts > 0).all()):
            raise AssertionError("the seeded router left an expert idle")
        for name, N, K, _ in MOE_SHAPES:
            qp, wd = qps[name], wds[name]
            wa = (qp.codes, qp.scales, qp.zeros)
            x = torch.randn((n, K), generator=gen, device=dev).to(
                torch.bfloat16)
            xq, xs, be, facts = grouped_operands(x, topi, MOE_E)
            xpad = padded_expert_rows(x, topi, MOE_E, MOE_TOP_K)
            Mp, live = facts["Mp"], facts["live_experts"]
            row("w4a8_grouped_matmul", case, name, N, K,
                lambda: M.w4a8_grouped_matmul(xq, xs, *wa, be),
                lambda: M.w4a8_grouped_matmul_plain(xq, xs, *wa, be),
                lambda: torch.bmm(xpad, wd.transpose(1, 2)),
                live * expert_bytes(N, K) + Mp * K + Mp * 4 + Mp * N * 4,
                2 * facts["selections"] * N * K, exact=True, **facts,
                library_rows_per_expert=xpad.shape[1],
                ops_bound_at_Mp_ms=2 * Mp * N * K / PEAK_OPS["int8"] * 1e3)
    # #7 at Mixtral's down in pair mode, 8 rows an expert
    qp, wd = qps["down"], wds["down"]
    N, K = qp.codes.shape[1], qp.codes.shape[2] * 8
    x = torch.randn((MOE_E, 8, K), generator=gen, device=dev).to(
        torch.bfloat16)
    xq, xs = W.quantize_act_per_token(x.reshape(-1, K))
    xq, xs = xq.reshape(MOE_E, 8, K), xs.reshape(MOE_E, 8, 1)
    wa = (qp.codes, qp.scales, qp.zeros)
    row("w4a8_stacked_matmul_smallm", "mixtral_down_pair", "down", N, K,
        lambda: M.w4a8_stacked_matmul_smallm(xq, xs, *wa, pair=True),
        lambda: M.w4a8_stacked_matmul_smallm_plain(xq, xs, *wa, True),
        lambda: torch.bmm(x, wd.transpose(1, 2)),
        MOE_E * expert_bytes(N, K) + xq.numel() + xs.numel() * 4
        + MOE_E * 8 * N * 4, 2 * MOE_E * 8 * N * K, tol=TOL_SMALLM,
        kind="bf16", repeat=True, B=8, pair=True)
    del qps, wds, wd, wa, qp
    torch.cuda.empty_cache()
    qwen3moe_kernel_rows(dev, gen, row)
    torch.cuda.empty_cache()
    out = {"phase": "moe_kernels", "rows": rows,
           "seconds": time.time() - t0}
    emit(out)
    t0 = time.time()
    crossover = stacked_crossover(dev, pad)
    emit(dict(crossover, seconds=time.time() - t0))
    return out


def stacked_rows(row, case, name, qp, wd, B, pair, gen, dev) -> None:
    """#6 on each body at B rows of shared x (B, K) or, with ``pair``,
    each expert's own (E, B, K), against its plain version bit for bit and
    timed beside the library's bmm over the dequantized experts."""
    E, N, K = qp.codes.shape[0], qp.codes.shape[1], qp.codes.shape[2] * 8
    wa = (qp.codes, qp.scales, qp.zeros)
    x = torch.randn((E, B, K) if pair else (B, K), generator=gen,
                    device=dev).to(torch.bfloat16)
    xq, xs = W.quantize_act_per_token(x.reshape(-1, K))
    if pair:
        xq, xs = xq.reshape(E, B, K), xs.reshape(E, B, 1)
    xe = x if pair else x.expand(E, B, K)
    for body in ("decode", "tile"):
        row("w4a8_stacked_matmul", case, name, N, K,
            lambda: M._w4a8_stacked_matmul(xq, xs, *wa, pair, body),
            lambda: M.w4a8_stacked_matmul_plain(xq, xs, *wa, pair),
            lambda: torch.bmm(xe, wd.transpose(1, 2)),
            E * expert_bytes(N, K) + xq.numel() + xs.numel() * 4
            + E * B * N * 4, 2 * E * B * N * K, exact=True, B=B, pair=pair,
            body=body, routed=M.stacked_body(B) == body)


def random_stacked(gen, dev, E: int, N: int, K: int):
    """E experts of random plane words, scales and zero corrections."""
    parts = [random_planes(gen, dev, N, K) for _ in range(E)]
    return tuple(torch.stack([t[i] for t in parts]) for i in range(3))


def stacked_crossover(dev, pad) -> dict:
    """Both bodies of #6 bit for bit against the plain version and timed
    at each B of STACKED_SCAN_B over a Mixtral-8x7B layer's three expert
    linears and over Qwen3-30B-A3B's gate and up (E 128, 768 x 2048), in
    random plane weights of their own (seed SEED + 8): per model and B the
    bodies' summed ms; ``tile_min_b_measured``: per model the least B of
    the scan from which the tile is faster at every larger B, beside the
    wrapper's STACKED_TILE_MIN_B."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    models = {"mixtral": (MOE_E, MOE_SHAPES),
              "qwen3": (QWEN3_30B_A3B.moe.num_experts,
                        [(n, *Q_GATE_UP, False) for n in ("gate", "up")])}
    out = {"phase": "stacked_crossover", "B": list(STACKED_SCAN_B),
           "tile_min_b_set": M.STACKED_TILE_MIN_B}
    from_b = {}
    for model, (E, linears) in models.items():
        ms = {b: [0.0] * len(STACKED_SCAN_B) for b in ("decode", "tile")}
        for name, N, K, pair in linears:
            w = random_stacked(gen, dev, E, N, K)
            for i, B in enumerate(STACKED_SCAN_B):
                x = torch.randn((E, B, K) if pair else (B, K), generator=gen,
                                device=dev)
                xq, xs = W.quantize_act_per_token(x.reshape(-1, K))
                if pair:
                    xq, xs = xq.reshape(E, B, K), xs.reshape(E, B, 1)
                ref = M.w4a8_stacked_matmul_plain(xq, xs, *w, pair)
                for body in ms:
                    run = lambda: M._w4a8_stacked_matmul(xq, xs, *w, pair,
                                                         body)
                    if not torch.equal(run(), ref):
                        raise AssertionError(f"#6 {body} {model} {name} "
                                             f"B={B}: not bit for bit")
                    ms[body][i] += time_ms(run, 20, pad)
            del w
        faster = [t < d for t, d in zip(ms["tile"], ms["decode"])]
        from_b[model] = next((STACKED_SCAN_B[i] for i in range(len(faster))
                              if all(faster[i:])), None)
        out[model] = {f"{b}_ms": v for b, v in ms.items()}
    out["tile_min_b_measured"] = from_b
    return out


# Qwen3-30B-A3B's expert linears: gate and up (N 768, K 2048) in stacked
# planes, the down (N 2048, K 768) int8 per channel; and an N that is not a
# multiple of 128 for #10's ragged edge
Q_GATE_UP = (768, 2048)
Q_DOWN = (2048, 768)
Q_RAGGED_N = 1000


def qwen3moe_kernel_rows(dev, gen, row) -> None:
    """#7 at Qwen3-30B-A3B's gate and up with the shared x of the 8-slot
    decode and of fewer live slots (B = 1, 4, 8; E 128), the same bits on
    a second call; #6 on each body there at B = 8, 32 (the dense
    decode of ``engine_qwen3moe``'s 32 slots) and 256; #10 at its down over the 24576 grouped rows of
    1024 tokens routed top-8 over 128 experts by a seeded router, at N
    2048 and at N 1000; #9 at its gate and up over the same grouping, as
    ``engine_qwen3moe``'s prefill launches it.  #9 and #10 must equal their
    plain versions bit for bit, #10 also on a second call."""
    arch = QWEN3_30B_A3B
    E, top_k = arch.moe.num_experts, arch.moe.top_k
    N, K = Q_GATE_UP
    acts = {}
    for B in SMALLM_ROWS_B:
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        acts[B] = (x, *W.quantize_act_per_token(x))
    gate_up = {}
    for name in ("gate", "up"):
        w3 = (torch.randn((E, N, K), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        qp = QM.quantize_linear_stacked(w3, WSPEC)
        del w3
        assert qp.layout == "stacked_planes"
        wd = QM.dequant_weight_stacked(qp, torch.bfloat16)
        wa = (qp.codes, qp.scales, qp.zeros)
        for B, (x, xq, xs) in acts.items():
            xe = x.expand(E, B, K)
            row("w4a8_stacked_matmul_smallm", f"qwen3_B{B}", name, N, K,
                lambda: M.w4a8_stacked_matmul_smallm(xq, xs, *wa),
                lambda: M.w4a8_stacked_matmul_smallm_plain(xq, xs, *wa),
                lambda: torch.bmm(xe, wd.transpose(1, 2)),
                E * expert_bytes(N, K) + xq.numel() + B * 4 + E * B * N * 4,
                2 * E * B * N * K, tol=TOL_SMALLM, kind="bf16", repeat=True,
                B=B, pair=False)
        for B in STACKED_ROWS_B:
            stacked_rows(row, f"qwen3_B{B}", name, qp, wd, B, False, gen,
                         dev)
        gate_up[name] = (qp, wd)
        del qp, wd, wa
    topi = seeded_topi(1024, gen, dev, E, arch)
    N, K = Q_DOWN
    x = torch.randn((1024, K), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs, be, facts = grouped_operands(x, topi, E)
    if facts["live_experts"] != E:
        raise AssertionError("the seeded router left an expert idle")
    xpad = padded_expert_rows(x, topi, E, top_k)
    Mp = facts["Mp"]
    for case, N in (("qwen3_prefill", N), ("ragged_n", Q_RAGGED_N)):
        w3 = (torch.randn((E, N, K), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        qp = QM.quantize_linear_stacked(w3, WSPEC)
        del w3
        assert (qp.layout, qp.bits) == ("stacked", 8)
        wd = QM.dequant_weight_stacked(qp, torch.bfloat16)
        wa = (qp.codes, qp.scales)
        y1, y2 = (M.w8a8_grouped_matmul(xq, xs, *wa, be) for _ in range(2))
        if not torch.equal(y1, y2):
            raise AssertionError(f"#10 {case}: a second call gave other "
                                 "bits")
        del y1, y2
        row("w8a8_grouped_matmul", case, "down", N, K,
            lambda: M.w8a8_grouped_matmul(xq, xs, *wa, be),
            lambda: M.w8a8_grouped_matmul_plain(xq, xs, *wa, be),
            lambda: torch.bmm(xpad, wd.transpose(1, 2)),
            E * (N * K + N * 4) + Mp * K + Mp * 4 + Mp * N * 4,
            2 * facts["selections"] * N * K, exact=True, **facts,
            library_rows_per_expert=xpad.shape[1], repeat_equal=True,
            ops_bound_at_Mp_ms=2 * Mp * N * K / PEAK_OPS["int8"] * 1e3)
        del qp, wd, wa
    N, K = Q_GATE_UP
    x = torch.randn((1024, K), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs, be, facts = grouped_operands(x, topi, E)
    xpad = padded_expert_rows(x, topi, E, top_k)
    for name, (qp, wd) in gate_up.items():
        wa = (qp.codes, qp.scales, qp.zeros)
        row("w4a8_grouped_matmul", "qwen3_prefill", name, N, K,
            lambda: M.w4a8_grouped_matmul(xq, xs, *wa, be),
            lambda: M.w4a8_grouped_matmul_plain(xq, xs, *wa, be),
            lambda: torch.bmm(xpad, wd.transpose(1, 2)),
            E * expert_bytes(N, K) + Mp * K + Mp * 4 + Mp * N * 4,
            2 * facts["selections"] * N * K, exact=True, **facts,
            library_rows_per_expert=xpad.shape[1],
            ops_bound_at_Mp_ms=2 * Mp * N * K / PEAK_OPS["int8"] * 1e3)
        del wa
    del gate_up


def attn_bound(kname: str, lengths: torch.Tensor):
    """Least time of one decode-attention call: the bytes of the valid
    columns only (codes and scales of K and V: 2 * D + 4 bytes a column
    and kv head at int8, D + 4 at int4; the kernels skip masked columns,
    which contribute exactly 0), q, the fresh token (#17) and the
    outputs, against the int8 dot operations (QK and PV, 2*D each per
    query row and column) at the int8 peak."""
    B, H, G, D = ATT_B, ATT_H, ATT_G, ATT_D
    cols = H * int(lengths.sum())
    per_col = (D + 4) if kname.startswith("decode_attention_bd4") \
        else (2 * D + 4)
    nbytes = cols * per_col + B * H * G * D * 2 + B * 4
    if kname == "decode_attention_i8":
        cols += B * H  # the fresh token's column
        nbytes += 2 * B * H * (D + 2) + B * H * G * D * 4
    else:
        nbytes += B * H * G * (D + 2) * 4  # ctx, m, d
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 4 * G * D * cols / PEAK_OPS["int8"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def ragged_lengths(S: int, dev) -> torch.Tensor:
    """8 slots: empty, at the buffer's end, and ragged between."""
    return torch.tensor([0, S, 1, S // 2 + 3, S - 5, 17, S // 3, 3 * S // 4],
                        dtype=torch.int32, device=dev)


def ctx_error(out, ref):
    """(max |err|, max |ref|) of the normalized context; ``out`` and
    ``ref`` are #17's context or the block-diagonal kernels' (ctx, m, d),
    whose m and d must agree to TOL_MD relative."""
    if isinstance(out, tuple):
        (c, m, d), (rc, rm, rd) = out, ref
        if not (((m - rm).abs() <= TOL_MD * rm.abs()).all()
                and ((d - rd).abs() <= TOL_MD * rd.abs()).all()):
            raise AssertionError("block-diagonal kernel: m or d off its "
                                 "plain version")
        out = c / d.clamp_min(1e-30)[..., None]
        ref = rc / rd.clamp_min(1e-30)[..., None]
    if not torch.isfinite(out).all():
        raise AssertionError("attention kernel output is not finite")
    return float((out - ref).abs().max()), float(ref.abs().max())


def attn_case(kname: str, S: int, dev, gen, lengths=None,
              s_block: int = AT.S_BLOCK):
    """Inputs of one decode-attention kernel at buffer S: (wrapper call,
    plain call, the bare kernel launch on prepared operands, the library
    yardstick call, lengths).  ``lengths`` None: ``ragged_lengths``; the
    flash kernels take ``s_block`` (the engine's 512 by default), their
    plain version the kernel's split (``AT.bd_flash_card_parts``)."""
    B, H, G, D = ATT_B, ATT_H, ATT_G, ATT_D
    q = torch.randn((B, H, G, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((B, H, S, D), generator=gen, device=dev) * 2
    v = torch.randn((B, H, S, D), generator=gen, device=dev)
    L = ragged_lengths(S, dev) if lengths is None else lengths
    q8, qs = AT.quantize_q(q)
    if kname == "decode_attention_i8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kn, kns = quantize_kv(torch.randn((B, H, 1, D), generator=gen,
                                          device=dev) * 2)
        vn, vns = quantize_kv(torch.randn((B, H, 1, D), generator=gen,
                                          device=dev))
        args = (q, kq, ks, vq, vs, kn[:, :, 0].contiguous(),
                kns[:, :, 0].contiguous(), vn[:, :, 0].contiguous(),
                vns[:, :, 0].contiguous(), L)
        bare = split_bare(q8, qs, args[1:5], L, "i8", args[5:9])
        kf, vf = (c.float() * s[..., None].float() for c, s in ((kq, ks),
                                                                 (vq, vs)))
        run = lambda: AT.decode_attention_i8(*args)
        plain = lambda: AT.decode_attention_i8_plain(*args)
    else:
        nib = kname.startswith("decode_attention_bd4")
        kc, ks = (quantize_kv4 if nib else quantize_kv)(k)
        vc, vs = (quantize_kv4 if nib else quantize_kv)(v)
        R = kc.shape[-1]
        kt = kc.transpose(2, 3).reshape(B, H * R, S).contiguous()
        vt = vc.transpose(1, 2).reshape(B, S, H * R).contiguous()
        args = (q, kt, ks, vt, vs, L)
        outs = [torch.empty(s, dtype=torch.float32, device=dev)
                for s in ((B, H, G, D), (B, H, G), (B, H, G))]
        extra = {}
        if kname.endswith("_flash"):
            sb = AT.flash_block(S, s_block)
            parts, slots = AT.bd_flash_card_parts(B * H, G, S, sb, nib, dev)
            bare = lambda: AT._bd_flash_launch(q8, qs, *args[1:], outs, sb,
                                               parts, slots, nib)
            extra = dict(s_block=s_block)
            plain_kw = dict(extra, parts=parts)
        else:
            bare = split_bare(q8, qs, args[1:5], L, "bd4" if nib else "bd")
            plain_kw = {}
        if nib:
            kf, vf = (unpack_kv4(c) * s[..., None].float()
                      for c, s in ((kc, ks), (vc, vs)))
        else:
            kf, vf = (c.float() * s[..., None].float()
                      for c, s in ((kc, ks), (vc, vs)))
        run = lambda: getattr(AT, kname)(*args, **extra)
        plain = lambda: getattr(AT, kname + "_plain")(*args, **plain_kw)
    kf, vf = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    mask = (torch.arange(S, device=dev)[None] < L[:, None])[:, None, None]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kf, vf, attn_mask=mask)
    return run, plain, bare, library, L


def split_bare(q8, qs, cache, L, mode, fresh=None):
    """The split kernel's bare launch in ``mode`` (``AT.SPLIT_MODES``: #18
    "bd", #20 "bd4" over the kv4 slabs, #17 "i8" with ``fresh``, the fresh
    token) on prepared operands: ``bare()`` on the cluster size and ring
    depth the wrapper picks (``AT.split_card_parts``), ``bare(parts,
    slots)`` on forced ones; returns the outputs."""
    B, H, G, D = q8.shape
    S = cache[0].shape[2] if mode == "i8" else cache[0].shape[-1]
    picked = AT.split_card_parts(B * H, S, G, mode, q8.device)
    f32 = dict(dtype=torch.float32, device=q8.device)
    outs = {}

    def bare(parts=picked[0], slots=picked[1]):
        if (parts, slots) not in outs:
            outs[parts, slots] = (torch.empty((B, H, G, D), **f32),) \
                if fresh is not None else (
                    torch.empty((B, H, G, D), **f32),
                    torch.empty((B, H, G), **f32),
                    torch.empty((B, H, G), **f32))
        AT._split_launch(q8, qs, cache, L, outs[parts, slots], parts, slots,
                         mode, fresh)
        return outs[parts, slots]

    bare.picked = picked
    bare.mode = mode
    return bare


def engine_lengths(S: int, dev, gen) -> torch.Tensor:
    """8 slots at the lengths of the engine phase over buffer S: prompts of
    100-128 tokens in 512 (``engine_pallas``, ``engine_bd``), 1500-2000 in
    4096 (``engine_bds``), 3000-4000 in 8192 (``engine_kv4_long``), plus
    the tokens generated."""
    lo, hi = {512: (100, 159), 4096: (1500, 2016),
              8192: (3000, 4016)}[S]
    return torch.randint(lo, hi + 1, (ATT_B,), generator=gen,
                         device=dev).to(torch.int32)


# #17/#18's split across cluster sizes: the chooser's against one CTA a
# pair, #17's output within this relative error (only d's f32 order moves)
SPLIT_REL = 1e-6
# the flash kernels' and #17/#18's extra rows: (kernel, S, case, s_block);
# the main rows (ragged lengths, 512-column blocks) stay first
FLASH_ROWS = (("decode_attention_i8", 512, "engine", AT.S_BLOCK),
              ("decode_attention_bd", 512, "engine", AT.S_BLOCK),
              ("decode_attention_bd4", 4096, "engine", AT.S_BLOCK),
              ("decode_attention_bd4", 4096, "full", AT.S_BLOCK),
              ("decode_attention_bd_flash", 4096, "full", AT.S_BLOCK),
              ("decode_attention_bd_flash", 4096, "engine", AT.S_BLOCK),
              ("decode_attention_bd_flash", 4096, "sb256", 256),
              ("decode_attention_bd4_flash", 8192, "full", AT.S_BLOCK),
              ("decode_attention_bd4_flash", 8192, "engine", AT.S_BLOCK))


def split_checks(kname, S, case, got, ref, again, bare) -> dict:
    """#17/#18/#20's gates beyond the plain version's: a second call the
    same bits; the chooser's cluster size against one CTA a pair (#18, #20:
    ctx and m the same bits; #17 within SPLIT_REL relative); #18's and
    #20's m their plain versions' bit for bit."""
    parts, slots = bare.picked
    mine = bare()
    one = bare(1, AT.split_slots(ATT_G, AT.kv8_columns(S, 1), bare.mode))
    torch.cuda.synchronize()
    where = f"{kname} S={S} {case}"
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where}: a second call gave other bits")
    out = dict(parts=parts, slots=slots, repeat_equal=True,
               split_equal=True)
    if kname in ("decode_attention_bd", "decode_attention_bd4"):
        if not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{where}: m is not its plain version's "
                                 f"bit for bit")
        if not (torch.equal(mine[0], one[0]) and torch.equal(mine[1],
                                                             one[1])):
            raise AssertionError(f"{where}: ctx or m differ between "
                                 f"{parts} CTAs a pair and 1")
        out["m_bit_equal"] = True
    else:
        rel = float(((mine[0] - one[0]).abs()
                     / one[0].abs().clamp_min(1e-30)).max())
        if not rel <= SPLIT_REL:
            raise AssertionError(f"{where}: {parts} CTAs a pair and 1 differ "
                                 f"by {rel} relative")
        out["split_max_rel"] = rel
    return out


def phase_attn_kernels(dev) -> dict:
    """#20 at buffer 4096 and 512, #21 at 8192, #17 at 512 and 4096, #18
    at 512 and 4096, #19 at 4096 (512-column blocks) against their plain
    versions, ragged lengths; #17, #18 and #20 also at their engine phases'
    lengths, #20 also at full ones (``split_checks``: a second call, the
    chooser's cluster size against one CTA, #18's and #20's m bit for
    bit); #19 and #21 also at full lengths
    and at their engine phases' lengths, #19 in 256-column blocks, held to
    the plain rendering of their split: m bit for bit, a second call the
    same bits.
    Times of the bare kernel (operands prepared), of the whole wrapper
    (with the query's int8 quantization), of the plain version, and of the
    library yardstick: PyTorch's scaled_dot_product_attention of the bf16
    q over the pre-dequantized bf16 K/V (another function over 2-4 times
    the bytes; the port never calls it)."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    rows = []
    cases = [(k, S, "ragged", AT.S_BLOCK) for k, S in (
        ("decode_attention_bd4", 4096), ("decode_attention_bd4_flash", 8192),
        ("decode_attention_bd4", 512),
        ("decode_attention_i8", 512), ("decode_attention_i8", 4096),
        ("decode_attention_bd", 512), ("decode_attention_bd", 4096),
        ("decode_attention_bd_flash", 4096))] + list(FLASH_ROWS)
    for kname, S, case, sbk in cases:
        lengths = {"ragged": None, "sb256": None,
                   "full": torch.full((ATT_B,), S, dtype=torch.int32,
                                      device=dev),
                   "engine": engine_lengths(S, dev, gen)}[case]
        run, plain, bare, library, L = attn_case(kname, S, dev, gen,
                                                 lengths, sbk)
        got, ref = run(), plain()
        extra = {}
        if kname.endswith("_flash"):
            again = run()
            torch.cuda.synchronize()
            if not torch.equal(got[1], ref[1]):
                raise AssertionError(f"{kname} S={S} {case}: m is not its "
                                     f"plain version's bit for bit")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{kname} S={S} {case}: a second call "
                                     f"gave other bits")
            sb = AT.flash_block(S, sbk)
            parts, slots = AT.bd_flash_card_parts(
                ATT_B * ATT_H, ATT_G, S, sb,
                kname.startswith("decode_attention_bd4"), dev)
            extra = dict(s_block=sb, parts=parts, slots=slots,
                         m_bit_equal=True, repeat_equal=True)
        elif kname in ("decode_attention_i8", "decode_attention_bd",
                       "decode_attention_bd4"):
            extra = split_checks(kname, S, case, got, ref, run(), bare)
        err, scale = ctx_error(got, ref)
        torch.cuda.synchronize()
        if not err <= TOL_CTX * scale:
            raise AssertionError(f"{kname} S={S} {case}: max|err| {err} > "
                                 f"{TOL_CTX} * {scale}")
        b_ms, b_by = attn_bound(kname, L)
        rows.append({
            "kernel": kname, "S": S, "case": case, "lengths": L.tolist(),
            **extra, "max_abs_err": err, "max_abs_ref": scale,
            "tol": TOL_CTX, "kernel_ms": time_ms(bare, 20, pad),
            "wrapper_ms": time_ms(run, 20, pad),
            "plain_ms": time_ms(plain, 3, pad),
            "library_ms": time_ms(library, 20, pad),
            "bound_ms": b_ms, "bound_by": b_by})
    return {"phase": "attn_kernels", "rows": rows,
            "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# the bench's decode stack (lightcompress_tpu_torch.bench): #5, #15, #16, #22
# ---------------------------------------------------------------------------

# #22: a bf16 probability can round one step apart where the f32 sums
# differ in their last bit; times a code of at most 127 (as the CPU tests)
TOL_KV8 = 1e-3
# #22's second row: 8 slots over 4097 columns, where its cluster splits S
KV8_SPLIT_CASE = (8, 4097)
# the five configurations of the bench phases: config fields and the
# launches each kernel takes (per layer, once a step)
BENCH_CONFIGS = {
    "default": ({}, {"w4a8_matmul_decode": (4, 0)}),
    "tail1": (dict(tail=1, scales="bf16"),
              {"w4a8_matmul_decode": (1, 0), "w4a8_attn_tail_fused": (1, 0)}),
    "tail2": (dict(tail=2, scales="bf16"),
              {"w4a8_matmul_decode": (0, 1), "w4a8_layer_fused": (1, 0)}),
    "pallas": (dict(attn="pallas"),
               {"w4a8_matmul_decode": (4, 0), "decode_attention_kv8": (1, 0)}),
    "ksplit": (dict(ksplit=True),
               {"w4a8_matmul_decode": (3, 0),
                "w4a8_matmul_planes_ksplit": (1, 0)}),
    # the root bench's BENCH_MASKED=qkv,o with its default f32 scales
    "masked": (dict(masked=("o", "qkv")),
               {"w4a8_matmul_decode": (2, 0),
                "w4a16_matmul_planes_masked": (2, 0)}),
}
BENCH_KERNELS = ("w4a8_matmul_planes_ksplit", "w4a8_attn_tail_fused",
                 "w4a8_layer_fused", "decode_attention_kv8")
# kernels whose kernels-line entry sums their ``main`` bench_kernels rows:
# #4 over the masked bench's entries (q|k|v and o), #11 over a Llama-3-8B
# block's seven linears at M 8
SUMMED_KERNELS = ("w4a16_matmul_planes_masked", "w4a8_matmul_s4_bytes")


# #5's rows beside the bench's B
KSPLIT_M = (1, 7, 300)
# #15 and #16 also on a grid capped at three blocks
BENCH_TAIL_CAP = 3


def random_planes(gen, dev, N: int, K: int):
    """Random plane words with random per-group scales and zero points:
    (codes, s, zs) with bf16 s and zs = z*s."""
    wp = torch.randint(-2**31, 2**31 - 1, (N, K // 8), generator=gen,
                       device=dev, dtype=torch.int32)
    s = torch.rand((N, K // 128), generator=gen, device=dev) * 0.02 + 0.005
    z = torch.randint(0, 16, (N, K // 128), generator=gen, device=dev).float()
    return wp, s.to(torch.bfloat16), (z * s).to(torch.bfloat16)


def planes_bytes(N: int, K: int) -> int:
    return N * K // 2 + 2 * N * (K // 128) * 2


def phase_bench_kernels(dev) -> dict:
    """#5, #15, #16 and #22 against their plain versions at the bench's
    shapes (B 32, H 4096, I 14336, q|k|v 6144; #5 on the down projection,
    K 14336; #22 over CTX + 1 = 2049 columns, 8 KV heads of 4 query
    heads), random weights with random per-group scales and zero points;
    times of the kernel, the plain version, the bound and the library
    yardstick (#15/#16: torch.matmul over the pre-dequantized bf16 o,
    gate|up, down (and q|k|v), in turn; #5: torch.matmul over the
    dequantized down; #22: scaled_dot_product_attention over the
    pre-dequantized bf16 K and V), and for #15/#16 the act codes each
    prologue flips against the plain version, the error in bf16 ulps, the
    same bits on a second call (also on a grid capped at three blocks),
    the grid, the shared memory of a block, the splits of each phase and
    the median µs of each phase over five launches (``LF.phase_times``)."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    cfg = TB.BenchConfig()
    B, H, I = cfg.batch, cfg.hidden, cfg.inter
    Nq = (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim
    shapes = {"o": (H, H), "gateup": (2 * I, H), "down": (H, I),
              "qkv": (Nq, H)}
    w = {n: random_planes(gen, dev, *nk) for n, nk in shapes.items()}
    wd = {n: dequant_weight(QLinearParams(*w[n], None, 128, "planes", True))
          for n in w}
    ctx = torch.randn((B, H), generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((B, H), generator=gen, device=dev).to(torch.bfloat16)
    mid = (torch.randn((B, I), generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    rows = []

    def row(kname, err, scale, tol, run, plain, library, nbytes, ops, kind,
            **extra):
        if not err <= limit(tol, scale):
            raise AssertionError(f"{kname}: max|err| {err} > {tol} * "
                                 f"{scale}")
        b_ms, b_by = bytes_ops_bound(nbytes, ops, kind)
        rows.append(dict(kernel=kname, max_abs_err=err, max_abs_ref=scale,
                         tol=tol, kernel_ms=time_ms(run, 20, pad),
                         plain_ms=time_ms(plain, 3, pad),
                         library_ms=time_ms(library, 20, pad),
                         bound_ms=b_ms, bound_by=b_by, **extra))

    def error(outs, refs):
        for o in outs:
            if not torch.isfinite(o.float()).all():
                raise AssertionError("a bench kernel's output is not finite")
        errs = [float((o.float() - r.float()).abs().max())
                for o, r in zip(outs, refs)]
        scales = [float(r.float().abs().max()) for r in refs]
        i = max(range(len(errs)), key=lambda j: errs[j] / scales[j])
        return errs[i], scales[i]

    for kname, names in (("w4a8_attn_tail_fused", ("o", "gateup", "down")),
                         ("w4a8_layer_fused",
                          ("o", "gateup", "down", "qkv"))):
        kern = getattr(LF, kname)
        nxt = len(names) == 4
        args = [t for n in names for t in w[n]]
        run = lambda: kern(ctx, x, *args)
        plain = lambda: getattr(LF, kname + "_plain")(ctx, x, *args)
        ry, rq, racts = LF._plain(ctx, x, *(w[n] for n in names[:3]),
                                  w["qkv"] if nxt else None, 1e-6)
        refs = [ry] if not nxt else [ry, rq]
        gates = {}
        # the co-resident grid and one capped at three blocks: each call
        # within the gates and a second call the same bits
        for cap in (0, BENCH_TAIL_CAP):
            y, q, acts = LF._with_act(kern, ctx, x, *args, max_blocks=cap)
            y2, q2, acts2 = LF._with_act(kern, ctx, x, *args,
                                         max_blocks=cap)
            torch.cuda.synchronize()
            flips = [int((a[0] != r[0]).sum()) for a, r in zip(acts, racts)]
            for f, (codes, _) in zip(flips, racts):
                if f > 1e-3 * codes.numel():
                    raise AssertionError(f"{kname} (grid cap {cap}): "
                                         f"{flips} act-code flips")
            outs, again = ([y], [y2]) if not nxt else ([y, q], [y2, q2])
            same = all(torch.equal(a, b) for a, b in zip(outs, again)) and \
                all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                    for a, b in zip(acts, acts2))
            if not same:
                raise AssertionError(f"{kname} (grid cap {cap}): a second "
                                     "call gave other bits")
            err, scale = error(outs, refs)
            if not err <= limit(TOL_ULP, scale):
                raise AssertionError(f"{kname} (grid cap {cap}): max|err| "
                                     f"{err} > a bf16 ulp at {scale}")
            gates[cap] = dict(max_abs_err=err, max_abs_ref=scale,
                              err_ulps=err / bf16_ulp(scale),
                              act_code_flips=flips, repeat_equal=True,
                              grid_blocks=LF.grid_blocks(B, H, I, Nq, nxt,
                                                         cap))
        stamps = []
        for _ in range(5):
            LF._with_act(kern, ctx, x, *args, stamps=stamps)
        torch.cuda.synchronize()
        phases = [LF.phase_times(t, nxt) for t in stamps]
        full = gates.pop(0)
        library = lambda: [torch.matmul(t, wd[n].t()) for t, n in
                           zip((ctx, x, mid, x), names)]
        nbytes = sum(planes_bytes(*shapes[n]) for n in names) \
            + 3 * B * H * 2 + (B * Nq * 2 if nxt else 0)
        ops = 2 * B * sum(shapes[n][0] * shapes[n][1] for n in names)
        pl = LF.plan(B, H, I, Nq, nxt)
        row(kname, full.pop("max_abs_err"), full.pop("max_abs_ref"), TOL_ULP,
            run, plain, library, nbytes, ops, "int8", **full,
            smem_bytes=pl["smem_bytes"], splits=pl["splits"],
            capped=gates[BENCH_TAIL_CAP],
            phase_us={k: statistics.median(t[k] for t in phases)
                      for k in phases[0]})

    # #5 at the bench's B first (the kernels line reads that row), then at
    # M 1, 7 and 300 (rows of their own seed): bit for bit its plain
    # version, and a second call the same bits
    gen5 = torch.Generator(device=dev)
    gen5.manual_seed(SEED + 6)
    for M in (B, *KSPLIT_M):
        xm = mid if M == B else (torch.randn(
            (M, I), generator=gen5, device=dev) * 3).to(torch.bfloat16)
        xq, xs = W.quantize_act_per_token(xm)
        run = lambda: W.w4a8_matmul_planes_ksplit(xq, xs, *w["down"])
        plain = lambda: W.w4a8_matmul_planes_ksplit_plain(xq, xs,
                                                          *w["down"])
        y, again, ref = run(), run(), plain()
        err, scale = error([y], [ref])
        if not (torch.equal(y, ref) and torch.equal(y, again)):
            raise AssertionError(f"#5 M={M}: not its plain version's bits, "
                                 "or a second call's")
        row("w4a8_matmul_planes_ksplit", err, scale, TOL_F32, run, plain,
            lambda: torch.matmul(xm, wd["down"].t()),
            planes_bytes(H, I) + M * I + M * H * 4 + M * 4, 2 * M * H * I,
            "int8", M=M, bit_equal=True, repeat_equal=True)

    # #22 at the bench's B 32 over CTX + 1 columns first (the kernels line
    # reads that row), then at 8 slots over 4097 (the cluster split at
    # work); a second call the same bits
    Hk, G, D = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim
    for Bk, S in ((B, cfg.ctx + 1), KV8_SPLIT_CASE):
        qg = torch.randn((Bk, Hk, G, D), generator=gen, device=dev).to(
            torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (Bk, Hk, S, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = ((torch.rand((Bk, Hk, S), generator=gen, device=dev) * 0.02
                   + 1e-3).to(torch.bfloat16) for _ in range(2))
        args = (qg, kq, ks, vq, vs)
        run = lambda: AT.decode_attention_kv8(*args)
        plain = lambda: AT.decode_attention_kv8_plain(*args)
        y, again = run(), run()
        err, scale = error([y], [plain()])
        if not torch.equal(y, again):
            raise AssertionError(f"#22 B={Bk} S={S}: a second call gave "
                                 "other bits")
        kf, vf = ((c.float() * s_[..., None].float()).to(torch.bfloat16)
                  for c, s_ in ((kq, ks), (vq, vs)))
        row("decode_attention_kv8", err, scale, TOL_KV8, run, plain,
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qg, kf, vf),
            2 * Bk * Hk * S * (D + 2) + Bk * Hk * G * D * (2 + 4),
            4 * Bk * Hk * G * S * D, "bf16", B=Bk, S=S, repeat_equal=True,
            parts=AT.kv8_card_parts(Bk * Hk, S, G, False, dev))
        del kq, vq, kf, vf
    return {"phase": "bench_kernels", "rows": rows,
            "seconds": time.time() - t0}


# #4 at the bench's four fused entries (N, K), the masked bench's main ones
# first
MASKED_SHAPES = [("qkv", 6144, 4096, True), ("o", 4096, 4096, True),
                 ("gateup", 28672, 4096, False), ("down", 4096, 14336, False)]
S4_NATURAL_M = (8, 32)


def dequant_codes(u, s, z):
    """(N, K) bf16 weights (u - z) * s per group of 128."""
    N, K = u.shape
    w = (u.float().reshape(N, -1, 128) - z[..., None]) * s.float()[..., None]
    return w.reshape(N, K).to(torch.bfloat16)


def phase_masked_s4_kernels(dev) -> dict:
    """#4 (masked planes, the root bench's f32 pre-divided scales, random
    codes, scales 0.01 and zero points 8) at the bench's fused entries at
    B 32 (and with bf16 scales at its main entries), and #11 (natural s4
    bytes, bf16 scales, random codes, scales and zero points) at a
    Llama-3-8B block's seven linears at M 8 and 32, each against its plain
    version (#4: f32 outputs, 1e-4 of max|y|; #11 bit for bit) with times of
    the kernel, the plain version, the bound and the library yardstick
    (torch.matmul over the pre-dequantized bf16 weight, on bf16 x or the
    dequantized int8 x), each the same bits on a second call; and #4
    against #1 on the same codes, scales and
    zero points (bf16-exact scale 0.01 and z = 8, which both layouts hold
    exactly): 1e-4 of max|y|."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    B = TB.BenchConfig().batch
    rows, vs_planes = [], []

    def row(kname, got, ref, run, plain, library, nbytes, ops, kind,
            exact=False, **extra):
        """``exact``: the kernel must equal its plain version bit for
        bit (#11), else be within TOL_F32 of max|y| (#4)."""
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{kname}: output not finite")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        equal = bool(torch.equal(got, ref))
        if not (err <= TOL_F32 * scale and (equal or not exact)):
            raise AssertionError(f"{kname} {extra}: max|err| {err} > "
                                 f"{TOL_F32} * {scale} or not bit-equal")
        if not torch.equal(run(), run()):
            raise AssertionError(f"{kname} {extra}: two calls differ")
        b_ms, b_by = bytes_ops_bound(nbytes, ops, kind)
        rows.append(dict(kernel=kname, max_abs_err=err, max_abs_ref=scale,
                         err_ulps=err / bf16_ulp(scale), bit_equal=equal,
                         tol="bit_equal" if exact else TOL_F32,
                         kernel_ms=time_ms(run, 20, pad),
                         plain_ms=time_ms(plain, 3, pad),
                         library_ms=time_ms(library, 20, pad),
                         bound_ms=b_ms, bound_by=b_by, **extra))

    for entry, N, K, main in MASKED_SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        s = torch.full((N, K // 128), 0.01, device=dev)
        z = torch.full_like(s, 8.0)
        wp = W.pack_int4_planes_masked(u)
        sm, zm = W.masked_scales(s), W.masked_zero_scales(z, s)
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        wd = dequant_codes(u, s, z)
        run = lambda: W.w4a16_matmul_planes_masked(x, wp, sm, zm)
        plain = lambda: W.w4a16_matmul_planes_masked_plain(x, wp, sm, zm)
        row("w4a16_matmul_planes_masked", run(), plain(), run, plain,
            lambda: torch.matmul(x, wd.t()),
            N * K // 2 + 2 * N * (K // 128) * 4 + 2 * B * K + 4 * B * N,
            2 * B * N * K, "bf16", entry=entry, N=N, K=K, M=B, main=main,
            scales="f32")
        if main:  # the kernel's bf16-scale instance
            smb, zmb = sm.to(torch.bfloat16), zm.to(torch.bfloat16)
            run = lambda: W.w4a16_matmul_planes_masked(x, wp, smb, zmb)
            plain = lambda: W.w4a16_matmul_planes_masked_plain(x, wp, smb,
                                                                zmb)
            row("w4a16_matmul_planes_masked", run(), plain(), run, plain,
                lambda: torch.matmul(x, wd.t()),
                N * K // 2 + 2 * N * (K // 128) * 2 + 2 * B * K + 4 * B * N,
                2 * B * N * K, "bf16", entry=entry, N=N, K=K, M=B,
                main=False, scales="bf16")
        # the same product through #1's unpack on scales both hold exactly
        sb = s.to(torch.bfloat16)
        y1 = W.w4a16_matmul(x.float(), W.pack_int4_planes(u), sb,
                            (z * sb.float()).to(torch.bfloat16))
        y4 = W.w4a16_matmul_planes_masked(x, wp, W.masked_scales(sb),
                                          W.masked_zero_scales(z, sb))
        torch.cuda.synchronize()
        err = float((y4 - y1).abs().max())
        scale = float(y1.abs().max())
        vs_planes.append(dict(entry=entry, max_abs_err=err,
                              max_abs_ref=scale))
        if not err <= TOL_F32 * scale:
            raise AssertionError(f"#4 vs #1 at {entry}: {err} > {TOL_F32} "
                                 f"* {scale}")
        del u, wp, sm, zm, wd

    for name, N, K in SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        s = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.02
             + 0.005).to(torch.bfloat16).float()
        z = torch.randint(0, 16, (N, K // 128), generator=gen,
                          device=dev).float()
        wb = W.pack_s4_bytes(u)
        sb, zb = s.to(torch.bfloat16), ((z - 8) * s).to(torch.bfloat16)
        wd = dequant_codes(u, s, z)
        for M in S4_NATURAL_M:
            xq, xs = W.quantize_act_per_token(
                torch.randn((M, K), generator=gen, device=dev))
            xd = (xq.float() * xs).to(torch.bfloat16)
            run = lambda: W.w4a8_matmul_s4_bytes(xq, xs, wb, sb, zb)
            plain = lambda: W.w4a8_matmul_s4_plain(xq, xs, wb, sb, zb)
            row("w4a8_matmul_s4_bytes", run(), plain(), run, plain,
                lambda: torch.matmul(xd, wd.t()),
                N * K // 2 + 2 * N * (K // 128) * 2 + M * K + 4 * M
                + 4 * M * N, 2 * M * N * K, "int8", exact=True, entry=name,
                N=N, K=K, M=M, main=M == S4_NATURAL_M[0])
        del u, wb, wd
    return {"phase": "masked_s4_kernels", "rows": rows,
            "masked_vs_planes": vs_planes, "seconds": time.time() - t0}


def phase_s4_entry(dev) -> dict:
    """#11's main path, its entry point ``w4a8_matmul_s4_bytes`` as a
    caller drives it: one Llama-3-8B block's seven linears, each on the
    per-token int8 quantization of its input, at M 8 (random weights, bf16
    scales); counts set to 0 just before and read just after: 7
    launches."""
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    w = {}
    for name, N, K in SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        s = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.02
             + 0.005)
        z = torch.randint(0, 16, s.shape, generator=gen, device=dev)
        w[name] = (W.pack_s4_bytes(u), s.to(torch.bfloat16),
                   ((z - 8) * s).to(torch.bfloat16))
    H, M = LLAMA3_8B.hidden_size, S4_NATURAL_M[0]
    x = torch.randn((M, H), generator=gen, device=dev)

    def lin(name, t):
        xq, xs = W.quantize_act_per_token(t)
        return W.w4a8_matmul_s4_bytes(xq, xs, *w[name])

    torch.cuda.synchronize()
    reset_launch_counts()
    q, k, v = (lin(n, x) for n in ("q", "k", "v"))
    h = x + lin("o", q)
    g, u_ = lin("gate", h), lin("up", h)
    y = h + lin("down", A._act(g, "silu") * u_)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in KERNELS}
    if launches["w4a8_matmul_s4_bytes"] != 7 or not torch.isfinite(y).all():
        raise AssertionError(f"s4 entry: {launches}")
    emit({"phase": "s4_entry", "M": M, "launches": launches,
          "out_shape": list(y.shape), "seconds": time.time() - t0})
    return launches


def bench_expected(name: str, layers: int) -> dict:
    """{kernel: launches of one step} of a bench configuration."""
    return {k: a * layers + c for k, (a, c) in BENCH_CONFIGS[name][1].items()}


def check_bench_launches(name: str, launches: dict, layers: int,
                         steps: int) -> None:
    want = bench_expected(name, layers)
    for k, n in launches.items():
        if n != want.get(k, 0) * steps:
            raise AssertionError(f"bench {name}: {k} launched {n} times in "
                                 f"{steps} steps, not "
                                 f"{want.get(k, 0) * steps}")


def phase_bench(dev) -> list:
    """The port's bench at B 32, CTX 2048, 32 layers of Llama-3-8B width in
    the five configurations (default, tail=1, tail=2, attn=pallas,
    ksplit): one line each with the bench's JSON fields; the launches of
    its warm-up and timed steps, every kernel exactly as often as the
    configuration routes it; then torch.profiler over two more steps
    (``profiled``).  Returns the launch counts."""
    runs = []
    for name, (over, _) in BENCH_CONFIGS.items():
        t0 = time.time()
        cfg = TB.BenchConfig(**over)
        inputs = TB.build_inputs(cfg, dev, seed=SEED)
        torch.cuda.synchronize()
        reset_launch_counts()
        res = TB.run(cfg, dev, inputs=inputs)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in KERNELS}
        steps = cfg.iters + 1  # the warm-up step and the timed ones
        check_bench_launches(name, launches, cfg.layers, steps)
        if not res["value"] > 0:
            raise AssertionError(f"bench {name}: no tokens/s")
        emit({"phase": "bench", "name": name, **res, "steps": steps,
              "launches_per_step": bench_expected(name, cfg.layers),
              "seconds": time.time() - t0})
        runs.append(launches)
        step = lambda: TB.renorm(TB.decode_step(cfg, *inputs))
        emit({"phase": "profile_bench", "name": name,
              **profiled(lambda: [step() for _ in range(2)], 2)})
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    return runs


@contextlib.contextmanager
def plain_bench_kernels():
    """The bench's kernels replaced by their plain versions (the same
    arguments, the same routes)."""
    swaps = [(W, "w4a8_matmul_decode"), (W, "w4a8_matmul_planes_ksplit"),
             (W, "w4a16_matmul_planes_masked"),
             (AT, "decode_attention_kv8"), (LF, "w4a8_attn_tail_fused"),
             (LF, "w4a8_layer_fused")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_bench_vs_plain(dev) -> None:
    """One bench decode step at full width and 2 layers, random int8
    caches and scales, each configuration with its kernels and with every
    kernel swapped for its plain version: corr >= 0.999, finite, each
    kernel launched as the configuration routes it (none in the plain
    run)."""
    for name, (over, _) in BENCH_CONFIGS.items():
        t0 = time.time()
        cfg = TB.BenchConfig(**over, layers=2)
        layers, x, kc, vc, kvs = TB.build_inputs(cfg, dev, seed=SEED + 11)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 12)
        for t in kc + vc:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        for pair in kvs:
            for t in pair:
                t.copy_(torch.rand(t.shape, generator=gen, device=dev)
                        * 0.02 + 1e-3)
        reset_launch_counts()
        y = TB.decode_step(cfg, layers, x, kc, vc, kvs)
        torch.cuda.synchronize()
        check_bench_launches(name, {k.__name__: k.launches
                                    for k in KERNELS}, cfg.layers, 1)
        reset_launch_counts()
        with plain_bench_kernels():
            ref = TB.decode_step(cfg, layers, x, kc, vc, kvs)
        torch.cuda.synchronize()
        check_bench_launches(name, {k.__name__: k.launches
                                    for k in KERNELS}, cfg.layers, 0)
        a, b = y.float().flatten(), ref.float().flatten()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        finite = bool(torch.isfinite(a).all())
        emit({"phase": "bench_vs_plain", "name": name, "layers": cfg.layers,
              "corr": corr, "max_abs_err": float((a - b).abs().max()),
              "max_abs_ref": float(b.abs().max()), "finite": finite,
              "seconds": time.time() - t0})
        if not (corr >= 0.999 and finite):
            raise AssertionError(f"bench {name} vs plain: corr {corr}")


def make_prompts(n: int, vocab: int, lo: int = 100, hi: int = 128):
    """``n`` prompts of ``lo`` to ``hi`` tokens drawn from the seed."""
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=rng.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def set_gammas(model, seed: int) -> None:
    """ln1/ln2 weights 1 + 0.1 N(0, 1) from ``seed`` (init_params sets
    ones, which a fold would leave as they were).  New tensors: builds made
    before keep the old ones."""
    dev = model.params["embed"]["weight"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h = model.arch.hidden_size
    for bp in model.params["blocks"]:
        for ln in ("ln1", "ln2"):
            bp[ln]["weight"] = (1 + 0.1 * torch.randn(
                h, generator=gen, device=dev)).to(model.arch.dtype)


def padded(prompts, T: int, dev):
    """(N, T) ids with the prompts left-aligned, and their lengths."""
    ids = torch.zeros((len(prompts), T), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, device=dev)
    return ids, torch.tensor([len(p) for p in prompts], device=dev)


def timed_engine(eng: LLMEngine):
    """Wrap the engine's prefill and decode passes (per-step, or the
    chunks of a chunked engine) with synchronised host timers; returns
    the dict they fill."""
    stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0,
             "decode_steps": 0, "prefill_rows": 0, "prefill_batches": 0}
    prefill, step, chunk = (eng._prefill_batch, eng._decode_step,
                            eng._decode_chunk)

    def p(ids, slots, tlens, T):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(ids, slots, tlens, T)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t
        stats["prefill_rows"] += ids.numel()
        stats["prefill_batches"] += 1
        return out

    def timed(fn, n_steps):
        def run(*args):  # args[1]: the active mask of both methods
            active = args[1]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stats["decode_s"] += time.perf_counter() - t
            n = n_steps(args)
            stats["decode_tokens"] += int(active.sum()) * n
            stats["decode_steps"] += n
            return out
        return run

    eng._prefill_batch = p
    if eng.decode_chunk > 1:
        stats["chunks"] = []

        def n_chunk(args):
            stats["chunks"].append(args[0])
            return args[0]
        eng._decode_chunk = timed(chunk, n_chunk)
    else:
        eng._decode_step = timed(step, lambda args: 1)
    return stats


def engine(sw, dev, **kw) -> LLMEngine:
    """The engine with the smoke's defaults (8 slots, max_len 512, kv8,
    prefill bucket 128) updated by ``kw``."""
    opts = dict(max_slots=8, max_len=512, kv_bits=8, prefill_buckets=(128,))
    opts.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # pallas, bd, bds are probe-only
        return LLMEngine(sw, seed=SEED, device=dev, **opts)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def run_engine(sw, prompts, n_new: int, dev, **kw) -> tuple:
    eng = engine(sw, dev, **kw)
    stats = timed_engine(eng)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=n_new))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in KERNELS}
    vocab = sw.arch.vocab_size
    if len(outs) != len(prompts) or any(
            len(o) != n_new or not all(0 <= t < vocab for t in o)
            for o in outs):
        raise AssertionError("engine output has the wrong shape or range")
    plens = [len(p) for p in prompts]
    return outs, launches, dict(
        stats, generate_s=time.time() - t0,
        decode_tok_s=stats["decode_tokens"] / stats["decode_s"],
        attn_impl=eng.attn_impl, ring=eng.ring,
        decode_chunk=eng.decode_chunk, kv_bits=eng.kv_bits,
        cache_bits=eng.cache.bits, layout=eng.cache.layout, body=eng.body,
        buf_len=eng.buf_len,
        prompt_tokens=[min(plens), max(plens)],
        context_max=max(plens) + n_new - 1)


def engine_phase(name: str, sw, prompts, n_new: int, dev, attn: str,
                 expect=None, route=None, outs=None, **kw) -> dict:
    """One engine phase: its attention kernel ``attn`` (None: a plain
    torch route or a ring) launched once a layer and decode step, the
    other attention kernels never.  With ``expect`` ({W4 kernel:
    (launches per prefill batch, per decode step)}) each W4 kernel
    launched exactly so often, and the others never.  With ``route``
    ({stats key: value}, e.g. the attn_impl, ring, cache bits and layout)
    the engine resolved to exactly that.  ``outs`` (a list) receives the
    generated tokens."""
    t0 = time.time()
    got, launches, stats = run_engine(sw, prompts, n_new, dev, **kw)
    if outs is not None:
        outs.extend(got)
    for key, want in (route or {}).items():
        if stats[key] != want:
            raise AssertionError(f"{name}: {key} is {stats[key]}, not "
                                 f"{want}")
    for k in ATTN:
        want = sw.arch.num_layers * stats["decode_steps"] if k == attn \
            else 0
        if launches[k] != want:
            raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                 f"times, not {want}")
    for k in (f.__name__ for f in LF.KERNELS):
        if launches[k]:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times")
    if expect is not None:
        for k in (f.__name__ for f in W4_KERNELS):
            per_p, per_d = expect.get(k, (0, 0))
            want = (per_p * stats["prefill_batches"]
                    + per_d * stats["decode_steps"])
            if launches[k] != want:
                raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                     f"times, not {want}")
    emit({"phase": name, "launches": launches, **stats,
          "seconds": time.time() - t0})
    return launches


def phase_profile(sw, prompts, dev, steps: int = 4, build: str = "w4a8",
                  **kw) -> dict:
    """torch.profiler over a few decode steps with every slot active (on a
    chunked engine one chunk of ``steps`` steps, its sampling and its ring
    flush included): device busy time per kernel name, and the device's
    idle share of the steps' wall time (one stream, so kernel times do not
    overlap)."""
    eng = engine(sw, dev, **kw)
    eng._admit([(i, Request(i, np.asarray(p), steps + 1))
                for i, p in enumerate(prompts)], SamplingParams())
    active = torch.ones(eng.max_slots, dtype=torch.bool, device=dev)

    def run():
        if eng.decode_chunk > 1:
            eng._decode_chunk(steps, active, SamplingParams())
        else:
            for _ in range(steps):
                eng._decode_step(eng.cur_tokens, active)

    return {"phase": "profile_decode", "build": build,
            "act_bits": sw.act_bits, "slots": eng.max_slots,
            "kv_bits": eng.kv_bits, "attn_impl": eng.attn_impl,
            "ring": eng.ring, "decode_chunk": eng.decode_chunk,
            "lengths": eng.lengths.tolist(), **profiled(run, steps)}


# the kernels a profile line lists by device time
PROFILE_TOP = 12


def profiled(run, steps: int) -> dict:
    """torch.profiler over ``run`` (``steps`` decode steps) after one
    warm-up call: wall and device busy time a step, the device's idle share
    of the wall (one stream, so kernel times do not overlap), kernels a
    step, and the top kernels by device time."""
    run()  # warm-up
    torch.cuda.synchronize()
    # device activity only: the readings are the kernels' (the host's ops
    # would add tens of thousands of events a step and no reading)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = kern.setdefault(e.key[:80], [0.0, 0])
        k[0] += us
        k[1] += e.count
    busy_ms = sum(v[0] for v in kern.values()) / 1e3 / steps
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3 / steps),
            "kernels_per_step": sum(v[1] for v in kern.values()) / steps,
            "top": [{"name": k, "ms_per_step": v[0] / 1e3 / steps,
                     "calls_per_step": v[1] / steps} for k, v in top]}


def plain_linear(qp, x, act_bits: int):
    """The engine's W4 routing, through the plain versions only; 8-bit
    and float weights dequantized, then matmul (no act quant)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if qp.bits == 8:
        y = qlinear_plain(x2, qp)
    elif qp.layout == "s4":
        if act_bits == 8 and x2.shape[0] <= W.DECODE_M_MAX:
            xq, xs = W.quantize_act_per_token(x2)
            y = W.w4a8_matmul_bytes_plain(xq, xs, qp.codes, qp.scales,
                                          qp.zeros).to(x.dtype)
        else:
            y = qlinear_plain(x2, qp)
    elif act_bits == 8:
        xq, xs = W.quantize_act_per_token(x2)
        y = W.w4a8_matmul_prefill_plain(xq, xs, qp.codes, qp.scales,
                                        qp.zeros, out_dtype=x.dtype)
    else:
        y = W.w4a16_matmul_plain(x2, qp.codes, qp.scales, qp.zeros).to(
            x.dtype)
    return y.reshape(*lead, -1)


@contextlib.contextmanager
def plain_experts():
    """The engine's MoE MLP with each expert kernel's wrapper replaced by
    its plain version (the same route, the same arguments)."""
    swaps = [(QM, "w4a8_stacked_matmul"), (QM, "w4a8_grouped_matmul"),
             (QM, "w4a8_stacked_matmul_smallm"), (QM, "w8a8_grouped_matmul"),
             (EN, "w4a8_gathered_matmul")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(M, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def plain_prefill_logits(sw, prompts, T: int, dev):
    """Batched prefill forward of the serving weights with every linear
    through its plain version (a MoE block's experts through the engine's
    route with the plain versions, ``plain_experts``); last true token's
    logits (N, V)."""
    xl, tl = plain_hidden(sw, prompts, T, dev)
    N = len(prompts)
    return head_logits(sw, xl[torch.arange(N, device=dev), tl - 1][:, None]
                       )[:, 0]


def plain_hidden(sw, prompts, T: int, dev):
    """``plain_prefill_logits``'s forward up to the final norm: (hidden
    states (N, T, H), true lengths)."""
    arch, ab = sw.arch, sw.act_bits
    N = len(prompts)
    ids, tl = padded(prompts, T, dev)
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    x = sw.embed[ids]
    cos, sin = A.rope_cos_sin(arch, torch.arange(T, device=dev))
    neg = torch.finfo(torch.float32).min
    mask = A.causal_mask(T, T, device=dev)[None, None] + torch.where(
        torch.arange(T, device=dev)[None] < tl[:, None], 0.0,
        neg)[:, None, None, :]
    def proj(e, h, names):
        """The named linears of ``h``, from their merged entry if any."""
        merged = {2: "mlp.gateup", 3: "attn.qkv"}[len(names)]
        if merged not in e:
            return [plain_linear(e[n], h, ab) for n in names]
        sizes = [e[merged].codes.shape[0] // 2] * 2 if len(names) == 2 \
            else [nh * hd, nkv * hd, nkv * hd]
        return torch.split(plain_linear(e[merged], h, ab), sizes, dim=-1)

    for e in sw.blocks:
        h1 = A.apply_norm(x, e["ln1"], arch)
        q, k, v = proj(e, h1, ("attn.q", "attn.k", "attn.v"))
        q, k, v = (q.reshape(N, T, nh, hd), k.reshape(N, T, nkv, hd),
                   v.reshape(N, T, nkv, hd))
        q, k = A.qk_normed(arch, e, q.transpose(1, 2), k.transpose(1, 2))
        q, k = A.apply_rope(q, k, cos, sin)
        ctx = A.sdpa(q, k, v.transpose(1, 2), mask, kv_groups=nh // nkv)
        h = x + plain_linear(e["attn.o"],
                             ctx.transpose(1, 2).reshape(N, T, nh * hd), ab)
        h2 = A.apply_norm(h, e["ln2"], arch)
        if "mlp.router" in e:
            with plain_experts():
                x = h + EN._moe_mlp(sw, e, h2, ab)
            continue
        g, u = proj(e, h2, ("mlp.gate", "mlp.up"))
        x = h + plain_linear(e["mlp.down"], A._act(g, arch.act_fn) * u, ab)
    return A.rmsnorm(x, sw.norm["weight"], arch.rms_eps), tl


# decode_vs_plain's gates (``gate``), set from the first full run (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md): every step's argmax equal to the
# plain forward's was the ask, but on these random weights the plain
# top-2 margin fell to 0.0045 logits at one step of 16, below the 0.11 by
# which the kv16 route and the kv8 witness (served since the first slice)
# both differ from it through the W4A8 act quant, and both flipped there.
# "exact" (kv16: no KV quantization): corr >= 0.999 at every step and a
# step's argmax differs only where the kv8 witness's differs too; "share"
# (kv4 and xla8 on Llama): the argmax equal at DECODE_ARGMAX_MIN of the
# steps; "corr" (Mixtral at kv4: routing flips turn KV noise into whole
# expert changes; its kv8 witness agreed at 15 of 16 steps, kv4 at 13,
# each disagreement at a margin under the step's largest difference):
# corr >= MOE_CORR_MIN at every step, the argmax shares reported beside
# the kv8 witness's; "corr999" (the W8A8 and e4m3 builds against the plain
# forward over their dequantized weights): corr >= 0.999 at every step,
# the argmax share reported
DECODE_ARGMAX_MIN = 0.9
MOE_CORR_MIN = 0.99


def forced_logits(sw, prompt, cont, dev, **kw):
    """Prefill ``prompt`` and teacher-force ``cont[:-1]`` through one slot
    of the engine built from ``kw``: (logits (len(cont), V), engine)."""
    eng = engine(sw, dev, **{**kw, "max_slots": 1})
    T = eng._bucket(len(prompt))
    ids, tl = padded([prompt], T, dev)
    with torch.no_grad():
        got = [eng._prefill_batch(ids, torch.zeros(1, dtype=torch.long,
                                                   device=dev), tl, T)[0]]
        got += [r[0] for r in forced_steps(
            eng, np.asarray(cont[:-1])[:, None], dev)]
    return torch.stack(got).float(), eng


def against_plain(got, ref) -> dict:
    """Each step's corr with the plain logits, the share of equal argmaxes
    and, where they differ, the plain top-2 margin and the step's largest
    logit difference."""
    corr = [float(torch.corrcoef(torch.stack([a, b]))[0, 1])
            for a, b in zip(got, ref)]
    equal = got.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    return {"min_corr": min(corr), "corr": corr,
            "argmax_equal_share": equal.float().mean().item(),
            "argmax_differs": [
                {"step": i, "plain_margin": float(top2[i, 0] - top2[i, 1]),
                 "max_abs_diff": float((got[i] - ref[i]).abs().max())}
                for i in torch.nonzero(~equal).flatten().tolist()],
            "finite": bool(torch.isfinite(got).all())}


def decode_vs_plain(name: str, sw, prompt, cont, dev, gate: str,
                    **kw) -> dict:
    """Teacher-forced decode logits of one engine route (1 slot) over
    ``prompt`` and its generated continuation ``cont`` against the plain
    forward of the same serving weights over the whole sequence
    (``plain_hidden``), position by position, beside the same for the
    kv8 ``xla`` route (the witness, served since the first slice) where
    the gate reads it or reports beside it; gated by ``gate`` (see
    above)."""
    t0 = time.time()
    got, eng = forced_logits(sw, prompt, cont, dev, **kw)
    wkw = {k: v for k, v in kw.items()
           if k not in ("kv_bits", "attn_impl", "decode_chunk")}
    # the kv8 witness: what the "exact" gate reads, and beside the "corr"
    # gate's shares
    wits = {"witness_kv8": forced_logits(sw, prompt, cont, dev, kv_bits=8,
                                         **wkw)[0]} \
        if gate in ("exact", "corr") else {}
    seq = list(prompt) + list(cont[:-1])
    with torch.no_grad():
        xl, _ = plain_hidden(sw, [seq], len(seq), dev)
        ref = head_logits(sw, xl[:, len(prompt) - 1:])[0].float()
    res = {"phase": "decode_vs_plain", "route": name, **kw,
           "attn_impl": eng.attn_impl, "ring": eng.ring,
           "cache_bits": eng.cache.bits, "layout": eng.cache.layout,
           "prompt_tokens": len(prompt), "steps": len(cont) - 1,
           "gate": gate, **against_plain(got, ref),
           **{k: against_plain(w, ref) for k, w in wits.items()},
           "seconds": time.time() - t0}
    emit(res)
    if gate == "exact":
        ok = res["min_corr"] >= 0.999 and {
            d["step"] for d in res["argmax_differs"]} <= {
            d["step"] for d in res["witness_kv8"]["argmax_differs"]}
    elif gate == "share":
        ok = res["argmax_equal_share"] >= DECODE_ARGMAX_MIN
    elif gate == "corr999":
        ok = res["min_corr"] >= 0.999
    else:
        ok = res["min_corr"] >= MOE_CORR_MIN
    if not (ok and res["finite"]):
        raise AssertionError(f"decode vs plain ({name}): {res}")
    return res


def engine_prefill_logits(sw, prompts, T: int, dev, **kw):
    eng = engine(sw, dev, max_slots=len(prompts), prefill_buckets=(T,),
                 **kw)
    ids, tl = padded(prompts, T, dev)
    return eng._prefill_batch(ids, torch.arange(len(prompts), device=dev),
                              tl, T)


SMALL = ArchSpec(family="llama", vocab_size=256, hidden_size=1024,
                 intermediate_size=2048, num_layers=2, num_heads=8,
                 num_kv_heads=2, head_dim=128, rope_theta=500000.0,
                 rms_eps=1e-5)


# the engine routes of small_vs_cpu: kv8 (plain xla attention), kv4 at
# buffers 4096 (#20) and 8192 (#21), kv8 with attn_impl="pallas" (#17),
# "bd" (#18) and "bds" (#19 at buffer 4096), the ring of a chunked kv8
# engine (xla8r, the teacher-forced steps in one ring chunk of 4), the kv4
# hhd cache on the generic path (xla) and on its ring (xla4r, one chunk of
# 4), kv16 (the generic path) and the xla8 concat variant
SMALL_ROUTES = {
    "kv8": dict(max_len=256),
    "kv4_4096": dict(kv_bits="auto", max_len=4096),
    "kv4_8192": dict(kv_bits=4, max_len=8192),
    "pallas": dict(max_len=256, attn_impl="pallas"),
    "bd": dict(max_len=256, attn_impl="bd"),
    "bds": dict(kv_bits=8, max_len=4096, attn_impl="bds"),
    "ring": dict(max_len=256, decode_chunk=4),
    "kv4_xla": dict(kv_bits=4, max_len=256, attn_impl="xla"),
    "kv4_ring": dict(kv_bits=4, max_len=256, decode_chunk=4),
    "kv16": dict(kv_bits=16, max_len=256),
    "xla8": dict(max_len=256, attn_impl="xla8"),
}
# the routes the card runs from the CPU's cache (and ring) at each decode
# step: the kv4 hhd cache on the generic path and on the xla4r ring, kv16,
# xla8 and a MoE model's kv4 generic path (PR 21's routes)
SMALL_SYNCED = ("kv4_xla", "kv4_ring", "kv16", "xla8", "moe_kv4")


def cache_tensors(cache) -> list:
    """The cache's codes and scales on the CPU (a bf16 cache has no
    scales: None)."""
    return [None if t is None else t.cpu()
            for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]


def forced_steps(eng: LLMEngine, forced, d, feed=None, record=None) -> list:
    """Teacher-forced decode steps of ``eng`` (every slot active), the
    rows of ``forced`` (steps, slots) fed one a step (a ring engine's
    steps in ring chunks of its ``decode_chunk``, each flushed after its
    last step): the logits of each step.  With ``feed`` (another run's
    ``record``) the engine is handed that run's cache, and ring, before
    each step; ``record`` (a list) receives this run's before each step."""
    active = torch.ones(eng.max_slots, dtype=torch.bool, device=d)
    W = eng.decode_chunk
    ring, out = None, []
    for i, t in enumerate(forced):
        if eng.ring and i % W == 0:
            ring = eng.ring_step(W)
        if ring is not None:
            ring.pos = i % W
        state = [eng.cache.k, eng.cache.v, eng.cache.k_scale,
                 eng.cache.v_scale] + (
            [ring.ring.kv, ring.ring.s] if ring is not None else [])
        if feed is not None:
            for a, b in zip(state, feed[i]):
                if a is not None:
                    a.copy_(b)
        if record is not None:
            record.append([None if a is None else a.cpu() for a in state])
        out.append(eng._decode_step(torch.from_numpy(np.asarray(t)).to(d),
                                    active, ring))
        if ring is not None and (i % W == W - 1 or i == len(forced) - 1):
            flush_ring_to_cache(eng.cache, ring.ring, ring.lengths0)
    return out


def small_route(sw, prompts, forced, d, kw, feed=None, record=None):
    """Prefill and teacher-forced decode of one route on device ``d``
    (``forced_steps``): (stacked logits on the CPU, the engine, the
    prefill cache on the CPU)."""
    eng = engine(sw, d, max_slots=len(prompts), **kw)
    ids, tl = padded(prompts, 128, d)
    out = [eng._prefill_batch(ids, torch.arange(len(prompts), device=d),
                              tl, 128)]
    cache = cache_tensors(eng.cache)
    out += forced_steps(eng, forced, d, feed, record)
    return torch.stack(out).float().cpu(), eng, cache


def writers_match(dev, eng: LLMEngine) -> bool:
    """The cache writers of ``eng``'s cache layout and bits on the card and
    on the CPU, fed the same K/V (a prefill of 100 tokens into each slot,
    then one decode token per slot, one of them at the buffer's end; on
    the ring a 4-column ring, its entries as wide as the cache's, flushed
    at the same lengths), write the same bytes."""
    S, H, T, D = (eng.max_slots, eng.arch.num_kv_heads, eng.buf_len,
                  eng.arch.head_dim)
    bits, layout = eng.cache.bits, eng.cache.layout
    R = eng.cache.k.shape[-1] if layout == "hhd" else D
    g = torch.Generator().manual_seed(SEED)
    k, v = (torch.randn((S, H, 100, D), generator=g).to(torch.bfloat16)
            for _ in range(2))
    kn, vn = (torch.randn((S, H, 1, D), generator=g) for _ in range(2))
    ring = Ring(torch.randint(-127, 128, (1, S, 2 * H, 4, R), generator=g,
                              dtype=torch.int8),
                torch.rand((1, S, 2 * H, 4), generator=g).to(torch.bfloat16))
    lengths = torch.full((S,), 100)
    lengths[-1] = T
    out = []
    for d in ("cpu", dev):
        c = KVCache.create(1, S, H, T, D, bits=bits, layout=layout,
                           device=d)
        append_slots(c, 0, torch.arange(S, device=d), k.to(d), v.to(d))
        if layout == "hhd":
            append_kv(c, 0, kn.to(d).to(torch.bfloat16),
                      vn.to(d).to(torch.bfloat16), lengths.to(d))
        else:
            q = quantize_kv4 if layout == "bd4" else quantize_kv
            append_kv_bd(c, 0, *q(kn.to(d)), *q(vn.to(d)), lengths.to(d))
        if eng.ring:
            flush_ring_to_cache(c, Ring(ring.kv.to(d), ring.s.to(d)),
                                lengths.to(d) + 1)
        out.append(cache_tensors(c))
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(*out))


LINEAR_FIELDS = ("codes", "scales", "zeros")


def same_tensor(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    b = b.to(a.device)
    if a.dtype != b.dtype:
        return False
    if a.element_size() == 1 and a.is_floating_point():  # e4m3, e5m2
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def same_codes(sws) -> bool:
    """The card's serving weights equal the CPU's bit for bit: every
    linear's codes, scales and zero corrections (stacked experts too), the
    ln and router weights, the head."""
    a, b = sws.values()
    return torch.equal(a.lm_head, b.lm_head.cpu()) and all(
        set(ea) == set(eb) and all(
            same_tensor(ea[n]["weight"], eb[n]["weight"])
            if isinstance(ea[n], dict) else
            all(same_tensor(getattr(ea[n], f), getattr(eb[n], f))
                for f in LINEAR_FIELDS)
            for n in ea)
        for ea, eb in zip(a.blocks, b.blocks))


@contextlib.contextmanager
def recorded_routing(out: list):
    """Appends the (n, top_k) experts of every ``moe_route`` call to
    ``out``, on the CPU."""
    route = A.moe_route

    def rec(*args, **kw):
        topi, topw = route(*args, **kw)
        out.append(topi.cpu())
        return topi, topw
    A.moe_route = rec
    try:
        yield
    finally:
        A.moe_route = route


def compare_routes(sws, prompts, forced, dev, routes_kw: dict,
                   share_max: float = 0.1) -> tuple:
    """Each route of ``routes_kw`` (name -> engine options) on the card
    against the CPU: (per route results, all gates met, the largest cache
    share under ``share_max``).  For a MoE model also the share of routing
    selections (token, k) that agree between the two."""
    routes, ok = {}, True
    for name, kw in routes_kw.items():
        topis = {}
        runs = []
        # routes in SMALL_SYNCED: the card is handed the CPU's cache (and
        # ring) before each decode step
        rec = [] if name in SMALL_SYNCED else None
        for d in ("cpu", dev):
            io = dict(record=rec) if d == "cpu" else dict(feed=rec)
            with recorded_routing(topis.setdefault(d, [])):
                runs.append(small_route(sws[d], prompts, forced, d, kw,
                                        **io))
        (la, _, ca), (lb, eng, cb) = runs
        a, b = la.flatten(0, 1), lb.flatten(0, 1)
        corr = min(float(torch.corrcoef(torch.stack([x, y]))[0, 1])
                   for x, y in zip(a, b))
        # per layer, per tensor (k, v, k_scale, v_scale): differing
        # entries over entries either cache wrote
        share = [[float((x[li] != y[li]).sum()
                        / ((x[li] != 0) | (y[li] != 0)).sum())
                  for x, y in zip(ca, cb) if x is not None]
                 for li in range(ca[0].shape[0])]
        routes[name] = {"attn_impl": eng.attn_impl, "ring": eng.ring,
                        "cache_bits": eng.cache.bits,
                        "layout": eng.cache.layout, "body": eng.body,
                        "synced": name in SMALL_SYNCED,
                        "buf_len": eng.buf_len,
                        "min_corr": corr, "cache_diff_share": share,
                        "writers_match": writers_match(dev, eng),
                        "finite": bool(torch.isfinite(b).all())}
        if topis["cpu"]:
            same = sum(int((x == y).sum()) for x, y in zip(*topis.values()))
            total = sum(x.numel() for x in topis["cpu"])
            routes[name]["routing_agree_share"] = same / total
            routes[name]["routing_calls"] = len(topis["cpu"])
        ok = ok and corr >= 0.999 and routes[name]["finite"] \
            and routes[name]["writers_match"] \
            and max(max(r) for r in share) < share_max
    return routes, ok


S4_FUSED = dict(layout="s4", fused_rms=True, fuse_qkv=True)
# the fused builds (from a model whose gammas are 1 + 0.1 N(0, 1)): the
# routes small_vs_cpu runs each through, its prompts and the limit of its
# cache shares.  fused_s4 at 2 prompts prefills 256 rows through kernel
# #12; fused_s4_512 at 4 prompts prefills 512 rows through the bf16
# dequant-then-matmul (the route of engine_fused_s4's prefill), where no
# int8 act quant snaps the card's and the CPU's last-bit differences back
# to equal codes and layer 1's caches differed in 14-21% of their entries
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md); its limit is 0.3 (a
# scrambled layout would differ in nearly all)
SMALL_FUSED = {
    "fused_planes": (dict(fused_rms=True, fuse_qkv=True), ("kv8",), 4, 0.1),
    "fused_s4": (S4_FUSED, ("kv8", "kv4_4096"), 2, 0.1),
    "fused_s4_512": (S4_FUSED, ("kv8",), 4, 0.3),
}


def bf16_ulps(out, ref) -> dict:
    """How far ``out`` lies from ``ref`` in bf16 ulps (an ulp at |t| in
    [2^(e-1), 2^e) is 2^(e-8)): the largest distance at the entries' own
    magnitude (the larger of the two; an output that cancels to near 0
    counts many of its small ulps), the largest distance in ulps of the
    tensor's largest |ref|, and the share of entries that differ at all;
    for int8 codes the largest code step and the share."""
    a, b = out.cpu(), ref.cpu()
    share = float((a != b).float().mean())
    if not a.is_floating_point():
        return {"max_code_step": int((a.int() - b.int()).abs().max()),
                "share_diff": share}
    a, b = a.float(), b.float()

    def ulp(t):
        e = torch.frexp(t.clamp_min(2.0 ** -126))[1]
        return torch.ldexp(torch.ones_like(t), e - 8)

    d = (a - b).abs()
    return {"max_ulps": float((d / ulp(torch.maximum(a.abs(),
                                                     b.abs()))).max()),
            "max_ulps_of_max": float(d.max() / ulp(b.abs().max())),
            "share_diff": share}


def layer_ops(sw, li, x, mask, cos, sin, feed=None) -> dict:
    """Layer ``li`` of a prefill through the engine's ops on ``sw``'s
    device, op by op: {op: (inputs, outputs)} on the CPU.  With ``feed``
    (another run's record) every op takes that run's inputs instead of its
    own chain's, so each op sees identical inputs on both devices."""
    arch, e = sw.arch, sw.blocks[li]
    nh, nkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    N, T, _ = x.shape
    d = x.device
    rec = {}

    def op(name, fn, *args):
        if feed is not None:
            args = tuple(a.to(d) for a in feed[name][0])
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        rec[name] = (tuple(a.cpu() for a in args),
                     tuple(o.cpu() for o in outs))
        return out

    def lin(name):
        return lambda h: QM.apply_qlinear(e[name], h, act_bits=sw.act_bits)

    h1 = op("rmsnorm_ln1", lambda t: A.apply_norm(t, e["ln1"], arch), x)
    q, k, v = torch.split(op("qkv", lin("attn.qkv"), h1),
                          EN._qkv_sizes(arch), dim=-1)
    q = q.reshape(N, T, nh, hd).transpose(1, 2)
    k = k.reshape(N, T, nkv, hd).transpose(1, 2)
    v = v.reshape(N, T, nkv, hd).transpose(1, 2)
    q, k = op("rope", lambda a, b: A.apply_rope(a, b, cos, sin), q, k)
    op("kv_quant", lambda a, b: (*quantize_kv(a), *quantize_kv(b)), k, v)
    ctx = op("sdpa", lambda a, b, c: A.sdpa(a, b, c, mask,
                                            kv_groups=nh // nkv), q, k, v)
    h = x + op("attn_o", lin("attn.o"),
               ctx.transpose(1, 2).reshape(N, T, nh * hd))
    gu = op("gateup", lin("mlp.gateup"),
            op("rmsnorm_ln2", lambda t: A.apply_norm(t, e["ln2"], arch), h))
    g, u = torch.split(gu, gu.shape[-1] // 2, dim=-1)
    mid = op("act", lambda t: A._act(t, arch.act_fn), g) * u
    op("output", lambda a, b: a + b, h, op("down", lin("mlp.down"), mid))
    return rec


def c1_readings(sws, prompts, dev) -> dict:
    """ROADMAP C1: layers 0 and 1 of the 512-row fused s4 prefill, card
    against CPU, each op on identical bf16 inputs (``same_inputs``: the
    CPU chain's inputs handed to the card) and along each device's own
    chain from the same embeddings (``chain``)."""
    T = 128
    ids, tl = padded(prompts, T, "cpu")
    sw = sws["cpu"]
    cos, sin = A.rope_cos_sin(sw.arch, torch.arange(T))
    mask = A.causal_mask(T, T)[None, None] + torch.where(
        torch.arange(T)[None] < tl[:, None], 0.0,
        torch.finfo(torch.float32).min)[:, None, None, :]
    x_ref = x_own = sw.embed[ids]
    on = [t.to(dev) for t in (mask, cos, sin)]
    layers = []
    for li in range(2):
        ref = layer_ops(sw, li, x_ref, mask, cos, sin)
        fed = layer_ops(sws[dev], li, x_ref.to(dev), *on, feed=ref)
        own = layer_ops(sws[dev], li, x_own.to(dev), *on)
        layers.append({name: {
            "same_inputs": [bf16_ulps(a, b) for a, b in zip(fed[name][1], r)],
            "chain": [bf16_ulps(a, b) for a, b in zip(own[name][1], r)]}
            for name, (_, r) in ref.items()})
        x_ref, x_own = ref["output"][1][0], own["output"][1][0]
    return {"phase": "small_vs_cpu_c1", "build": "fused_s4",
            "prefill_rows": len(prompts) * T, "layers": layers}


def phase_small_vs_cpu(dev, steps: int = 3) -> dict:
    """A small Llama at W4A8 through each engine route on the card and on
    the CPU: the same weight and head codes; cache writers that turn the
    same K/V into the same bytes; then the prefill logits and ``steps``
    teacher-forced decode steps with corr >= 0.999 for every row.  Then
    the same for the fused builds of the model with non-unit gammas
    (decode through #14 and #13 on the card, their plain versions on the
    CPU), and the 512-row fused s4 case once more with cuBLAS's bf16
    matmuls kept from reduced-precision reductions (reported, not gated).

    The engines' own prefill caches differ in a few codes: RMSNorm and
    the prefill attention sum in other orders on the card, and the int8
    act quant and the KV quant turn a last-bit difference into a code
    step now and then.  Each layer's share of differing cache entries is
    reported and held under 10% (a wrong layout would scramble nearly
    all of them), or under the case's limit in SMALL_FUSED."""
    t0 = time.time()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)
    model = Llama(SMALL, init_params(gen, SMALL))
    prompts = make_prompts(4, SMALL.vocab_size)
    forced = np.random.RandomState(SEED + 1).randint(
        0, SMALL.vocab_size, (steps, len(prompts)))
    sws = {d: build_serving_weights(model, WSPEC, act_bits=8, device=d)
           for d in ("cpu", dev)}
    res = {"phase": "small_vs_cpu", "same_codes": same_codes(sws)}
    res["routes"], ok = compare_routes(sws, prompts, forced, dev,
                                       SMALL_ROUTES)
    ok = ok and res["same_codes"]
    w8, w8_ok = small_w8_vs_cpu(dev, model, prompts, forced)
    res.update(w8)
    ok = ok and w8_ok
    set_gammas(model, SEED + 2)
    for bname, (bkw, names, n, share_max) in SMALL_FUSED.items():
        sws = {d: build_serving_weights(model, WSPEC, act_bits=8, device=d,
                                        **bkw) for d in ("cpu", dev)}
        routes, b_ok = compare_routes(
            sws, prompts[:n], forced[:, :n], dev,
            {r: SMALL_ROUTES[r] for r in names}, share_max)
        res[bname] = {"same_codes": same_codes(sws), "share_max": share_max,
                      "routes": routes}
        ok = ok and b_ok and res[bname]["same_codes"]
    emit(c1_readings(sws, prompts, dev))
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        routes, _ = compare_routes(sws, prompts, forced, dev,
                                   {"kv8": SMALL_ROUTES["kv8"]}, 1.0)
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced
    res["fused_s4_512"]["no_reduced_precision_reduction"] = routes["kv8"]
    res["moe"], moe_ok = small_moe_vs_cpu(dev, prompts, forced)
    res["qwen3moe"], q_ok = small_moe_vs_cpu(
        dev, prompts, forced, SMALL_QWEN3MOE, SMALL_QWEN3MOE_ROUTES,
        SEED + 8)
    ok = ok and moe_ok and q_ok
    res["seconds"] = time.time() - t0
    if not ok:
        raise AssertionError(f"small model, card vs CPU: {res}")
    return res


# a 2-layer Mixtral-shaped model (hidden 1024, expert width 1024, 8 experts,
# top-2) and its expert routes: gathered (#8 at the 2-slot decode, #6 at
# the 256-row prefill), dense (#6 throughout), grouped (#9 throughout), and
# the gathered route on the kv4 hhd cache's generic path (kv_bits="auto" at
# max_len 4096, handed the CPU's cache before each decode step)
SMALL_MOE = dataclasses.replace(
    SMALL, intermediate_size=1024, rope_theta=1e6,
    moe=MoESpec(num_experts=8, top_k=2, moe_intermediate_size=1024))
SMALL_MOE_ROUTES = {
    "gathered": dict(max_len=256),
    "dense": dict(max_len=256, moe_gather_max=0, moe_grouped=False),
    "grouped": dict(max_len=256, moe_gather_max=0, moe_grouped=True),
    "moe_kv4": dict(kv_bits="auto", max_len=4096),
}


# gates of small_moe_vs_cpu set from its first readings (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md): each layer's cache share 0.0234-0.0239 on every
# route, as the dense model's (held under 0.1 like them), and 0.9962 of the
# routing selections equal (4 of 1048 differ: near-tied experts that the
# card's and the CPU's last bits order differently)
MOE_ROUTING_AGREE_MIN = 0.98


# a 2-layer Qwen3-MoE-shaped model (hidden 1024, 16 heads of 128: q wider
# than hidden; 8 experts of width 384, top-2: gate/up in stacked planes,
# the down int8 per channel; qk_norm) and its expert routes: grouped (#9
# and #10 throughout; "interpret" has the CPU run the act quant and #10's
# plain version, as the card runs #10) and smallm (#6 at the 256-row
# prefill, #7 at the 2-slot decode).  Its gates are the Mixtral-shaped
# model's, set before its first run: routing agreement >= 0.98, each
# layer's cache share under 0.1.
SMALL_QWEN3MOE = dataclasses.replace(
    SMALL, num_heads=16, rope_theta=1e6, rms_eps=1e-6, qk_norm=True,
    moe=MoESpec(num_experts=8, top_k=2, moe_intermediate_size=384))
SMALL_QWEN3MOE_ROUTES = {
    "grouped": dict(max_len=256, moe_gather_max=0, moe_grouped="interpret"),
    "smallm": dict(max_len=256, moe_gather_max=0, moe_smallm=8),
}


def small_moe_vs_cpu(dev, prompts, forced, arch=SMALL_MOE,
                     routes_kw=SMALL_MOE_ROUTES, seed=SEED + 5) -> tuple:
    """A small MoE model (router sharpened x8, as the CPU tests do; with
    ``qk_norm`` its ln and q/k norm gammas 1 + 0.1 N(0, 1)) at W4A8
    through each expert route on the card against the CPU, 2 prompts:
    the same weight codes bit for bit, logits corr >= 0.999 over prefill
    and the teacher-forced decode steps, each layer's cache share under
    0.1 and a share of equal routing selections (token, k) of at least
    MOE_ROUTING_AGREE_MIN."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = init_params(gen, arch)
    for bp in params["blocks"]:
        bp["mlp"]["router"]["weight"] = bp["mlp"]["router"]["weight"] * 8
        if arch.qk_norm:
            for node in (bp["ln1"], bp["ln2"], bp["attn"]["q_norm"],
                         bp["attn"]["k_norm"]):
                w = node["weight"]
                node["weight"] = (1 + 0.1 * torch.randn(
                    w.shape, generator=gen)).to(w.dtype)
    model = (Qwen3Moe if arch.qk_norm else Llama)(arch, params)
    sws = {d: build_serving_weights(model, WSPEC, act_bits=8, device=d)
           for d in ("cpu", dev)}
    routes, ok = compare_routes(sws, prompts[:2], forced[:, :2], dev,
                                routes_kw)
    ok = ok and all(r["routing_agree_share"] >= MOE_ROUTING_AGREE_MIN
                    for r in routes.values())
    res = {"same_codes": same_codes(sws), "routes": routes}
    return res, ok and res["same_codes"]


def summarize(rows, attn_rows, fused_rows, moe_rows, bench_rows,
              launches) -> list:
    """One entry per kernel: for a W4 kernel, times summed over one
    block's seven linears at the kernel's main-path M (8 for decode, 1024
    for prefill; #12 at 8, the M of 15 of every 16 of its ``engine_s4``
    launches), or for #13 and #14 over the fused build's four decode
    linears at M = 8; for a MoE kernel over one Mixtral-8x7B layer's three
    expert linears at its main-path case (#6 B = 8 on the body
    ``stacked_body`` picks, with the same at B = 256 under ``B256``; #8 n =
    4 tokens, #9 the 1024-token prefill), or of one Qwen3-30B-A3B layer's
    (#7 gate and up at B = 8, #10 the down of the 1024-token prefill); for an
    attention kernel, one call at the
    buffer of its engine phase (#20 4096, #21 8192, #17 512, #18 512, #19
    4096); for a bench kernel (#5, #15, #16, #22), one call at the bench's
    shapes (``phase_bench_kernels``)."""
    main_m = {"w4a16_matmul": 8, "w4a8_matmul_decode": 8,
              "w4a8_matmul_prefill": 1024, "w4a8_matmul_bytes": S4_M[0],
              "w4a8_linear_bytes_fused": FUSED_M,
              "w4a8_linear_planes_fused": FUSED_M,
              "w4a8_stacked_matmul": "B8", "w4a8_gathered_matmul": "n4",
              "w4a8_grouped_matmul": "all_live",
              "w4a8_stacked_matmul_smallm": "qwen3_B8",
              "w8a8_grouped_matmul": "qwen3_prefill"}
    rows = rows + fused_rows + [dict(r, M=r["case"]) for r in moe_rows]
    main_s = {"decode_attention_bd4": 4096,
              "decode_attention_bd4_flash": 8192, "decode_attention_i8": 512,
              "decode_attention_bd": 512, "decode_attention_bd_flash": 4096}
    out = []
    for kname, info in KERNEL_INFO.items():
        if kname in SUMMED_KERNELS:
            rows = rows + [dict(r, M="main") for r in bench_rows
                           if r["kernel"] == kname and r["main"]]
            main_m[kname] = "main"
        if kname in BENCH_KERNELS:
            r = next(r for r in bench_rows if r["kernel"] == kname)
            out.append(dict(
                name=kname, route="cuda", **info, launches=launches[kname],
                max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"]))
            continue
        if kname in main_s:
            r = next(r for r in attn_rows if r["kernel"] == kname
                     and r["S"] == main_s[kname] and r["case"] == "ragged")
            out.append(dict(
                name=kname, route="cuda", **info, launches=launches[kname],
                max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"]))
            continue
        # #1's main rows: the bf16 store, as the engine runs it; #6's: the
        # body its wrapper routes B to
        def summed(case):
            rs = [r for r in rows if r["kernel"] == kname
                  and r["M"] == case and r.get("store") != "f32"
                  and r.get("routed", True)]
            by_ops = sum(r["bound_by"] == "operations" for r in rs)
            return dict(
                max_abs_err=max(r["max_abs_err"] for r in rs),
                ms=sum(r["kernel_ms"] for r in rs),
                plain_ms=sum(r["plain_ms"] for r in rs),
                bound_ms=sum(r["bound_ms"] for r in rs),
                bound_by="operations" if by_ops * 2 > len(rs) else "bytes",
                library_ms=sum(r["library_ms"] for r in rs))

        entry = dict(name=kname, route="cuda", **info,
                     launches=launches[kname], **summed(main_m[kname]))
        if kname == "w4a8_stacked_matmul":
            entry["B256"] = summed("B256")
        out.append(entry)
    return out


def engine_vs_plain(name: str, sw, prompts, dev, **kw) -> None:
    """The engine's prefill logits (first prompt) against the plain
    forward of the same serving weights: corr >= 0.999, same argmax."""
    t0 = time.time()
    with torch.no_grad():
        eng_l = engine_prefill_logits(sw, prompts, 128, dev, **kw)[0].float()
        ref_l = plain_prefill_logits(sw, prompts, 128, dev)[0].float()
    corr = float(torch.corrcoef(torch.stack([eng_l, ref_l]))[0, 1])
    same = int(eng_l.argmax()) == int(ref_l.argmax())
    emit({"phase": "engine_vs_plain", "build": name, **kw,
          "prefill_rows": len(prompts) * 128, "corr": corr,
          "argmax_equal": same, "finite": bool(torch.isfinite(eng_l).all()),
          "seconds": time.time() - t0})
    if not (corr >= 0.999 and same and torch.isfinite(eng_l).all()):
        raise AssertionError(f"engine vs plain ({name}): corr {corr}, "
                             f"argmax {same}")


class LazyBlocks:
    """The blocks of a random model, each made from its own seed when it
    is read (the last one kept), so that a model too large for the card
    in bf16 (Mixtral-8x7B: 93.4 GB; Qwen3-30B-A3B: 61 GB) is made and
    quantized one block at a time.  A ``qk_norm`` model's q/k norm gammas
    are 1 + 0.1 N(0, 1) (init_block_params sets ones, which would test
    nothing)."""

    def __init__(self, arch: ArchSpec, dev, seed: int):
        self.arch, self.dev, self.seed = arch, dev, seed
        self.idx, self.block = -1, None

    def __len__(self) -> int:
        return self.arch.num_layers

    def __getitem__(self, i: int):
        if i != self.idx:
            self.block = None
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(self.seed + 1 + i)
            bp = A.init_block_params(gen, self.arch)
            if self.arch.qk_norm:
                for name in ("q_norm", "k_norm"):
                    bp["attn"][name]["weight"] = (1 + 0.1 * torch.randn(
                        self.arch.head_dim, generator=gen,
                        device=self.dev)).to(self.arch.dtype)
            self.block, self.idx = bp, i
        return self.block


def serving_bytes(sw) -> int:
    """Bytes of every tensor of the serving weights."""
    def size(v):
        if v is None:
            return 0
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
        if isinstance(v, dict):
            return sum(size(t) for t in v.values())
        return sum(size(getattr(v, f)) for f in ("codes", "scales", "zeros",
                                                  "bias")
                   if getattr(v, f) is not None)
    return (size(sw.embed) + size(sw.norm) + size(sw.lm_head)
            + size(sw.lm_head_scale) + sum(size(e) for e in sw.blocks))


def phase_setup_moe(dev, arch: ArchSpec = MIXTRAL_8X7B,
                    model: str = "Mixtral-8x7B", seed: int = SEED + 6,
                    phase: str = "setup_moe") -> tuple:
    """A MoE model from the seed at full width and depth, RTN W4 g128
    (asymmetric; Mixtral's expert linears all take the stacked planes
    layout, Qwen3-30B-A3B's down the int8 fallback), int8 head, act_bits
    8, made and quantized one block at a time."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    V, H, dt = arch.vocab_size, arch.hidden_size, arch.dtype
    params = {"embed": {"weight": A._normal(gen, (V, H), 0.02, dt)},
              "blocks": LazyBlocks(arch, dev, seed),
              "norm": {"weight": torch.ones(H, dtype=dt, device=dev)},
              "lm_head": {"weight": A._normal(gen, (V, H), 0.02, dt)}}
    adapter = Qwen3Moe if arch.qk_norm else Llama
    sw = build_serving_weights(adapter(arch, params), WSPEC, act_bits=8,
                               device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    layouts = sorted({(n, e.layout, e.bits) for b in sw.blocks
                      for n, e in b.items() if hasattr(e, "layout")})
    return sw, {"phase": phase, "model": model,
                "layers": arch.num_layers, "serving_gb":
                serving_bytes(sw) / 1e9, "allocated_before_gb": before / 1e9,
                "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
                "layouts": layouts, "seconds": time.time() - t0}


# meta-llama/Meta-Llama-3-8B config.json
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 128256}
# the CI config's tiny Llama (tests/helpers.py make_tiny_hf_llama)
TINY_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 512, "model_type": "llama",
    "num_attention_heads": 4, "num_hidden_layers": 2,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "vocab_size": 256}
# checkpoints written here (``build/`` is not committed)
CALIB_DIR = Path(__file__).resolve().parent / "build" / "calib"
# the transformed model's PPL against the pretrained one: AWQ's transform
# is exact in real arithmetic, bf16 rounds the scaled weights
TOL_TRANSFORMED = 1e-2
# the tiny f32 calibration, card against CPU: summation order
TOL_SMALL_PPL = 1e-3


# calib_awq's calibration samples of 512 tokens: 16, cut from 32 for time
# (the AWQ search took 136-150 s of the run over 32; PERF.md lists the cut)
AWQ_SAMPLES = 16


def calib_config(path: str, method: str = "Awq", n_samples: int = 32,
                 seq_len: int = 512, n_tokens: int = 8192, bs: int = 4,
                 vocab: int = 128256, group: int = 128,
                 dtype: str = "bfloat16",
                 eval_pos=("pretrain", "transformed", "fake_quant"),
                 token_consist: bool = True) -> DotDict:
    """The pipeline's config as a dict (the card has no PyYAML): W4
    asymmetric per-group AWQ (v2 transform, the v1 clip, asymmetric) or
    RTN, synthetic calibration and eval data."""
    quant = {"method": method,
             "weight": {"bit": 4, "symmetric": False,
                        "granularity": "per_group", "group_size": group}}
    if method == "Awq":
        quant["special"] = {"trans": True, "trans_version": "v2",
                            "weight_clip": True, "clip_sym": False}
    return DotDict({
        "base": {"seed": 42},
        "model": {"type": "Llama", "path": path, "torch_dtype": dtype},
        "calib": {"name": "synthetic", "n_samples": n_samples, "bs": -1,
                  "seq_len": seq_len, "preproc": "synthetic_random",
                  "seed": 42, "vocab_size": vocab},
        "eval": {"eval_pos": list(eval_pos), "name": "synthetic",
                 "seq_len": seq_len, "bs": bs, "n_tokens": n_tokens,
                 "eval_token_consist": token_consist},
        "quant": quant})


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_calib_setup(dev, cfg: dict = LLAMA3_8B_CONFIG,
                      name: str = "llama3_8b") -> str:
    """A random bf16 model at ``cfg``'s widths and depth from the seed,
    written as a safetensors checkpoint by the port's ``save_params`` and
    read back by its loader onto the card: write and load seconds, bytes,
    and the read-back weights equal to the written ones."""
    t0 = time.time()
    arch = arch_from_hf_config(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = Llama(arch, init_params(gen, arch), config=cfg)
    sums = {k: float(t.float().sum()) for k, t in (
        ("embed", model.params["embed"]["weight"]),
        ("down_last", model.params["blocks"][-1]["mlp"]["down"]["weight"]))}
    torch.cuda.synchronize()
    make_s = time.time() - t0
    path = CALIB_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    t1 = time.time()
    nbytes = save_params(model, str(path), hf_config=cfg)
    write_s = time.time() - t1
    del model
    free_cuda()
    t1 = time.time()
    back = load_model(str(path), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t1
    got = {k: float(t.float().sum()) for k, t in (
        ("embed", back.params["embed"]["weight"]),
        ("down_last", back.params["blocks"][-1]["mlp"]["down"]["weight"]))}
    del back
    free_cuda()
    emit({"phase": "calib_setup", "model": name,
          "layers": arch.num_layers, "hidden": arch.hidden_size,
          "bytes": nbytes, "make_s": make_s, "write_s": write_s,
          "load_s": load_s, "write_gb_s": nbytes / write_s / 1e9,
          "load_gb_s": nbytes / load_s / 1e9, "sums": got,
          "seconds": time.time() - t0})
    if got != sums:
        raise AssertionError(f"checkpoint read back differs: {got} {sums}")
    return str(path)


def search_summary(algo) -> dict:
    """The AWQ grid index chosen per subset kind, over the blocks."""
    out = {}
    for (_, subset), (_, best) in algo.search_log.items():
        out.setdefault(subset, []).append(best)
    return out


def phase_calib_awq(dev, path: str, layers: int):
    """``run_pipeline`` on the checkpoint on the card: AWQ W4 asymmetric
    per-group 128 (v2 transform, v1 clip), bf16, AWQ_SAMPLES synthetic
    calibration samples of 512 tokens, synthetic PPL (seq_len 512, 8192
    tokens) at
    pretrain, transformed and fake_quant, token consistency.  Gates: every
    PPL finite, transformed within 1e-2 of pretrain, token consistency in
    [0, 1].  Returns the calibrated algorithm."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    tim = {}
    results, algo = run_pipeline(calib_config(path, n_samples=AWQ_SAMPLES),
                                 device=dev, timings=tim, return_algo=True)
    blocks = tim.pop("blocks")
    ppl = {k: v for k, v in results.items() if k.startswith("ppl_")}
    tc = results["token_consistency"]
    emit({"phase": "calib_awq", "layers": layers, "ppl": ppl,
          "token_consistency": tc, "block_s_median": statistics.median(
              blocks), "block_s_max": max(blocks), "block_s": blocks,
          "phase_s": tim, "awq_grid_index": search_summary(algo),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    finite = all(np.isfinite(v) for v in ppl.values())
    if not (finite and abs(ppl["ppl_transformed"] - ppl["ppl_pretrain"])
            <= TOL_TRANSFORMED * ppl["ppl_pretrain"] and 0 <= tc <= 1):
        raise AssertionError(f"calib_awq: {results}")
    return algo


def phase_engine_calibrated(dev, algo) -> list:
    """The AWQ model's serving weights (``algo=``: its clipped ranges
    served) at W4A8 through the engine: 8 prompts, 32 new tokens, kv8
    ``xla``, 8 slots; #3 on every prefill linear, #2 on every decode
    linear; then its prefill logits against the plain versions, and its
    serving checkpoint (``phase_serving_ckpt``, with a fused s4 build of
    the first two blocks).  Returns the engine phases' launches."""
    t0 = time.time()
    sw = build_serving_weights(algo.model, WSPEC, act_bits=8, device=dev,
                               algo=algo)
    sw_s4 = build_serving_weights(depth_view(algo.model, 2), WSPEC,
                                  act_bits=8, device=dev, algo=algo,
                                  **S4_FUSED)
    torch.cuda.synchronize()
    emit({"phase": "calibrated_build", "serving_gb": serving_bytes(sw) / 1e9,
          "seconds": time.time() - t0})
    algo.model.params.clear()
    free_cuda()
    layers = sw.arch.num_layers
    prompts = make_prompts(8, sw.arch.vocab_size)
    outs = []
    launches = engine_phase(
        "engine_calibrated", sw, prompts, 32, dev, None, outs=outs,
        expect={"w4a8_matmul_prefill": (7 * layers, 0),
                "w4a8_matmul_decode": (0, 7 * layers)})
    engine_vs_plain("calibrated", sw, prompts, dev)
    return [launches] + phase_serving_ckpt(dev, sw, sw_s4, prompts, outs)


def phase_calib_rtn(dev, path: str) -> None:
    """The driver entry's quantizer (RTN W4 asymmetric per-group 128) by
    the pipeline on the same checkpoint: its fake_quant PPL."""
    t0 = time.time()
    tim = {}
    results = run_pipeline(calib_config(path, method="RTN",
                                        eval_pos=("fake_quant",),
                                        token_consist=False),
                           device=dev, timings=tim)
    tim.pop("blocks")
    emit({"phase": "calib_rtn", "ppl": results, "phase_s": tim,
          "seconds": time.time() - t0})
    if not np.isfinite(results["ppl_fake_quant"]):
        raise AssertionError(f"calib_rtn: {results}")


def phase_small_calib_vs_cpu(dev) -> dict:
    """The CI config's shape (the tiny Llama, f32, W4 groups of 16, 4
    calibration samples of 16 tokens, 256 eval tokens) calibrated by the
    port on the card and on the CPU from one checkpoint: each subset's AWQ
    grid index (a subset whose index differs is listed with both losses),
    PPL at each position within 1e-3, token consistency, and the serving
    codes built with ``algo=`` bit for bit in the blocks whose indices
    all agree."""
    t0 = time.time()
    path = CALIB_DIR / "tiny"
    shutil.rmtree(path, ignore_errors=True)
    arch = arch_from_hf_config(TINY_CONFIG, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    save_params(Llama(arch, init_params(gen, arch)), str(path),
                hf_config=TINY_CONFIG)
    cfg = calib_config(str(path), n_samples=4, seq_len=16, n_tokens=256,
                       bs=1, vocab=256, group=16, dtype="float32")
    runs = {d: run_pipeline(cfg, device=d, return_algo=True)
            for d in ("cpu", dev)}
    (r_cpu, a_cpu), (r_card, a_card) = runs["cpu"], runs[dev]
    differ = {}
    for key, (loss_c, best_c) in a_cpu.search_log.items():
        loss_g, best_g = a_card.search_log[key]
        if best_c != best_g:
            differ[f"{key[0]}/{key[1]}"] = {
                "cpu": [best_c, float(loss_c[best_c]),
                        float(loss_c[best_g])],
                "card": [best_g, float(loss_g[best_g]),
                         float(loss_g[best_c])]}
    spec = QuantSpec(bit=4, symmetric=False, granularity="per_group",
                     group_size=16)
    sws = {d: build_serving_weights(a.model, spec, act_bits=8, device=d,
                                    algo=a)
           for d, (_, a) in (("cpu", runs["cpu"]), (dev, runs[dev]))}
    agree = [i for i in range(arch.num_layers)
             if not any(k.startswith(f"{i}/") for k in differ)]
    same = all(same_tensor(sws["cpu"].blocks[i][n].codes,
                           sws[dev].blocks[i][n].codes)
               for i in agree for n in sws["cpu"].blocks[i]
               if hasattr(sws["cpu"].blocks[i][n], "codes"))
    rel = {k: abs(r_card[k] - v) / v for k, v in r_cpu.items()
           if k.startswith("ppl_")}
    exports = exports_agree({"cpu": a_cpu, dev: a_card}, agree,
                            EXPORT_DIR / "tiny")
    gptq = small_gptq_vs_cpu(dev, str(path))
    c3 = small_c3_vs_cpu(dev, str(path))
    a8 = small_a8_vs_cpu(dev)
    res = {"phase": "small_calib_vs_cpu", "ppl_cpu": r_cpu,
           "ppl_card": r_card, "ppl_rel": rel, "index_differs": differ,
           "blocks_compared": agree, "same_codes": same, "gptq": gptq,
           "c3": c3, "exports": exports, "a8": a8,
           "seconds": time.time() - t0}
    emit(res)
    if not (all(v <= TOL_SMALL_PPL for v in rel.values()) and same
            and 0 <= r_card["token_consistency"] <= 1 and gptq["ok"]
            and c3["ok"] and exports["ok"] and a8["ok"]):
        raise AssertionError(f"small calibration, card vs CPU: {res}")
    return res


# the v2 clip factors (logits up to 13.8, where an f32 ulp is 9.5e-7) card
# against CPU: within 1e-6 of max(|factor|, 1), as the CPU tests hold them
# to JAX's
TOL_CLIP = 1e-6


def small_c3_vs_cpu(dev, path: str) -> dict:
    """ROADMAP C3's keys on the CI config's tiny model, card and CPU: AWQ
    with the v2 clip and ``save_clip`` writes ``clips.pkl`` on both (the
    same keys, factors within TOL_CLIP), ``profile_out`` the phase JSON
    (the same phase names and counts), ``trace_dir`` a Chrome trace that
    on the card holds CUDA kernel events."""
    out = []
    for i, d in enumerate(("cpu", dev)):
        base = CALIB_DIR / f"c3_{i}"
        shutil.rmtree(base, ignore_errors=True)
        cfg = calib_config(path, n_samples=4, seq_len=16, n_tokens=256,
                           bs=1, vocab=256, group=16, dtype="float32",
                           eval_pos=("fake_quant",), token_consist=False)
        cfg.quant.special.update(clip_version="v2", save_clip=True,
                                 clip_path=str(base / "clips"))
        cfg.base.update(profile_out=str(base / "profile.json"),
                        trace_dir=str(base / "trace"))
        run_pipeline(cfg, device=d)
        with open(base / "clips" / "clips.pkl", "rb") as f:
            clips = pickle.load(f)
        prof = json.loads((base / "profile.json").read_text())
        traces = list((base / "trace").glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] \
            if len(traces) == 1 else []
        out.append((clips, prof, events))
        shutil.rmtree(base, ignore_errors=True)
    (cc, pc, _), (cg, pg, eg) = out
    same_keys = sorted(cc) == sorted(cg) and all(
        sorted(cc[b]) == sorted(cg[b]) for b in cc)
    err = max((float(np.max(np.abs(cg[b][k] - cc[b][k])
                            / np.maximum(np.abs(cc[b][k]), 1.0)))
               for b in cc for k in cc[b] if cc[b][k] is not None),
              default=float("inf")) if same_keys else float("inf")
    kernels = sum(1 for e in eg if e.get("cat") == "kernel")
    res = {"clip_keys_equal": same_keys, "clip_factors": sum(
        len(v) for v in cc.values()), "clip_max_rel_err": err,
        "profile_names": sorted(pg),
        "profile_counts_equal": {k: v["count"] for k, v in pg.items()}
        == {k: v["count"] for k, v in pc.items()},
        "trace_events": len(eg), "trace_cuda_kernels": kernels}
    res["ok"] = (same_keys and err <= TOL_CLIP
                 and res["profile_counts_equal"] and kernels > 0
                 and "block_loop/Awq/block" in pg)
    return res


# ---------------------------------------------------------------------------
# the quantizer core and GPTQ (the slice after the kernels)
# ---------------------------------------------------------------------------

# (path name, spec fields, gate): "exact" bit for bit card vs CPU;
# "ref_manual" the same grid point (1e-5 relative) in >= 99.9% of values,
# the rest one grid step apart (log2 and pow differ by ulps); "mse" ranges
# equal in >= 99% of rows, where not the card's chosen error within 1e-6
# relative of the CPU's; "hqq" scales bit for bit, zeros within 1e-5
# relative (sums in other orders)
QC_G128 = dict(bit=4, symmetric=False, granularity="per_group",
               group_size=128)
QUANT_CORE_PATHS = [
    ("int4_g128_minmax", QC_G128, "exact"),
    ("int4_g128_mse", dict(QC_G128, calib_algo="mse"), "mse"),
    ("int4_g128_hqq", dict(QC_G128, calib_algo="hqq"), "hqq"),
    ("int4_per_head32", dict(bit=4, symmetric=False,
                             granularity="per_head", head_num=32), "exact"),
    ("int8_per_block128", dict(bit=8, symmetric=True,
                               granularity="per_block", block_size=128),
     "exact"),
    ("e4m3_hw", dict(bit="e4m3", granularity="per_channel"), "exact"),
    ("e5m2_hw", dict(bit="e5m2", granularity="per_channel"), "exact"),
    ("e4m3_ref_manual", dict(bit="e4m3", granularity="per_channel",
                             float_mode="ref_manual"), "ref_manual"),
    ("e5m2_ref_manual", dict(bit="e5m2", granularity="per_channel",
                             float_mode="ref_manual"), "ref_manual"),
]
# the searches, whose gates read their ranges or qparams: computed once on
# each side over the whole weight (hqq's stop test is one mean over the
# whole tensor, so a slice would be another problem), the values from them
QC_SEARCHES = ("mse", "hqq")
QC_W48 = (dict(bit=8, symmetric=True, granularity="per_channel"), QC_G128)
QC_ACT = ("static_minmax", "static_moving_minmax", "static_hist")


def timed_call(fn, dev):
    """(fn(), seconds), synchronised on the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.time() - t0


def ref_manual_share(got, want, m_bits: int):
    """(share on the same grid point, all within one grid step)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs())
    d = (got - want).abs()
    return (float((d <= 1e-5 * mag).double().mean()),
            bool((d <= 2.0 ** -m_bits * mag * (1 + 1e-6)).all()))


# rows of the grouped view a CPU mse call takes: each row's search is its
# own, so chunks that stay in the CPU's cache give the whole call's bits,
# about 5x sooner
QC_MSE_CPU_ROWS = 4096


def search_qparams(w, spec):
    """(grouped view, qparams) of the weight by spec's search, and for mse
    its range."""
    t2 = Q.reshape_tensor(w.float(), spec)
    if spec.calib_algo == "mse":
        if t2.device.type == "cuda":
            rng = Q.mse_range(t2, spec)
        else:
            parts = [Q.mse_range(c, spec) for c in t2.split(QC_MSE_CPU_ROWS)]
            rng = tuple(torch.cat(r) for r in zip(*parts))
        return t2, Q.qparams_from_range(rng, spec), rng
    return (*Q.get_tensor_qparams(w, spec), None)


def mse_gate(t2, rng_card, rng_cpu, spec) -> dict:
    """mse ranges on the card and the CPU: the share of rows whose range
    is the same, and the largest relative gap between the errors the two
    chosen ranges give (on the CPU view t2)."""
    cmn, cmx = (a.cpu() for a in rng_card)
    pmn, pmx = rng_cpu
    same = (cmn == pmn) & (cmx == pmx)

    def err(mn, mx):
        qp = Q.qparams_from_range((mn, mx), spec)
        q = Q.quant_dequant(t2, qp, spec)
        return ((q - t2).abs() ** 2.4).sum(dim=-1, keepdim=True)

    e_card, e_cpu = err(cmn, cmx), err(pmn, pmx)
    gap = float(((e_card - e_cpu).abs() / e_cpu.abs().clamp_min(1e-30))
                .max())
    return {"rows_same": float(same.float().mean()), "err_rel_max": gap,
            "ok": float(same.float().mean()) >= 0.99 and gap <= 1e-6}


def search_row(w, spec, dev) -> dict:
    """A search's qparams (mse or hqq) over the whole weight on the card
    and the CPU, timed, and its gate; the fake-quant values from them."""
    cpu = torch.device("cpu")
    (t_c, qc, rc), card_s = timed_call(lambda: search_qparams(w, spec), dev)
    (t_p, qp, rp), cpu_s = timed_call(lambda: search_qparams(w.cpu(), spec),
                                      cpu)
    row = {"card_s": card_s, "cpu_s": cpu_s}
    if spec.calib_algo == "mse":
        row.update(mse_gate(t_p, rc, rp, spec))
    else:
        z_rel = float((qc.zeros.cpu() - qp.zeros).abs().max()
                      / qp.zeros.abs().max())
        row.update(scales_equal=torch.equal(qc.scales.cpu(), qp.scales),
                   zeros_rel=z_rel)
        row["ok"] = row["scales_equal"] and z_rel <= 1e-5
    card, ref = (Q.quant_dequant(t, q, spec) for t, q in ((t_c, qc),
                                                          (t_p, qp)))
    row["values_equal"] = float((card.cpu() == ref).float().mean())
    return row


def phase_quant_core(dev) -> dict:
    """The quantizer core on the card and on the CPU: seeded bf16 weights
    at Llama-3-8B's q (4096 x 4096) and down (4096 x 14336) shapes through
    each path of ``QUANT_CORE_PATHS`` and W48, and 8 x 512 x 4096 seeded
    activations through the static per-tensor act qparams (minmax, moving
    minmax, the histogram search); each path's seconds on both and its
    gate; and GPTQ's column step on both fed the same U
    (``GPTQ_COLUMN_CASES``)."""
    t_phase = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    ws = {name: (0.02 * torch.randn(n, k, generator=gen, device=dev)).to(
        torch.bfloat16) for name, n, k in (("q", 4096, 4096),
                                           ("down", 4096, 14336))}
    acts = [torch.randn(1, 512, 4096, generator=gen, device=dev).to(
        torch.bfloat16) * (1 + i) for i in range(8)]
    cpu = torch.device("cpu")
    rows, failed = [], []
    for name, kw, gate in QUANT_CORE_PATHS:
        spec = QuantSpec(**kw)
        for wname, w in ws.items():
            row = {"path": name, "weight": wname}
            if gate in QC_SEARCHES:
                row.update(search_row(w, spec, dev))
                rows.append(row)
                if not row["ok"]:
                    failed.append(row)
                continue
            card, row["card_s"] = timed_call(
                lambda: Q.fake_quant_weight_dynamic(w, spec), dev)
            ref, row["cpu_s"] = timed_call(
                lambda: Q.fake_quant_weight_dynamic(w.cpu(), spec), cpu)
            card = card.cpu()
            if gate == "exact":
                row["ok"] = torch.equal(card, ref)
            else:  # ref_manual
                share, within = ref_manual_share(card, ref, spec.m_bits)
                row.update(same_point=share, within_step=within,
                           ok=share >= 0.999 and within)
            row["values_equal"] = float((card == ref).float().mean())
            rows.append(row)
            if not row["ok"]:
                failed.append(row)
    spec8, spec4 = (QuantSpec(**kw) for kw in QC_W48)
    for wname, w in ws.items():
        card, card_s = timed_call(
            lambda: Q.fake_quant_weight_w48(w, spec8, spec4), dev)
        ref, cpu_s = timed_call(
            lambda: Q.fake_quant_weight_w48(w.cpu(), spec8, spec4), cpu)
        row = {"path": "w48", "weight": wname, "card_s": card_s,
               "cpu_s": cpu_s, "ok": torch.equal(card.cpu(), ref)}
        rows.append(row)
        if not row["ok"]:
            failed.append(row)
    for i, case in enumerate(GPTQ_COLUMN_CASES):
        rows.append(gptq_column_row(*case, SEED + 20 + i, dev))
        if not rows[-1]["ok"]:
            failed.append(rows[-1])
    acts_cpu = [a.cpu() for a in acts]
    for algo in QC_ACT:
        spec = QuantSpec(bit=8, symmetric=True, granularity="per_tensor",
                         calib_algo=algo)
        qc, card_s = timed_call(lambda: Q.static_act_qparams(acts, spec),
                                dev)
        qp, cpu_s = timed_call(lambda: Q.static_act_qparams(acts_cpu, spec),
                               cpu)
        row = {"path": algo, "weight": "acts_8x512x4096", "card_s": card_s,
               "cpu_s": cpu_s, "scale": float(qp.scales),
               "ok": torch.equal(qc.scales.cpu(), qp.scales)}
        rows.append(row)
        if not row["ok"]:
            failed.append(row)
    res = {"phase": "quant_core", "rows": rows,
           "seconds": time.time() - t_phase}
    emit(res)
    if failed:
        raise AssertionError(f"quant_core: card vs CPU: {failed}")
    return res


# (name, out, in, tokens, group, block): the CI config's linears (the
# tiny Llama: q/o 64 x 64, k/v 32 x 64, gate/up 128 x 64, down 64 x 128;
# 64 calibration tokens; groups and blocks of 16) and Llama-3-8B's q
# (2048 tokens; groups of 128 and of 32 in blocks of 128).  On the card
# each runs the graphed block loop, on the CPU the eager one with the
# global groups
GPTQ_COLUMN_CASES = [("ci_q", 64, 64, 64, 16, 16),
                     ("ci_k", 32, 64, 64, 16, 16),
                     ("ci_gate", 128, 64, 64, 16, 16),
                     ("ci_down", 64, 128, 64, 16, 16),
                     ("llama_q", 4096, 4096, 2048, 128, 128),
                     ("llama_q_g32", 4096, 4096, 2048, 32, 128)]
# where the CI shapes' column step is held card vs CPU, as the CPU test
# holds the port's to JAX's on JAX's U: codes and W_new
GPTQ_CODES_SHARE = 0.999
GPTQ_W_REL = 1e-5
# at Llama width one flipped code at a tie moves the later columns by a
# fraction of a step, which flips others: the card's disagreement with
# the CPU is held to that of the CPU fed U moved by one ulp,
# GPTQ_CHAOS_RATIO times over
GPTQ_CHAOS_RATIO = 2.0


def gptq_codes(W, scales, zeros, gs: int) -> torch.Tensor:
    s = scales.repeat_interleave(gs, 1)
    z = zeros.repeat_interleave(gs, 1)
    return (torch.round(W / s) + z).clamp(WSPEC.qmin, WSPEC.qmax)


def ulp_moved(U: torch.Tensor, seed: int) -> torch.Tensor:
    """U with each entry moved by at most one f32 ulp (a seeded sign)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return U * (1 + 2.0 ** -23 * torch.randint(-1, 2, U.shape,
                                               generator=gen).to(U))


def gptq_column_row(name, oc, ic, tokens, gs, bs, seed, dev) -> dict:
    """GPTQ's column step (actorder, W4 asymmetric, groups of gs, blocks
    of bs) on the card and on the CPU fed the same permuted W and U, factored
    on the card from seeded tokens: the share of equal codes and W_new's
    largest difference relative to its largest entry; at Llama width also
    the CPU's share against itself fed U moved by one ulp."""
    cpu = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(seed)
    W = 0.02 * torch.randn(oc, ic, generator=gen)
    X = torch.randn(tokens, ic, generator=gen) * (
        0.2 + 2 * torch.rand(ic, generator=gen))
    Xd = X.to(dev)
    Wp, U, _ = G.gptq_factor(W.to(dev), 2 / tokens * (Xd.T @ Xd),
                             actorder=True)
    spec = WSPEC.with_(group_size=gs)
    (wc, sc, zc), card_s = timed_call(
        lambda: G.gptq_columns(Wp, U, spec, blocksize=bs, group_size=gs),
        dev)
    Wp, U = Wp.cpu(), U.cpu()
    (wp, sp, zp), cpu_s = timed_call(
        lambda: G.gptq_columns(Wp, U, spec, blocksize=bs, group_size=gs),
        cpu)
    wc, sc, zc = wc.cpu(), sc.cpu(), zc.cpu()
    cp = gptq_codes(wp, sp, zp, gs)
    share = float((gptq_codes(wc, sc, zc, gs) == cp).double().mean())
    w_rel = float((wc - wp).abs().max() / wp.abs().max())
    row = {"path": "gptq_columns", "weight": name, "shape": [oc, ic],
           "tokens": tokens, "group": gs, "block": bs, "card_s": card_s,
           "cpu_s": cpu_s,
           "codes_equal": share, "w_rel": w_rel}
    if oc <= 128:
        row["ok"] = share >= GPTQ_CODES_SHARE and w_rel <= GPTQ_W_REL
        return row
    wu, su, zu = G.gptq_columns(Wp, ulp_moved(U, seed), spec, blocksize=bs,
                                group_size=gs)
    ulp = float((gptq_codes(wu, su, zu, gs) == cp).double().mean())
    row.update(codes_equal_cpu_ulp=ulp,
               ok=1 - share <= GPTQ_CHAOS_RATIO * (1 - ulp))
    return row


def gptq_config(path: str, **kw) -> DotDict:
    """The pipeline's GPTQ config: W4 asymmetric per group 128, actorder,
    true_sequential, quant_out, blocksize 128, percdamp 0.01."""
    cfg = calib_config(path, method="GPTQ", **kw)
    cfg.quant["special"] = {"actorder": True, "static_groups": False,
                            "percdamp": 0.01, "blocksize": 128,
                            "true_sequential": True}
    cfg.quant["quant_out"] = True
    return cfg


def gptq_vs_rtn_block0(algo, path: str, cfg, dev) -> dict:
    """GPTQ's objective on block 0: for each linear, |X (W - W_q)| over
    the block's calibration inputs X (the float path's), W the checkpoint's
    weight, W_q GPTQ's (``algo.w_qdq`` of its updated weight) and RTN's
    with the same groups."""
    reader = ShardReader(path)
    bp0 = {}
    try:
        for canon, key in _llama_key_map(0).items():
            t = reader.get(key, dev)
            if t is None:
                continue
            node = bp0
            *parts, leaf = canon.split(".")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = t
    finally:
        reader.close()
    model = algo.model
    batches, _ = CalibDataset(None, cfg.calib).get_calib_dataset()
    x = model.collect_first_block_input([torch.from_numpy(b)
                                         for b in batches])
    feats = {}
    for xb in x:
        for k, v in model.block_forward(0, xb, block_params=bp0)[1].items():
            feats.setdefault(k, []).append(v)
    out = {}
    for name in model.get_block_linear_names(0):
        X = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats[name]]
                      ).float()
        W0 = A.resolve(bp0, name)["weight"]
        wg = algo.w_qdq(A.resolve(model.blocks[0], name)["weight"], 0, name)
        wr = Q.fake_quant_weight_dynamic(W0, algo.wspec)
        out[name] = {
            k: float(torch.linalg.matrix_norm(X @ (W0.float()
                                                   - wq.float()).T))
            for k, wq in (("gptq", wg), ("rtn", wr))}
        del X
    return out


def phase_calib_gptq(dev, path: str, layers: int):
    """``run_pipeline`` on the checkpoint on the card: GPTQ W4 asymmetric
    per group 128 (actorder, true_sequential, quant_out, blocksize 128,
    percdamp 0.01), bf16, 16 synthetic calibration samples of 512 tokens,
    synthetic PPL (8192 tokens) at pretrain and fake_quant; block seconds,
    the Hessian / factor / column-loop seconds, peak memory.  Gates: every
    PPL finite; on block 0 each linear's output error under GPTQ below
    RTN's.  Returns the calibrated algorithm."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    tim = {}
    cfg = gptq_config(path, n_samples=16,
                      eval_pos=("pretrain", "fake_quant"),
                      token_consist=False)
    results, algo = run_pipeline(cfg, device=dev, timings=tim,
                                 return_algo=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    blocks = tim.pop("blocks")
    t1 = time.time()
    errs = gptq_vs_rtn_block0(algo, path, cfg, dev)
    res = {"phase": "calib_gptq", "layers": layers, "ppl": results,
           "block_s_median": statistics.median(blocks),
           "block_s_max": max(blocks), "block_s": blocks,
           "gptq_s": algo.seconds, "phase_s": tim,
           "max_memory_allocated_gb": peak, "block0_out_err": errs,
           "block0_check_s": time.time() - t1,
           "seconds": time.time() - t0}
    emit(res)
    finite = all(np.isfinite(v) for v in results.values())
    if not (finite and all(e["gptq"] < e["rtn"] for e in errs.values())):
        raise AssertionError(f"calib_gptq: {results} {errs}")
    return algo


def phase_engine_gptq(dev, algo) -> dict:
    """The GPTQ model's serving weights (``algo=``: its searched groups
    through ``w_qdq``, re-coded) at W4A16 through the engine: 8 prompts,
    32 new tokens, kv8 ``xla``, 8 slots; #1 on every decode linear (the
    1024-row prefill dequantizes and matmuls, as in JAX); then its prefill
    logits against the plain versions."""
    t0 = time.time()
    sw = build_serving_weights(algo.model, WSPEC, act_bits=16, device=dev,
                               algo=algo)
    torch.cuda.synchronize()
    emit({"phase": "gptq_build", "serving_gb": serving_bytes(sw) / 1e9,
          "seconds": time.time() - t0})
    algo.model.params.clear()
    free_cuda()
    layers = sw.arch.num_layers
    prompts = make_prompts(8, sw.arch.vocab_size)
    launches = engine_phase("engine_gptq", sw, prompts, 32, dev, None,
                            expect={"w4a16_matmul": (0, 7 * layers)})
    engine_vs_plain("gptq", sw, prompts, dev)
    return launches


# configs/ci/gptq_w_only_tiny_synthetic.yml as a dict (the card has no
# PyYAML); the model path is filled in
GPTQ_CI_CONFIG = {
    "base": {"seed": 0},
    "model": {"type": "Llama", "path": None, "torch_dtype": "float32"},
    "calib": {"name": "synthetic", "n_samples": 4, "bs": 1, "seq_len": 16,
              "preproc": "synthetic_random", "seed": 0},
    "eval": {"eval_pos": ["fake_quant"], "name": "synthetic",
             "seq_len": 16, "bs": 1},
    "quant": {"method": "GPTQ",
              "weight": {"bit": 4, "symmetric": False,
                         "granularity": "per_group", "group_size": 16},
              "special": {"actorder": True, "static_groups": False,
                          "percdamp": 0.01, "blocksize": 16,
                          "true_sequential": True},
              "quant_out": True}}
def one_ulp_hessians():
    """GPTQ's Hessians each moved by at most one f32 ulp (a seeded sign a
    entry), as another device's summation order moves them."""
    orig = G.GPTQ.compute_hessian
    gen = torch.Generator()
    gen.manual_seed(SEED + 12)

    def moved(self, xs, name=""):
        H = orig(self, xs, name)
        return H * (1 + 2.0 ** -23 * torch.randint(
            -1, 2, H.shape, generator=gen).to(H))

    return moved


def codes_agree(sw_a, sw_b) -> float:
    same = total = 0
    for ea, eb in zip(sw_a.blocks, sw_b.blocks):
        for n, e in ea.items():
            if hasattr(e, "codes"):
                same += int((eb[n].codes.cpu() == e.codes.cpu()).sum())
                total += e.codes.numel()
    return same / total


def small_gptq_vs_cpu(dev, path: str) -> dict:
    """The GPTQ CI config calibrated on the card and on the CPU from one
    tiny checkpoint: PPL within ``TOL_SMALL_PPL``; the share of equal
    serving codes (``algo=``) and the largest relative difference of the
    searched scales, beside the CPU's own share against a CPU run whose
    Hessians moved by one ulp.  The config's 64 tokens a batch make H as
    wide as its rank at best, so a one-ulp move can flip a rounding tie
    that GPTQ's updates spread (and, through quant_out, a later block's
    order): the card's share of differing codes is held to the one-ulp
    run's, ``GPTQ_CHAOS_RATIO`` times over (the column step itself is held
    card vs CPU on the same U in ``quant_core``)."""
    cfg = DotDict(GPTQ_CI_CONFIG)
    cfg.model["path"] = path
    runs = {d: run_pipeline(cfg, device=d, return_algo=True)
            for d in ("cpu", dev)}
    saved, G.GPTQ.compute_hessian = G.GPTQ.compute_hessian, \
        one_ulp_hessians()
    try:
        runs["cpu_ulp"] = run_pipeline(cfg, device="cpu", return_algo=True)
    finally:
        G.GPTQ.compute_hessian = saved
    spec = QuantSpec(bit=4, symmetric=False, granularity="per_group",
                     group_size=16)
    sws = {k: build_serving_weights(a.model, spec, act_bits=16,
                                    device=a.model.device, algo=a)
           for k, (_, a) in runs.items()}
    (r_cpu, a_cpu), (r_card, a_card) = runs["cpu"], runs[dev]
    scale_rel = max(
        float((a_card.layer_state[i][n]["gptq"]["scales"].cpu() - sp).abs()
              .max() / sp.abs().max())
        for i in range(len(a_cpu.layer_state))
        for n, st in a_cpu.layer_state[i].items()
        for sp in (st["gptq"]["scales"],))
    rel = abs(r_card["ppl_fake_quant"] - r_cpu["ppl_fake_quant"]) \
        / r_cpu["ppl_fake_quant"]
    agree = codes_agree(sws["cpu"], sws[dev])
    agree_ulp = codes_agree(sws["cpu"], sws["cpu_ulp"])
    return {"ppl_cpu": r_cpu, "ppl_card": r_card,
            "ppl_cpu_ulp": runs["cpu_ulp"][0], "ppl_rel": rel,
            "codes_agree": agree, "codes_agree_cpu_ulp": agree_ulp,
            "scale_rel_max": scale_rel,
            "ok": rel <= TOL_SMALL_PPL
            and 1 - agree <= GPTQ_CHAOS_RATIO * (1 - agree_ulp)}

# ---------------------------------------------------------------------------
# the pipeline's outputs: real-quant exports, serving checkpoints; the W8A8
# and e4m3 serving builds
# ---------------------------------------------------------------------------

EXPORT_DIR = CALIB_DIR.parent / "export"
CKPT_DIR = CALIB_DIR.parent / "serving_ckpt"
W8SPEC = QuantSpec(bit=8, symmetric=True, granularity="per_channel")
FP8SPEC = QuantSpec(bit="e4m3", symmetric=True, granularity="per_channel")
# engine_fp8's cut: its e4m3 linears dequantize to bf16 at every call (as
# JAX's qlinear_xla does), so it runs the first FP8_LAYERS blocks of the
# Llama-3-8B model, FP8_NEW tokens
FP8_LAYERS = 8
FP8_NEW = 16
# the AWQ model's formats written over every block / over its first two
EXPORT_FULL = ("autoawq",)
EXPORT_TWO = ("vllm", "native", "trtllm")


def depth_view(model, layers: int):
    """The model over its first ``layers`` blocks, sharing their tensors."""
    arch = dataclasses.replace(model.arch, num_layers=layers)
    params = dict(model.params, blocks=model.params["blocks"][:layers])
    return type(model)(arch, params, config=model.config)


def algo_view(algo, layers: int):
    """What ``export.export_real_quant`` reads of a calibrated algorithm,
    over its model's first ``layers`` blocks."""
    return types.SimpleNamespace(
        model=depth_view(algo.model, layers), wspec=algo.wspec,
        layer_state=algo.layer_state[:layers], w_only=algo.w_only,
        aspec=algo.aspec, act_static=algo.act_static,
        quant_config=algo.quant_config)


def unpack_awq(qw: torch.Tensor) -> torch.Tensor:
    """AutoAWQ's (rows, oc/8) words -> (rows, oc) nibbles: nibble i of a
    word holds output channel _AWQ_ORDER[i] of its eight."""
    shifts = torch.arange(8, device=qw.device, dtype=torch.int32) * 4
    u = (qw[:, :, None] >> shifts) & 0xF
    out = torch.empty_like(u)
    out[:, :, list(_AWQ_ORDER)] = u
    return out.reshape(qw.shape[0], -1)


def exported_equal(fmt: str, sf, base: str, codes, scales, zeros,
                   dev) -> bool:
    """One linear read back from a real-quant file equals
    ``real_quant_weight``'s codes, scales and zeros (AutoAWQ: its fp16
    scales and rounded zeros)."""
    def get(k):
        return sf.get(base + k, dev)

    u = codes.to(torch.int32) & 0xF
    if fmt == "autoawq":
        return (torch.equal(unpack_awq(get(".qweight")).t(), u)
                and torch.equal(get(".scales").t(), scales.half())
                and torch.equal(unpack_awq(get(".qzeros")).t(),
                                torch.round(zeros).to(torch.int32)))
    names = ((".weight_packed", ".weight_scale", ".weight_zero_point")
             if fmt in ("vllm", "sgl") else
             (".qweight_packed", ".scales", ".zeros"))
    return (torch.equal(unpack_int4(get(names[0])), u)
            and torch.equal(get(names[1]), scales.float())
            and torch.equal(get(names[2]), zeros.float()))


def check_export(fmt: str, algo, layers: int, root: Path, dev) -> dict:
    """Read a format's file back with st_io and hold every linear written
    to ``real_quant_weight`` of the same weights and qparams."""
    t0 = time.time()
    path = root / f"{fmt}_quant_model"
    sf = st_io.SafetensorsFile(str(path / "quant_model.safetensors"))
    ok, n = True, 0
    try:
        for idx in range(layers):
            bp = algo.model.params["blocks"][idx]
            for name in algo.model.get_block_linear_names(idx):
                qp = algo.layer_state[idx].get(name, {}).get("qparams")
                c, s, z = Q.real_quant_weight(
                    resolve(bp, name)["weight"].float(), algo.wspec, qp=qp)
                ok = ok and exported_equal(fmt, sf, f"blocks.{idx}.{name}",
                                           c, s, z, dev)
                n += 1
    finally:
        sf.close()
    with open(path / "quantization_config.json") as f:
        qcfg = json.load(f)
    return {"layers": layers, "linears": n, "equal": ok,
            "quant_method": qcfg.get("quant_method"),
            "verify_s": time.time() - t0}


def phase_export_real_quant(dev, algo) -> None:
    """The calibrated AWQ model's real-quant exports through
    ``run_exports`` (the pipeline's ``save_*`` keys): AutoAWQ over every
    block, vllm, native and trtllm (with ``trtllm-build``'s command where
    it is absent) over the first two; each file read back and every
    linear's codes, scales and zeros equal to ``real_quant_weight``'s;
    seconds and GB written; the files deleted."""
    t0 = time.time()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    L = algo.model.num_blocks
    res = {"phase": "export_real_quant", "formats": {}}
    for keys, a, layers in ((EXPORT_FULL, algo, L),
                            (EXPORT_TWO, algo_view(algo, 2), 2)):
        cfg = {"save": {**{f"save_{k}": True for k in keys},
                        "save_path": str(EXPORT_DIR)}}
        t1 = time.time()
        written = run_exports(a, cfg)
        torch.cuda.synchronize()
        write_s = time.time() - t1
        for fmt in keys:
            res["formats"][fmt] = dict(
                gb=written[fmt] / 1e9, write_s=write_s,
                **check_export(fmt, a, layers, EXPORT_DIR, dev))
    res["build_cmd"] = (EXPORT_DIR / "trtllm_engine" /
                        "build_cmd.txt").exists()
    gb = sum(v["gb"] for v in res["formats"].values())
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    res.update(gb_written=gb, seconds=time.time() - t0)
    emit(res)
    if not (all(v["equal"] and v["linears"] == 7 * v["layers"]
                for v in res["formats"].values()) and res["build_cmd"]):
        raise AssertionError(f"export_real_quant: {res}")


def same_serving(a, b) -> bool:
    """Two serving weights hold the same linears (codes, scales, zeros,
    bias, layout, flags), norms, embedding and head."""
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        return x.shape == y.shape and torch.equal(x.float(), y.float())
    ok = eq(a.embed, b.embed) and same_tensor(a.lm_head.cpu(), b.lm_head) \
        and eq(a.lm_head_scale, b.lm_head_scale) \
        and all(eq(a.norm[k], b.norm[k]) for k in a.norm)
    for ea, eb in zip(a.blocks, b.blocks):
        ok = ok and set(ea) == set(eb)
        for n, va in ea.items():
            vb = eb.get(n)
            if isinstance(va, QLinearParams):
                ok = ok and all(getattr(va, f) == getattr(vb, f) for f in (
                    "layout", "tiled", "bits", "is_float", "group_size")) \
                    and all(same_tensor(getattr(va, f), getattr(vb, f))
                            for f in ("codes", "scales", "zeros", "bias"))
            else:
                ok = ok and all(eq(va[k], vb[k]) for k in va)
    return ok


def ckpt_roundtrip(name: str, sw, dev, **fields):
    """``export_serving`` then ``load_serving`` of ``sw``, the build
    fields the files do not record (``act_bits``, ``fused_rms``) set on
    the loaded weights: (the loaded weights, a dict of GB, write and load
    seconds, tensors equal)."""
    path = CKPT_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.time()
    nbytes = export_serving(sw, str(path))
    write_s = time.time() - t0
    t0 = time.time()
    back = dataclasses.replace(load_serving(str(path), device=dev),
                               **fields)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    shutil.rmtree(path, ignore_errors=True)
    return back, {"gb": nbytes / 1e9, "write_s": write_s, "load_s": load_s,
                  "write_gb_s": nbytes / write_s / 1e9,
                  "load_gb_s": nbytes / load_s / 1e9,
                  "same_weights": same_serving(sw, back)}


def phase_serving_ckpt(dev, sw, sw_s4, prompts, outs) -> list:
    """The calibrated AWQ planes build (W4A8) written by ``export_serving``
    and read back by ``load_serving``: the same tensors; then the kv8
    engine on the loaded build: the in-memory build's greedy tokens
    (``outs``) with #3 and #2 launched exactly, and its teacher-forced
    decode logits bit for bit.  The fused s4 build (two blocks) likewise,
    its decode steps through #13.  Returns the engine phase's launches."""
    t0 = time.time()
    back, io = ckpt_roundtrip("awq", sw, dev, act_bits=sw.act_bits)
    layers = sw.arch.num_layers
    got = []
    launches = engine_phase(
        "engine_serving_ckpt", back, prompts, len(outs[0]), dev, None,
        outs=got, expect={"w4a8_matmul_prefill": (7 * layers, 0),
                          "w4a8_matmul_decode": (0, 7 * layers)})
    cont = outs[0][:9]
    with torch.no_grad():
        la, _ = forced_logits(sw, prompts[0], cont, dev)
        lb, _ = forced_logits(back, prompts[0], cont, dev)
    del back
    free_cuda()
    res = {"phase": "serving_ckpt", "build": "awq_planes_w4a8", **io,
           "tokens_equal": got == [list(o) for o in outs],
           "logits_steps": len(cont), "logits_equal": torch.equal(la, lb)}
    s4_back, s4_io = ckpt_roundtrip("fused_s4", sw_s4, dev, act_bits=8,
                                    fused_rms=True)
    steps = 4
    n13 = []  # #13's launches in the in-memory run, then the loaded one's
    logits = []
    for build in (sw_s4, s4_back):
        reset_launch_counts()
        with torch.no_grad():
            logits.append(forced_logits(build, prompts[1],
                                        outs[1][:steps + 1], dev)[0])
        n13.append({k.__name__: k.launches
                    for k in KERNELS}["w4a8_linear_bytes_fused"])
    res["fused_s4"] = dict(s4_io, layers=sw_s4.arch.num_layers,
                           logits_equal=torch.equal(*logits),
                           linear_bytes_fused_launches=n13)
    res["seconds"] = time.time() - t0
    emit(res)
    want13 = 4 * sw_s4.arch.num_layers * steps
    if not (res["same_weights"] and res["tokens_equal"]
            and res["logits_equal"] and res["fused_s4"]["same_weights"]
            and res["fused_s4"]["logits_equal"]
            and n13 == [want13, want13]):
        raise AssertionError(f"serving_ckpt: {res}")
    return [launches]


def int8_mm_rows(sw, dev) -> list:
    """``int8_matmul_dynamic`` at Llama-3-8B's q and down (the W8 build's
    block-0 codes) at M 1, 8 and 256 on the card against the CPU, bit for
    bit, with the card's time."""
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED + 22)
    rows = []
    for name in ("attn.q", "mlp.down"):
        qp = sw.blocks[0][name]
        w_cpu, s_cpu = qp.codes.cpu(), qp.scales.cpu()
        N, K = qp.codes.shape
        for M_ in (1, 8, 256):
            x = torch.randn((M_, K), generator=gen).to(torch.bfloat16)
            xd = x.to(dev)
            got = int8_matmul_dynamic(xd, qp.codes, qp.scales)
            want = int8_matmul_dynamic(x, w_cpu, s_cpu)
            ms = time_ms(lambda: int8_matmul_dynamic(xd, qp.codes,
                                                     qp.scales), 10, pad)
            rows.append({"linear": name, "M": M_, "N": N, "K": K,
                         "bit_equal": torch.equal(got.cpu(), want),
                         "ms": ms})
    return rows


def phase_engine_w8(name: str, sw, prompts, n_new: int, dev,
                    mm: bool) -> dict:
    """A W8A8 or e4m3 build through the kv8 ``xla`` engine (no W4 kernel,
    no attention kernel launched), a 2-step ``profile_decode``, and its
    teacher-forced decode logits against the plain forward over the
    dequantized weights (``decode_vs_plain``, gate corr999); with ``mm``
    the int8 products card vs CPU."""
    outs = []
    launches = engine_phase(name, sw, prompts, n_new, dev, None, expect={},
                            outs=outs, route=dict(attn_impl="xla",
                                                  kv_bits=8))
    t0 = time.time()
    emit(dict(phase_profile(sw, prompts, dev, steps=2, build=name[7:]),
              seconds=time.time() - t0))
    decode_vs_plain(name[7:], sw, prompts[0], outs[0][:17], dev, "corr999")
    if mm:
        t0 = time.time()
        rows = int8_mm_rows(sw, dev)
        emit({"phase": "int8_matmul_dynamic", "rows": rows,
              "seconds": time.time() - t0})
        if not all(r["bit_equal"] for r in rows):
            raise AssertionError(f"int8_matmul_dynamic card vs CPU: {rows}")
    return launches


# small_w8_vs_cpu's cache-share limits: W8A8 snaps the card's and the
# CPU's last bits back to equal int8 act codes (the W4A8 limit, 0.1); the
# e4m3 build's linears are bf16 dequant-then-matmul, the route of ROADMAP
# C1, whose layer-1 caches differed in 14-20% of their entries on the
# first run (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): C1's limit, 0.3
SMALL_W8_SHARE = {"w8a8": 0.1, "fp8": 0.3}


def small_w8_vs_cpu(dev, model, prompts, forced) -> tuple:
    """The small Llama's W8A8 and e4m3 builds on the card against the CPU:
    the same codes, then the kv8 route (corr >= 0.999 per row, the cache
    shares under SMALL_W8_SHARE)."""
    res, ok = {}, True
    for name, spec in (("w8a8", W8SPEC), ("fp8", FP8SPEC)):
        sws = {d: build_serving_weights(model, spec, act_bits=8, device=d)
               for d in ("cpu", dev)}
        routes, r_ok = compare_routes(sws, prompts, forced, dev,
                                      {"kv8": SMALL_ROUTES["kv8"]},
                                      SMALL_W8_SHARE[name])
        res[name] = {"same_codes": same_codes(sws), "routes": routes}
        ok = ok and r_ok and res[name]["same_codes"]
    return res, ok


# exports_agree: f32 scales of the card's and the CPU's AWQ models (whose
# transformed weights differ in last bits: the searches' f32 sums run in
# other orders) within this relative distance
TOL_EXPORT_SCALE = 1e-6


def exports_agree(algos: dict, agree, root: Path) -> dict:
    """The tiny AWQ model's AutoAWQ and vllm exports from the card's and
    the CPU's calibrations: the same tensor names, dtypes and shapes and
    equal JSON; in the blocks whose AWQ grid indices agree the integer
    tensors (codes, packed zeros) bit for bit and the f32 scales within
    TOL_EXPORT_SCALE (AutoAWQ's fp16 scales bit for bit)."""
    dirs = {}
    for d, a in algos.items():
        dirs[d] = root / str(d)
        shutil.rmtree(dirs[d], ignore_errors=True)
        run_exports(a, {"save": {"save_autoawq": True, "save_vllm": True,
                                 "save_path": str(dirs[d])}})
    res = {}
    for fmt in ("autoawq", "vllm"):
        f = [dirs[d] / f"{fmt}_quant_model" for d in algos]
        h = [st_io.read_header(str(p / "quant_model.safetensors"))
             for p in f]
        blobs = [(p / "quant_model.safetensors").read_bytes() for p in f]
        shapes = all(h[0][0][k]["shape"] == h[1][0][k]["shape"]
                     and h[0][0][k]["dtype"] == h[1][0][k]["dtype"]
                     for k in h[0][0]) and set(h[0][0]) == set(h[1][0])
        compared = [k for k in h[0][0] if int(k.split(".")[1]) in agree]

        def raw(i, k):
            lo, hi = h[i][0][k]["data_offsets"]
            return blobs[i][h[i][1] + lo:h[i][1] + hi]
        same, scale_rel = True, 0.0
        for k in compared:
            if h[0][0][k]["dtype"] == "F32" and not k.endswith("zero_point"):
                a, b = (np.frombuffer(raw(i, k), np.float32)
                        for i in (0, 1))
                scale_rel = max(scale_rel, float(
                    (np.abs(a - b) / np.abs(a).clip(1e-30)).max()))
            else:
                same = same and raw(0, k) == raw(1, k)
        cfgs = [json.loads((p / "quantization_config.json").read_text())
                for p in f]
        res[fmt] = {"names_shapes_dtypes": shapes,
                    "tensors_compared": len(compared), "bit_equal": same,
                    "scale_rel_max": scale_rel,
                    "config_equal": cfgs[0] == cfgs[1]}
    shutil.rmtree(root, ignore_errors=True)
    res["ok"] = all(v["names_shapes_dtypes"] and v["bit_equal"]
                    and v["scale_rel_max"] <= TOL_EXPORT_SCALE
                    and v["config_equal"] for v in res.values())
    return res


# ---------------------------------------------------------------------------
# A8's untrained algorithms: QuaRot (and the Hadamard transforms), the
# KV-cache fake quant with the decode PPL, OsPlus, LLM.int8, QUIK, SpQR,
# DGQ and AdaDim
# ---------------------------------------------------------------------------

# the ``quant`` sections of configs/methods/*.yml as dicts (the card has no
# PyYAML; tests/test_torch_algos_a8.py holds them equal to the files).
# dgq_w4a8.yml's flat ``weight`` fails in both packages (ROADMAP C); DGQ
# runs with it as ``w_1`` and the int8 outer spec as ``w_2``.
_PER_TOKEN8 = {"bit": 8, "symmetric": True, "granularity": "per_token"}
A8_QUANT = {
    "quarot_fp8": {
        "method": "Quarot",
        "weight": {"bit": "e4m3", "symmetric": True,
                   "granularity": "per_channel", "quant_type": "float-quant"},
        "act": {"bit": "e4m3", "symmetric": True, "granularity": "per_token",
                "quant_type": "float-quant"},
        "special": {"rotate_mode": "hadamard", "online_rotate": True,
                    "fp32_had": True}},
    "osplus_w8a8": {
        "method": "OsPlus", "weight": {"bit": 8, "symmetric": True,
                                       "granularity": "per_channel"},
        "act": _PER_TOKEN8, "special": {"migrate": True}},
    "spqr_w3": {
        "method": "SpQR", "weight": {"bit": 3, "symmetric": False,
                                     "granularity": "per_group",
                                     "group_size": 16},
        "special": {"outlier_relative_threshold": 0.2}},
    "dgq_w4a8": {
        "method": "DGQ",
        "weight": {"w_1": {"bit": 4, "symmetric": False,
                           "granularity": "per_group", "group_size": 128},
                   "w_2": {"bit": 8, "symmetric": True,
                           "granularity": "per_channel"}},
        "act": _PER_TOKEN8},
    "llmint8_w8a8": {
        "method": "LlmInt8", "weight": {"bit": 8, "symmetric": True,
                                        "granularity": "per_channel"},
        "act": _PER_TOKEN8, "special": {"threshold": 6.0}},
    "quik_w4a4": {
        "method": "QUIK", "weight": {"bit": 4, "symmetric": False,
                                     "granularity": "per_channel"},
        "act": {"bit": 4, "symmetric": False, "granularity": "per_token"},
        "special": {"fp_features_num": 256}},
    "adadim_w4": {
        "method": "AdaDim", "weight": {"bit": 4, "symmetric": False,
                                       "granularity": "per_group",
                                       "group_size": 128}},
    "rtn_w8_kv8": {
        "method": "RTN", "weight": {"bit": 8, "symmetric": True,
                                    "granularity": "per_channel"},
        "kvcache": {"method": "Naive", "bit": 8, "symmetric": True,
                    "granularity": "per_token"}},
}
# the static and KIVI KV variants of rtn_w8_kv8 (kv_quant): static
# per-tensor act quant makes the KV quant static
KV_VARIANTS = {
    "naive_dynamic": A8_QUANT["rtn_w8_kv8"],
    "naive_static": dict(
        A8_QUANT["rtn_w8_kv8"],
        act={"bit": 8, "symmetric": True, "granularity": "per_tensor",
             "static": True, "calib_algo": "static_minmax"},
        kvcache={"method": "Naive", "bit": 8, "symmetric": True,
                 "granularity": "per_tensor"}),
    "kivi": dict(A8_QUANT["rtn_w8_kv8"],
                 kvcache={"method": "Kivi", "bit": 4, "symmetric": False,
                          "granularity": "per_token",
                          "residual_length": 32}),
}
# calib_algos' cut: the algorithms over the first A8_LAYERS blocks of a
# Llama-3-8B-width model (OsPlus's grid and SpQR's column loops cost
# seconds a block), A8_SAMPLES x 512 calibration tokens for every A8 phase
A8_LAYERS = 2
A8_SAMPLES = 4
# the tiny model of the CPU tests (tests/a8_helpers.py): hidden 128,
# intermediate 384 = 2^5 * 12 (QuaRot's online down takes a Paley factor)
A8_TINY_CONFIG = dict(TINY_CONFIG, hidden_size=128, intermediate_size=384)
# the tiny configs' PPL card vs CPU: the CPU tests' limits against JAX
# (1e-4; SpQR's and DGQ's loops are chaotic on 64 tokens: 1e-2)
A8_SMALL_TOL = dict({k: 1e-4 for k in A8_QUANT}, spqr_w3=1e-2,
                    dgq_w4a8=1e-2)
# matmul_hadU card vs CPU with a dense K x K factor (f32): sums in other
# orders (the CPU tests' limit against JAX)
TOL_HAD = 2e-6


def a8_config(path: str, quant: dict, evals, n_samples: int = A8_SAMPLES,
              seq_len: int = 512, dtype: str = "bfloat16",
              vocab: int = 128256) -> DotDict:
    return DotDict({
        "base": {"seed": 42},
        "model": {"type": "Llama", "path": path, "torch_dtype": dtype},
        "calib": {"name": "synthetic", "n_samples": n_samples, "bs": -1,
                  "seq_len": seq_len, "preproc": "synthetic_random",
                  "seed": 42, "vocab_size": vocab},
        "eval": evals, "quant": quant})


def ppl_eval(pos=("fake_quant",), n_tokens: int = 2048, seq_len: int = 512,
             bs: int = 4) -> dict:
    return {"eval_pos": list(pos), "name": "synthetic", "seq_len": seq_len,
            "bs": bs, "n_tokens": n_tokens}


def phase_hadamard(dev) -> None:
    """``matmul_hadU`` at (1024, 4096) and (1024, 14336) (K 1 and 28) in
    bf16 and f32 on the card against the CPU: bit for bit where it is
    add/sub stages (every bf16 stage rounds, as JAX's); with the f32 dense
    factor within TOL_HAD, in bf16 one bf16 ulp; the f32 round trip
    max|H H^T - I| at 4096 and 14336 within n * 2^-24; ms a call."""
    t0 = time.time()
    pad = torch.empty(PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator()
    gen.manual_seed(SEED + 30)
    rows, ok = [], True
    for n in (4096, 14336):
        K = HD.get_hadK(n)[1]
        x = torch.randn((1024, n), generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            xc = x.to(dt)
            xd = xc.to(dev)
            got = HD.matmul_hadU(xd).cpu()
            want = HD.matmul_hadU(xc)
            err = float((got.float() - want.float()).abs().max())
            top = float(want.float().abs().max())
            equal = torch.equal(got, want)
            if K == 1:
                good = equal
            elif dt == torch.float32:
                good = err <= TOL_HAD * top
            else:
                good = err <= bf16_ulp(top)
            ok = ok and good
            rows.append({"n": n, "K": K, "dtype": str(dt)[6:],
                         "bit_equal": equal, "max_abs_err": err,
                         "max_abs": top, "ok": good,
                         "ms": time_ms(lambda: HD.matmul_hadU(xd), 10, pad)})
        H = HD.matmul_hadU(torch.eye(n, device=dev))
        rt = float((H @ H.T - torch.eye(n, device=dev)).abs().max())
        # an f32 product of n terms rounds within about n units of 2^-24
        rows.append({"n": n, "K": K, "roundtrip_max_abs": rt,
                     "limit": n * 2.0 ** -24})
        ok = ok and rt <= n * 2.0 ** -24
        del H
    emit({"phase": "hadamard", "rows": rows, "seconds": time.time() - t0})
    if not ok:
        raise AssertionError(f"hadamard: {rows}")


def _against(got, ref) -> dict:
    got, ref = got.float().reshape(-1, got.shape[-1]), \
        ref.float().reshape(-1, ref.shape[-1])
    corr = float(torch.corrcoef(torch.stack([got.reshape(-1),
                                             ref.reshape(-1)]))[0, 1])
    return {"corr": corr,
            "argmax_equal_share": float(
                (got.argmax(-1) == ref.argmax(-1)).float().mean())}


def quarot_logits(path: str, dev, dtype: str, ids, quant, evals,
                  n_samples: int):
    """The original model's logits over ``ids``, the same with its
    embedding's per-token mean removed (QuaRot's first step, no
    equivalence on an RMSNorm model: ROADMAP C), then QuaRot by the
    pipeline and the transformed model's: (original, mean removed,
    transformed, pipeline results, timings, peak GB)."""
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        model = load_model(path, dtype=tdt, device=dev)
        orig = model.forward(ids)
        emb = model.params["embed"]
        w = emb["weight"].float()
        emb["weight"] = (w - mean_xla(w, -1, keepdim=True)).to(tdt)
        ref = model.forward(ids)
        del model, w, emb
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    tim = {}
    results, algo = run_pipeline(
        a8_config(path, quant, evals, n_samples=n_samples, dtype=dtype),
        device=dev, timings=tim, return_algo=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    algo.deploy("transformed")
    with torch.no_grad():
        got = algo.model.forward(ids)
    cfg = {k: list(v) for k, v in algo.model.rotate_cfg.items()}
    del algo
    free_cuda()
    return orig, ref, got, dict(results, rotate_cfg=cfg), tim, peak


def phase_calib_quarot(dev, path: str) -> None:
    """QuaRot (``quarot_fp8.yml``'s spec: the randomised Hadamard, online
    rotations, e4m3 W/A per channel / per token) by the pipeline on the
    Llama-3-8B checkpoint at full depth.  First in f32 (one calibration
    sample): the transformed model's logits over 256 tokens against the
    original's with its embedding's mean removed, corr >= 0.9999 and every
    argmax equal (a rotation changes nothing in exact arithmetic), against
    the untouched original reported.  Then at the config's bf16 with
    A8_SAMPLES x 512 calibration tokens: the transformed and fake-quant
    (online rotations) PPL, seconds, peak GB, and the same logit readings
    (reported: the rotated weights round to bf16)."""
    t0 = time.time()
    ids = torch.from_numpy(np.random.RandomState(SEED + 31).randint(
        0, LLAMA3_8B.vocab_size, (1, 256)))
    quant = A8_QUANT["quarot_fp8"]
    res, ok = {"phase": "calib_quarot"}, True
    for dtype, evals, n_samples in (
            ("float32", ppl_eval(("transformed",)), 1),
            ("bfloat16", ppl_eval(("transformed", "fake_quant")),
             A8_SAMPLES)):
        t1 = time.time()
        orig, ref, got, results, tim, peak = quarot_logits(
            path, dev, dtype, ids, quant, evals, n_samples)
        blocks = tim.pop("blocks")
        row = {"results": results, "vs_mean_removed": _against(got, ref),
               "vs_original": _against(got, orig),
               "finite": bool(torch.isfinite(got).all()),
               "layers": len(blocks),
               "block_s_median": statistics.median(blocks), "phase_s": tim,
               "max_memory_allocated_gb": peak,
               "seconds": time.time() - t1}
        res[dtype] = row
        del orig, ref, got
        free_cuda()
        ok = ok and row["finite"] and all(
            np.isfinite(v) for k, v in results.items() if k != "rotate_cfg")
    f32 = res["float32"]["vs_mean_removed"]
    ok = ok and f32["corr"] >= 0.9999 and f32["argmax_equal_share"] == 1
    res["seconds"] = time.time() - t0
    emit(res)
    if not ok:
        raise AssertionError(f"calib_quarot: {res}")


def phase_kv_quant(dev, path: str) -> None:
    """RTN W8 with the KV-cache fake quant by the pipeline on the Llama-3-8B
    checkpoint (full depth): Naive kv8 per token (``rtn_w8_kv8.yml``),
    Naive kv8 per tensor, static (with static per-tensor act quant), and
    KIVI kv4 with a 32-slot float residual; each with the decode PPL over
    64 tokens beside the prefill PPL of the same 64 predictions, with
    the KV quant and (naive_dynamic) without it.  Gates: every PPL finite;
    without the KV quant decode and prefill within 1e-2 (bf16 in two
    orders); decode tokens a second."""
    t0 = time.time()
    n = 64  # decode tokens (cut from 128 for time: about 27 tok/s)
    rows = {}
    for name, quant in KV_VARIANTS.items():
        pos = ("fake_quant", "fake_quant_wo_kv") \
            if name == "naive_dynamic" else ("fake_quant",)
        evals = [ppl_eval(pos, n_tokens=n + 1, seq_len=n + 1, bs=1),
                 dict(ppl_eval(pos), type="decode_ppl", num_eval_tokens=n)]
        tim = {}
        t1 = time.time()
        results = run_pipeline(a8_config(path, quant, evals), device=dev,
                               timings=tim)
        tim.pop("blocks")
        rows[name] = {"ppl": results, "phase_s": tim,
                      "decode_tok_s": len(pos) * n / sum(
                          tim[f"eval/{p}"] for p in pos),
                      "seconds": time.time() - t1}
        free_cuda()
    wo = rows["naive_dynamic"]["ppl"]
    drift = abs(wo["decode_ppl_synthetic_fake_quant_wo_kv"]
                - wo["ppl_synthetic_fake_quant_wo_kv"]) \
        / wo["ppl_synthetic_fake_quant_wo_kv"]
    res = {"phase": "kv_quant", "decode_tokens": n, "variants": rows,
           "decode_vs_prefill_wo_kv": drift, "seconds": time.time() - t0}
    emit(res)
    if not (drift <= 1e-2 and all(np.isfinite(v) for r in rows.values()
                                  for v in r["ppl"].values())):
        raise AssertionError(f"kv_quant: {res}")


def served_w4a8(name: str, algo, dev, n_new: int = 32) -> dict:
    """A calibrated algorithm's W4 g128 serving build (``algo=``) at
    act_bits 8 through the kv8 engine: 8 prompts of 100-128 tokens,
    ``n_new`` tokens, #3 on every prefill linear and #2 on every decode
    linear exactly; its prefill logits against the plain forward over the
    build's dequantized weights (``engine_vs_plain``: corr >= 0.999, same
    argmax).  Returns the launches."""
    t0 = time.time()
    sw = build_serving_weights(algo.model, WSPEC, act_bits=8, device=dev,
                               algo=algo)
    torch.cuda.synchronize()
    emit({"phase": f"{name}_build", "layers": sw.arch.num_layers,
          "serving_gb": serving_bytes(sw) / 1e9,
          "seconds": time.time() - t0})
    layers = sw.arch.num_layers
    prompts = make_prompts(8, sw.arch.vocab_size)
    launches = engine_phase(
        f"engine_{name}", sw, prompts, n_new, dev, None,
        expect={"w4a8_matmul_prefill": (7 * layers, 0),
                "w4a8_matmul_decode": (0, 7 * layers)})
    engine_vs_plain(name, sw, prompts, dev)
    del sw
    free_cuda()
    return launches


def phase_calib_algos(dev) -> list:
    """OsPlus, LLM.int8, QUIK, SpQR and DGQ (their configs' specs) by the
    pipeline on a Llama-3-8B-width checkpoint of A8_LAYERS blocks (written
    by ``save_params``), A8_SAMPLES x 512 calibration tokens, the
    fake-quant PPL over 2048 tokens: each one's seconds, peak GB, PPL.
    OsPlus's W8A8 build (W8 per channel, ``rows``, ``algo=``) serves 16
    tokens on the kv8 ``xla`` route (no W4 or attention kernel) with its
    teacher-forced decode logits against the plain forward (reported;
    corr >= MOE_CORR_MIN); DGQ's W4A8 build goes through
    ``served_w4a8``.  Returns the engine launches."""
    t0 = time.time()
    cfg = dict(LLAMA3_8B_CONFIG, num_hidden_layers=A8_LAYERS)
    path = phase_calib_setup(dev, cfg, name=f"llama3_8b_{A8_LAYERS}l")
    rows, launches = {}, []
    for name in ("osplus_w8a8", "llmint8_w8a8", "quik_w4a4", "spqr_w3",
                 "dgq_w4a8"):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        tim = {}
        results, algo = run_pipeline(a8_config(path, A8_QUANT[name],
                                               ppl_eval()),
                                     device=dev, timings=tim,
                                     return_algo=True)
        rows[name] = {"ppl": results["ppl_fake_quant"],
                      "block_s": tim.pop("blocks"), "phase_s": tim,
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9,
                      "seconds": time.time() - t1}
        if not np.isfinite(results["ppl_fake_quant"]):
            raise AssertionError(f"calib_algos {name}: {results}")
        if name == "osplus_w8a8":
            sw = build_serving_weights(algo.model, W8SPEC, act_bits=8,
                                       device=dev, algo=algo)
            prompts = make_prompts(8, sw.arch.vocab_size)
            outs = []
            launches.append(engine_phase(
                "engine_osplus_w8a8", sw, prompts, 16, dev, None, expect={},
                outs=outs, route=dict(attn_impl="xla", kv_bits=8)))
            # reported, gated at MOE_CORR_MIN: the 2-block OsPlus build
            # read min corr 0.99894 on its first run (PERF.md)
            decode_vs_plain("osplus_w8a8", sw, prompts[0], outs[0], dev,
                            "corr")
            del sw
        if name == "dgq_w4a8":
            launches.append(served_w4a8("dgq_w4a8", algo, dev))
        del algo
        free_cuda()
    shutil.rmtree(path, ignore_errors=True)
    emit({"phase": "calib_algos", "layers": A8_LAYERS,
          "calib_tokens": A8_SAMPLES * 512, "algos": rows,
          "seconds": time.time() - t0})
    return launches


def phase_engine_adadim(dev, path: str) -> dict:
    """AdaDim (``adadim_w4.yml``: W4 g128 asymmetric, the per-linear
    choice of the quantization dim) by the pipeline at full depth, then
    its W4A8 build through ``served_w4a8``; the share of linears that chose
    the input-channel dim."""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    tim = {}
    results, algo = run_pipeline(
        a8_config(path, A8_QUANT["adadim_w4"], ppl_eval()), device=dev,
        timings=tim, return_algo=True)
    dims = [st.get("dim_ic", False) for b in algo.layer_state
            for st in b.values()]
    emit({"phase": "calib_adadim", "ppl": results,
          "block_s_median": statistics.median(tim.pop("blocks")),
          "phase_s": tim, "dim_ic_share": sum(dims) / len(dims),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    if not np.isfinite(results["ppl_fake_quant"]):
        raise AssertionError(f"calib_adadim: {results}")
    launches = served_w4a8("adadim_w4", algo, dev)
    del algo
    free_cuda()
    return launches


def small_a8_vs_cpu(dev) -> dict:
    """Each A8 config on the CPU tests' tiny model (f32, 4 x 16 calibration
    tokens), on the card and on the CPU from one checkpoint: PPL within
    A8_SMALL_TOL (rtn_w8_kv8 also its decode PPL), QuaRot's Q and online
    rotations the same; AdaDim's dims and QUIK's float columns (16 a
    linear) reported."""
    path = CALIB_DIR / "tiny_a8"
    shutil.rmtree(path, ignore_errors=True)
    arch = arch_from_hf_config(A8_TINY_CONFIG, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(SEED + 32)
    save_params(Llama(arch, init_params(gen, arch)), str(path),
                hf_config=A8_TINY_CONFIG)
    out, ok = {}, True
    for name, quant in A8_QUANT.items():
        quant = dict(quant)
        if name == "quik_w4a4":  # fp_features_num is no key QUIK reads
            quant["special"] = {"fp_features": 16}
        evals = ppl_eval(n_tokens=64, seq_len=16, bs=1)
        if "kvcache" in quant:
            evals = [evals, dict(evals, type="decode_ppl",
                                 num_eval_tokens=32)]
        cfg = a8_config(str(path), quant, evals, seq_len=16,
                        dtype="float32", vocab=256)
        runs = {d: run_pipeline(cfg, device=d, return_algo=True)
                for d in ("cpu", dev)}
        (r_cpu, a_cpu), (r_card, a_card) = runs["cpu"], runs[dev]
        rel = max(abs(r_card[k] - v) / v for k, v in r_cpu.items())
        same = {}
        if name == "quarot_fp8":
            same["Q"] = torch.equal(a_cpu.Q, a_card.Q.cpu())
            same["rotate_cfg"] = a_cpu.model.rotate_cfg == \
                a_card.model.rotate_cfg
        for key in ("dim_ic", "fp_ids"):
            vals = [(st[key], a_card.layer_state[i][n][key])
                    for i, b in enumerate(a_cpu.layer_state)
                    for n, st in b.items() if key in st]
            if vals:
                same[key] = all(np.array_equal(a, b) for a, b in vals)
        # the choices are reported: the card's and the CPU's calibration
        # inputs are an ulp apart, which may move a choice at a near tie
        good = rel <= A8_SMALL_TOL[name] and same.get("Q", True) \
            and same.get("rotate_cfg", True)
        ok = ok and good
        out[name] = {"ppl_cpu": r_cpu, "ppl_card": r_card, "ppl_rel": rel,
                     "same": same, "ok": good}
    shutil.rmtree(path, ignore_errors=True)
    return {"configs": out, "ok": ok}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # the plain versions' f32 matmuls in full f32, not TF32 (the default,
    # set here); their operands and partial sums are then exact
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase_build())
    kern = phase_kernels(dev)
    emit(kern)
    emit(planes_crossover(dev))
    attn = phase_attn_kernels(dev)
    emit(attn)

    fused_k = phase_fused_kernels(dev)
    emit(fused_k)
    moe_k = phase_moe_kernels(dev)
    bench_k = phase_bench_kernels(dev)
    emit(bench_k)
    ms_k = phase_masked_s4_kernels(dev)
    emit(ms_k)
    bench_runs = phase_bench(dev)
    phase_bench_vs_plain(dev)
    bench_runs.append(phase_s4_entry(dev))

    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = Llama(LLAMA3_8B, init_params(gen, LLAMA3_8B))
    sw8 = build_serving_weights(model, WSPEC, act_bits=8, device=dev)
    # every other build from the same model, with non-unit gammas
    set_gammas(model, SEED + 2)
    builds = {name: build_serving_weights(model, WSPEC, act_bits=8,
                                          device=dev, **kw)
              for name, kw in (("fused_planes", dict(fused_rms=True,
                                                     fuse_qkv=True)),
                               ("fused_s4", S4_FUSED),
                               ("s4", dict(layout="s4")))}
    # W8A8 and e4m3 (the latter over the first FP8_LAYERS blocks)
    sw_w8 = build_serving_weights(model, W8SPEC, act_bits=8, device=dev)
    sw_fp8 = build_serving_weights(depth_view(model, FP8_LAYERS), FP8SPEC,
                                   device=dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "setup", "builds": ["w4a8", *builds, "w8a8", "fp8"],
          "w8a8_gb": serving_bytes(sw_w8) / 1e9,
          "fp8_gb": serving_bytes(sw_fp8) / 1e9, "fp8_layers": FP8_LAYERS,
          "seconds": time.time() - t0})
    vocab = LLAMA3_8B.vocab_size
    layers = LLAMA3_8B.num_layers
    prompts = make_prompts(8, vocab)
    runs = [engine_phase("engine_w4a8", sw8, prompts, 32, dev, None)]
    for k in ("w4a8_matmul_decode", "w4a8_matmul_prefill"):
        if runs[0][k] <= 0:
            raise AssertionError(f"the W4A8 engine never launched {k}")
    sw16 = dataclasses.replace(sw8, act_bits=16)
    # every decode linear through #1 (224 a step); the prefill (act_bits
    # 16 above 256 rows) is dequant-then-matmul, as in JAX
    runs.append(engine_phase("engine_w4a16", sw16, prompts[:4], 16, dev,
                             None, expect={"w4a16_matmul": (0, 7 * layers)}))
    t0 = time.time()
    emit(dict(phase_profile(sw8, prompts, dev), seconds=time.time() - t0))
    t0 = time.time()
    emit(dict(phase_profile(sw16, prompts, dev, build="w4a16"),
              seconds=time.time() - t0))

    kv4 = dict(kv_bits="auto", max_len=4096, prefill_buckets=(2048,))
    prompts_kv4 = make_prompts(8, vocab, 1500, 2000)
    runs.append(engine_phase("engine_kv4", sw8, prompts_kv4, 32, dev,
                             "decode_attention_bd4", **kv4))
    t0 = time.time()
    emit(dict(phase_profile(sw8, prompts_kv4, dev, **kv4),
              seconds=time.time() - t0))
    runs.append(engine_phase(
        "engine_kv4_long", sw8, make_prompts(8, vocab, 3000, 4000), 16, dev,
        "decode_attention_bd4_flash", kv_bits=4, max_len=8192,
        prefill_buckets=(4096,)))
    runs.append(engine_phase("engine_pallas", sw8, prompts, 16, dev,
                             "decode_attention_i8", attn_impl="pallas"))
    # the kv8 block-diagonal routes and the chunked ring: the seven planes
    # linears a block through #3 (prefill batches) and #2 (decode steps)
    dense = {"w4a8_matmul_prefill": (7 * layers, 0),
             "w4a8_matmul_decode": (0, 7 * layers)}
    runs.append(engine_phase("engine_bd", sw8, prompts, 32, dev,
                             "decode_attention_bd", expect=dense,
                             attn_impl="bd"))
    runs.append(engine_phase(
        "engine_bds", sw8, prompts_kv4, 16, dev,
        "decode_attention_bd_flash", expect=dense, kv_bits=8, max_len=4096,
        prefill_buckets=(2048,), attn_impl="bds"))
    runs.append(engine_phase("engine_chunk", sw8, prompts, 32, dev, None,
                             expect=dense, decode_chunk=16))
    t0 = time.time()
    emit(dict(phase_profile(sw8, prompts, dev, build="ring",
                            decode_chunk=16), seconds=time.time() - t0))
    # the routes JAX runs under XLA on the dense slot cache (plain torch
    # attention; the seven planes linears a block through #3 and #2): the
    # chunked kv4 engine on the packed kv4 ring (xla4r), kv16 and the xla8
    # concat variant on the generic and concat paths; each one's
    # teacher-forced decode against the plain forward
    kv4_ring = dict(kv4, decode_chunk=16)
    outs = []
    runs.append(engine_phase(
        "engine_kv4_ring", sw8, prompts_kv4, 16, dev, None, expect=dense,
        route=dict(attn_impl="xla4r", ring=True, cache_bits=4,
                   layout="hhd"), outs=outs, **kv4_ring))
    t0 = time.time()
    emit(dict(phase_profile(sw8, prompts_kv4, dev, steps=2,
                            build="kv4_ring", **kv4_ring),
              seconds=time.time() - t0))
    decode_vs_plain("kv4_ring", sw8, prompts_kv4[0], outs[0], dev, "share",
                    **kv4_ring)
    for name, kw, body, gate in (
            ("engine_kv16", dict(kv_bits=16, max_len=1024), "generic",
             "exact"),
            ("engine_xla8", dict(attn_impl="xla8"), "xla8", "share")):
        outs = []
        runs.append(engine_phase(
            name, sw8, prompts, 16, dev, None, expect=dense, outs=outs,
            route=dict(body=body, ring=False), **kw))
        decode_vs_plain(name[7:], sw8, prompts[0], outs[0], dev, gate,
                        **kw)

    # the fused builds: 4 linears a block (q|k|v and gate|up merged); #14
    # or #13 carries every decode linear, #3 the planes prefill (1024
    # rows); the s4 prefill (4096 rows) is dequant-then-matmul, as in JAX
    runs.append(engine_phase(
        "engine_fused_planes", builds["fused_planes"], prompts, 32, dev, None,
        expect={"w4a8_matmul_prefill": (4 * layers, 0),
                "w4a8_linear_planes_fused": (0, 4 * layers)}))
    t0 = time.time()
    emit(dict(phase_profile(builds["fused_planes"], prompts, dev,
                            build="fused_planes"),
              seconds=time.time() - t0))
    runs.append(engine_phase(
        "engine_fused_s4", builds["fused_s4"], prompts_kv4, 16, dev,
        "decode_attention_bd4",
        expect={"w4a8_linear_bytes_fused": (0, 4 * layers)}, **kv4))
    t0 = time.time()
    emit(dict(phase_profile(builds["fused_s4"], prompts_kv4, dev,
                            build="fused_s4", **kv4),
              seconds=time.time() - t0))
    # s4 unfused: #12 at prefill (2 prompts x 128 = 256 rows) and decode
    runs.append(engine_phase(
        "engine_s4", builds["s4"], prompts[:2], 16, dev, None,
        expect={"w4a8_matmul_bytes": (7 * layers, 7 * layers)}))

    for name, sw, ps, kw in (
            ("w4a8", sw8, prompts, {}),
            ("w4a8", sw8, prompts, dict(attn_impl="bd")),
            ("fused_planes", builds["fused_planes"], prompts, {}),
            ("fused_s4", builds["fused_s4"], prompts[:2], {}),
            ("s4", builds["s4"], prompts[:2], {})):
        engine_vs_plain(name, sw, ps, dev, **kw)
    # W8A8 at full width and depth, e4m3 over FP8_LAYERS blocks: no W4 or
    # attention kernel; the int8 products exact (torch._int_mm)
    runs.append(phase_engine_w8("engine_w8a8", sw_w8, prompts, 32, dev,
                                True))
    runs.append(phase_engine_w8("engine_fp8", sw_fp8, prompts, FP8_NEW,
                                dev, False))
    # the Llama builds go before Mixtral's are made
    del sw8, sw16, builds, sw, sw_w8, sw_fp8
    gc.collect()
    torch.cuda.empty_cache()

    swm, setup = phase_setup_moe(dev)
    emit(setup)
    layers = MIXTRAL_8X7B.num_layers
    prompts_m = make_prompts(8, MIXTRAL_8X7B.vocab_size)
    # 8 slots: the 1024-row prefill through #9 (grouped, n >= 257), every
    # decode step through #6 (dense: n = 8 > E / top_k); the attention
    # linears through #3 and #2
    runs.append(engine_phase(
        "engine_moe", swm, prompts_m, 32, dev, None,
        expect={"w4a8_matmul_prefill": (4 * layers, 0),
                "w4a8_matmul_decode": (0, 4 * layers),
                "w4a8_grouped_matmul": (3 * layers, 0),
                "w4a8_stacked_matmul": (0, 3 * layers)}))
    # 4 slots, 2 prompts: the 256-row prefill through #6 (dense) and #2,
    # every decode step through #8 (gathered: n = 4 = E / top_k)
    runs.append(engine_phase(
        "engine_moe_small", swm, prompts_m[:2], 16, dev, None, max_slots=4,
        expect={"w4a8_matmul_decode": (4 * layers, 4 * layers),
                "w4a8_stacked_matmul": (3 * layers, 0),
                "w4a8_gathered_matmul": (0, 3 * layers)}))
    # 4 slots, 4 prompts of 700-1000 tokens at kv_bits="auto", max_len
    # 4096: the kv4 hhd cache on the generic path (MoE forces xla); one
    # 4096-row prefill batch, each block's attention linears through #3
    # and its experts through #9 (grouped, n >= 257); every decode step
    # (n = 4 = E / top_k: gathered) through #2 and #8.  (The prompts are
    # cut from 1500-2000 tokens to keep the whole run inside its time on
    # a slow host.)
    moe_kv4 = dict(max_slots=4, kv_bits="auto", max_len=4096,
                   prefill_buckets=(1024,))
    prompts_mk = make_prompts(4, MIXTRAL_8X7B.vocab_size, 700, 1000)
    outs = []
    runs.append(engine_phase(
        "engine_moe_kv4", swm, prompts_mk, 16, dev, None, outs=outs,
        route=dict(attn_impl="xla", ring=False, cache_bits=4, layout="hhd",
                   body="generic"),
        expect={"w4a8_matmul_prefill": (4 * layers, 0),
                "w4a8_grouped_matmul": (3 * layers, 0),
                "w4a8_matmul_decode": (0, 4 * layers),
                "w4a8_gathered_matmul": (0, 3 * layers)}, **moe_kv4))
    t0 = time.time()
    emit(dict(phase_profile(swm, prompts_mk, dev, steps=2,
                            build="moe_kv4", **moe_kv4),
              seconds=time.time() - t0))
    decode_vs_plain("moe_kv4", swm, prompts_mk[0], outs[0], dev, "corr",
                    **moe_kv4)
    t0 = time.time()
    emit(dict(phase_profile(swm, prompts_m, dev, build="moe"),
              seconds=time.time() - t0))
    engine_vs_plain("moe", swm, prompts_m, dev)
    del swm
    gc.collect()
    torch.cuda.empty_cache()

    swq, setup = phase_setup_moe(dev, QWEN3_30B_A3B, "Qwen3-30B-A3B",
                                 SEED + 7, "setup_qwen3moe")
    emit(setup)
    layers = QWEN3_30B_A3B.num_layers
    prompts_q = make_prompts(8, QWEN3_30B_A3B.vocab_size)
    # 32 slots, 8 prompts: the 1024-row prefill through #9 (gate, up) and
    # #10 (the int8 down), every decode step dense (n = 32 > E / top_k =
    # 16): #6 for gate and up, the int8 down in torch; the attention
    # linears through #3 and #2
    runs.append(engine_phase(
        "engine_qwen3moe", swq, prompts_q, 32, dev, None, max_slots=32,
        expect={"w4a8_matmul_prefill": (4 * layers, 0),
                "w4a8_matmul_decode": (0, 4 * layers),
                "w4a8_grouped_matmul": (2 * layers, 0),
                "w8a8_grouped_matmul": (layers, 0),
                "w4a8_stacked_matmul": (0, 2 * layers)}))
    # 8 slots, 2 prompts, the gathered route off (its int8-down fault) and
    # #7 up to 8 tokens: the 256-row dense prefill through #6 and #2, every
    # decode step's gate and up through #7
    runs.append(engine_phase(
        "engine_qwen3moe_smallm", swq, prompts_q[:2], 16, dev, None,
        moe_gather_max=0, moe_smallm=8,
        expect={"w4a8_matmul_decode": (4 * layers, 4 * layers),
                "w4a8_stacked_matmul": (2 * layers, 0),
                "w4a8_stacked_matmul_smallm": (0, 2 * layers)}))
    t0 = time.time()
    emit(dict(phase_profile(swq, prompts_q, dev, build="qwen3moe",
                            max_slots=32), seconds=time.time() - t0))
    # 4 prompts (512 rows, still the grouped route): the plain versions of
    # #9/#10 over 1024 rows took 28 s of the run (a cut for time; PERF.md)
    engine_vs_plain("qwen3moe", swq, prompts_q[:4], dev)
    del swq
    gc.collect()
    torch.cuda.empty_cache()

    # the quantizer core, card against CPU
    phase_quant_core(dev)
    free_cuda()
    # the main path's front half: a Llama-3-8B checkpoint written and read
    # by the port, calibrated (AWQ, then RTN, then GPTQ) and evaluated by
    # its pipeline, and the AWQ and GPTQ models served
    path = phase_calib_setup(dev)
    algo = phase_calib_awq(dev, path, LLAMA3_8B_CONFIG["num_hidden_layers"])
    phase_export_real_quant(dev, algo)
    runs.extend(phase_engine_calibrated(dev, algo))
    del algo
    free_cuda()
    phase_calib_rtn(dev, path)
    free_cuda()
    algo = phase_calib_gptq(dev, path, LLAMA3_8B_CONFIG["num_hidden_layers"])
    runs.append(phase_engine_gptq(dev, algo))
    del algo
    free_cuda()
    # A8: QuaRot, the KV-cache quant and AdaDim on the same checkpoint,
    # then the other algorithms over the first blocks
    phase_hadamard(dev)
    phase_calib_quarot(dev, path)
    phase_kv_quant(dev, path)
    runs.append(phase_engine_adadim(dev, path))
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    runs.extend(phase_calib_algos(dev))
    phase_small_calib_vs_cpu(dev)
    emit(phase_small_vs_cpu(dev))

    # the main path's launches: every engine phase and bench run
    runs += bench_runs
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    idle = [k for k in KERNEL_INFO if not launches[k] > 0]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    emit({"kernels": summarize(kern["rows"], attn["rows"], fused_k["rows"],
                               moe_k["rows"],
                               bench_k["rows"] + ms_k["rows"], launches)})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
