"""Time the planes W4 kernels of the tree in the working directory on one
NVIDIA GPU, for comparing two trees (designs) in one call:

    cd <tree> && python3 <repo>/kernel_ab.py TAG

#3 over a Llama-3-8B block's seven linears and the fused q|k|v and
gate|up at M 1024, #9 over a Mixtral-8x7B layer's grouped prefill (1024
tokens), #5 at the bench's down (N 4096, K 14336) at B 1, 8 and 32, #1
over a Llama-3-8B block's seven linears at each M of P1_M (bf16 x and
store), #4 at the bench's four fused entries at B 32 (f32 scales), #15
and #16 at the bench's shape (``tail_ms``); the median of CUDA-event
times with L2 flushed and the card held in a spin while the host enqueues
each call (``time_ms`` below, the same in every tree).  The shapes and
helpers come from the tree's ``chip_smoke.py``.  Prints one JSON line: ms
by kernel and shape, the card's name and power limit.

    cd <tree> && python3 <repo>/kernel_ab.py TAG tail

times #15 and #16 alone (B 32, H 4096, I 14336, q|k|v 6144, random plane
words and scales from the seed).

    cd <tree> && python3 <repo>/kernel_ab.py TAG w4a16_profile

instead profiles four decode steps of the W4A16 engine (Llama-3-8B at full
width and depth, random weights from chip_smoke's seed, 8 slots, #1 on
every decode linear) with the tree's ``chip_smoke.phase_profile``: wall
and busy ms a step, the idle share, kernels a step.

    cd <tree> && python3 <repo>/kernel_ab.py TAG stacked

times #6 on each of its bodies (the decode block and, where the tree has
it, the planes tile) at each B of STACKED_B over a Mixtral-8x7B layer's
three expert linears (E 8: gate and up 14336 x 4096 on a shared x, the
down 4096 x 14336 in pair mode) and over Qwen3-30B-A3B's gate and up (E
128, 768 x 2048), random plane words and scales from the seed; the least
B of the scan from which the tile is faster at every larger B, per model.

    cd <tree> && python3 <repo>/kernel_ab.py TAG engines

profiles four decode steps of the fused s4 engine (Llama-3-8B, the fused
s4 build with chip_smoke's gammas, kv4 ``bd4``, 8 prompts of 1500-2000
tokens) and of Qwen3-30B-A3B's 32-slot engine (its decode's dense route
through #6), and times the 256-row prefill of Mixtral-8x7B's
``engine_moe_small`` (2 prompts, 4 slots, the dense route through #6),
with the tree's chip_smoke helpers: wall and busy ms a step, prefill s.

    cd <tree> && python3 <repo>/kernel_ab.py TAG fused_s4

times #13 at each M of FUSED_S4_M over a Llama-3-8B block's four fused
linears (q|k|v 6144 and gate|up 28672 with the RMSNorm, o and down
without), random s4 byte pairs and scales from the seed, bf16 x.

    cd <tree> && python3 <repo>/kernel_ab.py TAG planes

times #2 at each M of P2_M over a Llama-3-8B block's seven linears (and
its q, k, v and o alone; the f32 store, which every tree takes) and #14
at each M of FUSED_S4_M over the fused build's four linears, random plane
words and scales from the seed, bf16 x.

    cd <tree> && python3 <repo>/kernel_ab.py TAG planes_engines

profiles four decode steps of the kv8 W4A8 engine (Llama-3-8B, 8 slots,
#2 on every decode linear) and of the fused planes engine (chip_smoke's
gammas, #14 on every decode linear), and times the 256-row prefill of
Mixtral-8x7B's ``engine_moe_small`` (#2 on its attention linears), with
the tree's chip_smoke helpers: wall and busy ms a step, prefill s.

    cd <tree> && python3 <repo>/kernel_ab.py TAG kv8_w8

times #22 at each (B, S) of KV8_SHAPES (8 kv heads of 4 queries, bf16
scales: the bench's B 32 over 2049 columns, 8 slots over 4097) and #10
at Qwen3-30B-A3B's down over the grouping of 1024 seeded tokens at each N
of W8_N (2048, and 1000: a ragged edge), random codes and scales from the
seed; then profiles two steps of the port bench's ``attn=pallas``
configuration (32 layers; busy and wall ms a step) and runs it for its
tok/s, and times the prefill of ``engine_qwen3moe`` (Qwen3-30B-A3B at full
width and depth, 32 slots, 8 prompts; three runs of 2 new tokens, the
first carrying the process's first-call costs) with the tree's chip_smoke
helpers.

    cd <tree> && python3 <repo>/kernel_ab.py TAG smallm_s4

times #7 at each B of SMALLM_B over Qwen3-30B-A3B's gate and up (E 128,
768 x 2048, a shared x) and over Mixtral-8x7B's down in pair mode (E 8,
4096 x 14336, each expert's own rows), and #11 at each M of S4_M over a
Llama-3-8B block's seven linears (natural s4 bytes, bf16 scales), random
codes and scales from the seed.

    cd <tree> && python3 <repo>/kernel_ab.py TAG smallm_engine

profiles four decode steps of ``engine_qwen3moe_smallm`` (Qwen3-30B-A3B
at full width and depth, 8 slots, ``moe_gather_max=0``, ``moe_smallm=8``:
every step's gate and up through #7) with the tree's chip_smoke helpers:
wall and busy ms a step, the idle share, and #7's share of the busy
time.

    cd <tree> && python3 <repo>/kernel_ab.py TAG s4_parts

times #11's tile (the tree's ``csrc/w4_bytes.cu``) over a Llama-3-8B
block's seven linears at M 8 and 32 beside copies of it built with one
part cut each (S4_CUTS: the h = 0 warps' corrections, the group dots, the
x copies, all three), to show where its time goes; the cut builds give
wrong outputs and are timed only.  Needs ``nvcc``.

    cd <tree> && python3 <repo>/kernel_ab.py TAG bd_flash

times #19 (kv8) and #21 (kv4): the bare kernel and its wrapper at
chip_smoke's shapes (8 slots of 8 kv heads of 4 queries, ragged lengths,
512-column blocks: #19 over 4096 columns, #21 over 8192), then the
wrapper over every slot full at each S of FLASH_S, s_block of FLASH_SB and
(B, G) of FLASH_BG, and at the engine phases' lengths (8 slots, #19 1500-
2016 of 4096, #21 3000-4016 of 8192), random codes and scales from the
seed; where the tree has the rank split, the bare kernel on each forced
split and ring depth (FLASH_PARTS x 1-3 slots) at the ragged shapes; then
profiles four decode steps of ``engine_bds`` and ``engine_kv4_long``
(Llama-3-8B, 8 slots, chip_smoke's prompts) with the tree's
``phase_profile``: wall and busy ms a step, and #19's or #21's share of
the busy time.

    cd <tree> && python3 <repo>/kernel_ab.py TAG i8_bd

times #17 (int8 hhd cache) and #18 (kv8 bd slabs): the bare kernel and its
wrapper against SDPA at chip_smoke's shapes (8 slots of 8 kv heads of 4
queries, ragged lengths, S 512 and 4096) and at the ``engine_pallas`` /
``engine_bd`` lengths (S 512); where the tree has the cluster split, the
bare kernel on each forced cluster size and ring depth (SPLIT_P x 1-2
slots) with the chooser's pick; then the wrapper over every slot full at
each S of I8BD_S and (B, G) of I8BD_BG (a shape a tree refuses records
its error); then profiles four decode steps of ``engine_pallas`` and
``engine_bd`` (Llama-3-8B, 8 slots, chip_smoke's prompts) with the tree's
``phase_profile``: wall and busy ms a step, and #17's or #18's share of
the busy time.

    cd <tree> && python3 <repo>/kernel_ab.py TAG attn_rows

times the bare launch of every block-diagonal and int8 decode-attention
kernel at chip_smoke's shapes (``attn_case``: 8 slots, ragged lengths;
#17 and #18 at S 512 and 4096, #20 at 4096, #19 at 4096 and #21 at 8192 in
512-column blocks), 50 launches each, the L2 flushed before each.

    cd <tree> && python3 <repo>/kernel_ab.py TAG flash_stamps

builds a copy of the tree's ``csrc/decode_attention.cu`` with
``-DLC_FLASH_STAMPS`` (%globaltimer stamps of thread 0 of one CTA: rank 0
of kv head 0 of slot 1, a full slot) and runs #19 (S 4096) and #21 (S
8192) at chip_smoke's ragged shapes on 1 and 8 ranks: for each span
between two consecutive stamp points (FLASH_POINTS), its median ns, count
a launch and summed ns a launch over five launches, the L2 flushed before
each.  Timing only.  Needs ``nvcc``.

    cd <tree> && python3 <repo>/kernel_ab.py TAG gathered_bd4

times #8 at each n of GB_N tokens routed top-2 by chip_smoke's seeded
router over a Mixtral-8x7B layer's three expert linears (the down in pair
mode), each linear against torch.bmm over the gathered bf16 experts;
then #20: the bare kernel and its wrapper against SDPA at chip_smoke's
shapes (8 slots of 8 kv heads of 4 queries; ragged lengths at S 4096 and
512, and the ``engine_kv4`` lengths, 1500-2016 of 4096), where the tree
has #20 on the cluster split, each forced cluster size and ring depth
(SPLIT_P x 1-2 slots) with the chooser's pick; then the wrapper over every
slot full at each S of GB_S and (B, G) of GB_BG (a shape a tree refuses
records its error); then profiles four decode steps of ``engine_kv4``,
``engine_fused_s4`` and the 4-slot ``engine_moe_small`` (every step's
expert linears through #8) with the tree's chip_smoke helpers: wall and
busy ms a step, the idle share, and #20's or #8's share of the busy
time.  Needs ``nvcc``."""

import dataclasses
import gc
import json
import statistics
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from lightcompress_tpu_torch.ops import moe_matmul as M  # noqa: E402
from lightcompress_tpu_torch.ops import w4_matmul as W  # noqa: E402
from lightcompress_tpu_torch.ops.qlinear import quantize_linear  # noqa: E402
from lightcompress_tpu_torch.serving import quantized_model as QM  # noqa: E402


# #1's M: the scan of a decode block's rows up to DECODE_M_MAX (in two
# trees, the old body's crossover with the new)
P1_M = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# #6's B: the dense MoE route's rows, from a decode step to a 256-row
# prefill
STACKED_B = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# (model, E, [(name, N, K, pair)]) of #6's main-path calls
STACKED_MODELS = (
    ("mixtral", 8, [("gate", 14336, 4096, False), ("up", 14336, 4096, False),
                    ("down", 4096, 14336, True)]),
    ("qwen3", 128, [("gate", 768, 2048, False), ("up", 768, 2048, False)]))
# #13's M: a decode step of 1, 8 and 32 slots
FUSED_S4_M = (1, 8, 32)
# #2's M: a decode step of 1 to 32 slots, up to a 256-row prefill
P2_M = (1, 8, 32, 64, 128, 256)
# #22's (slots, columns): the bench's, and 8 slots where its cluster splits
KV8_SHAPES = ((32, 2049), (8, 4097))
# #10's channels at Qwen3-30B-A3B's down (K 768): its N, and a ragged one
W8_N = (2048, 1000)
# #7's rows: a decode step of 1 to 32 slots
SMALLM_B = (1, 2, 4, 8, 16, 32)
# #11's rows: a decode step of 1 to 32 slots, up to the JAX gate's 256
S4_M = (1, 8, 16, 32, 64, 128, 256)
# #19/#21's scan: buffers, column blocks, (slots, queries a kv head)
FLASH_S = (512, 1280, 4096, 8192, 16384)
FLASH_SB = (512, 256)
FLASH_BG = ((1, 4), (8, 1), (8, 4), (8, 8), (32, 4), (32, 8))
# the forced splits of the rank scan
FLASH_PARTS = (1, 2, 4, 8, 16)
# #17/#18's scan: buffers, (slots, queries a kv head), forced cluster sizes
I8BD_S = (512, 1024, 4096, 8192, 16384)
I8BD_BG = ((1, 4), (8, 1), (8, 4), (8, 8), (32, 4), (32, 8))
SPLIT_P = (1, 2, 4, 8)
# gathered_bd4's scans: #8's tokens (2-8 selections), #20's buffers and
# (slots, queries a kv head)
GB_N = (1, 2, 3, 4)
GB_S = (512, 1024, 2048, 4096, 8192)
GB_BG = ((1, 4), (8, 1), (8, 4), (8, 8), (16, 8), (32, 4), (32, 8))


def time_ms(fn, reps: int, pad: torch.Tensor) -> float:
    fn()
    times = []
    for _ in range(reps):
        pad.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tail_ms(gen, dev, pad) -> dict:
    """#15 and #16 at the port bench's shape, 50 launches each."""
    from lightcompress_tpu_torch.ops import layer_fused as LF

    B, H, I, Nq = 32, 4096, 14336, 6144
    w = [t for n, k in ((H, H), (2 * I, H), (H, I), (Nq, H))
         for t in C.random_planes(gen, dev, n, k)]
    ctx, x = (torch.randn((B, H), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    return {"p15": time_ms(lambda: LF.w4a8_attn_tail_fused(ctx, x, *w[:9]),
                           50, pad),
            "p16": time_ms(lambda: LF.w4a8_layer_fused(ctx, x, *w), 50,
                           pad)}


def main(tag: str, only_tail: bool = False) -> None:
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi(), **tail_ms(gen, dev, pad)}
    if only_tail:
        print(json.dumps(out), flush=True)
        return
    t3 = {}
    for name, N, K in C.SHAPES + [("qkv", 6144, 4096),
                                  ("gateup", 28672, 4096)]:
        qp = quantize_linear(torch.randn((N, K), generator=gen, device=dev)
                             * 0.02, C.WSPEC)
        x = torch.randn((1024, K), generator=gen, device=dev).to(
            torch.bfloat16)
        xq, xs = W.quantize_act_per_token(x)
        t3[name] = time_ms(lambda: W.w4a8_matmul_prefill(
            xq, xs, qp.codes, qp.scales, qp.zeros), 20, pad)
    out["p3"] = t3
    out["p3_block"] = sum(t3[n] for n, _, _ in C.SHAPES)
    t9 = {}
    for name, N, K, _ in C.MOE_SHAPES:
        qp = QM.quantize_linear_stacked(
            (torch.randn((8, N, K), generator=gen, device=dev) * 0.02).to(
                torch.bfloat16), C.WSPEC)
        topi = C.seeded_topi(1024, gen, dev)
        x = torch.randn((1024, K), generator=gen, device=dev).to(
            torch.bfloat16)
        xq, xs, be, _ = C.grouped_operands(x, topi, 8)
        t9[name] = time_ms(lambda: M.w4a8_grouped_matmul(
            xq, xs, qp.codes, qp.scales, qp.zeros, be), 20, pad)
        del qp
    out["p9"] = t9
    out["p9_layer"] = sum(t9.values())
    w = C.random_planes(gen, dev, 4096, 14336)
    for B in (1, 8, 32):
        xq, xs = W.quantize_act_per_token(
            torch.randn((B, 14336), generator=gen, device=dev))
        out[f"p5_B{B}"] = time_ms(
            lambda: W.w4a8_matmul_planes_ksplit(xq, xs, *w), 50, pad)
    del w
    t1 = {m: 0.0 for m in P1_M}
    for name, N, K in C.SHAPES:
        w = C.random_planes(gen, dev, N, K)
        for m in t1:
            x = torch.randn((m, K), generator=gen, device=dev).to(
                torch.bfloat16)
            t1[m] += time_ms(lambda: W.w4a16_matmul(x, *w), 20, pad)
        del w
    out.update({f"p1_block_M{m}": t for m, t in t1.items()})
    t4 = {}
    for entry, N, K, _ in C.MASKED_SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        s = torch.full((N, K // 128), 0.01, device=dev)
        wp = W.pack_int4_planes_masked(u)
        sm = W.masked_scales(s)
        zm = W.masked_zero_scales(torch.full_like(s, 8.0), s)
        x = torch.randn((32, K), generator=gen, device=dev).to(
            torch.bfloat16)
        t4[entry] = time_ms(
            lambda: W.w4a16_matmul_planes_masked(x, wp, sm, zm), 20, pad)
        del u, wp
    out["p4_B32"] = t4
    out["p4_qkv_o"] = t4["qkv"] + t4["o"]
    print(json.dumps(out), flush=True)


def random_stacked(gen, dev, E: int, N: int, K: int):
    """E experts of random plane words, per-group scales and zero
    corrections (z * s), stacked."""
    parts = [C.random_planes(gen, dev, N, K) for _ in range(E)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))


def stacked_ms(tag: str) -> None:
    """#6 on each body at each B of STACKED_B, summed over each model's
    linears; a tree without the planes-tile body times its one body as
    ``decode``."""
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    forced = getattr(M, "_w4a8_stacked_matmul", None)
    bodies = ("decode", "tile") if forced is not None else ("decode",)
    out = {"tag": tag, "gpu": C.smi()}
    for model, E, linears in STACKED_MODELS:
        ms = {b: {B: 0.0 for B in STACKED_B} for b in bodies}
        for name, N, K, pair in linears:
            w = random_stacked(gen, dev, E, N, K)
            for B in STACKED_B:
                x = torch.randn((E, B, K) if pair else (B, K), generator=gen,
                                device=dev)
                xq, xs = W.quantize_act_per_token(x.reshape(-1, K))
                if pair:
                    xq, xs = xq.reshape(E, B, K), xs.reshape(E, B, 1)
                for b in bodies:
                    run = ((lambda: forced(xq, xs, *w, pair, b)) if forced
                           else (lambda: M.w4a8_stacked_matmul(
                               xq, xs, *w, pair=pair)))
                    ms[b][B] += time_ms(run, 20, pad)
            del w
        out[model] = {b: {str(B): t for B, t in v.items()}
                      for b, v in ms.items()}
        if forced is not None:
            faster = [ms["tile"][B] < ms["decode"][B] for B in STACKED_B]
            out[f"{model}_tile_from_B"] = next(
                (STACKED_B[i] for i in range(len(faster)) if all(faster[i:])),
                None)
    print(json.dumps(out), flush=True)


def fused_s4_ms(tag: str) -> None:
    """#13 at each M of FUSED_S4_M over a Llama-3-8B block's four fused
    linears, and each linear's ms at M 8."""
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
    tot = {m: 0.0 for m in FUSED_S4_M}
    for name, N, K, rms in C.FUSED_SHAPES:
        wb = torch.randint(-128, 128, (N, K // 2), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        s = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.02
             + 0.005).to(torch.bfloat16)
        zs = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.1
              - 0.05).to(torch.bfloat16)
        for m in FUSED_S4_M:
            x = (torch.randn((m, K), generator=gen, device=dev) * 3).to(
                torch.bfloat16)
            t = time_ms(lambda: W.w4a8_linear_bytes_fused(
                x, wb, s, zs, rms=rms, eps=1e-5), 20, pad)
            tot[m] += t
            if m == 8:
                out[f"p13_{name}_M8"] = t
        del wb, s, zs
    out.update({f"p13_block_M{m}": t for m, t in tot.items()})
    print(json.dumps(out), flush=True)


def planes_ms(tag: str) -> None:
    """#2 at each M of P2_M over a Llama-3-8B block's seven linears (and
    q, k, v, o) and #14 at each M of FUSED_S4_M over its four fused
    linears (``planes`` in the docstring)."""
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
    block = {m: 0.0 for m in P2_M}
    attn = {m: 0.0 for m in P2_M}
    for name, N, K in C.SHAPES:
        w = C.random_planes(gen, dev, N, K)
        for m in P2_M:
            xq, xs = W.quantize_act_per_token(
                torch.randn((m, K), generator=gen, device=dev))
            t = time_ms(lambda: W.w4a8_matmul_decode(xq, xs, *w), 20, pad)
            block[m] += t
            if name in ("q", "k", "v", "o"):
                attn[m] += t
        del w
    fused = {m: 0.0 for m in FUSED_S4_M}
    for name, N, K, rms in C.FUSED_SHAPES:
        w = C.random_planes(gen, dev, N, K)
        for m in FUSED_S4_M:
            x = (torch.randn((m, K), generator=gen, device=dev) * 3).to(
                torch.bfloat16)
            fused[m] += time_ms(lambda: W.w4a8_linear_planes_fused(
                x, *w, rms=rms, eps=1e-5), 20, pad)
        del w
    out.update({f"p2_block_M{m}": t for m, t in block.items()})
    out.update({f"p2_qkvo_M{m}": t for m, t in attn.items()})
    out.update({f"p14_block_M{m}": t for m, t in fused.items()})
    print(json.dumps(out), flush=True)


def planes_engines(tag: str) -> None:
    """The kv8 W4A8 and fused planes decode steps' profiles and
    Mixtral-8x7B's 256-row prefill (``planes_engines`` in the
    docstring)."""
    dev = torch.device("cuda")
    out = {"tag": tag, "gpu": C.smi()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    sw8 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev)
    C.set_gammas(model, C.SEED + 2)
    fused = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev,
                                    fused_rms=True, fuse_qkv=True)
    del model
    prompts = C.make_prompts(8, C.LLAMA3_8B.vocab_size)
    keys = ("wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "kernels_per_step")
    for name, sw, build in (("kv8", sw8, "w4a8"),
                            ("fused_planes", fused, "fused_planes")):
        prof = C.phase_profile(sw, prompts, dev, build=build)
        out[name] = {k: prof[k] for k in keys}
    del sw8, fused, sw
    gc.collect()
    torch.cuda.empty_cache()
    swm, _ = C.phase_setup_moe(dev)
    prompts = C.make_prompts(8, C.MIXTRAL_8X7B.vocab_size)
    _, launches, stats = C.run_engine(swm, prompts[:2], 16, dev,
                                      max_slots=4)
    out["moe_small"] = {"prefill_s": stats["prefill_s"],
                        "prefill_rows": stats["prefill_rows"],
                        "decode_launches": launches["w4a8_matmul_decode"]}
    print(json.dumps(out), flush=True)


def engines(tag: str) -> None:
    """The fused s4 and Qwen3-30B-A3B decode steps' profiles and
    Mixtral-8x7B's 256-row dense prefill (``engines`` in the docstring)."""
    dev = torch.device("cuda")
    out = {"tag": tag, "gpu": C.smi()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    C.set_gammas(model, C.SEED + 2)
    sw = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev,
                                 **C.S4_FUSED)
    del model
    kv4 = dict(kv_bits="auto", max_len=4096, prefill_buckets=(2048,))
    prof = C.phase_profile(sw, C.make_prompts(8, C.LLAMA3_8B.vocab_size, 1500,
                                              2000), dev, build="fused_s4",
                           **kv4)
    out["fused_s4"] = {k: prof[k] for k in (
        "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
        "kernels_per_step")}
    del sw
    gc.collect()
    torch.cuda.empty_cache()
    swm, _ = C.phase_setup_moe(dev)
    prompts = C.make_prompts(8, C.MIXTRAL_8X7B.vocab_size)
    _, launches, stats = C.run_engine(swm, prompts[:2], 16, dev,
                                      max_slots=4)
    out["moe_small"] = {"prefill_s": stats["prefill_s"],
                        "prefill_rows": stats["prefill_rows"],
                        "stacked_launches": launches["w4a8_stacked_matmul"]}
    del swm
    gc.collect()
    torch.cuda.empty_cache()
    swq, _ = C.phase_setup_moe(dev, C.QWEN3_30B_A3B, "Qwen3-30B-A3B",
                               C.SEED + 7, "setup_qwen3moe")
    prof = C.phase_profile(swq, C.make_prompts(8, C.QWEN3_30B_A3B.vocab_size),
                           dev, build="qwen3moe", max_slots=32)
    out["qwen3moe"] = {k: prof[k] for k in (
        "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
        "kernels_per_step")}
    print(json.dumps(out), flush=True)


def kv8_w8(tag: str) -> None:
    """#22 and #10 alone, the ``attn=pallas`` bench step and
    ``engine_qwen3moe``'s prefill (``kv8_w8`` in the docstring)."""
    from lightcompress_tpu_torch import bench as TB
    from lightcompress_tpu_torch.ops import attention as AT

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
    H, G, D = 8, 4, 128
    for B, S in KV8_SHAPES:
        q = torch.randn((B, H, G, D), generator=gen, device=dev).to(
            torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (B, H, S, D), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = ((torch.rand((B, H, S), generator=gen, device=dev) * 0.02
                   + 1e-3).to(torch.bfloat16) for _ in range(2))
        out[f"p22_B{B}_S{S}"] = time_ms(
            lambda: AT.decode_attention_kv8(q, kq, ks, vq, vs), 20, pad)
        del kq, vq
    E, K = 128, 768
    topi = C.seeded_topi(1024, gen, dev, E, C.QWEN3_30B_A3B)
    x = torch.randn((1024, K), generator=gen, device=dev).to(torch.bfloat16)
    xq, xs, be, _ = C.grouped_operands(x, topi, E)
    for N in W8_N:
        codes = torch.randint(-127, 128, (E, N, K), generator=gen,
                              device=dev, dtype=torch.int8)
        scales = torch.rand((E, N, 1), generator=gen, device=dev) * 0.01
        out[f"p10_N{N}"] = time_ms(lambda: M.w8a8_grouped_matmul(
            xq, xs, codes, scales, be), 20, pad)
        del codes
    cfg = TB.BenchConfig(attn="pallas")
    inputs = TB.build_inputs(cfg, dev, seed=C.SEED)
    step = lambda: TB.renorm(TB.decode_step(cfg, *inputs))
    prof = C.profiled(lambda: [step() for _ in range(2)], 2)
    res = TB.run(cfg, dev, inputs=inputs)
    out["bench_pallas"] = {
        "busy_ms_per_step": prof["device_busy_ms_per_step"],
        "wall_ms_per_step": prof["wall_ms_per_step"],
        "idle_share": prof["idle_share"], "tok_s": res["value"]}
    del inputs
    gc.collect()
    torch.cuda.empty_cache()
    swq, _ = C.phase_setup_moe(dev, C.QWEN3_30B_A3B, "Qwen3-30B-A3B",
                               C.SEED + 7, "setup_qwen3moe")
    prompts = C.make_prompts(8, C.QWEN3_30B_A3B.vocab_size)
    runs = [C.run_engine(swq, prompts, 2, dev, max_slots=32)[2]
            for _ in range(3)]
    out["qwen3moe_prefill_s"] = [r["prefill_s"] for r in runs]
    out["qwen3moe_prefill_rows"] = runs[-1]["prefill_rows"]
    print(json.dumps(out), flush=True)


def smallm_s4(tag: str) -> None:
    """#7 and #11 alone (``smallm_s4`` in the docstring)."""
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
    for model, E, linears in (
            ("qwen3", 128, [("gate", 768, 2048, False),
                            ("up", 768, 2048, False)]),
            ("mixtral_down", 8, [("down", 4096, 14336, True)])):
        ms = {B: 0.0 for B in SMALLM_B}
        for name, N, K, pair in linears:
            w = random_stacked(gen, dev, E, N, K)
            for B in SMALLM_B:
                x = torch.randn((E, B, K) if pair else (B, K), generator=gen,
                                device=dev)
                xq, xs = W.quantize_act_per_token(x.reshape(-1, K))
                if pair:
                    xq, xs = xq.reshape(E, B, K), xs.reshape(E, B, 1)
                ms[B] += time_ms(lambda: M.w4a8_stacked_matmul_smallm(
                    xq, xs, *w, pair=pair), 20, pad)
            del w
        out.update({f"p7_{model}_B{B}": t for B, t in ms.items()})
    tot = {m: 0.0 for m in S4_M}
    for name, N, K in C.SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        wb = W.pack_s4_bytes(u)
        s = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.02
             + 0.005).to(torch.bfloat16)
        zs = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.1
              - 0.05).to(torch.bfloat16)
        for m in S4_M:
            xq, xs = W.quantize_act_per_token(
                torch.randn((m, K), generator=gen, device=dev))
            tot[m] += time_ms(lambda: W.w4a8_matmul_s4_bytes(
                xq, xs, wb, s, zs), 20, pad)
        del u, wb
    out.update({f"p11_block_M{m}": t for m, t in tot.items()})
    print(json.dumps(out), flush=True)


# #11's parts, cut in copies of csrc/w4_bytes.cu: (old, new) source edits
S4_CORR = ("    if (h == 0 && p > 0) corrections(p - 1);",
           "    if (h == 7 && p > 0) corrections(p - 1);")
S4_DOTS = ("      s4_group_dots<MI>(d, st + j * kS4WTile, x0 + (2 * j + h) * kXT,"
           " ct, h,\n                        two);",
           "      for (int i = 0; i < MI; ++i)\n        for (int e = 0; e < 4;"
           " ++e) d[i][e] = st[e];")
S4_X = ("        const bool ok = r < mv && 4 * p + (q >> 3) < G;",
        "        const bool ok = false;")
S4_CUTS = {"whole": [], "no_corr": [S4_CORR], "no_dots": [S4_DOTS],
           "no_x": [S4_X], "copies_only": [S4_CORR, S4_DOTS, S4_X]}


def s4_parts(tag: str) -> None:
    """#11 whole and with parts cut (``s4_parts`` in the docstring)."""
    import ctypes
    import os
    import subprocess

    from lightcompress_tpu_torch.ops import _build

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
    work = os.path.join("build", "s4_parts")
    os.makedirs(work, exist_ok=True)
    src = (_build.CSRC / "w4_bytes.cu").read_text()
    procs = {}
    for name, cuts in S4_CUTS.items():
        text = src
        for a, b in cuts:
            assert a in text, (name, a)
            text = text.replace(a, b)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.abspath(os.path.join(work, f"lib{name}.so"))
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", so, path], stdout=subprocess.DEVNULL), so)
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(so)
        lib.lc_w4a8_s4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [
            ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lc_w4a8_s4.restype = ctypes.c_int
        libs[name] = lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    tot = {(n, m): 0.0 for n in libs for m in (8, 32)}
    for lname, N, K in C.SHAPES:
        u = torch.randint(0, 16, (N, K), generator=gen, device=dev,
                          dtype=torch.int32)
        wb = W.pack_s4_bytes(u)
        s = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.02
             + 0.005).to(torch.bfloat16)
        zs = (torch.rand((N, K // 128), generator=gen, device=dev) * 0.1
              - 0.05).to(torch.bfloat16)
        for m in (8, 32):
            xq, xs = W.quantize_act_per_token(
                torch.randn((m, K), generator=gen, device=dev))
            y = torch.empty((m, N), device=dev)
            for name, lib in libs.items():
                def run():
                    rc = lib.lc_w4a8_s4(xq.data_ptr(), xs.data_ptr(),
                                        wb.data_ptr(), s.data_ptr(),
                                        zs.data_ptr(), 1, y.data_ptr(), m, N,
                                        K, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                run()
                if name == "whole":
                    torch.cuda.synchronize()
                    assert torch.equal(y, W.w4a8_matmul_s4_plain(
                        xq, xs, wb, s, zs))
                tot[name, m] += time_ms(run, 20, pad)
        del u, wb
    out.update({f"p11_{n}_block_M{m}": t for (n, m), t in tot.items()})
    print(json.dumps(out), flush=True)


def smallm_engine(tag: str) -> None:
    """``engine_qwen3moe_smallm``'s decode step profiled (``smallm_engine``
    in the docstring)."""
    dev = torch.device("cuda")
    out = {"tag": tag, "gpu": C.smi()}
    swq, _ = C.phase_setup_moe(dev, C.QWEN3_30B_A3B, "Qwen3-30B-A3B",
                               C.SEED + 7, "setup_qwen3moe")
    prof = C.phase_profile(swq, C.make_prompts(8, C.QWEN3_30B_A3B.vocab_size),
                           dev, build="qwen3moe_smallm", moe_gather_max=0,
                           moe_smallm=8)
    p7 = [t for t in prof["top"] if "smallm" in t["name"]]
    busy = prof["device_busy_ms_per_step"]
    res = {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                "idle_share", "kernels_per_step")}
    res.update(p7_ms_per_step=sum(t["ms_per_step"] for t in p7),
               p7_calls_per_step=sum(t["calls_per_step"] for t in p7),
               p7_share=sum(t["ms_per_step"] for t in p7) / busy,
               top=prof["top"][:6])
    out["qwen3moe_smallm"] = res
    print(json.dumps(out), flush=True)


def _flash_slabs(gen, dev, nib: bool, B: int, S: int):
    """Random block-diagonal slabs of 8 kv heads (kv8 codes or kv4 bytes)
    and bf16 scales in [1e-3, 0.021)."""
    R = 64 if nib else 128
    kt = torch.randint(-128, 128, (B, 8 * R, S), generator=gen, device=dev,
                       dtype=torch.int8)
    vt = torch.randint(-128, 128, (B, S, 8 * R), generator=gen, device=dev,
                       dtype=torch.int8)
    ks, vs = ((torch.rand((B, 8, S), generator=gen, device=dev) * 0.02
               + 1e-3).to(torch.bfloat16) for _ in range(2))
    return kt, ks, vt, vs


def bd_flash(tag: str) -> None:
    """#19 and #21 alone, their split scan where the tree has one, and the
    ``engine_bds`` / ``engine_kv4_long`` steps' profiles (``bd_flash`` in
    the docstring)."""
    from lightcompress_tpu_torch.ops import attention as AT

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    out = {"tag": tag, "gpu": C.smi()}
    kernels = (("decode_attention_bd_flash", 4096, False),
               ("decode_attention_bd4_flash", 8192, True))
    for kname, S, _ in kernels:
        run, _, bare, library, _ = C.attn_case(kname, S, dev, gen)
        out[f"{kname}_S{S}"] = {
            "kernel_ms": time_ms(bare, 20, pad),
            "wrapper_ms": time_ms(run, 20, pad),
            "library_ms": time_ms(library, 20, pad)}
    scan = {}
    for kname, _, nib in kernels:
        fn = getattr(AT, kname)
        for S in FLASH_S:
            for B, G in FLASH_BG:
                q = torch.randn((B, 8, G, 128), generator=gen,
                                device=dev).to(torch.bfloat16)
                slabs = _flash_slabs(gen, dev, nib, B, S)
                L = torch.full((B,), S, dtype=torch.int32, device=dev)
                for sb in FLASH_SB:
                    scan[f"{kname}_S{S}_B{B}_G{G}_sb{sb}"] = time_ms(
                        lambda: fn(q, *slabs, L, s_block=sb), 10, pad)
                del slabs
        S = dict((k, s) for k, s, _ in kernels)[kname]
        lo = 1500 if S == 4096 else 3000
        q = torch.randn((8, 8, 4, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        slabs = _flash_slabs(gen, dev, nib, 8, S)
        L = torch.randint(lo, lo + 517, (8,), generator=gen,
                          device=dev).to(torch.int32)
        scan[f"{kname}_S{S}_engine"] = time_ms(
            lambda: fn(q, *slabs, L, s_block=512), 20, pad)
    out["scan"] = scan
    if hasattr(AT, "_bd_flash_launch"):
        split = {}
        for kname, S, nib in kernels:
            B, G = 8, 4
            q = torch.randn((B, 8, G, 128), generator=gen, device=dev).to(
                torch.bfloat16)
            slabs = _flash_slabs(gen, dev, nib, B, S)
            q8, qs = AT.quantize_q(q)
            L = C.ragged_lengths(S, dev)
            outs = [torch.empty(sh, dtype=torch.float32, device=dev)
                    for sh in ((B, 8, G, 128), (B, 8, G), (B, 8, G))]
            for parts in FLASH_PARTS:
                for slots in (1, 2, 3):
                    split[f"{kname}_S{S}_P{parts}_slots{slots}"] = time_ms(
                        lambda: AT._bd_flash_launch(q8, qs, *slabs, L, outs,
                                                    512, parts, slots, nib),
                        20, pad)
            split[f"{kname}_S{S}_picked"] = AT.bd_flash_card_parts(
                B * 8, G, S, 512, nib, dev)
        out["split"] = split
    # every kernel of the step (a tree without PROFILE_TOP lists 12: the
    # old body is among them)
    C.PROFILE_TOP = 1000
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    sw8 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev)
    del model
    vocab = C.LLAMA3_8B.vocab_size
    for name, prompts, kw, kern in (
            ("engine_bds", C.make_prompts(8, vocab, 1500, 2000),
             dict(kv_bits=8, max_len=4096, prefill_buckets=(2048,),
                  attn_impl="bds"), "attn_bd_flash_kernel<4, false>"),
            ("engine_kv4_long", C.make_prompts(8, vocab, 3000, 4000),
             dict(kv_bits=4, max_len=8192, prefill_buckets=(4096,)),
             "attn_bd_flash_kernel<4, true>")):
        prof = C.phase_profile(sw8, prompts, dev, **kw)
        busy = prof["device_busy_ms_per_step"]
        mine = [t for t in prof["top"] if kern in t["name"]]
        out[name] = {k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "kernels_per_step", "lengths", "attn_impl")}
        out[name].update(
            flash_ms_per_step=sum(t["ms_per_step"] for t in mine),
            flash_calls_per_step=sum(t["calls_per_step"] for t in mine),
            flash_share=sum(t["ms_per_step"] for t in mine) / busy,
            top=prof["top"][:6])
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _i8_cache(gen, dev, B: int, S: int):
    """A random int8 hhd cache of 8 kv heads (B, 8, S, 128) with bf16 scales
    in [1e-3, 0.021), and a fresh token: (kq, ks, vq, vs, kn, kns, vn,
    vns)."""
    kq, vq = (torch.randint(-128, 128, (B, 8, S, 128), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, 8, 128), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand((B, 8, S), generator=gen, device=dev) * 0.02
               + 1e-3).to(torch.bfloat16) for _ in range(2))
    kns, vns = ((torch.rand((B, 8), generator=gen, device=dev) * 0.02
                 + 1e-3).to(torch.bfloat16) for _ in range(2))
    return kq, ks, vq, vs, kn, kns, vn, vns


def i8_bd(tag: str) -> None:
    """#17 and #18 alone, their cluster scan where the tree has one, and the
    ``engine_pallas`` / ``engine_bd`` steps' profiles (``i8_bd`` in the
    docstring)."""
    from lightcompress_tpu_torch.ops import attention as AT

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    out = {"tag": tag, "gpu": C.smi()}
    split = hasattr(AT, "split_card_parts")
    for kname, S, case in (("decode_attention_i8", 512, "ragged"),
                           ("decode_attention_i8", 4096, "ragged"),
                           ("decode_attention_bd", 512, "ragged"),
                           ("decode_attention_bd", 4096, "ragged"),
                           ("decode_attention_i8", 512, "engine"),
                           ("decode_attention_bd", 512, "engine")):
        lengths = None if case == "ragged" else torch.randint(
            100, 160, (8,), generator=gen, device=dev).to(torch.int32)
        run, _, bare, library, _ = C.attn_case(kname, S, dev, gen, lengths)
        row = {"kernel_ms": time_ms(bare, 20, pad),
               "wrapper_ms": time_ms(run, 20, pad),
               "library_ms": time_ms(library, 20, pad)}
        if split:
            row["picked"] = list(bare.picked)
            for p in SPLIT_P:
                for slots in (1, 2):
                    per = AT.kv8_columns(S, p)
                    if AT.split_smem_bytes(4, per, slots) <= AT.SMEM_MAX:
                        row[f"P{p}_slots{slots}"] = time_ms(
                            lambda: bare(p, slots), 20, pad)
        out[f"{kname}_S{S}_{case}"] = row
    scan = {}
    for S in I8BD_S:
        for B, G in I8BD_BG:
            q = torch.randn((B, 8, G, 128), generator=gen,
                            device=dev).to(torch.bfloat16)
            L = torch.full((B,), S, dtype=torch.int32, device=dev)
            cache = _i8_cache(gen, dev, B, S)
            slabs = (cache[0].transpose(2, 3).reshape(B, 8 * 128, S)
                     .contiguous(), cache[1],
                     cache[2].transpose(1, 2).reshape(B, S, 8 * 128)
                     .contiguous(), cache[3])
            for kname, fn in (
                    ("decode_attention_i8", lambda: AT.decode_attention_i8(
                        q, *cache, lengths=L)),
                    ("decode_attention_bd", lambda: AT.decode_attention_bd(
                        q, *slabs, L))):
                try:
                    scan[f"{kname}_S{S}_B{B}_G{G}"] = time_ms(fn, 10, pad)
                except (RuntimeError, ValueError) as e:
                    scan[f"{kname}_S{S}_B{B}_G{G}"] = str(e)[:60]
            del cache, slabs
    out["scan"] = scan
    C.PROFILE_TOP = 1000
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    sw8 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev)
    del model
    prompts = C.make_prompts(8, C.LLAMA3_8B.vocab_size)
    for name, impl, kerns in (
            ("engine_pallas", "pallas", ("attn_i8_kernel",
                                         "attn_split_kernel<4, true>",
                                         "attn_split_kernel<4, 1>")),
            ("engine_bd", "bd", ("attn_bd_kernel<4, false>",
                                 "attn_split_kernel<4, false>",
                                 "attn_split_kernel<4, 0>"))):
        prof = C.phase_profile(sw8, prompts, dev, attn_impl=impl)
        busy = prof["device_busy_ms_per_step"]
        mine = [t for t in prof["top"] if any(k in t["name"] for k in kerns)]
        out[name] = {k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "kernels_per_step", "lengths", "attn_impl")}
        out[name].update(
            attn_ms_per_step=sum(t["ms_per_step"] for t in mine),
            attn_calls_per_step=sum(t["calls_per_step"] for t in mine),
            attn_share=sum(t["ms_per_step"] for t in mine) / busy,
            top=prof["top"][:6])
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _share(prof, match) -> dict:
    """A profile's wall and busy ms a step, idle share, and the share of
    the busy time in the kernels whose names ``match`` accepts."""
    mine = [t for t in prof["top"] if match(t["name"])]
    res = {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                "idle_share", "kernels_per_step")}
    res.update(kernel_ms_per_step=sum(t["ms_per_step"] for t in mine),
               kernel_calls_per_step=sum(t["calls_per_step"] for t in mine),
               kernel_share=sum(t["ms_per_step"] for t in mine)
               / prof["device_busy_ms_per_step"],
               top=prof["top"][:6])
    return res


def _is_p20(name: str) -> bool:
    return "attn_bd_kernel<4, true>" in name or \
        "attn_split_kernel<4, 2>" in name


def _is_p8(name: str) -> bool:
    return "w4a8_gathered_kernel" in name or (
        "planes_decode_kernel" in name and "true>" in name)


def gathered_bd4(tag: str) -> None:
    """#8 and #20 alone, #20's cluster scan where the tree has one, and the
    ``engine_kv4``, ``engine_fused_s4`` and 4-slot ``engine_moe_small``
    steps' profiles (``gathered_bd4`` in the docstring)."""
    from lightcompress_tpu_torch.ops import attention as AT

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED + 4)
    out = {"tag": tag, "gpu": C.smi()}
    p8 = {}
    for name, N, K, pair in C.MOE_SHAPES:
        w3 = (torch.randn((C.MOE_E, N, K), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
        qp = QM.quantize_linear_stacked(w3, C.WSPEC)
        del w3
        wd = QM.dequant_weight_stacked(qp, torch.bfloat16)
        wa = (qp.codes, qp.scales, qp.zeros)
        for n in GB_N:
            topi = C.seeded_topi(n, gen, dev)
            e_idx = topi.reshape(-1).to(torch.int32)
            n_sel = e_idx.shape[0]
            t_idx = (torch.arange(n_sel, device=dev) if pair else
                     torch.arange(n, device=dev).repeat_interleave(
                         C.MOE_TOP_K)).to(torch.int32)
            x = torch.randn((n_sel if pair else n, K), generator=gen,
                            device=dev).to(torch.bfloat16)
            xq, xs = W.quantize_act_per_token(x)
            wsel = wd[e_idx.long()]
            xsel = x[t_idx.long()][:, None]
            row = {"n_sel": n_sel,
                   "experts": len(torch.unique(e_idx)),
                   "kernel_ms": time_ms(lambda: M.w4a8_gathered_matmul(
                       xq, xs, *wa, e_idx, t_idx), 20, pad),
                   "library_ms": time_ms(lambda: torch.bmm(
                       xsel, wsel.transpose(1, 2)), 20, pad)}
            p8[f"n{n}_{name}"] = row
            del wsel
        del qp, wd
        gc.collect()
        torch.cuda.empty_cache()
    for n in GB_N:
        p8[f"n{n}_sum"] = {k: sum(p8[f"n{n}_{nm}"][k]
                                  for nm, _, _, _ in C.MOE_SHAPES)
                           for k in ("kernel_ms", "library_ms")}
    out["p8"] = p8
    gen.manual_seed(C.SEED)
    kname = "decode_attention_bd4"
    for S, case in ((4096, "ragged"), (512, "ragged"), (4096, "engine")):
        lengths = None if case == "ragged" else torch.randint(
            1500, 2017, (8,), generator=gen, device=dev).to(torch.int32)
        run, _, bare, library, _ = C.attn_case(kname, S, dev, gen, lengths)
        row = {"kernel_ms": time_ms(bare, 20, pad),
               "wrapper_ms": time_ms(run, 20, pad),
               "library_ms": time_ms(library, 20, pad)}
        if hasattr(bare, "picked"):
            row["picked"] = list(bare.picked)
            for p in SPLIT_P:
                for slots in (1, 2):
                    per = AT.kv8_columns(S, p)
                    if AT.split_smem_bytes(4, per, slots, "bd4") \
                            <= AT.SMEM_MAX:
                        row[f"P{p}_slots{slots}"] = time_ms(
                            lambda: bare(p, slots), 20, pad)
        out[f"p20_S{S}_{case}"] = row
    scan = {}
    for S in GB_S:
        for B, G in GB_BG:
            q = torch.randn((B, 8, G, 128), generator=gen,
                            device=dev).to(torch.bfloat16)
            L = torch.full((B,), S, dtype=torch.int32, device=dev)
            kt, vt = (torch.randint(-128, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8)
                      for shape in ((B, 8 * 64, S), (B, S, 8 * 64)))
            ks, vs = ((torch.rand((B, 8, S), generator=gen, device=dev)
                       * 0.02 + 1e-3).to(torch.bfloat16) for _ in range(2))
            try:
                scan[f"S{S}_B{B}_G{G}"] = time_ms(
                    lambda: AT.decode_attention_bd4(q, kt, ks, vt, vs, L),
                    10, pad)
            except (RuntimeError, ValueError) as e:
                scan[f"S{S}_B{B}_G{G}"] = str(e)[:60]
            del kt, vt
    out["p20_scan"] = scan
    C.PROFILE_TOP = 1000
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    sw8 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev)
    C.set_gammas(model, C.SEED + 2)
    sws4 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev,
                                   **C.S4_FUSED)
    del model
    kv4 = dict(kv_bits="auto", max_len=4096, prefill_buckets=(2048,))
    prompts = C.make_prompts(8, C.LLAMA3_8B.vocab_size, 1500, 2000)
    out["engine_kv4"] = _share(C.phase_profile(sw8, prompts, dev, **kv4),
                               _is_p20)
    del sw8
    out["engine_fused_s4"] = _share(C.phase_profile(
        sws4, prompts, dev, build="fused_s4", **kv4), _is_p20)
    del sws4
    gc.collect()
    torch.cuda.empty_cache()
    swm, _ = C.phase_setup_moe(dev)
    out["engine_moe_small"] = _share(C.phase_profile(
        swm, C.make_prompts(4, C.MIXTRAL_8X7B.vocab_size), dev,
        build="moe_small", max_slots=4), _is_p8)
    print(json.dumps(out), flush=True)


# attn_rows' (kernel, S): chip_smoke's attention rows
ATTN_ROWS = (("decode_attention_i8", 512), ("decode_attention_i8", 4096),
             ("decode_attention_bd", 512), ("decode_attention_bd", 4096),
             ("decode_attention_bd4", 4096),
             ("decode_attention_bd_flash", 4096),
             ("decode_attention_bd4_flash", 8192))


def attn_rows(tag: str) -> None:
    """The attention kernels' bare launches (``attn_rows`` in the
    docstring)."""
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    out = {"tag": tag, "gpu": C.smi()}
    for kname, S in ATTN_ROWS:
        _, _, bare, _, _ = C.attn_case(kname, S, dev, gen)
        out[f"{kname}_S{S}"] = time_ms(bare, 50, pad)
    print(json.dumps(out), flush=True)


# flash_stamps' points (the kernel's FLASH_STAMP ids)
FLASH_POINTS = {0: "start", 1: "prologue", 2: "k_waited", 3: "k_mma",
                4: "k_refilled", 5: "k_scored", 6: "scores_done",
                7: "max_met", 8: "softmax_done", 9: "sums_met",
                10: "p8_made", 11: "v_waited", 12: "v_mma", 13: "v_refilled",
                14: "pv_done", 15: "pv_met", 16: "blocks_done", 17: "merged"}


def flash_stamps(tag: str) -> None:
    """#19/#21's phase times from %globaltimer stamps (``flash_stamps`` in
    the docstring)."""
    import ctypes
    import os
    import subprocess

    from lightcompress_tpu_torch.ops import _build
    from lightcompress_tpu_torch.ops import attention as AT

    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    out = {"tag": tag, "gpu": C.smi()}
    work = os.path.abspath(os.path.join("build", "flash_stamps"))
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libstamps.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DLC_FLASH_STAMPS",
                    "-I", str(_build.CSRC), "-o", so,
                    str(_build.CSRC / "decode_attention.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lc_attn_bd_flash.argtypes = [P] * 12 + [I] * 8 + [P]
    lib.lc_attn_bd_flash.restype = I
    lib.lc_flash_stamps.argtypes = [P]
    lib.lc_flash_stamps.restype = I
    buf = (ctypes.c_ulonglong * 2048)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, G, sb = 8, 4, 512
    for kname, S, nib in (("decode_attention_bd_flash", 4096, False),
                          ("decode_attention_bd4_flash", 8192, True)):
        q = torch.randn((B, 8, G, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        kt, ks, vt, vs = _flash_slabs(gen, dev, nib, B, S)
        q8, qs = AT.quantize_q(q)
        L = C.ragged_lengths(S, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = (torch.empty((B, 8, G, 128), **f32),
                torch.empty((B, 8, G), **f32), torch.empty((B, 8, G), **f32))
        for parts in (1, 8):
            part = torch.empty(B * 8 * parts * G * 130, **f32)
            cnt = torch.zeros(B * 8, dtype=torch.int32, device=dev)
            spans = {}
            for rep in range(6):
                pad.zero_()
                rc = lib.lc_attn_bd_flash(
                    q8.data_ptr(), qs.data_ptr(), kt.data_ptr(),
                    ks.data_ptr(), vt.data_ptr(), vs.data_ptr(),
                    L.data_ptr(), *(t.data_ptr() for t in outs),
                    part.data_ptr(), cnt.data_ptr(), B, 8, G, S, sb, parts,
                    3, int(nib), stream)
                torch.cuda.synchronize()
                n = lib.lc_flash_stamps(buf)
                if rc or n < 0:
                    raise RuntimeError(f"stamps: CUDA error {rc} {n}")
                pts = [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]
                if rep == 0:
                    continue
                for (a, ta), (b, tb) in zip(pts, pts[1:]):
                    key = f"{FLASH_POINTS[a]}->{FLASH_POINTS[b]}"
                    spans.setdefault(key, []).append(tb - ta)
                spans.setdefault("total", []).append(pts[-1][1] - pts[0][1])
            out[f"{kname}_S{S}_P{parts}"] = {
                k: {"median_ns": statistics.median(v), "count": len(v) // 5,
                    "sum_ns": sum(v) / 5}
                for k, v in spans.items()}
    print(json.dumps(out), flush=True)


def profile_w4a16(tag: str) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SEED)
    model = C.Llama(C.LLAMA3_8B, C.init_params(gen, C.LLAMA3_8B))
    sw8 = C.build_serving_weights(model, C.WSPEC, act_bits=8, device=dev)
    del model
    out = C.phase_profile(dataclasses.replace(sw8, act_bits=16),
                          C.make_prompts(8, C.LLAMA3_8B.vocab_size), dev,
                          build="w4a16")
    print(json.dumps({"tag": tag, "gpu": C.smi(), "profile_w4a16": out}),
          flush=True)


if __name__ == "__main__":
    mode = sys.argv[2] if len(sys.argv) > 2 else ""
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if mode == "w4a16_profile":
        profile_w4a16(tag)
    elif mode == "stacked":
        stacked_ms(tag)
    elif mode == "fused_s4":
        fused_s4_ms(tag)
    elif mode == "engines":
        engines(tag)
    elif mode == "planes":
        planes_ms(tag)
    elif mode == "planes_engines":
        planes_engines(tag)
    elif mode == "kv8_w8":
        kv8_w8(tag)
    elif mode == "smallm_s4":
        smallm_s4(tag)
    elif mode == "smallm_engine":
        smallm_engine(tag)
    elif mode == "s4_parts":
        s4_parts(tag)
    elif mode == "bd_flash":
        bd_flash(tag)
    elif mode == "flash_stamps":
        flash_stamps(tag)
    elif mode == "attn_rows":
        attn_rows(tag)
    elif mode == "i8_bd":
        i8_bd(tag)
    elif mode == "gathered_bd4":
        gathered_bd4(tag)
    else:
        main(tag, mode == "tail")
