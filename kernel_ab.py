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
and busy ms a step, the idle share, kernels a step."""

import dataclasses
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
    if sys.argv[2:3] == ["w4a16_profile"]:
        profile_w4a16(sys.argv[1])
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "tree",
             sys.argv[2:3] == ["tail"])
