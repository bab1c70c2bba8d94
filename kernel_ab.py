"""Time the planes W4A8 kernels of the tree in the working directory on one
NVIDIA GPU, for comparing two trees (designs) in one call:

    cd <tree> && python3 <repo>/kernel_ab.py TAG

#3 over a Llama-3-8B block's seven linears and the fused q|k|v and
gate|up at M 1024, #9 over a Mixtral-8x7B layer's grouped prefill (1024
tokens), #5 at the bench's down (N 4096, K 14336) at B 1, 8 and 32; the
median of CUDA-event times with L2 flushed and the card held in a spin
while the host enqueues each call (``time_ms`` below, the same in every
tree).  The shapes and helpers come from the tree's ``chip_smoke.py``.
Prints one JSON line: ms by kernel and shape, the card's name and power
limit."""

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


def main(tag: str) -> None:
    dev = torch.device("cuda")
    pad = torch.empty(C.PAD, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tag": tag, "gpu": C.smi()}
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
