"""``device.bf16_ulp``, the one-ulp gate of the on-card bf16 comparisons:
the spacing of bf16 numbers at |v|, read off torch's own bf16 grid."""

import pytest
import torch

from lightcompress_tpu_torch.device import bf16_ulp


def _spacing(v: float) -> float:
    """The gap from the bf16 number at or below |v| (its f32 bits with the
    low 16 cleared) to the next one up."""
    bits = torch.tensor(abs(v), dtype=torch.float32).view(torch.int32)
    lo = bits & ~0xFFFF
    pair = torch.stack([lo, lo + 0x10000]).view(torch.float32)
    assert bool((pair.to(torch.bfloat16).float() == pair).all())
    return float(pair[1] - pair[0])


@pytest.mark.parametrize("e", [-20, -8, -1, 0, 1, 3, 7, 15])
@pytest.mark.parametrize("m", [1.0, 1.0 + 2.0 ** -7, 1.25, 1.5, 1.9999])
def test_bf16_ulp_is_the_spacing(e, m):
    """At powers of two (m = 1) and between them the helper gives the bf16
    spacing: 2^(e - 7) for |v| in [2^e, 2^(e + 1)), the same for -v."""
    v = m * 2.0 ** e
    assert bf16_ulp(v) == _spacing(v) == 2.0 ** (e - 7)
    assert bf16_ulp(-v) == bf16_ulp(v)
    # the old gate, 2^-8 |v|, is half an ulp at a power of two and below
    # one ulp between them
    assert 2.0 ** -8 * v <= bf16_ulp(v) and (m > 1 or
                                             2.0 ** -8 * v < bf16_ulp(v))


def test_bf16_ulp_edges():
    assert bf16_ulp(0.0) == 0.0
    assert bf16_ulp(2.0 ** -130) == 2.0 ** -133  # subnormal spacing
    assert bf16_ulp(float(torch.finfo(torch.bfloat16).max)) == 2.0 ** 120
