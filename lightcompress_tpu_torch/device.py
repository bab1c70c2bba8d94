"""Device resolution for the port.

Every entry point runs on the CUDA card unless the caller asks for the
CPU by name.  Without a card and without that request it raises: the
port never falls back to the CPU on its own.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightcompress_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _scalar(value: float, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as IEEE division on every device.  PyTorch's CUDA kernels
    divide by a Python number by multiplying with its reciprocal, which can
    land one ulp away; the quantizers round at exact ties (bf16 weights hit
    them often), so their codes would then differ between the card, the
    CPU and the JAX package.  Dividing by a 0-d tensor on ``t``'s device
    takes the true division."""
    return t / _scalar(float(d), t.device, t.dtype)


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at |v|: 2^(floor(log2 |v|) - 7), one
    unit in the last place of a bf16 value of that magnitude (2^-133 among
    the subnormals, 0 at 0).  The on-card gates of bf16 outputs allow one
    ulp at the largest |y|."""
    if v == 0:
        return 0.0
    _, e = math.frexp(abs(v))  # |v| = m * 2^e, 0.5 <= m < 1
    return math.ldexp(1.0, max(e - 8, -133))
