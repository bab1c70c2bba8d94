"""PyTorch/CUDA port of lightcompress_tpu: the checkpoint loader, the
quantizer core, RTN, AWQ, GPTQ, HQQ and SmoothQuant calibration, the PPL
evals and the pipeline, the W4 serving engine and the bench's decode
stack.

Mirrors the JAX package's module paths.  Imports ``torch`` only; the
kernels are CUDA C++ for Hopper (``ops/csrc``), built at first use.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
