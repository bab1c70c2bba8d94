"""QuantSpec — frozen quantization specification (port of
lightcompress_tpu/quant/spec.py).

Integer formats: bit in 2..16, symmetric or asymmetric, an optional
custom ``int_range``.  Float formats: bit in ``FLOAT_FORMATS`` (e4m3,
e5m2, e3m2, e2m1, e4m7).  Granularities: per_tensor, per_channel,
per_group (``group_size``), per_head (``head_num``) and per_block
(``block_size``, symmetric minmax only).  Ranges (``calib_algo``): minmax,
mse (the shrink grid), learnable (sigmoid clip factors), hqq (proximal
zero points); the static act ranges static_minmax, static_moving_minmax
and static_hist.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

# name -> (exponent bits, mantissa bits, qmax); e4m3's qmax is
# float8_e4m3fn's largest value, e5m2's float8_e5m2's
FLOAT_FORMATS = {
    "e4m3": (4, 3, 448.0),
    "e5m2": (5, 2, 57344.0),
    "e3m2": (3, 2, 28.0),
    "e2m1": (2, 1, 6.0),
    "e4m7": (4, 7, 510.0),
}

GRANULARITIES = ("per_tensor", "per_channel", "per_group", "per_head",
                 "per_block")

# the algorithms that train through the rounding (ROADMAP A8)
TRAINED = "OmniQuant, NormTweaking, TesseraQ"


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bit: Union[int, str] = 8
    symmetric: bool = True
    granularity: str = "per_channel"
    group_size: int = 0
    head_num: int = 0
    block_size: int = 0
    calib_algo: str = "minmax"
    round_zp: bool = True
    int_range: Optional[Tuple[int, int]] = None
    # the mse range's shrink grid
    mse_b_num: int = 1
    maxshrink: float = 0.8
    mse_grid: int = 100
    # the hqq range's proximal steps
    lp_norm: float = 0.7
    beta: float = 10.0
    kappa: float = 1.01
    iters: int = 20
    # straight-through rounding: only the trained algorithms need it
    ste: bool = False
    # float fake quant: "hw" rounds to nearest even on the format's grid
    # scaled so that the range's max maps to the format's max;
    # "ref_manual" takes a power-of-two scale from each element's exponent
    float_mode: str = "hw"

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.granularity == "per_group" and self.group_size <= 0:
            raise ValueError("per_group requires group_size > 0")
        if self.granularity == "per_head" and self.head_num <= 0:
            raise ValueError("per_head requires head_num > 0")
        if self.granularity == "per_block":
            if self.block_size <= 0:
                raise ValueError("per_block requires block_size > 0")
            if not (self.symmetric and self.calib_algo == "minmax"):
                raise ValueError("per_block requires symmetric minmax")
        if self.is_float and self.bit not in FLOAT_FORMATS:
            raise ValueError(f"unknown float format {self.bit!r}")
        if self.ste:
            raise NotImplementedError(
                f"ste (straight-through rounding, for the trained "
                f"algorithms {TRAINED}) is not ported: ROADMAP A8")

    @property
    def is_float(self) -> bool:
        return isinstance(self.bit, str)

    @property
    def e_bits(self) -> int:
        return FLOAT_FORMATS[self.bit][0]

    @property
    def m_bits(self) -> int:
        return FLOAT_FORMATS[self.bit][1]

    @property
    def qmin(self) -> float:
        if self.is_float:
            return -FLOAT_FORMATS[self.bit][2]
        if self.int_range is not None:
            return float(self.int_range[0])
        if self.symmetric:
            return float(-(2 ** (self.bit - 1)))
        return 0.0

    @property
    def qmax(self) -> float:
        if self.is_float:
            return FLOAT_FORMATS[self.bit][2]
        if self.int_range is not None:
            return float(self.int_range[1])
        if self.symmetric:
            return float(2 ** (self.bit - 1) - 1)
        return float(2**self.bit - 1)

    @property
    def dst_nbins(self) -> int:
        if self.is_float:
            return 2 ** (self.e_bits + self.m_bits + 1)
        return 2**self.bit

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


def spec_from_config(cfg: dict, extra: Optional[dict] = None) -> QuantSpec:
    """A QuantSpec from a config's ``quant.weight`` / ``quant.act``
    sub-dict (bit, symmetric, granularity, group_size, calib_algo, ...);
    unknown keys are ignored, ``per_token`` is per_channel and
    ``use_qtorch`` picks the float mode."""
    cfg = dict(cfg or {})
    cfg.update(extra or {})
    if cfg.get("granularity") == "per_token":
        cfg["granularity"] = "per_channel"
    if "use_qtorch" in cfg and "float_mode" not in cfg:
        cfg["float_mode"] = "hw" if cfg["use_qtorch"] else "ref_manual"
    known = {f.name for f in dataclasses.fields(QuantSpec)}
    kwargs = {k: v for k, v in cfg.items() if k in known}
    if kwargs.get("int_range") is not None:
        kwargs["int_range"] = tuple(kwargs["int_range"])
    return QuantSpec(**kwargs)
