"""QuantSpec — frozen quantization specification (port of
lightcompress_tpu/quant/spec.py, integer formats only in this slice)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

GRANULARITIES = ("per_tensor", "per_channel", "per_group")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bit: int = 8
    symmetric: bool = True
    granularity: str = "per_channel"
    group_size: int = 0
    calib_algo: str = "minmax"
    round_zp: bool = True
    int_range: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.granularity == "per_group" and self.group_size <= 0:
            raise ValueError("per_group requires group_size > 0")
        if not isinstance(self.bit, int):
            raise ValueError("only integer formats are ported")
        if self.calib_algo != "minmax":
            raise ValueError("only the minmax range is ported")

    @property
    def qmin(self) -> float:
        if self.int_range is not None:
            return float(self.int_range[0])
        if self.symmetric:
            return float(-(2 ** (self.bit - 1)))
        return 0.0

    @property
    def qmax(self) -> float:
        if self.int_range is not None:
            return float(self.int_range[1])
        if self.symmetric:
            return float(2 ** (self.bit - 1) - 1)
        return float(2**self.bit - 1)

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


def spec_from_config(cfg: dict) -> QuantSpec:
    """A QuantSpec from a config's ``quant.weight`` sub-dict (the JAX
    ``spec_from_config``); what the port's quantizer does not have raises
    ``NotImplementedError`` naming ROADMAP A2."""
    cfg = dict(cfg or {})
    if cfg.get("granularity") == "per_token":
        cfg["granularity"] = "per_channel"
    bit = cfg.get("bit", 8)
    unported = [
        (not isinstance(bit, int) or bit == 48, f"bit {bit!r}"),
        (cfg.get("granularity", "per_channel") not in GRANULARITIES,
         f"granularity {cfg.get('granularity')!r}"),
        (cfg.get("calib_algo", "minmax") != "minmax",
         f"calib_algo {cfg.get('calib_algo')!r}"),
        (bool(cfg.get("ste")), "ste"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"quantizer {what} is not ported: "
                                      f"ROADMAP A2")
    known = {f.name for f in dataclasses.fields(QuantSpec)}
    kwargs = {k: v for k, v in cfg.items() if k in known}
    if kwargs.get("int_range") is not None:
        kwargs["int_range"] = tuple(kwargs["int_range"])
    return QuantSpec(**kwargs)
