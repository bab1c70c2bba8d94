"""The YAML config (port of lightcompress_tpu/config.py): the reference's
single-YAML layout (sections ``base/model/calib/eval/quant|sparse/save``)
in an attribute-access dict, with its checks.

PyYAML is imported only by ``load_config``: a config may also be built in
code as a ``DotDict`` (the machine with the card has no PyYAML).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional


class DotDict(dict):
    """dict with attribute access, recursively."""

    def __init__(self, d: Optional[Dict] = None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, DotDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __deepcopy__(self, memo):
        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def load_config(path: str) -> DotDict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg = DotDict(cfg)
    check_config(cfg)
    return cfg


def _check_weight_cfg(w: DotDict) -> None:
    gran = w.get("granularity", "per_channel")
    if gran == "per_group" and "group_size" not in w:
        raise ValueError("per_group weight quant requires "
                         "quant.weight.group_size")
    if gran == "per_block" and "block_size" not in w:
        raise ValueError("per_block weight quant requires "
                         "quant.weight.block_size")
    bit = w.get("bit", 8)
    if isinstance(bit, int) and not (1 <= bit <= 16 or bit == 48):
        raise ValueError(f"unsupported integer bit-width {bit}")
    if isinstance(bit, str) and bit not in ("e4m3", "e5m2", "e3m2", "e2m1",
                                            "e4m7"):
        raise ValueError(f"unsupported float format {bit!r}")


def check_config(config: DotDict) -> None:
    """The invariants the pipeline relies on (the JAX ``check_config``)."""
    if "model" not in config:
        raise ValueError("config must have a 'model' section")
    quant = config.get("quant", None)
    if quant is not None:
        keys = [k for k in ("language", "vision", "video_gen") if k in quant]
        for qc in [quant[k] for k in keys] or [quant]:
            if "weight" in qc:
                _check_weight_cfg(qc.weight)
            for sub in ("w_1", "w_2"):
                if sub in qc:
                    _check_weight_cfg(qc[sub])
    calib = config.get("calib", None)
    if calib is not None and "n_samples" in calib and calib.n_samples <= 0:
        raise ValueError("calib.n_samples must be positive")


def get_modalities(config: DotDict) -> List[str]:
    """['language'] unless the compression section nests per-modality
    sub-configs."""
    for section in ("quant", "sparse"):
        sec = config.get(section, None)
        if sec is None:
            continue
        mods = [k for k in ("vision", "language", "video_gen") if k in sec]
        return mods or ["language"]
    return ["language"]


def get_compress_config(config: DotDict, modality: str) -> DotDict:
    """The per-modality compression sub-config, or the flat section."""
    for section in ("quant", "sparse"):
        sec = config.get(section, None)
        if sec is None:
            continue
        if modality in sec:
            sub = copy.deepcopy(sec[modality])
            if "method" not in sub and "method" in sec:
                sub["method"] = sec["method"]
            return sub
        return sec
    return DotDict()
