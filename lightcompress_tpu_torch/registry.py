"""String-keyed factory registries (port of lightcompress_tpu/registry.py):
the pipeline looks up models, algorithms, calibration preprocessors and
KV-cache quantizers by the names a config gives."""

from __future__ import annotations

from typing import Any, Callable


class Register(dict):
    """A dict-backed registry usable as a decorator: ``@MODEL_REGISTRY``
    keys by the class name, ``@MODEL_REGISTRY.register("Alias")`` by an
    explicit one."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def register(self, key: str) -> Callable:
        def deco(obj: Any) -> Any:
            if key in self:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self[key] = obj
            return obj

        return deco

    def __call__(self, obj: Any) -> Any:
        return self.register(obj.__name__)(obj)

    def __missing__(self, key: str):
        raise KeyError(f"{key!r} not found in {self.name}; available: "
                       f"{sorted(self.keys())}")


MODEL_REGISTRY = Register("MODEL_REGISTRY")
ALGO_REGISTRY = Register("ALGO_REGISTRY")
PREPROC_REGISTRY = Register("PREPROC_REGISTRY")
KV_REGISTRY = Register("KV_REGISTRY")
