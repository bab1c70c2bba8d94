"""Phase timing and tracing (port of lightcompress_tpu/utils/profiling.py).

``PhaseTimer``: hierarchical wall-clock phases (``with t.phase("block"):``
inside ``with t.phase("block_loop/Awq"):`` records ``block_loop/Awq`` and
``block_loop/Awq/block``), synchronised on the card at each phase's start
and end; ``report`` gives ``{name: {count, total_s, mean_s}}`` plus
``__wall__``, JAX's JSON.  ``device_trace``: a ``torch.profiler`` trace of
the enclosed code (CPU activity, and CUDA activity on the card) written as
a Chrome trace into a directory; a no-op when the directory is falsy.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, List, Optional

import torch

log = logging.getLogger("lightcompress_tpu_torch")


def sync(device: Optional[torch.device]) -> None:
    """Wait for the card's queued work (no-op off the card)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Phases with the same full name accumulate (count, total seconds)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._acc: Dict[str, List[float]] = {}
        self._stack: List[str] = []
        self.t0 = time.monotonic()

    @contextlib.contextmanager
    def phase(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        sync(self.device)
        start = time.monotonic()
        try:
            yield
        finally:
            sync(self.device)
            dt = time.monotonic() - start
            self._stack.pop()
            cnt_tot = self._acc.setdefault(full, [0, 0.0])
            cnt_tot[0] += 1
            cnt_tot[1] += dt

    def total(self, name: str) -> float:
        """Seconds of every phase of that full name (0 if none ran)."""
        return self._acc.get(name, [0, 0.0])[1]

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, (cnt, tot) in sorted(self._acc.items()):
            out[name] = {"count": cnt, "total_s": round(tot, 4),
                         "mean_s": round(tot / max(cnt, 1), 4)}
        out["__wall__"] = {"count": 1,
                           "total_s": round(time.monotonic() - self.t0, 4),
                           "mean_s": 0.0}
        return out

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
        return path

    def log_report(self, top: int = 20) -> None:
        for name, r in list(self.report().items())[:top]:
            log.info("PROFILE %-40s n=%-5d total=%8.3fs mean=%7.4fs",
                     name, r["count"], r["total_s"], r["mean_s"])


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str],
                 device: Optional[torch.device] = None):
    """``torch.profiler`` over the enclosed code, exported as a Chrome
    trace ``<trace_dir>/block_loop.<pid>.<ns>.pt.trace.json``; CUDA
    activity on a ``cuda`` device.  No-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        sync(device)
    path = os.path.join(trace_dir, f"block_loop.{os.getpid()}."
                                   f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
