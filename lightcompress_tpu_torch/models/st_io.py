"""The safetensors format, read and written without the ``safetensors``
package (which the machine with the card lacks).

A file is an 8-byte little-endian header length N, N bytes of JSON (per
tensor ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the
data that follows; an optional ``__metadata__`` of strings), then the raw
little-endian tensor bytes.  The reader maps the file and copies one tensor
at a time onto the requested device, so the host never holds a checkpoint
twice; the writer streams tensor by tensor.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# dtype name -> (numpy type of the raw bytes, torch dtype); BF16 and the
# e4m3/e5m2 codes arrive as raw uint16/uint8 and are reinterpreted, never
# converted (numpy has no such types: the reader needs none)
DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "F64": (np.float64, torch.float64),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I16": (np.int16, torch.int16),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
}
# the torch dtypes whose bytes are read as another numpy type
_VIEWED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
_NAMES = {t: name for name, (_, t) in DTYPES.items()}


def read_header(path: str) -> Tuple[Dict, int]:
    """(header without ``__metadata__``, offset of the data section)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile:
    """One mapped ``.safetensors`` file."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._data = read_header(path)
        with open(path, "rb") as f:
            # copy-on-write: the arrays over it are writable (torch takes
            # them without a warning) and nothing is written back
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if os.fstat(f.fileno()).st_size else None)

    def keys(self) -> Iterable[str]:
        return self.header.keys()

    def get(self, key: str, device: torch.device,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The tensor ``key`` on ``device`` (cast to ``dtype`` there)."""
        info = self.header[key]
        if info["dtype"] not in DTYPES:
            raise NotImplementedError(
                f"{key}: safetensors dtype {info['dtype']} is not read "
                f"(the port reads {sorted(DTYPES)})")
        np_t, torch_t = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        a = np.frombuffer(self._map, dtype=np_t, count=(end - begin)
                          // np.dtype(np_t).itemsize,
                          offset=self._data + begin)
        t = torch.from_numpy(a.reshape(info["shape"]))
        if torch_t in _VIEWED:
            t = t.view(torch_t)
        # the copy onto the device (or a host copy) leaves the map
        t = t.to(device, copy=True)
        return t if dtype is None else t.to(dtype)

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None


def write(path: str, tensors: Dict[str, torch.Tensor],
          metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any dtype of ``DTYPES``, any device) in key order,
    one at a time; returns the bytes written."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    keys = sorted(tensors)
    for k in keys:
        t = tensors[k]
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"{k}: dtype {t.dtype} is not written")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data section starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in keys:
            t = tensors[k].detach().contiguous()
            if t.dtype in _VIEWED:
                t = t.view(torch.int16 if t.dtype == torch.bfloat16
                           else torch.uint8)
            f.write(memoryview(t.cpu().numpy()).cast("B"))
    return 8 + len(blob) + offset
