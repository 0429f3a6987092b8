"""The safetensors file format, read and written without the safetensors
package (absent on the card's machine).

Layout: an 8-byte little-endian header length n, n bytes of JSON (name →
``{"dtype", "shape", "data_offsets": [begin, end]}``, plus an optional
``"__metadata__"`` of strings), then the tensors' bytes, offsets relative
to the end of the header. Tensors are row-major and little-endian.

``SafeTensorsFile`` maps the file (``mmap``, copy-on-write so that torch
gets a writable buffer; nothing is written back) and hands out CPU tensors
that view it through ``torch.frombuffer``: an 8B checkpoint is read from
the page cache once, never held twice in host memory by a whole-file
``read()``. dtypes F32, F16, BF16 and I8 are served; any other raises.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8}
_NAMES = {v: k for k, v in DTYPES.items()}
_ALIGN = 8


class SafeTensorsFile:
    """One ``*.safetensors`` file, mapped. Tensors it returns share the
    mapping, which stays open while any of them lives."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
            (n,) = struct.unpack("<Q", f.read(8))
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} exceeds the file")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
        self._data = 8 + n
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries: dict[str, dict[str, Any]] = header
        for name, e in header.items():
            begin, end = e["data_offsets"]
            if not 0 <= begin <= end <= size - self._data:
                raise ValueError(f"{path}: {name}'s data_offsets {e['data_offsets']} leave the file")

    def keys(self) -> list[str]:
        return list(self._entries)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor viewing the mapped file."""
        e = self._entries[name]
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(
                f"{self.path}: tensor {name!r} has dtype {e['dtype']}; supported: "
                f"{', '.join(DTYPES)}"
            )
        shape = tuple(int(d) for d in e["shape"])
        begin, end = e["data_offsets"]
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes, shape {shape} "
                             f"needs {count * itemsize}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=self._data + begin).reshape(shape)


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (CPU tensors of the served dtypes) as one
    safetensors file, tensor by tensor."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {list(DTYPES.values())}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)
