"""Reader and writer of the ``.safetensors`` format, with numpy and torch
only (the machines the port runs on need not have the ``safetensors``
package).

The format: 8 bytes of little-endian header length N, then N bytes of a
JSON header ``{name: {"dtype", "shape", "data_offsets": [begin, end]},
"__metadata__": {...}}``, then the tensors' raw little-endian bytes, the
offsets counted from the end of the header.

The reader maps the file (``np.memmap``, copy-on-write): a tensor it
returns is a view of the page cache until someone converts or writes it,
so a 10 GB float32 U-Net file never sits twice in host memory.  Numpy has
no bfloat16: BF16 is read as uint16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U8": np.uint8, "BOOL": np.bool_}
_NAME = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
         torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
         torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def read_header(path: str) -> Tuple[Dict, int]:
    """(the header without ``__metadata__``, the byte offset where the
    tensor data starts).  Reads the header only."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_shapes(path: str) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} from the header alone (no tensor bytes are read)."""
    header, _ = read_header(path)
    return {k: tuple(v["shape"]) for k, v in header.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor}, each a view of the mapped file."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        dtype = info["dtype"]
        if dtype not in _NUMPY:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = np.dtype(_NUMPY[dtype]).itemsize
        if end - begin != math.prod(shape) * itemsize or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end}, "
                             f"which do not hold {dtype} {list(shape)}")
        arr = mm[start + begin:start + end].view(_NUMPY[dtype]).reshape(shape)
        if arr.ctypes.data % itemsize:       # a writer that did not align the data
            arr = arr.copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) to
    ``path``, each stored in ``dtype`` where given: one tensor at a time,
    so the host holds at most one copy of one tensor; the file appears
    whole under its name or not at all.  The data are ordered by element
    size, then name, and the header is padded to 8 bytes, so every tensor
    starts aligned."""
    items = []
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(t))
        stored = dtype or t.dtype
        if stored not in _NAME:
            raise ValueError(f"tensor {name!r} has unsupported dtype {stored}")
        items.append((name, t, stored))
    items.sort(key=lambda it: (-it[2].itemsize, it[0]))
    header, offset = {}, 0
    for name, t, stored in items:
        n = t.numel() * stored.itemsize
        header[name] = {"dtype": _NAME[stored], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t, stored in items:
            t = t.detach().to(stored).to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)
