"""The safetensors file format, read and written without the safetensors
package (the CUDA host has none).

A file is an 8-byte little-endian u64 N, N bytes of JSON header, then the
raw little-endian tensor data. The header maps each name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (offsets into the data, which the
tensors cover without holes) and may hold a ``"__metadata__"`` map of
strings (read and ignored here). Offsets are Python ints, so files past
4 GiB need nothing special.

``load_file`` maps the file (``mmap``, copy-on-write) and returns tensors
that view the mapping, so a file is not held twice in host memory.
``save_file`` writes tensor by tensor, each made contiguous on the host
first (the raw buffer of a transposed view is not its values).
"""

from __future__ import annotations

import json
import math
import mmap
import struct
import sys
from typing import Dict, Mapping

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != "little":
    raise ImportError("the safetensors reader and writer assume a little-endian host")


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _NAMES:
        raise ValueError(f"safetensors: dtype {t.dtype} is not supported; "
                         f"supported: {sorted(DTYPES)}")
    return _NAMES[t.dtype]


def load_file(path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor, each a view of the mapped file where its offset
    is aligned to its element size (a copy of its bytes otherwise)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        f.seek(0, 2)
        end_of_data = f.tell() - base
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if end_of_data > 0 else b""
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"safetensors: {name} has dtype {info['dtype']}, not supported; "
                             f"supported: {sorted(DTYPES)}")
        dt, shape = DTYPES[info["dtype"]], list(info["shape"])
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        size = torch.empty((), dtype=dt).element_size()
        if end - begin != count * size or not 0 <= begin <= end <= end_of_data:
            raise ValueError(f"safetensors: {name}'s offsets [{begin}, {end}) do not hold "
                             f"{shape} {info['dtype']} in {path}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
        elif (base + begin) % size == 0:
            out[name] = torch.frombuffer(buf, dtype=dt, count=count,
                                         offset=base + begin).reshape(shape)
        else:
            raw = bytearray(buf[base + begin:base + end])
            out[name] = torch.frombuffer(raw, dtype=dt).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path) -> None:
    """Write ``tensors`` (on any device) to ``path``: the wider dtypes
    first, then by name, so every tensor starts aligned to its element
    size; the header padded with spaces to a multiple of 8 bytes."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
