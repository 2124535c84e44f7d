"""Reader and writer of ``.safetensors`` files, the format of diffusers'
weight folders, without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON mapping
each name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end
within the data, optionally beside a ``__metadata__`` entry), then the raw
little-endian data. ``load_file`` maps the file copy-on-write and returns
tensors that share its pages, as ``torch.load(mmap=True)`` does.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in its stored dtype."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                             f"does not take ({sorted(DTYPES)})")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = dtype.itemsize
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * size or base + end > len(buf):
            raise ValueError(f"{path}: {name}'s data_offsets do not fit its shape and dtype")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % size == 0:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
        else:  # unaligned data: a copy
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=base + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path) -> None:
    """Write ``tensors`` (on any device, in any layout) as one
    ``.safetensors`` file; the largest elements first, so that every tensor
    is aligned."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
