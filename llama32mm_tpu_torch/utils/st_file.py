"""The safetensors file layout, read and written with numpy and json: an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian bytes. Files written
here load with the ``safetensors`` package and back (the JAX package writes
its adapters with it)."""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_CODES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}
_DTYPES = {code: dtype for dtype, code in _CODES.items()}


def save_file(tensors: dict, path: str) -> None:
    """Write ``{name: tensor}`` (torch tensors, any device) to ``path``."""
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code here")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for raw in chunks:
            fh.write(raw)


def load_file(path: str) -> dict:
    """``{name: tensor}`` (CPU) from a safetensors file, in file order."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        as_np = torch.empty(0, dtype=torch.int16 if dtype == torch.bfloat16 else dtype).numpy().dtype
        arr = np.frombuffer(data[begin:end], dtype=as_np.newbyteorder("<")).reshape(info["shape"])
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out
