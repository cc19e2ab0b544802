"""The safetensors file layout, read and written with numpy and json: an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw little-endian bytes. Files written
here load with the ``safetensors`` package and back (the JAX package writes
its adapters and checkpoints with it).

Reading maps the file (``iter_file``) and yields each tensor as a view of
the mapping, in header order, one at a time: a checkpoint shard is never
read whole into memory, and BF16 stays ``torch.bfloat16`` (a view of the raw
bits). Writing (``write_file``) lays the header out from shapes alone and
asks for each tensor only when its bytes are due, so a shard's tensors need
not exist together."""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np
import torch

_CODES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}
DTYPES = {code: dtype for dtype, code in _CODES.items()}

# (name, dtype, shape, produce): ``produce()`` returns the tensor when its bytes are written
Entry = Tuple[str, torch.dtype, tuple, Callable[[], torch.Tensor]]


def _storage_dtype(dtype: torch.dtype) -> np.dtype:
    """The little-endian numpy dtype that holds ``dtype``'s bytes (bf16 as int16)."""
    as_np = torch.empty(0, dtype=torch.int16 if dtype == torch.bfloat16 else dtype).numpy().dtype
    return as_np.newbyteorder("<")


def write_file(path: str, entries: Iterable[Entry]) -> int:
    """Write the tensors that ``entries`` describe; returns the data bytes.
    Each ``produce()`` is called once, in order, and its tensor (any device)
    must have the announced dtype and shape."""
    entries = list(entries)
    header, offset = {}, 0
    for name, dtype, shape, _ in entries:
        if dtype not in _CODES:
            raise TypeError(f"{name}: dtype {dtype} has no safetensors code here")
        nbytes = math.prod(shape) * _storage_dtype(dtype).itemsize
        header[name] = {"dtype": _CODES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for name, dtype, shape, produce in entries:
            t = produce().detach()
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: produced {t.dtype} {tuple(t.shape)}, "
                                 f"announced {dtype} {tuple(shape)}")
            t = t.to("cpu").contiguous()
            fh.write(memoryview((t.view(torch.int16) if dtype == torch.bfloat16 else t).numpy())
                     .cast("B"))
    return offset


def save_file(tensors: dict, path: str) -> None:
    """Write ``{name: tensor}`` (torch tensors, any device) to ``path``."""
    write_file(path, [(name, t.dtype, tuple(t.shape), lambda t=t: t)
                      for name, t in tensors.items()])


def read_header(fh) -> Tuple[dict, int]:
    """``({name: info}, start of the data)`` of an open file; the
    ``__metadata__`` entry is dropped."""
    (n,) = struct.unpack("<Q", fh.read(8))
    header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def tensor_view(buf, offset: int, nbytes: int, code: str, shape) -> torch.Tensor:
    """A CPU tensor over ``nbytes`` of ``buf`` at ``offset``: a view (it
    holds an export of ``buf``) unless the bytes are not aligned to the
    element size, when it is a copy."""
    dtype = DTYPES[code]
    np_dtype = _storage_dtype(dtype)
    if nbytes == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    arr = np.frombuffer(buf, dtype=np_dtype, count=nbytes // np_dtype.itemsize, offset=offset)
    if offset % np_dtype.itemsize:
        arr = arr.copy()
    t = torch.from_numpy(arr.reshape(tuple(shape)))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def close_mapping(mm: mmap.mmap, owner: str) -> None:
    """Unmap; raises ``RuntimeError`` while a tensor view of the mapping lives."""
    try:
        mm.close()
    except BufferError:
        raise RuntimeError(
            f"a tensor view outlived its {owner}: views yielded with copy=False (or "
            "returned by get_tensor) must be consumed (copied/transformed) before the "
            "reader closes; clone the tensor if it must survive"
        ) from None


def iter_file(path: str, copy: bool = True) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, CPU tensor)`` for each tensor of the file, in header order.

    With ``copy=False`` every tensor but the last is a view of the file's
    mapping, valid only until the next one is requested: consume it (cast,
    copy to a device) before advancing. A view still referenced when the
    iteration ends makes the unmap raise ``RuntimeError``; the last tensor
    is a copy, so a loop variable that outlives the loop is safe."""
    with open(path, "rb") as fh:
        header, start = read_header(fh)
        # a private (copy-on-write) mapping: the views are writable tensors,
        # and nothing written through one reaches the file
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
    t = None
    try:
        items = list(header.items())
        for i, (name, info) in enumerate(items):
            begin, end = info["data_offsets"]
            t = tensor_view(mm, start + begin, end - begin, info["dtype"], info["shape"])
            if copy or i == len(items) - 1:
                t = t.clone()
            yield name, t
    finally:
        t = None  # this frame's reference; a caller's must be gone too
        close_mapping(mm, "file mapping")


def load_file(path: str) -> dict:
    """``{name: tensor}`` (CPU copies) from a safetensors file, in file order."""
    return dict(iter_file(path, copy=True))
