"""ctypes binding of the native safetensors reader
(``native/safetensors_reader.cpp``; counterpart of
``llama32mm_tpu/io/native_st.py``).

The C++ reader parses each shard's header; the tensors are views of a
Python ``mmap`` of the same file (``utils/st_file.py::tensor_view``), so
every view holds an export of the mapping and ``close()`` raises
``RuntimeError`` while one is alive: a retained view never reads unmapped
pages. BF16 stays ``torch.bfloat16`` and F16 ``torch.float16``, views of
the raw bits (no widening to fp32).

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, named by a hash of the source and flags.
``iter_tensors`` reads through ``utils/st_file.py`` when it cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import mmap
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Tuple

import torch

from llama32mm_tpu_torch.utils import st_file

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "safetensors_reader.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX = "g++"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes() if SOURCE.exists() else b"")
    return BUILD_DIR / f"libstreader_{h.hexdigest()[:16]}.so"


def ensure_built(quiet: bool = True) -> bool:
    """Build the reader unless a library for the current source exists.
    Returns whether it is available."""
    lib = library_path()
    if lib.exists():
        return True
    gxx = shutil.which(GXX)
    if gxx is None or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(out)],
                              capture_output=quiet)
        if proc.returncode != 0:
            return False
        os.replace(out, lib)  # atomic: concurrent builds race harmlessly
    return True


@functools.lru_cache(maxsize=None)
def _load_lib():
    if not ensure_built():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:  # a library this machine cannot load
        return None
    p, i, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    lib.stro_open.restype = p
    lib.stro_open.argtypes = [ctypes.c_char_p]
    lib.stro_error.restype = ctypes.c_char_p
    lib.stro_error.argtypes = [p]
    lib.stro_num_tensors.restype = i
    lib.stro_num_tensors.argtypes = [p]
    lib.stro_name.restype = ctypes.c_char_p
    lib.stro_name.argtypes = [p, i]
    lib.stro_info.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.stro_info.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p, i64p,
                              ctypes.POINTER(ctypes.c_int), i64p]
    lib.stro_data_offset.restype = ctypes.c_int64
    lib.stro_data_offset.argtypes = [p, ctypes.c_char_p]
    lib.stro_close.restype = None
    lib.stro_close.argtypes = [p]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeSafetensors:
    """One shard: the header through the C++ reader, the tensors as views of
    a Python ``mmap`` of the file (private and copy-on-write, so a view is a
    writable tensor whose writes never reach the file)."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native reader unavailable (g++ build failed)")
        self._lib = lib
        self._mm = None
        self._h = lib.stro_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open safetensors file: {path}")
        err = lib.stro_error(self._h).decode()
        if err:
            lib.stro_close(self._h)
            self._h = None
            raise ValueError(f"bad safetensors header in {path}: {err}")
        with open(path, "rb") as fh:
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self) -> list:
        n = self._lib.stro_num_tensors(self._h)
        return [self._lib.stro_name(self._h, i).decode() for i in range(n)]

    def get_tensor(self, name: str) -> Tuple[torch.Tensor, str]:
        """``(tensor, safetensors dtype code)``. The tensor is a VIEW of the
        shard's mapping; ``close()`` raises while it is alive, so clone
        anything that must outlive the reader."""
        dtype_buf = ctypes.create_string_buffer(16)
        shape_buf = (ctypes.c_int64 * 8)()
        ndim = ctypes.c_int()
        nbytes = ctypes.c_int64()
        ptr = self._lib.stro_info(self._h, name.encode(), dtype_buf, shape_buf,
                                  ctypes.byref(ndim), ctypes.byref(nbytes))
        if not ptr:
            raise KeyError(name)
        code = dtype_buf.value.decode()
        if code not in st_file.DTYPES:
            raise ValueError(f"{name}: safetensors dtype {code} is not supported")
        shape = tuple(shape_buf[i] for i in range(ndim.value))
        off = self._lib.stro_data_offset(self._h, name.encode())
        return st_file.tensor_view(self._mm, off, nbytes.value, code, shape), code

    def close(self) -> None:
        if self._h:
            self._lib.stro_close(self._h)
            self._h = None
        if self._mm is not None:
            st_file.close_mapping(self._mm, "NativeSafetensors reader")  # raises while a view lives
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_tensors(path: str, copy: bool = True) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, CPU tensor)`` over a shard, in header order, through the
    native reader when it builds and ``utils/st_file.py`` otherwise.

    With ``copy=True`` every tensor is safe to keep. With ``copy=False``
    each is a view valid until the next is requested: consume it before
    advancing. A view still referenced when the iteration ends makes the
    reader's close raise ``RuntimeError``; the last tensor is yielded as a
    copy, so a conforming caller's loop variable never trips the guard."""
    if not native_available():
        yield from st_file.iter_file(path, copy=copy)
        return
    f = NativeSafetensors(path)
    t = None
    try:
        names = f.keys()
        for i, name in enumerate(names):
            t, _ = f.get_tensor(name)
            if copy or i == len(names) - 1:
                t = t.clone()
            yield name, t
    finally:
        t = None  # this frame's reference; a caller's must be gone too
        f.close()
