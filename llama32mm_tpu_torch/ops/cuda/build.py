"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``llama32mm_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes). The library is built at
first use into ``build/kernels/`` at the root of the checkout and named by a
hash of the sources and flags, so an edited source rebuilds. A missing
``nvcc`` or a failed build raises with the compiler's output; nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


class KernelCompileError(RuntimeError):
    pass


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise KernelCompileError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelCompileError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build_library(verbose: bool = False) -> Path:
    """Compile the kernels (objects in parallel, then one link) unless a
    library for the current sources exists; return its path."""
    sources = _sources()
    lib = BUILD_DIR / f"libllama32mm_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objs.append(str(obj))
        failures, logs = [], []
        for cmd, proc in procs:
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}\n{err}")
        if failures:
            raise KernelCompileError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / lib.name
        logs.append(_run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_lib)]))
        os.replace(tmp_lib, lib)  # atomic: concurrent builds race harmlessly
    if verbose:
        print("\n".join(logs))
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # (x, residual|NULL, weight, out, t|NULL, rms|NULL, rows, cols, eps, dtype, stream)
        "l32_rmsnorm_fwd": [p, p, p, p, p, p, i, i, f, i, p],
        # (g, t, weight, rms, dt, dw|NULL, workspace|NULL, rows, cols, parts, dtype, stream)
        "l32_rmsnorm_bwd": [p, p, p, p, p, p, p, i, i, i, i, p],
        # (x, w, pad|NULL, out, rows, n, k, dtype, kernel (-1: routed, 0: the general route,
        #  1: the tensor-core kernel on x as it is), launched kernel (out), stream)
        "l32_gemv": [p, p, p, p, i, i, i, i, i, p, p],
        # (x, w_gate, w_up, x|w_gate|w_up workspaces (each NULL unless the general route
        #  copies that operand), out, rows, hidden, inter, dtype, kernel (-1: routed, -2: the
        #  general route, or the fp32 tile for fp32, 3: the TMA tile, 4: the tensor-core rows
        #  kernel, 5: the fp32 tile, 6: the rows kernel), launched kernel (out), stream)
        "l32_swiglu_fwd": [p, p, p, p, p, p, p, i, i, i, i, i, p, p],
        # (x, w_gate, w_up, workspaces (as l32_swiglu_fwd's), g, d_gate, d_up, rows, hidden,
        #  inter, dtype, kernel (as l32_swiglu_fwd's), launched kernel (out), stream)
        "l32_swiglu_bwd": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, p],
        # (q, k, v, kv_valid, q_offsets|NULL, out, lse|NULL, b, nq, nkv, tq, tk, hd, q_offset,
        #  causal, dtype, stream); 3xTF32 tensor cores
        "l32_flash_attn_tf32_fwd": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
        # (q, k, v, kv_valid, lse, delta, dout, dq, b, nq, nkv, tq, tk, hd, q_offset, causal,
        #  dtype, stream); 3xTF32 tensor cores
        "l32_flash_attn_tf32_bwd_dq": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
        # (q, k, v, kv_valid, lse, delta, dout, dk, dv, b, nq, nkv, tq, tk, hd, q_offset,
        #  causal, dtype, stream); 3xTF32 tensor cores
        "l32_flash_attn_tf32_bwd_dkv": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
        # (q, k, v, kv_valid, lse, delta, dout, dq, b, nq, nkv, tq, tk, hd, q_offset, causal,
        #  stream); bf16
        "l32_flash_attn_bwd_dq_tc": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        # (q, k, v, kv_valid, lse, delta, dout, dk, dv, b, nq, nkv, tq, tk, hd, q_offset, causal,
        #  stream); bf16
        "l32_flash_attn_bwd_dkv_tc": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        # (q, k, v, k_scale, v_scale, kv_valid, q_offsets|NULL, out, b, nq, nkv, tq, tk, hd,
        #  q_offset, causal, dtype, stream); 3xTF32 tensor cores
        "l32_flash_attn_tf32_fwd_int8kv": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
        # (x, q, scale, planes|NULL, out, rows, n, k, dtype, kernel (-1: routed, 0: the general
        #  route, 1: the tensor-core kernel on x as it is), launched kernel (out), stream)
        "l32_gemv_int8": [p, p, p, p, p, i, i, i, i, i, p, p],
        # (x, q4, scale, planes|NULL, out, rows, n, k, group, dtype, stream)
        "l32_gemv_int4": [p, p, p, p, p, i, i, i, i, i, p],
        # (x, q4, scale, xq, ax, out, rows, n, k, group, dtype, stream)
        "l32_gemv_int4_w4a8": [p, p, p, p, p, p, i, i, i, i, i, p],
        # (x, w_gate, w_up, w_down, partial_ws, out, rows, hidden, inter, tile, dtype, stream)
        "l32_swiglu_down": [p, p, p, p, p, p, i, i, i, i, i, p],
        # (x, q|q4, scale, workspace|NULL, out, rows, n, k, group (0: int8), dtype, kernel (-1:
        #  routed, 0: the general route, 1: x as it is), launched kernel (out), stream)
        "l32_qmatmul": [p, p, p, p, p, i, i, i, i, i, i, p, p],
        # (q, k, v, k_scale|NULL, v_scale|NULL, kv_valid, q_offsets|NULL, out, lse|NULL, b, nq,
        #  nkv, tq, tk, hd, q_offset, causal, stream); bf16 q
        "l32_flash_attn_tc": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p],
        # (q, k, v, k_scale|NULL, v_scale|NULL, kv_valid, q_offsets|NULL, workspace, out, b, nq,
        #  nkv, tq, tk, hd, q_offset, causal, dtype, stream)
        "l32_flash_decode": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.l32_error_string.argtypes = [ctypes.c_int]
    lib.l32_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    return _declare(ctypes.CDLL(str(build_library())))


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if status != 0:
        msg = load_library().l32_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
