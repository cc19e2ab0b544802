"""Fused SwiGLU: the CUDA kernels (``csrc/swiglu.cu``) and their plain
PyTorch versions, both weights in nn.Linear's ``[I, H]`` layout.

- forward: ``silu(x @ w_gate.T) * (x @ w_up.T)``, replacing
  ``llama32mm_tpu/ops/pallas/swiglu.py::_fwd_kernel``;
- backward (``::_bwd_kernel``): from the output's cotangent ``g`` it
  recomputes gate and up and returns ``d_gate = silu'(gate) * g * up`` and
  ``d_up = g * silu(gate)`` in x's dtype, with
  ``silu'(x) = s (1 + x (1 - s))``, ``s = sigmoid(x)``;
- SwiGLU + down (``csrc/swiglu_down.cu``, replacing ``::_down_kernel``):
  ``(silu(x @ w_gate.T) * (x @ w_up.T)) @ w_down.T`` for a few rows, the
  intermediate rounded to x's dtype and never written, ``w_down`` ``[H, I]``.

``fused_swiglu_cuda`` and ``fused_swiglu_bwd_cuda`` are the entries the
model calls: ``l32_swiglu_fwd`` / ``l32_swiglu_bwd`` route each call by its
shape and report the kernel they launched. A bf16 call with at most 8 rows
(forward or backward), H a multiple of 32 and aligned operands takes the
tensor-core rows kernel (``mma.sync``), counted by
``fused_swiglu_rows_tc_cuda`` / ``fused_swiglu_bwd_rows_tc_cuda``; every
other call with at most 8 rows (fp32 forward, ragged H, misaligned
pointers) the CUDA-core rows kernel, counted by ``fused_swiglu_rows_cuda``
/ ``fused_swiglu_bwd_rows_cuda``. A bf16 call with more rows whose
operands the TMA tile reads as they are (``reads_as_is``: H a multiple of
8, 16-byte-aligned x and weights) takes the TMA tile (wgmma fed by TMA),
counted by ``fused_swiglu_tc_cuda`` / ``fused_swiglu_bwd_tc_cuda``; any
other takes the general route, counted by ``fused_swiglu_general_cuda`` /
``fused_swiglu_bwd_general_cuda``: a pre-pass copies the operands the tile
cannot read as they are into workspaces this module allocates
(``workspaces``: rows of H rounded up to 8, zeros past H), then the same
TMA tile reads them. Copying a weight moves its bytes twice more: at the
11B widths two 117 MB workspaces and ~0.14 ms a call, which no main-path
shape pays. An fp32 call with more than 8 rows, and every fp32 backward,
takes the fp32 tile (3xTF32 ``mma.sync``), counted by
``fused_swiglu_tf32_cuda`` / ``fused_swiglu_bwd_tf32_cuda``. Called
directly, each of those counted wrappers forces its own kernel; the general
ones copy every operand at any row count (and send fp32 calls to the fp32
tile: there is no other).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import acc_dtype, counted, dtype_code, require, stream_of


def _check(x, w_gate, w_up):
    require("x", x, x)
    h = x.shape[-1]
    if w_gate.dim() != 2 or w_gate.shape[1] != h:
        raise ValueError(f"w_gate must be [I, {h}], got {tuple(w_gate.shape)}")
    require("w_gate", w_gate, x)
    require("w_up", w_up, x, w_gate.shape)
    return h, w_gate.shape[0], (x.numel() // h if h else 0)


# l32_swiglu_fwd / l32_swiglu_bwd's kernel argument: route by shape, ask for
# the base route (the general route, or the fp32 tile for fp32), or ask for
# the TMA tile on the caller's tensors, the tensor-core rows kernel, the fp32
# tile or the CUDA-core rows kernel (also the values they report when they
# launched those: GENERAL for the general route).
ROUTED, ROUTED_BASE, GENERAL, TMA, ROWS_TC, TF32, ROWS = -1, -2, 1, 3, 4, 5, 6
ROWS_KERNEL_MAX = 8  # rows a call of a rows kernel takes at most


def reads_as_is(t: torch.Tensor) -> bool:
    """Whether the TMA tile reads an operand (x or a weight, rows of H) as
    it is: rows of whole 16 bytes (H a multiple of 8) from a 16-byte-aligned
    base. The general route's pre-pass copies any other."""
    return t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0


def padded_ld(h: int) -> int:
    """Elements of a row of the general route's copies: H rounded up to 8."""
    return -(-h // 8) * 8


def workspaces(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               kernel: int = ROUTED) -> tuple:
    """The general route's workspaces for ``(x, w_gate, w_up)``: for each
    operand the route copies, an empty bf16 tensor of ``[rows or I,
    padded_ld(H)]``, else None. The route is taken by a bf16 call asked for
    it (``ROUTED_BASE``: every operand copied, at any row count) or routed
    with more than 8 rows and an operand ``reads_as_is`` refuses (only those
    copied); every other call copies nothing."""
    h, inter = x.shape[-1], w_gate.shape[0]
    rows = x.numel() // h if h else 0
    if x.dtype != torch.bfloat16 or rows == 0 or inter == 0:
        return (None,) * 3
    if kernel == ROUTED_BASE:
        copy = (True,) * 3
    elif kernel == ROUTED and rows > ROWS_KERNEL_MAX:
        copy = tuple(not reads_as_is(t) for t in (x, w_gate, w_up))
    else:
        return (None,) * 3
    return tuple(torch.empty(n, padded_ld(h), dtype=x.dtype, device=x.device) if c else None
                 for n, c in zip((rows, inter, inter), copy))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, kernel: int):
    h, inter, rows = _check(x, w_gate, w_up)
    out = torch.empty(*x.shape[:-1], inter, dtype=x.dtype, device=x.device)
    ws = workspaces(x, w_gate, w_up, kernel)
    launched = ctypes.c_int(-1)
    status = load_library().l32_swiglu_fwd(
        *map(_ptr, (x, w_gate, w_up, *ws)), out.data_ptr(), rows, h, inter, dtype_code(x),
        kernel, ctypes.byref(launched), stream_of(x),
    )
    check(status, "swiglu kernel")
    counter = {GENERAL: fused_swiglu_general_cuda, TMA: fused_swiglu_tc_cuda,
               ROWS_TC: fused_swiglu_rows_tc_cuda, TF32: fused_swiglu_tf32_cuda,
               ROWS: fused_swiglu_rows_cuda}.get(launched.value)
    if counter is not None:
        counter.launches += 1
    return out


def fused_swiglu_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """x ``[..., H]``, w_gate/w_up ``[I, H]`` → ``[..., I]``; gate and up
    accumulate in fp32 inside the kernel and are never written. Through the
    kernel the call's shape routes to."""
    return _forward(x, w_gate, w_up, ROUTED)


@counted("launches")
def fused_swiglu_tc_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """The TMA tile; raises for a call it does not take."""
    return _forward(x, w_gate, w_up, TMA)


@counted("launches")
def fused_swiglu_rows_tc_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """The tensor-core rows kernel (bf16, at most 8 rows); raises for a call
    it does not take."""
    return _forward(x, w_gate, w_up, ROWS_TC)


@counted("launches")
def fused_swiglu_tf32_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """The fp32 tile (fp32 operands, any rows); raises for a call it does
    not take."""
    return _forward(x, w_gate, w_up, TF32)


@counted("launches")
def fused_swiglu_rows_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """The CUDA-core rows kernel (fp32 or bf16, at most 8 rows); raises for a
    call it does not take."""
    return _forward(x, w_gate, w_up, ROWS)


@counted("launches")
def fused_swiglu_general_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor):
    """The general route, any shape and alignment: bf16 operands all copied
    by the pre-pass, then the TMA tile; fp32 takes the fp32 tile."""
    return _forward(x, w_gate, w_up, ROUTED_BASE)


@counted("calls")
def fused_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch: two matmuls in x's dtype, silu and the
    product in fp32, one rounding."""
    fused_swiglu_plain.calls += 1
    acc = acc_dtype(x)
    gate = torch.matmul(x, w_gate.t()).to(acc)
    up = torch.matmul(x, w_up.t()).to(acc)
    return (F.silu(gate) * up).to(x.dtype)


SWIGLU_DOWN_SPAN = 32  # intermediate columns of one k step of csrc/swiglu_down.cu's products
SWIGLU_DOWN_MAX_SPANS = 4  # spans a tile at most
SWIGLU_DOWN_TILES = 112  # tile count the width aims at: 14 clusters of 8 blocks, one wave on H100
SWIGLU_DOWN_CLUSTER = 8  # tiles a thread-block cluster sums in distributed shared memory


def swiglu_down_tiles(rows: int, hidden: int, inter: int) -> tuple:
    """``(tile, tiles, workspace)`` of ``csrc/swiglu_down.cu``: each block owns
    ``tile`` intermediate columns (the fewest 32-column spans, at most 4, that
    keep ``tiles = ceil(inter / tile)`` at most 112); each cluster of 8 tiles
    writes its partial ``[rows, hidden]`` product to an fp32 workspace of
    ``workspace`` floats. The tiles depend on ``inter`` alone."""
    spans = -(-inter // SWIGLU_DOWN_SPAN)
    tile = SWIGLU_DOWN_SPAN * min(SWIGLU_DOWN_MAX_SPANS, max(1, -(-spans // SWIGLU_DOWN_TILES)))
    tiles = -(-inter // tile)
    return tile, tiles, -(-tiles // SWIGLU_DOWN_CLUSTER) * rows * hidden


@counted("launches")
def swiglu_down_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor) -> torch.Tensor:
    """x ``[..., H]``, w_gate/w_up ``[I, H]``, w_down ``[H, I]`` → ``[..., H]``:
    each cluster of 8 blocks' tiles of I (``swiglu_down_tiles``) goes to an
    fp32 ``[clusters, R, H]`` workspace, a second kernel sums them in order."""
    h, inter, rows = _check(x, w_gate, w_up)
    require("w_down", w_down, x, (h, inter))
    if inter == 0:
        raise ValueError("swiglu_down needs an intermediate size > 0")
    out = torch.empty_like(x)
    tile, _, workspace = swiglu_down_tiles(rows, h, inter)
    part = torch.empty(workspace, dtype=torch.float32, device=x.device)
    status = load_library().l32_swiglu_down(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), part.data_ptr(),
        out.data_ptr(), rows, h, inter, tile, dtype_code(x), stream_of(x),
    )
    check(status, "swiglu down kernel")
    swiglu_down_cuda.launches += 1
    return out


@counted("calls")
def swiglu_down_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch: gate and up in fp32, the intermediate
    rounded to x's dtype, the down product in fp32, one rounding."""
    swiglu_down_plain.calls += 1
    acc = acc_dtype(x)
    xf = x.to(acc)
    gate = torch.matmul(xf, w_gate.to(acc).t())
    up = torch.matmul(xf, w_up.to(acc).t())
    inter = (F.silu(gate) * up).to(x.dtype)
    return torch.matmul(inter.to(acc), w_down.to(acc).t()).to(x.dtype)


def _backward(x, w_gate, w_up, g, kernel: int):
    h, inter, rows = _check(x, w_gate, w_up)
    shape = (*x.shape[:-1], inter)
    require("g", g, x, shape)
    d_gate = torch.empty(shape, dtype=x.dtype, device=x.device)
    d_up = torch.empty_like(d_gate)
    ws = workspaces(x, w_gate, w_up, kernel)
    launched = ctypes.c_int(-1)
    status = load_library().l32_swiglu_bwd(
        *map(_ptr, (x, w_gate, w_up, *ws)), g.data_ptr(), d_gate.data_ptr(), d_up.data_ptr(),
        rows, h, inter, dtype_code(x), kernel, ctypes.byref(launched), stream_of(x),
    )
    check(status, "swiglu backward kernel")
    counter = {GENERAL: fused_swiglu_bwd_general_cuda, TMA: fused_swiglu_bwd_tc_cuda,
               ROWS_TC: fused_swiglu_bwd_rows_tc_cuda, TF32: fused_swiglu_bwd_tf32_cuda,
               ROWS: fused_swiglu_bwd_rows_cuda}.get(launched.value)
    if counter is not None:
        counter.launches += 1
    return d_gate, d_up


def fused_swiglu_bwd_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                          g: torch.Tensor):
    """``(d_gate, d_up)``, each ``[..., I]`` in x's dtype, from the cotangent
    ``g [..., I]``; gate and up are recomputed in fp32 inside the kernel.
    Through the kernel the call's shape routes to."""
    return _backward(x, w_gate, w_up, g, ROUTED)


@counted("launches")
def fused_swiglu_bwd_tc_cuda(x, w_gate, w_up, g):
    """The TMA tile's backward; raises for a call it does not take."""
    return _backward(x, w_gate, w_up, g, TMA)


@counted("launches")
def fused_swiglu_bwd_rows_tc_cuda(x, w_gate, w_up, g):
    """The tensor-core rows kernel's backward (bf16, at most 8 rows); raises
    for a call it does not take."""
    return _backward(x, w_gate, w_up, g, ROWS_TC)


@counted("launches")
def fused_swiglu_bwd_tf32_cuda(x, w_gate, w_up, g):
    """The fp32 tile's backward (fp32 operands); raises for a call it does
    not take."""
    return _backward(x, w_gate, w_up, g, TF32)


@counted("launches")
def fused_swiglu_bwd_rows_cuda(x, w_gate, w_up, g):
    """The CUDA-core rows kernel's backward (bf16, at most 8 rows); raises
    for a call it does not take."""
    return _backward(x, w_gate, w_up, g, ROWS)


@counted("launches")
def fused_swiglu_bwd_general_cuda(x, w_gate, w_up, g):
    """The general route's backward, any shape and alignment: bf16 operands
    all copied by the pre-pass, then the TMA tile; fp32 takes the fp32
    tile."""
    return _backward(x, w_gate, w_up, g, ROUTED_BASE)


@counted("calls")
def fused_swiglu_bwd_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                           g: torch.Tensor):
    """The backward formula in PyTorch: ``(d_gate, d_up)``."""
    fused_swiglu_bwd_plain.calls += 1
    acc = acc_dtype(x)
    gate = torch.matmul(x, w_gate.t()).to(acc)
    up = torch.matmul(x, w_up.t()).to(acc)
    gf = g.to(acc)
    s = torch.sigmoid(gate)
    d_gate = s * (1.0 + gate * (1.0 - s)) * gf * up
    d_up = gf * (gate * s)
    return d_gate.to(x.dtype), d_up.to(x.dtype)
