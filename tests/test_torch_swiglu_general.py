"""The bf16 SwiGLU calls that no main-path shape makes, against the JAX
package's Pallas kernels in interpret mode on the CPU: the backward of at
most 8 rows (the rows kernels' backward epilogue), the TMA tile's
zero-filled last 64-k box (H a multiple of 8, not of 64), and the general
route's workspaces (``reads_as_is``, ``workspaces``).

- The backward at R 1, 3 and 8 (the rows kernels' 1-, 4- and 8-row
  instantiations), H 96 and 256 (the tensor-core rows kernel: 3 and 8 spans
  of 32 k over ``tc_warps``' 4 warps) and 100 (the CUDA-core rows kernel's
  element loads), I 200 and 300, the cotangent as given and as a view one
  element into its buffer. The port's CPU path (``fused_swiglu_bwd_plain``,
  and the autograd function's dx and weight gradients) against the Pallas
  backward kernel (``_swiglu_bwd_call``) and VJP; then a numpy emulation of
  the rows kernels' arithmetic (fp32 sums of each 32-k span added in span
  order within a warp and the warps' totals in warp order, or for H = 100
  each lane's fmaf chain over k = lane + 32 j and the warp's xor tree; then
  ``swiglu_grad``'s formulas in fp32, one rounding) against the same
  kernel, and each of its rows against its R = 1 call, bit for bit.
- The zero-filled last box: H 200 and 520, R 130, I 300, forward and
  backward, emulated as 64-k tiles with zeros past H (each tile's fp32 sum
  added in order) against the Pallas kernels.
- ``reads_as_is`` and ``workspaces`` at H 4096, 4104 and 100, x, w_gate or
  w_up one element into its buffer, R 8, 9 and 1632: which operands the
  general route copies and into rows of what length, none at 8 rows or
  fewer unless the route is asked for (then all three), and the plain
  version on zero-padded copies of those lengths equals it on the
  originals.

Inputs come from numpy with a fixed seed (weights 0.1 N(0, 1), x and the
cotangent N(0, 1)), rounded to bf16 for both sides. Tolerances, of the
largest magnitude of the expected tensor: bf16 results 1.6e-2 (the bar
``chip_smoke.py`` holds the kernels to on the card; each side rounds its
output once and sums in its own order, an ulp of bf16 being 2^-8 of the
value; dx and the weight gradients also round d_gate and d_up before their
bf16 matmuls); the padded copies 1e-6 in fp32 (zeros add nothing; the two
matmuls may block the sums differently).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.pallas.swiglu import _swiglu_bwd_call, fused_swiglu_pallas
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.cuda.swiglu import (
    ROUTED,
    ROUTED_BASE,
    padded_ld,
    reads_as_is,
    workspaces,
)
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu

BF16_TOL = 1.6e-2
PAD_TOL = 1e-6
BF = torch.bfloat16


def _bf16(a):
    """``a`` rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def _port(a, offset=False):
    """A bf16 torch copy of ``a``; with ``offset`` a contiguous view that
    starts one element into its buffer."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
    if not offset:
        return t
    view = torch.cat([torch.zeros(1, dtype=BF), t.reshape(-1)])[1:].view(t.shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _case(r, h, i):
    """x [R, H], w_gate and w_up in the JAX layout [H, I] and the cotangent
    [R, I], bf16 values as fp32 numpy."""
    rs = np.random.RandomState(27)
    x = _bf16(rs.randn(r, h))
    wg, wu = (_bf16(rs.randn(h, i) * 0.1) for _ in range(2))
    g = _bf16(rs.randn(r, i))
    return x, wg, wu, g


@functools.lru_cache(maxsize=None)
def _pallas_bwd(r, h, i):
    """The Pallas backward kernel's d_gate and d_up, and the VJP's dx, dwg,
    dwu, on the bf16 inputs."""
    x, wg, wu, g = (jnp.asarray(a, jnp.bfloat16) for a in _case(r, h, i))
    d_gate, d_up = _swiglu_bwd_call(x, wg, wu, g)
    _, vjp = jax.vjp(fused_swiglu_pallas, x, wg, wu)
    return (d_gate, d_up) + tuple(vjp(g))


# ---- the backward of at most 8 rows ----

ROWS = [1, 3, 8]
HS = [96, 100, 256]
IS = [200, 300]


@pytest.mark.parametrize("offset", [False, True], ids=["g_aligned", "g_offset_view"])
@pytest.mark.parametrize("i", IS)
@pytest.mark.parametrize("h", HS)
@pytest.mark.parametrize("r", ROWS)
def test_rows_backward_matches_pallas(r, h, i, offset):
    """The port's CPU path of a backward of at most 8 rows: d_gate and d_up
    against the Pallas backward kernel's, and through the autograd function
    dx and the weight gradients against the Pallas VJP's."""
    x, wg, wu, g = _case(r, h, i)
    want_dgate, want_dup, want_dx, want_dwg, want_dwu = _pallas_bwd(r, h, i)
    xt, wgt, wut, gt = _port(x), _port(wg.T), _port(wu.T), _port(g, offset)
    d_gate, d_up = kernels.fused_swiglu_bwd_plain(xt, wgt, wut, gt)
    _close(d_gate, want_dgate, BF16_TOL)
    _close(d_up, want_dup, BF16_TOL)
    leaves = [t.clone().requires_grad_() for t in (xt, wgt, wut)]
    fused_swiglu(*leaves, impl="torch").backward(gt)
    _close(leaves[0].grad, want_dx, BF16_TOL)
    _close(leaves[1].grad.t(), want_dwg, BF16_TOL)
    _close(leaves[2].grad.t(), want_dwu, BF16_TOL)


def _tc_warps(n, k):
    """``common.cuh::tc_warps``: warps a block of the tensor-core rows kernel."""
    warps = 8 if n >= 8192 else 16
    while warps > 4 and k // 32 < 8 * warps:
        warps //= 2
    return warps


def _span_sums(x, w, k0, k1):
    """fp32 sums over k0 .. k1 - 1 of x [R, H] times w [H, I] (bf16 values:
    each product exact), per (row, column)."""
    return (x[:, None, k0:k1].astype(np.float64)
            * w.T[None, :, k0:k1].astype(np.float64)).sum(-1).astype(np.float32)


def _gate_up_tc(x, w):
    """The tensor-core rows kernel's sums: each warp adds its 32-k spans'
    fp32 sums in span order, the warps' totals are added in warp order."""
    h, i = w.shape
    spans, warps = h // 32, _tc_warps(i, h)
    total = np.zeros((x.shape[0], i), np.float32)
    for v in range(warps):
        acc = np.zeros_like(total)
        for u in range(v * spans // warps, (v + 1) * spans // warps):
            acc = acc + _span_sums(x, w, 32 * u, 32 * u + 32)
        total = total + acc if v else acc
    return total


def _gate_up_simt(x, w):
    """The CUDA-core rows kernel's sums with element loads: lane l's fmaf
    chain over k = l, l + 32, ... (a bf16 product is exact in fp32, so fmaf
    is a product and one rounded add), then the xor tree over the 32 lanes
    (reduce_scatter adds as warp_sum does)."""
    h, i = w.shape
    lanes = np.zeros((32, x.shape[0], i), np.float32)
    for k in range(h):
        lanes[k % 32] += np.float32(x[:, k, None] * w[None, k, :])
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    return lanes[0]


def _grad(gate, up, g):
    """``swiglu.cu::swiglu_grad`` in fp32, then one rounding to bf16 each."""
    one = np.float32(1)
    s = one / (one + np.exp(-gate))
    return _bf16(s * (one + gate * (one - s)) * g * up), _bf16(g * (gate * s))


def _rows_emulation(x, wg, wu, g):
    sums = _gate_up_tc if wg.shape[0] % 32 == 0 else _gate_up_simt
    return _grad(sums(x, wg), sums(x, wu), g)


@pytest.mark.parametrize("i", IS)
@pytest.mark.parametrize("h", HS)
@pytest.mark.parametrize("r", ROWS)
def test_rows_backward_emulation(r, h, i):
    """The rows kernels' backward arithmetic, emulated in numpy, against the
    Pallas backward kernel; each row of the R-row emulation equals its
    R = 1 emulation bit for bit (the k order depends on H and I alone)."""
    x, wg, wu, g = _case(r, h, i)
    want_dgate, want_dup = _pallas_bwd(r, h, i)[:2]
    d_gate, d_up = _rows_emulation(x, wg, wu, g)
    _close(d_gate, want_dgate, BF16_TOL)
    _close(d_up, want_dup, BF16_TOL)
    for row in range(r):
        one = _rows_emulation(x[row:row + 1], wg, wu, g[row:row + 1])
        assert np.array_equal(one[0], d_gate[row:row + 1])
        assert np.array_equal(one[1], d_up[row:row + 1])


# ---- the TMA tile's zero-filled last box ----


def _tile_sums(x, w):
    """The TMA tile's sums: 64-k tiles over H rounded up to 64, zeros past
    H (what TMA reads outside the matrix), each tile's fp32 sum added in
    order."""
    h, i = w.shape
    nk = -(-h // 64)
    xp = np.zeros((x.shape[0], 64 * nk), np.float32)
    wp = np.zeros((64 * nk, i), np.float32)
    xp[:, :h], wp[:h] = x, w
    acc = np.zeros((x.shape[0], i), np.float32)
    for t in range(nk):
        acc = acc + _span_sums(xp, wp, 64 * t, 64 * t + 64)
    return acc


@pytest.mark.parametrize("h", [200, 520])
def test_zero_filled_last_box_forward(h):
    x, wg, wu, _ = _case(130, h, 300)
    gate, up = _tile_sums(x, wg), _tile_sums(x, wu)
    got = _bf16(gate / (np.float32(1) + np.exp(-gate)) * up)
    want = fused_swiglu_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu)))
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("h", [200, 520])
def test_zero_filled_last_box_backward(h):
    x, wg, wu, g = _case(130, h, 300)
    d_gate, d_up = _grad(_tile_sums(x, wg), _tile_sums(x, wu), g)
    want_dgate, want_dup = _pallas_bwd(130, h, 300)[:2]
    _close(d_gate, want_dgate, BF16_TOL)
    _close(d_up, want_dup, BF16_TOL)


# ---- the general route's workspaces ----

OPERANDS = ("x", "w_gate", "w_up")


def _operands(rows, h, inter, offset):
    """bf16 x [rows, H] and both weights [I, H], the one named ``offset``
    one element into its buffer, and fp32 copies of the same values."""
    rs = np.random.RandomState(5)
    vals = [rs.randn(rows, h), rs.randn(inter, h) * 0.1, rs.randn(inter, h) * 0.1]
    bf = [_port(v, offset == name) for v, name in zip(vals, OPERANDS)]
    return bf, [t.float() for t in bf]


@pytest.mark.parametrize("rows", [8, 9, 1632])
@pytest.mark.parametrize("offset", [None, *OPERANDS])
@pytest.mark.parametrize("h", [4096, 4104, 100])
def test_general_route_workspaces(h, offset, rows):
    inter = 24
    bf, f32 = _operands(rows, h, inter, offset)
    as_is = [reads_as_is(t) for t in bf]
    assert as_is == [h % 8 == 0 and name != offset for name in OPERANDS]
    assert padded_ld(h) == (h if h % 8 == 0 else h + 8 - h % 8)
    routed, forced = workspaces(*bf, kernel=ROUTED), workspaces(*bf, kernel=ROUTED_BASE)
    want_copied = [rows > 8 and not a for a in as_is]
    assert [w is not None for w in routed] == want_copied
    assert all(w is not None for w in forced)
    assert all(w is None for w in workspaces(*f32, kernel=ROUTED_BASE))  # fp32: the fp32 tile
    for ws in (routed, forced):
        for w, t in zip(ws, bf):
            if w is not None:
                assert w.shape == (t.shape[0], padded_ld(h)) and w.dtype == BF
                assert w.data_ptr() % 16 == 0
    # the plain version on copies padded with zeros to rows of padded_ld(H)
    padded = [torch.nn.functional.pad(t, (0, padded_ld(h) - h)) for t in f32]
    want = kernels.fused_swiglu_plain(*f32)
    got = kernels.fused_swiglu_plain(*padded)
    assert (got - want).abs().max() <= PAD_TOL * want.abs().max()
