"""The arithmetic of the dequantizing GEMM's general route (``csrc/qmatmul.cu``)
on fp32 x, emulated in numpy / torch on the CPU against the JAX package's
Pallas kernels in interpret mode (``int8_matmul_pallas``,
``int4_matmul_pallas``), and the layout of its pre-pass's workspace:

- the pre-pass writes x as three exact bf16 planes (``split_bf16_planes``),
  int8 in natural order with rows padded by zeros to whole 64-k tiles, int4
  in packed order (the x of each weight byte's low nibble in one half of the
  row, of its high nibble in the other; every group given whole 16-slot
  units, zeros past g/2);
- each k-tile's three planes run against the exact bf16 weights (int8 q;
  int4 u - 8) into a fresh fp32 partial, added to the running total: int8
  the channel scale on the total, int4 the group scale on the partial, once
  a tile where a tile lies in one group, else once a 16-slot unit;
- that holds to the Pallas kernels within 1e-5 of max|out| (int4 at K >
  256 to the float64 product of the same dequantized weights instead:
  ``tests/test_torch_quant.py::test_qmatmul_plain_int4_k512_matches_float64``
  says why); one bf16 plane of x, or the scale folded into a bf16 weight,
  would not;
- the wrappers allocate the workspace exactly where the kernel does not
  read x as it is.

The kernel itself runs only on the card (``chip_smoke.py``). Inputs from
numpy with a fixed seed, CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.ops.pallas.quant_matmul import int4_matmul_pallas, int8_matmul_pallas
from llama32mm_tpu_torch.ops.cuda.qgemv import split_bf16_planes
from llama32mm_tpu_torch.ops.cuda.qmatmul import GENERAL, TC, reads_as_is, row_elems, workspace
from llama32mm_tpu_torch.ops.quant import (
    dequantize_weight,
    quantize_weight,
    quantize_weight_int4,
    unpack_int4,
)

FP32_TOL = 1e-5  # of max|out|: chip_smoke.FP32_TOL


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(w):
    """``[in, out]`` (JAX) → ``[out, in]`` (the port), as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(w.T))


def packed_sources(k, g):
    """The k that each element of a packed workspace row holds (-1: a zero),
    as the pre-pass (``common.cuh::planes_source``) lays it out."""
    g2, ld = g // 2, row_elems(k, g)
    half, span = ld // 2, 16 * -(-g2 // 16)
    e = np.arange(ld)
    hi = (e >= half).astype(np.int64)
    c = e - hi * half
    grp, off = c // span, c % span
    return np.where((grp < k // g) & (off < g2), grp * g + hi * g2 + off, -1)


def _planes(xw, planes):
    return split_bf16_planes(torch.from_numpy(xw)).float().numpy()[:planes]


def int8_general_emulation(x, q, scale, planes=3):
    """``[R, K]`` fp32 x, ``[N, K]`` int8 q, ``[N]`` scale: the general
    route's sums (``planes=1``: x rounded to one bf16 plane)."""
    rows, k = x.shape
    xw = np.zeros((rows, row_elems(k, 0)), np.float32)
    xw[:, :k] = x
    w = np.zeros((q.shape[0], xw.shape[1]), np.float32)
    w[:, :k] = q.numpy()
    p = _planes(xw, planes)
    total = np.zeros((rows, w.shape[0]), np.float32)
    for t in range(xw.shape[1] // 64):
        cols = slice(64 * t, 64 * t + 64)
        part = sum(pl[:, cols] @ w[:, cols].T for pl in p)  # each product exact in fp32
        total += part
    return total * scale.numpy()


def int4_general_emulation(x, q4, scale, g, fold=False):
    """``[R, K]`` fp32 x, packed ``q4 [N, K/2]``, ``scale [N, K/g]``: the
    general route's sums (``fold``: the weight bf16((u - 8) s) with no scale
    on the partials, as bf16 x takes it)."""
    rows, k = x.shape
    n, ng = scale.shape
    src = packed_sources(k, g)
    ld, half, units = len(src), len(src) // 2, -(-(g // 2) // 16)
    has = src >= 0
    xw = np.zeros((rows, ld), np.float32)
    xw[:, has] = x[:, src[has]]
    wq = unpack_int4(q4, ng).float().numpy()  # u - 8, [N, K]
    w = np.zeros((n, ld), np.float32)
    w[:, has] = wq[:, src[has]]
    sc = scale.numpy()
    if fold:
        s_slot = np.zeros((n, ld), np.float32)
        s_slot[:, has] = sc[:, src[has] // g]
        w = torch.from_numpy(w * s_slot).to(torch.bfloat16).float().numpy()
    p = _planes(xw, 3)
    total = np.zeros((rows, n), np.float32)
    for t in range(half // 32):
        lo, hi = np.arange(32 * t, 32 * t + 32), np.arange(half + 32 * t, half + 32 * t + 32)
        # a tile in one group: one partial; else one a 16-slot unit
        sets = [np.concatenate([lo, hi])] if units % 2 == 0 else [
            np.concatenate([lo[:16], hi[:16]]), np.concatenate([lo[16:], hi[16:]])]
        for cols in sets:
            part = sum(pl[:, cols] @ w[:, cols].T for pl in p)
            grp = (2 * t + (cols[0] - 32 * t) // 16) // units
            s = 1.0 if fold else (sc[:, grp] if grp < ng else np.zeros(n, np.float32))
            total += part * s
    return total


@pytest.mark.parametrize("rows", [33, 130])  # one 128-row tile; two
@pytest.mark.parametrize("k", [256, 4100])  # whole 64-k tiles; ragged (the padded planes)
def test_int8_fp32_planes_match_pallas(k, rows):
    """The three-plane sums hold to ``int8_matmul_pallas`` on fp32 x within
    1e-5 of max|out|; one bf16 plane (x rounded to bf16) would not."""
    rs = np.random.RandomState(31)
    n = 96
    w = _rand(rs, k, n, scale=0.02)
    x = _rand(rs, rows, k)
    jqw = jq.quantize_weight(jnp.asarray(w))
    qw = quantize_weight(_port(w))
    np.testing.assert_array_equal(qw["q"].numpy(), np.asarray(jqw["q"]).T)
    want = np.asarray(int8_matmul_pallas(jnp.asarray(x), jqw["q"], jqw["scale"]))
    assert _rel_err(int8_general_emulation(x, qw["q"], qw["scale"]), want) <= FP32_TOL
    assert _rel_err(int8_general_emulation(x, qw["q"], qw["scale"], planes=1), want) > FP32_TOL


# g=128: a tile in one group; g=32: two groups a tile, a partial a unit;
# g=24: one group a unit, 4 zero slots in each
@pytest.mark.parametrize("rows", [33, 130])
@pytest.mark.parametrize("g,k", [(128, 256), (32, 256), (24, 192)])
def test_int4_fp32_planes_match_pallas(g, k, rows):
    """At K <= 256 the packed three-plane sums, scaled per partial, hold to
    ``int4_matmul_pallas`` on fp32 x within 1e-5 of max|out|; the scale
    folded into a bf16 weight would not."""
    rs = np.random.RandomState(33)
    n = 96
    w = _rand(rs, k, n, scale=0.1)
    x = _rand(rs, rows, k)
    jqw = jq.quantize_weight_int4(jnp.asarray(w), g)
    qw = quantize_weight_int4(_port(w), g)
    np.testing.assert_array_equal(qw["q4"].numpy(), np.asarray(jqw["q4"]).T)
    want = np.asarray(int4_matmul_pallas(jnp.asarray(x), jqw["q4"], jqw["scale"]))
    got = int4_general_emulation(x, qw["q4"], qw["scale"], g)
    assert _rel_err(got, want) <= FP32_TOL
    folded = int4_general_emulation(x, qw["q4"], qw["scale"], g, fold=True)
    assert _rel_err(folded, want) > FP32_TOL


@pytest.mark.parametrize("rows", [33, 130])
@pytest.mark.parametrize("g,k", [(128, 4096), (32, 4096), (24, 4104)])
def test_int4_fp32_planes_match_float64(g, k, rows):
    """At K > 256 the same sums hold to the float64 product of the same
    dequantized weights within 1e-5 of max|out| (the Pallas kernel's raw
    ``u = q + 8`` product, ~16x the result, drifts past it there)."""
    rs = np.random.RandomState(35)
    n = 64
    w = _rand(rs, n, k, scale=0.1)  # [N, K], the port's orientation
    x = _rand(rs, rows, k)
    qw = quantize_weight_int4(torch.from_numpy(w), g)
    want = x.astype(np.float64) @ dequantize_weight(qw, torch.float32).double().numpy().T
    assert _rel_err(int4_general_emulation(x, qw["q4"], qw["scale"], g), want) <= FP32_TOL


@pytest.mark.parametrize("g,k", [(128, 4096), (64, 512), (32, 4160), (24, 192), (6, 192),
                                 (2, 64), (4100, 4100)])
def test_packed_workspace_holds_each_k_once(g, k):
    """The packed row holds every k exactly once (low nibbles' k in its first
    half, high nibbles' in the second), rows are whole 64-k tiles, and every
    16-slot unit lies in one group (so a k16 step of the products does)."""
    src = packed_sources(k, g)
    ld = len(src)
    assert ld == row_elems(k, g) and ld % 64 == 0
    np.testing.assert_array_equal(np.sort(src[src >= 0]), np.arange(k))
    half = ld // 2
    assert all((src[:half][src[:half] >= 0] % g) < g // 2)
    assert all((src[half:][src[half:] >= 0] % g) >= g // 2)
    for unit in src.reshape(-1, 16):
        assert len(set(unit[unit >= 0] // g)) <= 1


def _x(dtype, rows, k, off):
    """``[rows, k]`` x starting ``off`` elements into a 64-byte-aligned buffer."""
    buf = torch.zeros(rows * k + 64, dtype=dtype)
    base = (-buf.data_ptr() // buf.element_size()) % (64 // buf.element_size())
    x = buf[base + off:base + off + rows * k].view(rows, k)
    assert (x.data_ptr() % 16 == 0) == (off * buf.element_size() % 16 == 0)
    return x


@pytest.mark.parametrize("off", [0, 1])  # x aligned; one element off
@pytest.mark.parametrize("k,g", [(4096, 0), (4100, 0), (4096, 128), (4096, 32), (192, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_workspace_where_x_is_not_read_as_it_is(dtype, k, g, off):
    """``workspace`` is None exactly where the kernel reads x as it is (bf16
    x, int8 K a multiple of 64 or int4 g/2 a multiple of 32, x and q
    16-byte aligned), else three planes (fp32 x) or one of ``row_elems``
    bf16 a row; a forced general call always gets one, a forced direct one
    never."""
    rows = 3
    x = _x(dtype, rows, k, off)
    q = torch.zeros((8, k // 2) if g else (8, k), dtype=torch.uint8 if g else torch.int8)
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    as_is = dtype == torch.bfloat16 and aligned and (k % 64 == 0 if g == 0 else (g // 2) % 32 == 0)
    assert reads_as_is(x, q, k, g) == as_is
    want = (3 if dtype == torch.float32 else 1) * rows * row_elems(k, g)
    ws = workspace(x, q, rows, k, g)
    if as_is:
        assert ws is None
    else:
        assert ws.dtype == torch.bfloat16 and ws.numel() == want
    assert workspace(x, q, rows, k, g, GENERAL).numel() == want
    assert workspace(x, q, rows, k, g, TC) is None
