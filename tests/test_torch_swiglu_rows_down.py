"""The functions of the SwiGLU rows kernel and of the SwiGLU+down fusion at
their kernels' edges, against the JAX package's Pallas kernels in interpret
mode on the CPU, and the fusion's tiling helper.

- ``fused_swiglu`` (fp32, the plain path the CUDA-core rows kernel computes
  on the card for at most 8 rows) against ``fused_swiglu_pallas``: R 1, 3
  and 8 (the kernel's 1-, 4- and 8-row instantiations), H 96, 100 (not a
  multiple of its 16-byte vectors: the element-load route) and 4096 (the
  decoder's chain length), I 200 and 300 (not a multiple of the 4 columns a
  warp owns, nor of 16), x as given and as a view one element into its buffer
  (not 16-byte aligned).
- ``swiglu_down`` against the JAX ``swiglu_down(impl="pallas")`` in fp32 and
  bf16 at H 100, I 200 and 4100 (neither a multiple of its tile width, 32 and
  64 columns), R 1, 8 and 9 (9: two blocks of rows).
- ``swiglu_down_tiles``: the tile width and count and the workspace size the
  wrapper allocates and the kernel is given, at the 11B, 3B, tp=2 and ragged
  widths.

Inputs come from numpy with a fixed seed (weights 0.02 N(0, 1) at H = 4096,
else 0.1 N(0, 1)); weights in the JAX layout (``[H, I]`` gate and up,
``[I, H]`` down), transposed for the port. Tolerances, of the largest
magnitude of the expected output: fp32 1e-5 (the bar ``chip_smoke.py`` holds
both kernels to on the card; both sides compute in fp32, in other orders),
bf16 1.6e-2 (as ``tests/test_torch_swiglu_down.py``: the intermediate and the
output each take one bf16 rounding, which another summation order can move by
one ulp).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.pallas.swiglu import fused_swiglu_pallas
from llama32mm_tpu.ops.swiglu import swiglu_down as jax_swiglu_down
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.cuda.swiglu import swiglu_down_tiles
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu, swiglu_down

FP32_TOL = 1e-5
BF16_TOL = 1.6e-2


def _weights(rs, h, i):
    scale = 0.02 if h == 4096 else 0.1
    return tuple((rs.randn(h, i) * scale).astype(np.float32) for _ in range(2))


def _port(a, dtype=torch.float32, offset=False):
    """A torch copy of ``a``; with ``offset`` a contiguous view that starts
    one element into its buffer."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if not offset:
        return t
    view = torch.cat([torch.zeros(1, dtype=dtype), t.reshape(-1)])[1:].view(t.shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def _close(got, want, tol):
    got, want = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _rows_case(r, h, i):
    """x and both weights (JAX layout) and the Pallas kernel's output."""
    rs = np.random.RandomState(23)
    x = rs.randn(r, h).astype(np.float32)
    wg, wu = _weights(rs, h, i)
    return x, wg, wu, np.asarray(fused_swiglu_pallas(jnp.asarray(x), jnp.asarray(wg),
                                                     jnp.asarray(wu)))


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset_view"])
@pytest.mark.parametrize("i", [200, 300])
@pytest.mark.parametrize("h", [96, 100, 4096])
@pytest.mark.parametrize("r", [1, 3, 8])
def test_rows_forward_matches_pallas(r, h, i, offset):
    """The rows kernel's function: silu(x wg^T) * (x wu^T) at most 8 rows."""
    x, wg, wu, want = _rows_case(r, h, i)
    kernels.reset_counters()
    got = fused_swiglu(_port(x, offset=offset), _port(wg.T), _port(wu.T))
    assert kernels.plain_counts()["swiglu"] == 1 and not any(kernels.launch_counts().values())
    _close(got, want, FP32_TOL)


@functools.lru_cache(maxsize=None)
def _down_case(r, h, i, bf16):
    """x and the three weights (JAX layout) and the Pallas op's output in
    fp32 or bf16."""
    rs = np.random.RandomState(29)
    x = rs.randn(r, h).astype(np.float32)
    wg, wu = _weights(rs, h, i)
    wd = (rs.randn(i, h) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = jax_swiglu_down(*(jnp.asarray(a, jdt) for a in (x, wg, wu, wd)), impl="pallas")
    return x, wg, wu, wd, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("i", [200, 4100])
@pytest.mark.parametrize("r", [1, 8, 9])
def test_swiglu_down_matches_pallas(r, i, dtype):
    """The fusion's function: the intermediate rounded to x's dtype, then the
    down product; I ragged against the tile, one or two blocks of rows."""
    h = 100
    bf16 = dtype == torch.bfloat16
    x, wg, wu, wd, want = _down_case(r, h, i, bf16)
    assert i % swiglu_down_tiles(r, h, i)[0] != 0
    kernels.reset_counters()
    got = swiglu_down(_port(x, dtype), _port(wg.T, dtype), _port(wu.T, dtype), _port(wd.T, dtype))
    assert kernels.plain_counts()["swiglu_down"] == 1 and got.dtype == dtype
    assert tuple(got.shape) == (r, h)
    _close(got, want, BF16_TOL if bf16 else FP32_TOL)


# (rows, hidden, inter) -> (tile width, tile count)
TILES = {
    (1, 4096, 14336): (128, 112),  # 11B decode
    (8, 4096, 14336): (128, 112),  # 11B server
    (8, 3072, 8192): (96, 86),     # 3B
    (4, 4096, 7168): (64, 112),    # 11B at tp=2
    (9, 96, 200): (32, 7),         # ragged
    (3, 100, 37): (32, 2),
    (2, 64, 10000): (96, 105),
    (1, 64, 40000): (128, 313),    # past 4 spans a tile: more tiles
}


@pytest.mark.parametrize("shape", sorted(TILES), ids=lambda s: "r{}_h{}_i{}".format(*s))
def test_swiglu_down_tiles(shape):
    """The tile width (a multiple of the 32-column span, at most 128) and
    count, from I alone, and the workspace (clusters of 8 tiles x R x H fp32
    values): at most 112 tiles (14 clusters) up to 4 spans a tile, at the 11B
    widths 1.8 MB each way at R = 8."""
    r, h, i = shape
    tile, tiles, workspace = swiglu_down_tiles(r, h, i)
    assert (tile, tiles) == TILES[shape]
    assert tile % 32 == 0 and tile <= 128 and tiles == -(-i // tile)
    assert tiles <= 112 or tile == 128
    assert workspace == -(-tiles // 8) * r * h
    assert swiglu_down_tiles(1, 1, i)[:2] == (tile, tiles)  # R and H do not enter
    if (h, i) == (4096, 14336) and r == 8:
        assert 4 * workspace <= 16.8e6 / 8
