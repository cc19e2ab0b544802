"""The fp32 SwiGLU tile's plain versions (the functions that the 3xTF32 tile
computes on the card for fp32 calls above 8 rows and every fp32 backward)
against the JAX package's Pallas kernels in fp32: ``fused_swiglu_pallas``
(``_fwd_kernel``) and its custom VJP (``_bwd_kernel``'s d_gate and d_up,
then dx and the weight gradients), interpret mode on the CPU. The cases sit
at the tile's edges: R 9 (just above the rows kernel), 65 and 130 against
its 128-row tiles; H 96, 100 (not a multiple of its 64-k stages, nor of the
4 floats of its 16-byte copies) and 4096 (the decoder's chain length); I 200
and 300 against its 64-column tiles; x and the cotangent as views one
element into their buffers (not 16-byte aligned: the tile's plain-load
route).

Inputs come from numpy with a fixed seed (weights 0.02 N(0, 1) at H = 4096,
as ``chip_smoke.py``'s cases, else 0.1 N(0, 1)). Tolerance: 1e-5 of the
largest magnitude of each compared tensor (the bar ``chip_smoke.py`` holds
the tile to on the card): both sides compute in fp32, in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.pallas.swiglu import _swiglu_bwd_call, fused_swiglu_pallas
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu

TOL = 1e-5

# (R, H, I, x and g one element into their buffers)
CASES = {
    "r9_h96_i200": (9, 96, 200, False),
    "r65_h100_i300": (65, 100, 300, False),
    "r130_h4096_i200": (130, 4096, 200, False),
    "r130_h100_i300_offset_views": (130, 100, 300, True),
}


def _inputs(case):
    r, h, i, offset = CASES[case]
    rs = np.random.RandomState(3)
    scale = 0.02 if h == 4096 else 0.1
    x = rs.randn(r, h).astype(np.float32)
    wg, wu = ((rs.randn(h, i) * scale).astype(np.float32) for _ in range(2))  # JAX's [H, I]
    g = rs.randn(r, i).astype(np.float32)
    return x, wg, wu, g, offset


def _t(a, offset=False):
    """A torch copy of ``a``; with ``offset`` a contiguous view that starts
    one element into its buffer."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t
    view = torch.cat([torch.zeros(1), t.reshape(-1)])[1:].view(t.shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_forward_matches_pallas(case):
    """``swiglu_tf32``'s function: silu(x wg^T) * (x wu^T), weights [I, H]."""
    x, wg, wu, _, offset = _inputs(case)
    want = fused_swiglu_pallas(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    got = kernels.fused_swiglu_plain(_t(x, offset), _t(wg.T), _t(wu.T))
    _close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_backward_matches_pallas(case):
    """``swiglu_bwd_tf32``'s function: d_gate and d_up against the Pallas
    backward kernel's; through the autograd function's formulas, dx and the
    weight gradients against the Pallas VJP's."""
    x, wg, wu, g, offset = _inputs(case)
    xj, wgj, wuj, gj = (jnp.asarray(a) for a in (x, wg, wu, g))
    want_dgate, want_dup = _swiglu_bwd_call(xj, wgj, wuj, gj)
    _, vjp = jax.vjp(fused_swiglu_pallas, xj, wgj, wuj)
    want_dx, want_dwg, want_dwu = vjp(gj)
    xt, wgt, wut, gt = _t(x, offset), _t(wg.T), _t(wu.T), _t(g, offset)
    d_gate, d_up = kernels.fused_swiglu_bwd_plain(xt, wgt, wut, gt)
    _close(d_gate, want_dgate)
    _close(d_up, want_dup)
    leaves = [t.clone().requires_grad_() for t in (xt, wgt, wut)]
    fused_swiglu(*leaves, impl="torch").backward(gt)
    _close(leaves[0].grad, want_dx)
    _close(leaves[1].grad.t(), want_dwg)
    _close(leaves[2].grad.t(), want_dwu)
