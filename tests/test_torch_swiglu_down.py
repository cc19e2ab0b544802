"""The port's SwiGLU+down op (the full-FFN decode fusion) against the JAX
package's ``swiglu_down(impl="pallas")`` in interpret mode, at the shapes of
its own test (``(R, H, I)`` = (16, 64, 128) and (9, 96, 200), the second a
ragged last intermediate tile), in fp32 and bf16, and the biased path.
Weights from numpy in the JAX layout (``[H, I]`` gate/up, ``[I, H]`` down),
transposed for the port.

Tolerances: fp32 1e-5 (the same fp32 sums in another order); bf16 1.6e-2 of
the largest output (the intermediate and the output each take one bf16
rounding, which a different summation order can move by one ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.swiglu import swiglu_down as jax_swiglu_down
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu, swiglu_down


def _case(r, h, i, seed=8):
    rs = np.random.RandomState(seed)
    x = rs.randn(r, h).astype(np.float32)
    wg, wu = ((rs.randn(h, i) * 0.1).astype(np.float32) for _ in range(2))
    wd = (rs.randn(i, h) * 0.1).astype(np.float32)
    return x, wg, wu, wd


def _port(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(dtype)


def _check(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 1.6e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,h,i", [(16, 64, 128), (9, 96, 200)])
def test_swiglu_down_matches_pallas(r, h, i, dtype):
    x, wg, wu, wd = _case(r, h, i)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_swiglu_down(*(jnp.asarray(a, jdt) for a in (x, wg, wu, wd)), impl="pallas")
    kernels.reset_counters()
    xt = torch.from_numpy(x).to(dtype)
    got = swiglu_down(xt, _port(wg, dtype), _port(wu, dtype), _port(wd, dtype))
    assert kernels.plain_counts()["swiglu_down"] == 1 and got.dtype == dtype
    assert tuple(got.shape) == (r, h)
    _check(got, want, dtype)


def test_swiglu_down_biased_path_matches_jax():
    """With biases both packages compose the SwiGLU and a matmul."""
    x, wg, wu, wd = _case(9, 96, 200, seed=3)
    rs = np.random.RandomState(4)
    bg, bu = (rs.randn(200).astype(np.float32) * 0.1 for _ in range(2))
    want = jax_swiglu_down(*(jnp.asarray(a) for a in (x, wg, wu, wd, bg, bu)), impl="pallas")
    kernels.reset_counters()
    got = swiglu_down(torch.from_numpy(x), _port(wg, torch.float32), _port(wu, torch.float32),
                      _port(wd, torch.float32), torch.from_numpy(bg), torch.from_numpy(bu))
    assert kernels.plain_counts()["swiglu_down"] == 0
    _check(got, want, torch.float32)
    # the biased SwiGLU alone: silu(x @ wg + bg) * (x @ wu + bu)
    gate, up = x @ wg + bg, x @ wu + bu
    np.testing.assert_allclose(
        fused_swiglu(torch.from_numpy(x), _port(wg, torch.float32), _port(wu, torch.float32),
                     torch.from_numpy(bg), torch.from_numpy(bu)).numpy(),
        gate / (1 + np.exp(-gate)) * up, atol=1e-5, rtol=1e-5)


def test_swiglu_down_under_autograd_is_the_composition():
    """Under autograd the op is fused SwiGLU then a matmul, with gradients."""
    x, wg, wu, wd = _case(3, 64, 128, seed=5)
    xt = torch.from_numpy(x).requires_grad_()
    out = swiglu_down(xt, _port(wg, torch.float32), _port(wu, torch.float32),
                      _port(wd, torch.float32))
    out.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    with torch.no_grad():
        want = swiglu_down(xt, _port(wg, torch.float32), _port(wu, torch.float32),
                           _port(wd, torch.float32))
    torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=1e-5)
