"""The arithmetic of the gemvs' general routes (``csrc/gemv.cu``,
``csrc/qgemv.cu``) against the JAX package's Pallas kernels in interpret
mode, on fp32 x, with numpy / torch emulations of what the card computes:

- the int8 gemv takes fp32 x as three exact bf16 planes (the pre-pass,
  ``split_bf16_planes``), each plane's products with the int8 weights exact
  in fp32, each 64-k span summed apart, the planes added, the channel scale
  on the total: within 2e-6 of max|out| of ``int8_gemv_pallas``;
- the float gemv takes fp32 x and weights as 3xTF32 products (big = the
  value rounded to TF32 by an integer add and mask, small = the rest,
  truncated to TF32 as the ``mma`` reads it; small x small dropped), each
  16-k span summed apart: within 1e-5 of max|out| of ``gemv_pallas`` and
  ``gemv_t_pallas``;
- the wrappers allocate the pre-pass's workspace exactly where the kernels
  do not read x as it is.

The kernels themselves run only on the card (``chip_smoke.py``). Inputs
from numpy with a fixed seed, CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.ops.pallas.gemv import gemv_pallas, gemv_t_pallas, int8_gemv_pallas
from llama32mm_tpu_torch.ops.cuda.gemv import pad_workspace
from llama32mm_tpu_torch.ops.cuda.qgemv import int8_planes, split_bf16_planes
from llama32mm_tpu_torch.ops.quant import quantize_weight

INT8_TOL = 2e-6  # of max|out|: exact products, fp32 sums in another order
FP32_TOL = 1e-5  # of max|out|: chip_smoke.FP32_TOL


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _spans(k, span):
    return [slice(s, min(s + span, k)) for s in range(0, k, span)]


def int8_planes_emulation(x, q, scale, planes=3):
    """``[R, K]`` fp32 x, ``[N, K]`` int8 q, ``[N]`` scale: the int8 general
    route's sums in fp32 (``planes=1``: x rounded to one bf16 plane)."""
    p = split_bf16_planes(torch.from_numpy(x)).float().numpy()[:planes]
    w = q.numpy().astype(np.float32)
    tot = None
    for plane in p:  # ((t0 + t1) + t2)
        t = np.zeros((x.shape[0], w.shape[0]), np.float32)
        for sl in _spans(x.shape[1], 64):
            t += plane[:, sl] @ w[:, sl].T  # each product exact in fp32
        tot = t if tot is None else tot + t
    return tot * scale.numpy()


def split_tf32(v):
    """fp32 ``v`` as the kernel's registers: big rounded to TF32's 10-bit
    mantissa by an integer add and mask, small = v - big truncated to TF32
    (the ``mma`` reads the top 19 bits of a register)."""
    bits = v.view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = (v - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def tf32x3_emulation(x, w, products=3):
    """``[R, K]`` fp32 x against ``[N, K]`` fp32 w as the float general
    route sums it: w_s x_b + w_b x_s + w_b x_b a k (``products=1``: w_b x_b
    alone, one TF32 product), each 16-k span in fresh sums added in fp32."""
    xb, xs = split_tf32(x)
    wb, ws = split_tf32(w)
    out = np.zeros((x.shape[0], w.shape[0]), np.float32)
    for sl in _spans(x.shape[1], 16):
        c = xb[:, sl] @ wb[:, sl].T  # each TF32 x TF32 product exact in fp32
        if products == 3:
            c = (xb[:, sl] @ ws[:, sl].T + xs[:, sl] @ wb[:, sl].T) + c
        out += c
    return out


@pytest.mark.parametrize("k", [256, 4100])  # whole 64-k spans; ragged (the padded planes)
@pytest.mark.parametrize("rows", [1, 8, 32])  # one n8 tile of planes; chunks of 8 rows
def test_int8_fp32_planes_match_pallas(rows, k):
    """The three-plane sums hold to ``int8_gemv_pallas`` on fp32 x within
    2e-6 of max|out|; one bf16 plane (x rounded to bf16) would not."""
    rs = np.random.RandomState(21)
    n = 96
    w = _rand(rs, k, n, scale=0.02)  # [in, out], the JAX orientation
    x = _rand(rs, rows, k)
    jqw = jq.quantize_weight(jnp.asarray(w))
    qw = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(qw["q"].numpy(), np.asarray(jqw["q"]).T)
    want = np.asarray(int8_gemv_pallas(jnp.asarray(x), jqw["q"], jqw["scale"]))
    assert _rel_err(int8_planes_emulation(x, qw["q"], qw["scale"]), want) <= INT8_TOL
    assert _rel_err(int8_planes_emulation(x, qw["q"], qw["scale"], planes=1), want) > INT8_TOL


@pytest.mark.parametrize("k", [256, 4100])  # whole 16-k spans; ragged (the padded copy)
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("pallas_fn", ["gemv_pallas", "gemv_t_pallas"])
def test_float_tf32x3_matches_pallas(pallas_fn, rows, k):
    """3xTF32 holds to the fp32 Pallas gemvs within 1e-5 of max|out|; one
    TF32 product a k would not."""
    rs = np.random.RandomState(23)
    n = 80
    w = _rand(rs, n, k, scale=0.02)  # [N, K], the port's orientation
    x = _rand(rs, rows, k)
    if pallas_fn == "gemv_pallas":
        want = gemv_pallas(jnp.asarray(x), jnp.asarray(np.ascontiguousarray(w.T)))
    else:
        want = gemv_t_pallas(jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(want)
    assert _rel_err(tf32x3_emulation(x, w), want) <= FP32_TOL
    assert _rel_err(tf32x3_emulation(x, w, products=1), want) > FP32_TOL


def test_split_tf32_parts():
    """big is a TF32 value within half a TF32 ulp of v; small is what is left,
    truncated: big + small is v within 2^-21 of |v|."""
    rs = np.random.RandomState(25)
    v = _rand(rs, 4096) * np.float32(1e3)
    big, small = split_tf32(v)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(v - big) <= np.abs(v) * 2.0 ** -11)
    np.testing.assert_array_less(np.abs((big.astype(np.float64) + small) - v),
                                 np.abs(v) * 2.0 ** -21 + 1e-30)


def _x(dtype, rows, k, off):
    """``[rows, k]`` x starting ``off`` elements into a 64-byte-aligned buffer."""
    buf = torch.zeros(rows * k + 64, dtype=dtype)
    base = (-buf.data_ptr() // buf.element_size()) % (64 // buf.element_size())
    x = buf[base + off:base + off + rows * k].view(rows, k)
    assert (x.data_ptr() % 16 == 0) == (off * buf.element_size() % 16 == 0)
    return x


@pytest.mark.parametrize("off", [0, 1])  # x aligned; one element off
@pytest.mark.parametrize("k", [32, 64, 4096, 100, 4100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_workspace_where_x_is_not_read_as_it_is(dtype, k, off):
    """``pad_workspace`` (the float gemv: spans of 16 k fp32, 32 k bf16) and
    ``int8_planes`` (64 k; three planes for fp32 x) are None exactly where
    the kernel reads x as it is, else rows of K rounded up to the span."""
    rows = 3
    x = _x(dtype, rows, k, off)
    aligned = x.data_ptr() % 16 == 0
    span = 16 if dtype == torch.float32 else 32
    pad = pad_workspace(x, rows, k)
    if k % span == 0 and aligned:
        assert pad is None
    else:
        assert pad.dtype == dtype and pad.numel() == rows * -(-k // span) * span
    planes = int8_planes(x, rows, k)
    if dtype == torch.bfloat16 and k % 64 == 0 and aligned:
        assert planes is None
    else:
        count = 3 if dtype == torch.float32 else 1
        assert planes.dtype == torch.bfloat16
        assert planes.numel() == count * rows * -(-k // 64) * 64
