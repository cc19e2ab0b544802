"""The port's W4A8 int4 gemv (int8-quantized activations) against the JAX
package's ``int4_gemv_stacked_pallas(variant="w4a8" | "w4a8b")`` in
interpret mode, its routing in ``qlinear``, and a tiny int4 engine whose
greedy tokens under W4A8 equal those under W4A16. Inputs from numpy with a
fixed seed, CPU.

Tolerances: on the exact int8 grid (``x = 0.0173·i``) the activation
quantization is lossless and both sides compute the same integers, so fp32
agrees to accumulation order, 1e-4 (the JAX package's own bound for this
case); generic fp32 activations quantize to the same int8 values on both
sides (true divisions, round half to even), 1e-4 again; bf16 outputs agree
to one bf16 rounding of the result, 1.6e-2 of the largest output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.ops.pallas.gemv import int4_gemv_pallas, int4_gemv_stacked_pallas
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops import gemv as gemv_mod
from llama32mm_tpu_torch.ops.cuda.qgemv import gemv_int4_w4a8_plain, quantize_rows_int8
from llama32mm_tpu_torch.ops.gemv import qlinear

K, N = 256, 192


def _weights(seed, group):
    """Two stacked JAX-layout int4 layers and layer 1 in the port's layout."""
    ws = (np.random.RandomState(seed).randn(2, K, N) * 0.1).astype(np.float32)
    jqw = [jq.quantize_weight_int4(jnp.asarray(w), group) for w in ws]
    stacked = (jnp.stack([q["q4"] for q in jqw]), jnp.stack([q["scale"] for q in jqw]))
    port = (torch.from_numpy(np.array(np.asarray(jqw[1]["q4"]).T, order="C")),
            torch.from_numpy(np.array(np.asarray(jqw[1]["scale"]).T, order="C")))
    return stacked, port


def _x(seed, rows, grid):
    rs = np.random.RandomState(seed)
    if grid:  # x = m·i, i in [-127, 127]: the per-row int8 rounding is exact
        return (rs.randint(-127, 128, (rows, K)) * 0.0173).astype(np.float32)
    return rs.randn(rows, K).astype(np.float32)


def _plain_matches_pallas(variant, group, dtype, row_counts):
    (q4s, scales), (q4, scale) = _weights(7, group)
    for rows in row_counts:
        for grid in (True, False):
            x = _x(rows * 10 + grid, rows, grid)
            xj = jnp.asarray(x, dtype=jnp.dtype(dtype))
            want = np.asarray(int4_gemv_stacked_pallas(xj, q4s, scales, jnp.asarray(1),
                                                       block_bytes=64 * 1024, variant=variant),
                              np.float32)
            xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
            got = gemv_int4_w4a8_plain(xt, q4, scale)
            assert got.dtype == xt.dtype and tuple(got.shape) == (rows, N)
            got = got.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
            else:
                assert np.abs(got - want).max() <= 1.6e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [64, K])  # grouped, and per-channel (g = K)
@pytest.mark.parametrize("variant", ["w4a8", "w4a8b"])
def test_w4a8_plain_matches_pallas(variant, group, dtype):
    _plain_matches_pallas(variant, group, dtype, (1, 2, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [64, K])  # g/2 a multiple of 16: the card's tensor-core class
@pytest.mark.parametrize("rows", [8, 9, 16, 17, 32])  # the row buckets' edges (n8 tiles of x)
def test_w4a8_plain_matches_pallas_row_buckets(rows, group, dtype):
    """``test_w4a8_plain_matches_pallas`` at the row counts where the card's
    tensor-core W4A8 kernel changes its tiling (one n8 tile of x rows up to
    8, two up to 16, four with two m16 tiles up to 32)."""
    _plain_matches_pallas("w4a8", group, dtype, (rows,))


@pytest.mark.parametrize("k,g", [(192, 16), (192, 24), (200, 200), (4100, 4100)])
@pytest.mark.parametrize("variant", ["w4a8", "w4a8b"])
def test_w4a8_plain_matches_pallas_other_groups(variant, k, g):
    """The W4A8 plain version against ``int4_gemv_pallas`` at the group sizes
    the card's kernel reads in packed order (g/2 not a multiple of 16: spans
    straddle groups; per-channel K % 32 != 0: rows of K/2 = 100 and 2050
    bytes), fp32 x at R = 1, 8, 9 and 32 (1e-5 of the largest output: the same
    integers, fp32 scale sums in other orders) and bf16 x (1.6e-2)."""
    rs = np.random.RandomState(k + g)
    w = (rs.randn(k, 150) * 0.1).astype(np.float32)
    jqw = jq.quantize_weight_int4(jnp.asarray(w), g)
    q4 = torch.from_numpy(np.array(np.asarray(jqw["q4"]).T, order="C"))
    scale = torch.from_numpy(np.array(np.asarray(jqw["scale"]).T, order="C"))
    for rows in (1, 8, 9, 32):
        x = rs.randn(rows, k).astype(np.float32)
        for dtype, tol in (("float32", 1e-5), ("bfloat16", 1.6e-2)):
            xj = jnp.asarray(x, dtype=jnp.dtype(dtype))
            want = np.asarray(int4_gemv_pallas(xj, jqw["q4"], jqw["scale"], variant=variant),
                              np.float32)
            xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
            got = gemv_int4_w4a8_plain(xt, q4, scale)
            assert got.dtype == xt.dtype and tuple(got.shape) == (rows, 150)
            assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_w4a8_row_quantization():
    """Per-row scales, round half to even, and an all-zero row at ax = 1."""
    x = torch.tensor([[0.0, 0.0, 0.0, 0.0], [127.0, 0.5, 1.5, -2.5], [-3.0, 1.0, 2.0, 0.0]])
    xq, ax = quantize_rows_int8(x)
    assert ax.tolist() == [1.0, 1.0, float(np.float32(3.0) / np.float32(127.0))]
    assert xq.dtype == torch.int8
    assert xq[0].tolist() == [0, 0, 0, 0] and xq[1].tolist() == [127, 0, 2, -2]
    assert xq[2].tolist() == [-127, 42, 85, 0]


@pytest.mark.parametrize("variant, rows, kernel", [
    ("w4a8", 1, "gemv_int4_w4a8"), ("w4a8b", 32, "gemv_int4_w4a8"),
    ("w4a8", 33, "qmatmul"), ("post", 5, "gemv_int4"), ("post", 32, "gemv_int4"),
    ("post", 33, "qmatmul"), ("pre", 8, "gemv_int4"), ("post-cat", 1, "gemv_int4"),
])
def test_qlinear_routes_int4_by_variant_and_rows(monkeypatch, variant, rows, kernel):
    """Under w4a8/w4a8b an int4 linear of at most 32 rows is the W4A8 gemv;
    more rows stay on the dequantizing GEMM (W4A16), as the JAX package sends
    prefill rows to its dequantized matmul. The variant is read per call."""
    monkeypatch.setattr(gemv_mod, "_INT4_VARIANT", variant)
    _, (q4, scale) = _weights(3, 64)
    x = torch.from_numpy(_x(rows, rows, False))
    kernels.reset_counters()
    out = qlinear(x, {"q4": q4, "scale": scale})
    counts = kernels.plain_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    if kernel == "gemv_int4_w4a8":
        torch.testing.assert_close(out, gemv_int4_w4a8_plain(x, q4, scale), rtol=0, atol=0)


def test_tiny_int4_engine_greedy_w4a8_equals_post(monkeypatch):
    """The JAX package's end-to-end assertion: on a tiny int4 model (g=32)
    the W4A8 decode gives the greedy tokens of the W4A16 one."""
    cfg = tiny_mllama_config()
    # seed 2: greedy tokens that change along the generation
    model = quantize_llama_params(init_vlm(cfg, "cpu", torch.Generator().manual_seed(2),
                                           tie_weights=False), bits=4, group_size=32)
    ids = np.random.RandomState(1).randint(0, 250, (1, 12))
    tokens = {}
    for variant in ("post", "w4a8"):
        monkeypatch.setattr(gemv_mod, "_INT4_VARIANT", variant)
        kernels.reset_counters()
        res = InferenceEngine(model, cfg, "cpu", max_cache_length=32).generate(
            ids, max_new_tokens=8)
        tokens[variant] = res.tokens[0].tolist()
        used = kernels.plain_counts()
        assert used["gemv_int4_w4a8" if variant == "w4a8" else "gemv_int4"] > 0
    assert tokens["w4a8"] == tokens["post"] and len(set(tokens["post"])) > 1
