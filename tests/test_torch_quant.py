"""The port's weight quantization against the JAX package: quantized bytes
are bit-identical (after the ``[in, out]`` → ``[out, in]`` transpose), the
plain versions of the quantized gemv and the dequantizing GEMM match the
Pallas kernels in interpret mode, quantized trees convert both ways bitwise,
and the quantized tiny model matches JAX's ``vlm_forward(impl="xla")``.
Inputs from numpy with a fixed seed, fp32, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.ops.pallas.gemv import (
    int4_gemv_pallas,
    int4_gemv_stacked_pallas,
    int8_gemv_pallas,
    int8_gemv_stacked_pallas,
)
from llama32mm_tpu.ops.pallas.quant_matmul import int4_matmul_pallas, int8_matmul_pallas
from llama32mm_tpu.utils import kvcache as jkv
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params
from llama32mm_tpu_torch.models.common import QuantLinear
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.cuda.qgemv import split_bf16_planes
from llama32mm_tpu_torch.ops.gemv import qlinear
from llama32mm_tpu_torch.ops.quant import (
    INT4_MIXED_RECIPE,
    dequantize_weight,
    quantize_weight,
    quantize_weight_int4,
    unpack_int4,
)
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache

# (bits, group_size, recipe) of the JAX package's quantize_llama_params
MODES = {
    "int8": dict(bits=8),
    "int4_g32": dict(bits=4, group_size=32),
    "mixed_g32": dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE),
}


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _weight(seed=0, k=256, n=96):
    """``[in, out]`` (the JAX orientation) with a zero column and a zero group."""
    w = _rand(np.random.RandomState(seed), k, n)
    w[:, 5] = 0.0
    w[32:64, 7] = 0.0
    return w


def _port(w):
    return torch.from_numpy(np.ascontiguousarray(w.T))


@pytest.mark.parametrize("compiled", [False, True])
def test_quantize_weight_is_bitwise_jax(compiled):
    """Eager JAX divides by 127; under jit XLA multiplies by the fp32
    reciprocal. ``compiled`` selects which of the two the port reproduces."""
    w = _weight()
    fn = jax.jit(jq.quantize_weight) if compiled else jq.quantize_weight
    want = fn(jnp.asarray(w))
    got = quantize_weight(_port(w), compiled=compiled)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert float(got["scale"][5]) == 1.0  # zero column


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("group_size", [32, 128])
def test_quantize_weight_int4_is_bitwise_jax(group_size, compiled):
    w = _weight(1)
    fn = jax.jit(jq.quantize_weight_int4, static_argnums=1) if compiled else jq.quantize_weight_int4
    want = fn(jnp.asarray(w), group_size)
    got = quantize_weight_int4(_port(w), group_size, compiled=compiled)
    assert got["q4"].dtype == torch.uint8 and tuple(got["q4"].shape) == (96, 128)
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]).T)
    assert float(got["scale"][5].max()) == 1.0 == float(got["scale"][5].min())


def test_quantize_weight_int4_refuses_ragged_groups():
    with pytest.raises(ValueError, match="divisible"):
        quantize_weight_int4(torch.ones(8, 60), group_size=32)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_and_unpack_equal_jax(bits):
    w = _weight(2)
    if bits == 8:
        jqw = jq.quantize_weight(jnp.asarray(w))
        qw = quantize_weight(_port(w))
    else:
        jqw = jq.quantize_weight_int4(jnp.asarray(w), 32)
        qw = quantize_weight_int4(_port(w), 32)
        np.testing.assert_array_equal(unpack_int4(qw["q4"], 8).numpy(),
                                      np.asarray(jq.unpack_int4(jqw["q4"], 8)).T)
    want = np.asarray(jq.dequantize_weight(jqw, jnp.float32)).T
    np.testing.assert_array_equal(dequantize_weight(qw, torch.float32).numpy(), want)


@pytest.mark.parametrize("rows", [1, 5, 32])
@pytest.mark.parametrize("pallas_fn", ["int8_gemv_pallas", "int8_gemv_stacked_pallas"])
def test_int8_gemv_plain_matches_pallas(rows, pallas_fn):
    rs = np.random.RandomState(3)
    k, n, layers = 96, 300, 3
    ws = _rand(rs, layers, k, n, scale=0.1)
    x = _rand(rs, rows, k)
    jqw = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    if pallas_fn == "int8_gemv_pallas":
        want = int8_gemv_pallas(jnp.asarray(x), jqw[1]["q"], jqw[1]["scale"])
    else:
        want = int8_gemv_stacked_pallas(jnp.asarray(x), jnp.stack([q["q"] for q in jqw]),
                                        jnp.stack([q["scale"] for q in jqw]), 1)
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x), quantize_weight(_port(ws[1])))
    assert kernels.plain_counts()["gemv_int8"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [128, 100])  # a multiple of the kernel's 64-k span; ragged
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 16, 17, 32])  # the kernel's row tiles: 8, 16, 32
@pytest.mark.parametrize("pallas_fn", ["int8_gemv_pallas", "int8_gemv_stacked_pallas"])
def test_int8_gemv_plain_matches_pallas_bf16(pallas_fn, rows, k):
    """bf16 x, as the decode path gives the int8 gemv. Which kernel runs is
    decided in C (``l32_gemv_int8``: the tensor-core kernel on x as it is for
    bf16 x with K a multiple of 64 and 16-byte-aligned x and q, else the
    general route after a pre-pass) and
    cannot be tested here, where ``qlinear`` runs ``gemv_int8_plain`` at
    every shape; ``chip_smoke.py`` checks the routing on the card. Tolerance
    2^-7 of the largest output: the plain version rounds the product to bf16
    before the scale and the scaled result again, Pallas once (each rounding
    at most 2^-9 relative, and an output's scale below the largest one's)."""
    rs = np.random.RandomState(5)
    n, layers = 200, 2
    ws = _rand(rs, layers, k, n, scale=0.1)
    x = _rand(rs, rows, k)
    jqw = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if pallas_fn == "int8_gemv_pallas":
        want = int8_gemv_pallas(xj, jqw[1]["q"], jqw[1]["scale"])
    else:
        want = int8_gemv_stacked_pallas(xj, jnp.stack([q["q"] for q in jqw]),
                                        jnp.stack([q["scale"] for q in jqw]), 1)
    want = np.asarray(want.astype(jnp.float32))
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x).to(torch.bfloat16), quantize_weight(_port(ws[1])))
    assert got.dtype == torch.bfloat16 and kernels.plain_counts()["gemv_int8"] == 1
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("g", [32, 64, 256])  # 256 = K: per-channel
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 32])  # the kernel's row tiles: 8, 16, 32
@pytest.mark.parametrize("variant", ["post", "pre"])
def test_int4_gemv_plain_matches_pallas(variant, rows, g):
    """The Pallas "post" and "pre" unpacks compute one product; the port has
    one W4A16 kernel for both."""
    rs = np.random.RandomState(4)
    k, n, layers = 256, 200, 2
    ws = _rand(rs, layers, k, n, scale=0.1)
    x = _rand(rs, rows, k)
    jqw = [jq.quantize_weight_int4(jnp.asarray(w), g) for w in ws]
    want = int4_gemv_stacked_pallas(jnp.asarray(x), jnp.stack([q["q4"] for q in jqw]),
                                    jnp.stack([q["scale"] for q in jqw]), 1, variant=variant)
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x), quantize_weight_int4(_port(ws[1]), g))
    assert kernels.plain_counts()["gemv_int4"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# (K, g) of the group sizes the card's W4A16 kernel reads in packed order:
# g/2 not a multiple of 16 (spans of 16 weight bytes straddle groups), and
# per-channel groups with K % 32 != 0 (rows of K/2 = 100 and 2050 bytes, not
# 16-byte aligned). The Pallas kernel takes each in interpret mode.
OTHER_GROUPS = [(192, 16), (192, 24), (200, 200), (4100, 4100)]


@pytest.mark.parametrize("k,g", OTHER_GROUPS)
@pytest.mark.parametrize("rows", [1, 8, 9, 32])  # fp32 x at the kernel's row tiles
def test_int4_gemv_plain_matches_pallas_other_groups(rows, k, g):
    """fp32 x through ``qlinear`` (the W4A16 plain version) against
    ``int4_gemv_pallas`` at those group sizes, within 1e-5 of the largest
    output: both sides sum in fp32, in other orders."""
    rs = np.random.RandomState(k + g)
    w = _rand(rs, k, 150, scale=0.1)
    x = _rand(rs, rows, k)
    jqw = jq.quantize_weight_int4(jnp.asarray(w), g)
    want = np.asarray(int4_gemv_pallas(jnp.asarray(x), jqw["q4"], jqw["scale"], variant="post"))
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x), quantize_weight_int4(_port(w), g))
    assert kernels.plain_counts()["gemv_int4"] == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 150)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["normal", "huge", "tiny", "zero"])
def test_split_bf16_planes_sum_back_exactly(kind):
    """The W4A16 pre-pass's split of fp32 x into three bf16 planes: each
    plane is a bf16 value, and the three add back to x exactly (in fp64, and
    in fp32 from the largest plane down), with signs, near the fp32 maximum
    (truncation: no plane rounds up to inf) and far below 1."""
    rs = np.random.RandomState(11)
    x = rs.randn(7, 33).astype(np.float32)
    x[0, :4] = [1.0, -1.0, np.float32(1 + 2.0 ** -23), -np.float32(3.0) / np.float32(7.0)]
    x *= {"normal": 1.0, "huge": 3.0e38 / np.abs(x).max(), "tiny": 1e-30, "zero": 0.0}[kind]
    planes = split_bf16_planes(torch.from_numpy(x))
    assert planes.dtype == torch.bfloat16 and tuple(planes.shape) == (3, 7, 33)
    p = planes.double().numpy()
    np.testing.assert_array_equal(p.sum(axis=0), x.astype(np.float64))
    f = planes.float()
    assert torch.equal((f[0] + f[1]) + f[2], torch.from_numpy(x))
    assert torch.isfinite(f).all()
    if kind == "normal":  # every plane carries bits of a generic fp32 value
        assert (f[1] != 0).any() and (f[2] != 0).any()


# (bits, rows, K, N, group): rows above the gemv limit; K=200 is ragged for
# the int8 Pallas kernel's 256-wide K blocks, K=96 for int4 is 3 groups of 32.
# The *_r130 cases are shapes the card's wgmma kernel takes (int8 K a
# multiple of 64, int4 g/2 a multiple of 32) with R past one 128-row tile
# and N past two 128-column tiles.
QMATMUL_CASES = {
    "int8_r130": (8, 130, 256, 300, 0),
    "int4_g128_r130": (4, 130, 256, 300, 128),
    "int8_r33": (8, 33, 256, 300, 0),
    "int8_r100": (8, 100, 256, 130, 0),
    "int8_ragged_k": (8, 40, 200, 130, 0),
    "int4_r33": (4, 33, 256, 300, 64),
    "int4_r100": (4, 100, 256, 130, 32),
    "int4_ragged_k": (4, 40, 96, 130, 32),
}


@pytest.mark.parametrize("case", sorted(QMATMUL_CASES))
def test_qmatmul_plain_matches_pallas(case):
    bits, rows, k, n, g = QMATMUL_CASES[case]
    rs = np.random.RandomState(5)
    w, x = _rand(rs, k, n, scale=0.1), _rand(rs, rows, k)
    if bits == 8:
        jqw = jq.quantize_weight(jnp.asarray(w))
        want = int8_matmul_pallas(jnp.asarray(x), jqw["q"], jqw["scale"])
        qw = quantize_weight(_port(w))
    else:
        jqw = jq.quantize_weight_int4(jnp.asarray(w), g)
        want = int4_matmul_pallas(jnp.asarray(x), jqw["q4"], jqw["scale"])
        qw = quantize_weight_int4(_port(w), g)
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x), qw)
    assert kernels.plain_counts()["qmatmul"] == 1 and not any(kernels.launch_counts().values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_qmatmul_plain_int4_k512_matches_float64():
    """int4 g=128 R=130 N=300 at K=512 (four groups), held against the float64
    product of the same dequantized weights rather than against the Pallas
    kernel. With this data the port's plain version is within 4.3e-6 of
    float64 everywhere, while ``int4_matmul_pallas`` (interpret mode) is
    1.7e-5 away at five elements, past the 1e-5 tolerance: it takes the raw
    product with ``u = q + 8`` and subtracts ``8 * rowsum(x) @ scale``
    afterwards, and that raw fp32 product is ~16x the result, so its rounding
    is ~16x larger relative to it. ``int4_g128_r130`` above therefore
    compares with Pallas at K=256, where both stay within 1e-5."""
    rs = np.random.RandomState(5)
    w, x = _rand(rs, 512, 300, scale=0.1), _rand(rs, 130, 512)
    qw = quantize_weight_int4(_port(w), 128)
    kernels.reset_counters()
    got = qlinear(torch.from_numpy(x), qw)
    assert kernels.plain_counts()["qmatmul"] == 1 and not any(kernels.launch_counts().values())
    want = x.astype(np.float64) @ dequantize_weight(qw, torch.float32).double().numpy().T
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def untied():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(0), jcfg, tie_weights=False)
    return jcfg, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_tree_roundtrip_is_bitwise(untied, mode):
    jcfg, params = untied
    qtree = _np(jq.quantize_llama_params(params, **MODES[mode]))
    model = from_jax_params(qtree, tiny_mllama_config(), "cpu")
    blk = model.language_model.model.blocks[0]
    assert isinstance(blk.att.W_query, QuantLinear) and isinstance(model.language_model.lm_head,
                                                                   QuantLinear)
    _assert_trees_equal(to_jax_params(model), qtree)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_quantize_llama_params_equals_jax(untied, mode):
    jcfg, params = untied
    want = _np(jq.quantize_llama_params(params, **MODES[mode]))
    model = from_jax_params(_np(params), tiny_mllama_config(), "cpu")
    before = to_jax_params(model)
    got = to_jax_params(quantize_llama_params(model, **MODES[mode]))
    _assert_trees_equal(got, want)
    _assert_trees_equal(to_jax_params(model), before)  # the float model is untouched


def test_quantize_llama_params_options(untied):
    jcfg, params = untied
    cfg = tiny_mllama_config()
    with pytest.raises(ValueError, match="bits"):
        quantize_llama_params(from_jax_params(_np(params), cfg, "cpu"), bits=3)
    with pytest.raises(ValueError, match="recipe"):
        quantize_llama_params(from_jax_params(_np(params), cfg, "cpu"), recipe={"w_up": 2})
    model = from_jax_params(_np(params), cfg, "cpu")
    q = quantize_llama_params(model, quantize_lm_head=False, free_originals=True)
    assert q.language_model.lm_head.weight.numel() > 0 and not isinstance(
        q.language_model.lm_head, QuantLinear)
    assert model.language_model.model.blocks[0].ff.w_down.weight.numel() == 0  # freed
    assert q.vision_model is model.vision_model  # shared, not copied
    tied = from_jax_params(_np(init_vlm_params(jax.random.PRNGKey(0), jcfg)), cfg, "cpu")
    assert quantize_llama_params(tied).language_model.lm_head is None  # a tied head stays float


def _inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 240, (2, 12))
    ids[:, 2:6] = cfg.image_token_index
    px = rs.randn(2, 3, 28, 28).astype(np.float32)
    mask = np.ones((2, 12), np.int64)
    mask[1, 9:] = 0
    return ids, px, mask


@pytest.mark.parametrize("cache", [None, "float"])
@pytest.mark.parametrize("mode", ["int8", "mixed_g32"])
def test_quantized_vlm_forward_matches_jax(untied, mode, cache):
    """Without a cache and through a float KV cache (the int8 cache:
    tests/test_torch_int8_kv.py)."""
    jcfg, params = untied
    qtree = jq.quantize_llama_params(params, **MODES[mode])
    cfg = tiny_mllama_config()
    model = from_jax_params(_np(qtree), cfg, "cpu")
    ids, px, mask = _inputs(cfg)
    jcache = pcache = None
    if cache == "float":
        jcache = jkv.init_kv_cache(jcfg.text_config, 2, 32, dtype=jnp.float32)
        pcache = init_kv_cache(cfg.text_config, 2, "cpu", max_length=32, dtype=torch.float32)
    want = jax_vlm_forward(qtree, jcfg, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                           attention_mask=jnp.asarray(mask), impl="xla", kv_cache=jcache)
    kernels.reset_counters()
    got = vlm_forward(model, cfg, input_ids=torch.from_numpy(ids),
                      pixel_values=torch.from_numpy(px), attention_mask=torch.from_numpy(mask),
                      kv_cache=pcache)
    plain = kernels.plain_counts()
    assert plain["gemv_int8"] and plain["swiglu"] == 0  # 24 rows: gemvs; quantized FFN explicit
    assert bool(plain["gemv_int4"]) == (mode == "mixed_g32")
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=1e-4)
