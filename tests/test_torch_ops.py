"""The port's op math (the plain PyTorch versions the CPU runs) against the
JAX package's Pallas kernels in interpret mode and its rope and sampler.
Inputs come from numpy with a fixed seed; everything is fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.attention import AttnMask as JaxAttnMask
from llama32mm_tpu.ops.attention import dense_from_structured as jax_dense
from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.ops.pallas.gemv import gemv_pallas, gemv_t_pallas
from llama32mm_tpu.ops.pallas.rmsnorm import fused_add_rmsnorm_pallas
from llama32mm_tpu.ops.pallas.swiglu import fused_swiglu_pallas
from llama32mm_tpu.ops.rope import apply_rotary_pos_emb as jax_apply_rope
from llama32mm_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from llama32mm_tpu.utils.sampling import filter_logits as jax_filter_logits
from llama32mm_tpu.utils.sampling import select_next_token as jax_select_next_token
from llama32mm_tpu_torch.ops.attention import AttnMask, dense_from_structured, gqa_attention
from llama32mm_tpu_torch.ops.gemv import linear
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_cos_sin
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu
from llama32mm_tpu_torch.utils.sampling import filter_logits, select_next_token


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 7, 64), (2, 160), (3, 9, 256), (1, 33)])
@pytest.mark.parametrize("with_residual", [True, False])
def test_rmsnorm_matches_pallas(shape, with_residual):
    rs = np.random.RandomState(0)
    x, res = _rand(rs, *shape), _rand(rs, *shape)
    w = _rand(rs, shape[-1]) + 1.0
    eps = 1e-5
    want = fused_add_rmsnorm_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(res if with_residual else np.zeros_like(x)), eps)
    got = fused_add_rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps,
                            residual=torch.from_numpy(res) if with_residual else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# (130, 256, 300): more than one 128-row tile, H a multiple of 64 (the
# shape class of the TMA tile on the card), I not a multiple of its 128.
# (5, 96, 200) and (8, 128, 384): at most 8 rows with H a multiple of 32 (the
# tensor-core rows kernel's class), I = 200 not a multiple of its 16 columns.
@pytest.mark.parametrize("r,h,i", [(1, 64, 128), (10, 96, 200), (33, 128, 384), (130, 256, 300),
                                   (5, 96, 200), (8, 128, 384)])
def test_swiglu_matches_pallas(r, h, i):
    rs = np.random.RandomState(1)
    x, wg, wu = _rand(rs, r, h), _rand(rs, h, i, scale=0.1), _rand(rs, h, i, scale=0.1)
    want = fused_swiglu_pallas(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    # the port stores both weights [I, H]
    got = fused_swiglu(torch.from_numpy(x), torch.from_numpy(wg.T.copy()),
                       torch.from_numpy(wu.T.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# (rows, K): K = 96 as before; the row buckets' edges 8, 16 and 17 at K = 128,
# a multiple of 32 (the shape class of the tensor-core kernel on the card).
# N = 300 is not a multiple of 16 (the kernel's column groups).
GEMV_CASES = [(1, 96), (5, 96), (32, 96), (8, 128), (16, 128), (17, 128)]


@pytest.mark.parametrize("rows,k", GEMV_CASES, ids=[str(r) for r, _ in GEMV_CASES])
@pytest.mark.parametrize("pallas_fn", ["gemv_t_pallas", "gemv_pallas"])
def test_gemv_matches_pallas(rows, k, pallas_fn):
    rs = np.random.RandomState(2)
    n = 300
    x, w_nk = _rand(rs, rows, k), _rand(rs, n, k, scale=0.1)
    if pallas_fn == "gemv_t_pallas":
        want = gemv_t_pallas(jnp.asarray(x), jnp.asarray(w_nk))
    else:
        want = gemv_pallas(jnp.asarray(x), jnp.asarray(w_nk.T.copy()))
    got = linear(torch.from_numpy(x), torch.from_numpy(w_nk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_gemv_bf16_matches_pallas():
    """bf16 x and weight, 8 rows, K = 128, N = 300, against the Pallas kernel
    in bf16. Both accumulate in fp32 and round once to bf16, summing in other
    orders, so an output may move by one bf16 step: at most 2^-7 of its
    magnitude, so 2^-7 of max|want|."""
    rs = np.random.RandomState(2)
    x, w_nk = _rand(rs, 8, 128), _rand(rs, 300, 128, scale=0.1)
    want = gemv_t_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(w_nk).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = linear(torch.from_numpy(x).bfloat16(), torch.from_numpy(w_nk).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-7 * np.abs(want).max())


def _swiglu_bf16_matches_pallas(r, h, i):
    rs = np.random.RandomState(1)
    x, wg, wu = _rand(rs, r, h), _rand(rs, h, i, scale=0.1), _rand(rs, h, i, scale=0.1)
    want = fused_swiglu_pallas(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wg, wu)))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = fused_swiglu(torch.from_numpy(x).bfloat16(), torch.from_numpy(wg.T.copy()).bfloat16(),
                       torch.from_numpy(wu.T.copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1.6e-2 * np.abs(want).max())


def test_swiglu_bf16_matches_pallas():
    """bf16 (130, 256, 300) against the Pallas kernel in bf16, within
    1.6e-2 of max|want| (two bf16 steps): the Pallas kernel keeps gate and
    up in fp32, the port's plain version rounds each to bf16 (cuBLAS's
    products in x's dtype) before silu(gate) * up, and the output is rounded
    once more."""
    _swiglu_bf16_matches_pallas(130, 256, 300)


@pytest.mark.parametrize("r,h,i", [(1, 128, 384), (5, 96, 200), (8, 128, 384)])
def test_swiglu_bf16_decode_rows_match_pallas(r, h, i):
    """``test_swiglu_bf16_matches_pallas`` in the tensor-core rows kernel's
    class (at most 8 rows, H a multiple of 32)."""
    _swiglu_bf16_matches_pallas(r, h, i)


# (b, nq, nkv, tq, tk, hd, q_offset, causal, key validity)
FLASH_CASES = {
    "noncausal_group1": (1, 4, 4, 16, 16, 16, 0, False, "all"),
    "causal_group4": (2, 4, 1, 16, 16, 16, 0, True, "all"),
    "decode_tq1_cache_tail_hd80": (1, 4, 1, 1, 200, 80, 150, True, "prefix151"),
    "qoffset_padded_keys": (2, 4, 2, 8, 200, 16, 120, True, "holes"),
    "noncausal_hd80_padded": (1, 2, 2, 12, 12, 80, 0, False, "prefix9"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_pallas(case):
    b, nq, nkv, tq, tk, hd, q_offset, causal, validity = FLASH_CASES[case]
    rs = np.random.RandomState(3)
    q, k, v = _rand(rs, b, nq, tq, hd), _rand(rs, b, nkv, tk, hd), _rand(rs, b, nkv, tk, hd)
    kv_valid = np.ones((b, tk), np.int32)
    if validity.startswith("prefix"):
        kv_valid[:, int(validity[6:]):] = 0
    elif validity == "holes":
        kv_valid = (rs.rand(b, tk) > 0.3).astype(np.int32)
        kv_valid[:, q_offset + tq:] = 0  # cache tail
    want = flash_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid), q_offset,
        causal=causal, block_q=8, block_k=128,
    )
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        AttnMask(torch.from_numpy(kv_valid), q_offset), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_fully_masked_row_is_zero():
    rs = np.random.RandomState(4)
    q, k, v = _rand(rs, 1, 2, 3, 16), _rand(rs, 1, 2, 5, 16), _rand(rs, 1, 2, 5, 16)
    kv_valid = np.array([[0, 0, 1, 1, 1]], np.int32)  # query 0 (causal) sees only key 0
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        AttnMask(torch.from_numpy(kv_valid), 0))
    assert torch.all(got[:, :, 0] == 0)
    want = flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(kv_valid), 0, block_q=8, block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_rope_matches_jax():
    rs = np.random.RandomState(5)
    pos = rs.randint(0, 40, (2, 6))
    q, k = _rand(rs, 2, 4, 6, 16), _rand(rs, 2, 2, 6, 16)
    jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    jq, jk = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    pq, pk = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k), cos, sin)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-6)


def test_rope_scaling_matches_jax():
    scaling = dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                   original_context_length=8192)
    pos = np.arange(8)[None, :]
    jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), 128, 500000.0, scaling=scaling)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 128, 500000.0, scaling=scaling)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


@pytest.mark.parametrize("temperature,top_p,top_k,min_p", [
    (0.7, 0.9, 10, 0.0), (1.0, 0.5, 0, 0.05), (1.3, 1.0, 5, 0.1), (0.9, 0.95, 50, 0.0),
])
def test_filter_logits_matches_jax(temperature, top_p, top_k, min_p):
    logits = _rand(np.random.RandomState(6), 3, 97, scale=3.0)
    want = np.asarray(jax_filter_logits(jnp.asarray(logits), temperature, top_p, top_k, min_p))
    got = filter_logits(torch.from_numpy(logits), temperature, top_p, top_k, min_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=1e-6)


def test_greedy_select_matches_jax():
    logits = _rand(np.random.RandomState(7), 4, 97)
    want = np.asarray(jax_select_next_token(jnp.asarray(logits), None, temperature=0.0))
    got = select_next_token(torch.from_numpy(logits), temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_select_stays_inside_filter():
    logits = torch.from_numpy(_rand(np.random.RandomState(8), 2, 97, scale=3.0))
    allowed = ~torch.isneginf(filter_logits(logits, 0.8, 0.9, 5, 0.0))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = select_next_token(logits, gen, temperature=0.8, top_p=0.9, top_k=5)
        assert bool(allowed[torch.arange(2), tok].all())


@pytest.mark.parametrize("causal", [True, False])
def test_dense_from_structured_matches_jax(causal):
    kv_valid = np.array([[1, 1, 0, 1, 1, 0], [1, 1, 1, 1, 0, 0]], np.int32)
    want = np.asarray(jax_dense(JaxAttnMask(jnp.asarray(kv_valid), jnp.asarray(2, jnp.int32)),
                                3, 6, jnp.float32, causal))
    got = dense_from_structured(AttnMask(torch.from_numpy(kv_valid), 2), 3, 6, torch.float32,
                                causal).numpy()
    np.testing.assert_array_equal(got, want)
