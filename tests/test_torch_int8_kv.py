"""The port's int8 KV cache against the JAX package: ``quantize_kv`` bytes,
the cache write, the int8-KV flash attention's plain version against the
Pallas kernel (interpret mode) with ``k_scale``/``v_scale``, the VLM forward
through an int8 cache against JAX's ``impl="xla"``, and greedy generation
with ``kv_dtype="int8"`` on float, int8 and int4-mixed trees, token for
token against the JAX engine. Tiny config, fp32, CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.utils import kvcache as jkv
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache, quantize_kv

MAX_LEN = 64
TREES = {"float": None, "int8": dict(bits=8),
         "mixed_g32": dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE)}


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def test_quantize_kv_is_bitwise_jax():
    """The JAX package quantizes keys and values inside its compiled decoder;
    the port reproduces that program's bytes (zero rows included)."""
    x = _rand(np.random.RandomState(0), 2, 4, 50, 16)
    x[0, 1, 3] = 0.0
    want_q, want_s = jax.jit(jkv.quantize_kv)(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_int8_cache_update_writes_values_and_scales():
    tc = tiny_mllama_config().text_config
    cache = init_kv_cache(tc, 1, "cpu", max_length=8, dtype=torch.int8)
    kv = torch.from_numpy(_rand(np.random.RandomState(1), 1, tc.n_kv_groups, 3, tc.head_dim))
    cache.advance(2)
    k, v, ks, vs = cache.update(1, kv, 2 * kv)
    want_q, want_s = quantize_kv(kv)
    assert torch.equal(k[:, :, 2:5], want_q) and torch.equal(ks[:, :, 2:5], want_s)
    assert torch.equal(vs[:, :, 2:5], quantize_kv(2 * kv)[1])
    assert not k[:, :, :2].any() and not ks[:, :, 5:].any()  # other slots untouched
    assert k.data_ptr() == cache.k[1].data_ptr()  # the layer's buffers, not copies


# (b, nq, nkv, tq, tk, hd, q_offset, causal, key validity)
FLASH_CASES = {
    "prefill_causal": (1, 4, 2, 24, 40, 16, 0, True, "prefix24"),
    "decode_tq1": (1, 4, 1, 1, 200, 32, 150, True, "prefix151"),
    "ragged_b2_padded_keys": (2, 4, 2, 8, 200, 16, 120, True, "holes"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_int8kv_plain_matches_pallas(case):
    b, nq, nkv, tq, tk, hd, q_offset, causal, validity = FLASH_CASES[case]
    rs = np.random.RandomState(2)
    q = _rand(rs, b, nq, tq, hd)
    kq, ks = jkv.quantize_kv(jnp.asarray(_rand(rs, b, nkv, tk, hd)))
    vq, vs = jkv.quantize_kv(jnp.asarray(_rand(rs, b, nkv, tk, hd)))
    kv_valid = np.ones((b, tk), np.int32)
    if validity.startswith("prefix"):
        kv_valid[:, int(validity[6:]):] = 0
    else:
        kv_valid = (rs.rand(b, tk) > 0.3).astype(np.int32)
        kv_valid[:, q_offset + tq:] = 0  # cache tail
    want = flash_gqa_attention(jnp.asarray(q), kq, vq, jnp.asarray(kv_valid), q_offset,
                               causal=causal, block_q=8, block_k=128, k_scale=ks, v_scale=vs)
    kernels.reset_counters()
    got = gqa_attention(torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (kq, vq)),
                        AttnMask(torch.from_numpy(kv_valid), q_offset), causal=causal,
                        k_scale=torch.from_numpy(np.array(ks)),
                        v_scale=torch.from_numpy(np.array(vs)))
    assert kernels.plain_counts()["flash_attention_int8kv"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def trees():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    out = {}
    for name, kw in TREES.items():
        tree = params if kw is None else jq.quantize_llama_params(params, **kw)
        out[name] = (tree, from_jax_params(jax.tree.map(np.asarray, tree), tiny_mllama_config(),
                                           "cpu"))
    return jcfg, out


@pytest.mark.parametrize("tree", sorted(TREES))
def test_vlm_forward_int8_cache_matches_jax(trees, tree):
    jcfg, all_trees = trees
    params, model = all_trees[tree]
    cfg, tc = tiny_mllama_config(), tiny_mllama_config().text_config
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 240, (2, 12))
    ids[:, 2:6] = cfg.image_token_index
    px = rs.randn(2, 3, 28, 28).astype(np.float32)
    mask = np.ones((2, 12), np.int32)
    want = jax_vlm_forward(params, jcfg, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                           attention_mask=jnp.asarray(mask), impl="xla",
                           kv_cache=jkv.init_kv_cache(jcfg.text_config, 2, 32, dtype=jnp.int8))
    cache = init_kv_cache(tc, 2, "cpu", max_length=32, dtype=torch.int8)
    got = vlm_forward(model, cfg, input_ids=torch.from_numpy(ids),
                      pixel_values=torch.from_numpy(px), attention_mask=torch.from_numpy(mask),
                      kv_cache=cache)
    assert cache.pos == 12 and cache.k.dtype == torch.int8
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=1e-4)
    # the cache holds JAX's bytes up to rounding-boundary ties of the fp32 keys
    jk = np.asarray(want.kv_cache.k)[:, :, :, :12]
    assert np.abs(cache.k[:, :, :, :12].numpy().astype(np.int32) - jk).max() <= 1


@pytest.mark.parametrize("tree", sorted(TREES))
def test_engine_int8_kv_matches_jax(trees, tree):
    jcfg, all_trees = trees
    params, model = all_trees[tree]
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 240, (1, 10))
    ids[:, 1:5] = 250
    px = rs.randn(1, 3, 28, 28).astype(np.float32)
    jres = JaxEngine(params, jcfg, max_cache_length=MAX_LEN, impl="xla", kv_dtype="int8").generate(
        jnp.asarray(ids), jnp.asarray(px), max_new_tokens=8, eos_token_id=-1)
    kernels.reset_counters()
    pres = InferenceEngine(model, tiny_mllama_config(), "cpu", max_cache_length=MAX_LEN,
                           kv_dtype="int8").generate(ids, px, max_new_tokens=8, eos_token_id=-1)
    assert kernels.plain_counts()["flash_attention_int8kv"] > 0
    assert len(set(pres.tokens[0].tolist())) > 2  # the comparison is not degenerate
    np.testing.assert_array_equal(pres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_allclose(pres.prefill_logits.numpy(), np.asarray(jres.prefill_logits),
                               atol=1e-4, rtol=1e-4)
