"""The pieces the continuous-batching server stands on, against the JAX
package on the same numpy inputs, fp32, CPU: the per-slot sampler
(repetition penalty, presence, the traced filter and the traced token
choice, with the same uniforms handed to both sides), attention and the KV
cache with a per-row query/write offset, and a decoder step whose rows sit
at different fill levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.language import llama_forward as jax_llama_forward
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.ops import attention as jattn
from llama32mm_tpu.utils import kvcache as jkv
from llama32mm_tpu.utils import sampling as js
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.models.language import llama_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, dense_from_structured, gqa_attention
from llama32mm_tpu_torch.utils import sampling as ps
from llama32mm_tpu_torch.utils.kvcache import KVCache, init_kv_cache, quantize_kv

V = 300
# per-row settings: greedy, top-k, top-p, both with min-p, a loose row
TEMP = np.array([0.0, 0.7, 1.3, 0.9, 2.0], np.float32)
TOP_P = np.array([0.9, 1.0, 0.5, 0.8, 1.0], np.float32)
TOP_K = np.array([50, 5, 0, 20, 0], np.int32)
MIN_P = np.array([0.0, 0.0, 0.0, 0.05, 0.0], np.float32)
PEN = np.array([1.0, 1.3, 1.0, 2.0, 0.8], np.float32)


def _logits(seed=0, b=5):
    return (np.random.RandomState(seed).randn(b, V) * 3).astype(np.float32)


def _presence(seed=1, b=5):
    return np.random.RandomState(seed).rand(b, V) < 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("per_row", [False, True])
def test_repetition_penalty_matches_jax(per_row):
    logits, pres = _logits(), _presence()
    pen = PEN if per_row else 1.4
    want = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(pres),
                                       jnp.asarray(pen) if per_row else pen)
    got = ps.apply_repetition_penalty(_t(logits), _t(pres), _t(pen) if per_row else pen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_presence_from_tokens_matches_jax():
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, V, (3, 12))
    tokens[0, 2] = V  # the image placeholder id: not a vocabulary token
    tokens[1, 0] = -1
    n_valid = np.array([12, 5, 0], np.int32)
    want = js.presence_from_tokens(jnp.asarray(tokens), jnp.asarray(n_valid), V)
    got = ps.presence_from_tokens(_t(tokens), _t(n_valid), V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any() and got[0].sum() <= 11


@pytest.mark.parametrize("with_min_p", [False, True])
def test_filter_logits_traced_matches_jax(with_min_p):
    logits = _logits(3)
    args = [TEMP, TOP_P, TOP_K] + ([MIN_P] if with_min_p else [])
    want = np.asarray(js.filter_logits_traced(jnp.asarray(logits), *map(jnp.asarray, args)))
    got = ps.filter_logits_traced(_t(logits), *map(_t, args)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert (np.isfinite(got).sum(axis=1) < V).sum() >= 3  # the masks bite


def test_select_next_token_traced_with_given_uniforms():
    """Greedy rows are the penalised argmax; sampled rows are the Gumbel-max
    draw over JAX's filtered, penalised logits with the same uniforms."""
    logits, pres = _logits(4), _presence(5)
    u = np.random.RandomState(6).rand(5, V).astype(np.float32)
    pen_logits = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(pres),
                                             jnp.asarray(PEN))
    filt = np.asarray(js.filter_logits_traced(pen_logits, *map(jnp.asarray, (TEMP, TOP_P, TOP_K,
                                                                             MIN_P))))
    sampled = np.argmax(filt - np.log(-np.log(u)), axis=-1)
    want = np.where(TEMP <= 0, np.argmax(np.asarray(pen_logits), axis=-1), sampled)
    got = ps.select_next_token_traced(_t(logits), *map(_t, (TEMP, TOP_P, TOP_K, MIN_P)),
                                      presence=_t(pres), penalty=_t(PEN), uniforms=_t(u))
    np.testing.assert_array_equal(got.numpy(), want)
    # every row greedy: the fast path equals JAX's (which skips the filter too)
    zeros = np.zeros_like(TEMP)
    want_g = js.select_next_token_traced(jnp.asarray(logits), jax.random.PRNGKey(0),
                                         *map(jnp.asarray, (zeros, TOP_P, TOP_K, MIN_P)),
                                         jnp.asarray(pres), jnp.asarray(PEN))
    got_g = ps.select_next_token_traced(_t(logits), *map(_t, (zeros, TOP_P, TOP_K, MIN_P)),
                                        presence=_t(pres), penalty=_t(PEN), all_greedy=True)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_static_select_applies_penalty_before_argmax():
    logits, pres = _logits(7, b=2), _presence(8, b=2)
    want = js.select_next_token(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0,
                                presence=jnp.asarray(pres), repetition_penalty=1.7)
    got = ps.select_next_token(_t(logits), None, 0.0, presence=_t(pres),
                               repetition_penalty=1.7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attn_inputs(tq, seed=0, b=3, nq=4, nkv=2, tk=40, hd=16):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, nq, tq, hd).astype(np.float32)
    k, v = (rs.randn(b, nkv, tk, hd).astype(np.float32) for _ in range(2))
    offsets = np.array([5, 31, 17], np.int32)[:b]
    kv_valid = np.zeros((b, tk), np.int32)
    for i, o in enumerate(offsets):
        kv_valid[i, :o + tq] = 1
    kv_valid[0, 2] = 0  # a padded prompt slot
    return q, k, v, kv_valid, offsets


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("tq", [1, 3])
def test_attention_per_row_offsets_match_jax(tq, int8_kv):
    """Per-row ``q_offset`` (the server's decode) against JAX's densified
    per-row mask; the port's plain version takes the offsets as they are."""
    q, k, v, kv_valid, offsets = _attn_inputs(tq)
    ks = vs = None
    if int8_kv:
        (kq, ks), (vq, vs) = (jkv.quantize_kv(jnp.asarray(a)) for a in (k, v))
        k, v, ks, vs = (np.asarray(a) for a in (kq, vq, ks, vs))
    mask = jattn.AttnMask(jnp.asarray(kv_valid), jnp.asarray(offsets))
    want = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), structured=mask,
                               impl="xla", k_scale=None if ks is None else jnp.asarray(ks),
                               v_scale=None if vs is None else jnp.asarray(vs))
    kernels.reset_counters()
    got = gqa_attention(_t(q), _t(k), _t(v), AttnMask(_t(kv_valid), _t(offsets)),
                        k_scale=None if ks is None else _t(ks),
                        v_scale=None if vs is None else _t(vs))
    # 2 query heads per kv head x Tq rows: the split-KV decode route
    assert kernels.plain_counts()["flash_decode_int8kv" if int8_kv else "flash_decode"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # one row alone with a scalar offset gives that row
    one = gqa_attention(_t(q[1:2]), _t(k[1:2]), _t(v[1:2]),
                        AttnMask(_t(kv_valid[1:2]), int(offsets[1])),
                        k_scale=None if ks is None else _t(ks[1:2]),
                        v_scale=None if vs is None else _t(vs[1:2]))
    np.testing.assert_allclose(one.numpy(), got[1:2].numpy(), atol=1e-6, rtol=1e-6)


def test_dense_mask_per_row_matches_jax():
    _, _, _, kv_valid, offsets = _attn_inputs(3)
    want = jattn.dense_from_structured(jattn.AttnMask(jnp.asarray(kv_valid), jnp.asarray(offsets)),
                                       3, 40, jnp.float32)
    got = dense_from_structured(AttnMask(_t(kv_valid), _t(offsets)), 3, 40, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_kv_cache_per_row_update_matches_jax(int8, t):
    """Row b's T entries land at pos[b] .. pos[b]+T-1, scales with them."""
    tc = tiny_mllama_config().text_config
    rs = np.random.RandomState(9)
    b, nkv, hd, s = 3, tc.n_kv_groups, tc.head_dim, 16
    pos = np.array([0, 7, 14], np.int64)
    k_new, v_new = (rs.randn(b, nkv, t, hd).astype(np.float32) for _ in range(2))
    cache = init_kv_cache(tc, b, "cpu", max_length=s, dtype=torch.int8 if int8 else None)
    cache.pos = torch.from_numpy(pos)
    k_l, v_l, ks_l, vs_l = cache.update(1, _t(k_new), _t(v_new))
    jshape = (tc.n_layers, b, nkv, s, hd)
    jdt = jnp.int8 if int8 else jnp.float32
    kz, vz = jnp.zeros(jshape, jdt), jnp.zeros(jshape, jdt)
    kw, vw = jnp.asarray(k_new), jnp.asarray(v_new)
    if int8:
        (kw, ksw), (vw, vsw) = jkv.quantize_kv(kw), jkv.quantize_kv(vw)
        zs = jnp.zeros(jshape[:-1], jnp.float32)
        want_ks = jkv.update_stacked_scales(zs, ksw, 1, jnp.asarray(pos, jnp.int32))
        want_vs = jkv.update_stacked_scales(zs, vsw, 1, jnp.asarray(pos, jnp.int32))
        np.testing.assert_array_equal(cache.k_scale.numpy(), np.asarray(want_ks))
        np.testing.assert_array_equal(cache.v_scale.numpy(), np.asarray(want_vs))
        assert ks_l.data_ptr() == cache.k_scale[1].data_ptr()
    want_k, want_v = jkv.update_stacked(kz, vz, kw, vw, 1, jnp.asarray(pos, jnp.int32))
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want_v))
    assert k_l.data_ptr() == cache.k[1].data_ptr() and cache.per_row
    with pytest.raises(ValueError, match="per-row"):
        cache.advance(1)


def test_slot_view_writes_the_batch_cache_in_place():
    tc = tiny_mllama_config().text_config
    cache = init_kv_cache(tc, 3, "cpu", max_length=8, dtype=torch.int8)
    view = cache.slot(1)
    kv = torch.randn(1, tc.n_kv_groups, 2, tc.head_dim)
    view.update(0, kv, kv)
    q, s = quantize_kv(kv)
    assert torch.equal(cache.k[0, 1, :, :2], q[0]) and torch.equal(cache.k_scale[0, 1, :, :2], s[0])
    assert not cache.k[:, [0, 2]].any() and view.pos == 0


def test_decoder_step_with_per_row_offsets_matches_jax():
    """One decode step of a 3-row batch whose rows sit at offsets 4, 9, 6 of
    a shared cache (default mask and RoPE positions from the offsets)."""
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    tc, jtc = cfg.text_config, jcfg.text_config
    rs = np.random.RandomState(11)
    b, s = 3, 16
    pos = np.array([4, 9, 6], np.int64)
    k0 = (rs.randn(tc.n_layers, b, tc.n_kv_groups, s, tc.head_dim) * 0.5).astype(np.float32)
    v0 = (rs.randn(*k0.shape) * 0.5).astype(np.float32)
    ids = rs.randint(0, 240, (b, 1))
    jcache = jkv.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pos, jnp.int32))
    want = jax_llama_forward(params["language_model"]["model"], jtc, input_ids=jnp.asarray(ids),
                             kv_cache=jcache, impl="xla")
    cache = KVCache(_t(k0), _t(v0), torch.from_numpy(pos))
    got = llama_forward(model.language_model.model, tc, input_ids=_t(ids), kv_cache=cache)
    np.testing.assert_allclose(got.hidden_states.numpy(), np.asarray(want.hidden_states),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(want.kv_cache.k), atol=1e-5, rtol=1e-5)
    assert cache.pos.tolist() == pos.tolist()  # the owner advances per-row offsets
