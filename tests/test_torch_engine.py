"""The port's inference engine against the JAX engine (``impl="xla"``) on the
tiny fp32 config: greedy tokens must be equal, token for token. Also the
on-device image preprocessing against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.preprocess.image import preprocess_image_device as jax_preprocess
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine, bucketed_len
from llama32mm_tpu_torch.preprocess.image import preprocess_image_device

MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny():
    # seed 2 gives a tiny model whose greedy tokens vary from step to step
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return params, jcfg, model, cfg


def _prompt(seed=2, s=10, image=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 240, (1, s))
    if image:
        ids[:, 1:5] = 250
    px = rs.randn(1, 3, 28, 28).astype(np.float32)
    return ids, px


def _run_both(tiny, ids, px=None, mask=None, buckets=None, eos=-1, new=10):
    params, jcfg, model, cfg = tiny
    jeng = JaxEngine(params, jcfg, max_cache_length=MAX_LEN, impl="xla", prompt_buckets=buckets)
    jres = jeng.generate(jnp.asarray(ids), None if px is None else jnp.asarray(px),
                         attention_mask=None if mask is None else jnp.asarray(mask),
                         max_new_tokens=new, eos_token_id=eos)
    peng = InferenceEngine(model, cfg, "cpu", max_cache_length=MAX_LEN, prompt_buckets=buckets)
    pres = peng.generate(ids, px, attention_mask=mask, max_new_tokens=new, eos_token_id=eos)
    return jres, pres


def _assert_same(jres, pres):
    np.testing.assert_array_equal(pres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(pres.num_generated.numpy(), np.asarray(jres.num_generated))
    np.testing.assert_allclose(pres.prefill_logits.numpy(), np.asarray(jres.prefill_logits),
                               atol=1e-4, rtol=1e-4)


def test_greedy_with_image_matches_jax(tiny):
    ids, px = _prompt()
    jres, pres = _run_both(tiny, ids, px)
    assert len(set(pres.tokens[0].tolist())) > 2  # the comparison is not degenerate
    _assert_same(jres, pres)


def test_right_padded_prompt_matches_jax_and_unpadded(tiny):
    ids, _ = _prompt(image=False)
    padded = np.concatenate([ids, np.zeros((1, 3), ids.dtype)], axis=1)
    mask = np.concatenate([np.ones((1, 10), np.int32), np.zeros((1, 3), np.int32)], axis=1)
    jres, pres = _run_both(tiny, padded, mask=mask)
    _assert_same(jres, pres)
    _, unpadded = _run_both(tiny, ids)
    np.testing.assert_array_equal(pres.tokens.numpy(), unpadded.tokens.numpy())


def test_auto_buckets_match_jax(tiny):
    ids, px = _prompt()
    jres, pres = _run_both(tiny, ids, px, buckets="auto")
    _assert_same(jres, pres)
    assert bucketed_len(10, 10, MAX_LEN, "auto") == 54
    assert bucketed_len(10, 10, MAX_LEN, (8, 16, 32)) == 16


def test_eos_early_stop_matches_jax(tiny):
    ids, px = _prompt()
    _, base = _run_both(tiny, ids, px)
    eos = int(base.tokens[0, 3])
    jres, pres = _run_both(tiny, ids, px, eos=eos)
    _assert_same(jres, pres)
    assert int(pres.num_generated[0]) == base.tokens[0].tolist().index(eos) + 1


def test_ragged_batch_with_image_matches_jax(tiny):
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 240, (2, 12))
    ids[:, 0:4] = 250
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    px = rs.randn(2, 3, 28, 28).astype(np.float32)
    jres, pres = _run_both(tiny, ids, px, mask=mask, new=6)
    _assert_same(jres, pres)


def test_capacity_check(tiny):
    *_, model, cfg = tiny
    eng = InferenceEngine(model, cfg, "cpu", max_cache_length=16)
    with pytest.raises(ValueError, match="exceeds KV cache"):
        eng.generate(np.zeros((1, 10), np.int64), max_new_tokens=10)


def test_preprocess_matches_jax():
    raw = np.random.RandomState(0).randint(0, 256, (2, 28, 28, 3)).astype(np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(raw), 28))
    got = preprocess_image_device(torch.from_numpy(raw), 28)
    assert got.shape == (2, 3, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_preprocess_refuses_resize():
    """Pixels that are not ``image_size`` square are resized as
    ``jax.image.resize(method="cubic")`` resizes them, not refused; what is
    refused is a tensor that is not ``[B, H, W, C]``."""
    raw = np.random.RandomState(1).randint(0, 256, (1, 30, 28, 3)).astype(np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(raw), 28))
    got = preprocess_image_device(torch.from_numpy(raw), 28)
    assert got.shape == (1, 3, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        preprocess_image_device(torch.zeros(30, 28, 3, dtype=torch.uint8), 28)
