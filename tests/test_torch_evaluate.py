"""The port's evaluation (``evaluate.py``) against the JAX package's on the
tiny fp32 model: windowed perplexity (one window, a ragged tail, the int8 KV
cache) and cross-mode agreement (a model with itself, and float against
int8).

Tolerances: the NLL per token 1e-5 relative (fp32 log-softmax sums in other
orders); agreement's top-1 hits equal JAX's count exactly (the logits agree
to 1e-5 and no position is near a tie) and the mean |Δlogit| 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import evaluate as jax_eval
from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu_torch import evaluate
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops import cuda as kernels


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_config()
    # one jitted init: faster here than the eager ops
    params = jax.jit(lambda k: init_vlm_params(k, jcfg))(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), tiny_mllama_config(), "cpu")
    return jcfg, params, tiny_mllama_config(), model


def _ids(n, seed):
    return np.random.RandomState(seed).randint(0, 246, (n,))


@pytest.mark.parametrize("n,window,kv_dtype", [(24, 24, None), (37, 16, None), (37, 16, "int8")])
def test_perplexity_matches_jax(tiny, n, window, kv_dtype):
    """One window, then 16 + 16 + 5 tokens (a ragged tail), and the same
    through the int8 KV cache (the cache's rounding is in the number)."""
    jcfg, params, cfg, model = tiny
    ids = _ids(n, seed=n)
    want = jax_eval.perplexity(params, jcfg, ids, window=window,
                               kv_dtype=None if kv_dtype is None else jnp.int8)
    kernels.reset_counters()
    got = evaluate.perplexity(model, cfg, ids, window=window, kv_dtype=kv_dtype)
    assert got["tokens"] == want["tokens"] and got["window"] == want["window"] == window
    np.testing.assert_allclose(got["nll_per_token"], want["nll_per_token"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)
    # the int8 cache's prefill ran an int8-KV attention (its plain version here)
    int8kv = sum(v for k, v in kernels.plain_counts().items() if k.endswith("int8kv"))
    assert bool(int8kv) == (kv_dtype == "int8")
    with pytest.raises(ValueError, match="at least 2 tokens"):
        evaluate.perplexity(model, cfg, ids[:1])


def test_agreement_self_and_int8_match_jax(tiny):
    jcfg, params, cfg, model = tiny
    ids = _ids(30, seed=5)
    same = evaluate.agreement(model, model, cfg, ids, window=16)
    assert same == {"top1_agreement": 1.0, "mean_abs_dlogit": 0.0, "tokens": 15 + 13}
    want = jax_eval.agreement(params, jq.quantize_llama_params(params), jcfg, ids, window=16)
    got = evaluate.agreement(model, quantize_llama_params(model), cfg, ids, window=16)
    assert got["tokens"] == want["tokens"]
    assert round(got["top1_agreement"] * got["tokens"]) == round(
        want["top1_agreement"] * want["tokens"])
    np.testing.assert_allclose(got["mean_abs_dlogit"], want["mean_abs_dlogit"], rtol=1e-4)
    assert got["mean_abs_dlogit"] > 0.0
