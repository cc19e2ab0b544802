"""The port's object API (``models/wrapper.py``), its module-style RMSNorm and
SwiGLU and its top-level exports, against the JAX package's classes on the
same converted weights (``tests/test_wrapper_api.py`` and the API parts of
``tests/test_parity_stragglers.py``, re-targeted): outputs to 1e-5."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama32mm_tpu as jax_pkg
import llama32mm_tpu_torch as pkg
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.configs import LLAMA32Config as JaxLLAMA32Config
from llama32mm_tpu.models import wrapper as jw
from llama32mm_tpu.ops.rmsnorm import LLAMARMSNorm as JaxRMSNorm
from llama32mm_tpu.ops.swiglu import FusedSwiGLU as JaxSwiGLU
from llama32mm_tpu.utils.kvcache import init_kv_cache as jax_init_kv_cache
from llama32mm_tpu_torch.configs import LLAMA32Config, tiny_mllama_config
from llama32mm_tpu_torch.models import wrapper
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops.rmsnorm import LLAMARMSNorm, fused_add_rmsnorm
from llama32mm_tpu_torch.ops.swiglu import FusedSwiGLU, fused_swiglu
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _ids(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab - 10, shape)


def test_vlm_wrapper_forward_dict_contract():
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    jmodel = jw.MllamaForConditionalGeneration(jcfg, seed=0)
    model = wrapper.MllamaForConditionalGeneration(cfg, params=_np_tree(jmodel.params),
                                                   device="cpu")
    ids = _ids(1, (1, 10), cfg.vocab_size)
    px = np.random.RandomState(2).randn(1, 3, 28, 28).astype(np.float32)
    want = jmodel(input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                  labels=jnp.asarray(ids))
    t_ids = torch.as_tensor(ids)
    out = model(input_ids=t_ids, pixel_values=torch.as_tensor(px), labels=t_ids)
    assert set(out) == {"logits", "loss", "hidden_states", "kv_cache"}
    assert tuple(out["logits"].shape) == (1, 10, cfg.vocab_size)
    assert model.language_model.lm_head is not None  # the wrappers init untied
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), **TOL)
    fn = vlm_forward(model, cfg, input_ids=t_ids, pixel_values=torch.as_tensor(px))
    assert torch.equal(fn.logits, out["logits"])  # the module's forward is vlm_forward


def test_wrapper_tie_weights():
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    jmodel = jw.MllamaForConditionalGeneration(jcfg, seed=0)
    base = wrapper.MllamaForConditionalGeneration(cfg, params=_np_tree(jmodel.params),
                                                  device="cpu")
    model = wrapper.MllamaForConditionalGeneration(cfg, params=base, device="cpu")
    assert model.get_input_embeddings() is base.language_model.model.tok_emb  # shared
    jmodel.tie_weights()
    model.tie_weights()
    assert model.language_model.lm_head is None
    assert base.language_model.lm_head is not None  # the module it shared stays untied
    emb = model.get_input_embeddings()
    assert tuple(emb.shape) == (cfg.vocab_size, cfg.text_config.hidden_size)
    out = model(input_ids=torch.zeros(1, 4, dtype=torch.long))
    want = jmodel(input_ids=jnp.zeros((1, 4), jnp.int32))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(want["logits"]), **TOL)


def test_causal_lm_wrapper_with_cache():
    jtc, tc = jax_tiny_config().text_config, tiny_mllama_config().text_config
    jmodel = jw.Llama3ForCausalLM(jtc, seed=0)
    model = wrapper.Llama3ForCausalLM(tc, params=_np_tree(jmodel.params), device="cpu")
    ids = _ids(3, (1, 6), tc.vocab_size)
    logits, cache = model(input_ids=torch.as_tensor(ids))
    assert cache is None and tuple(logits.shape) == (1, 6, tc.vocab_size)
    want, _ = jmodel(input_ids=jnp.asarray(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)

    cache = init_kv_cache(tc, 1, "cpu", max_length=16, dtype=torch.float32)
    logits_c, new_cache = model(input_ids=torch.as_tensor(ids), kv_cache=cache)
    assert new_cache.pos == 6
    np.testing.assert_allclose(logits_c.numpy(), logits.numpy(), atol=1e-4)
    model.tie_weights()
    assert model.lm_head is None
    jmodel.tie_weights()
    np.testing.assert_allclose(model(input_ids=torch.as_tensor(ids))[0].numpy(),
                               np.asarray(jmodel(input_ids=jnp.asarray(ids))[0]), **TOL)


def test_llama3model_wrapper():
    kw = dict(vocab_size=64, hidden_size=32, n_heads=4, n_layers=2, hidden_dim=64,
              n_kv_groups=2, dtype="float32", max_cache_length=16)
    jtc, tc = JaxLLAMA32Config(**kw), LLAMA32Config(**kw)
    jm = jw.Llama3Model(jtc, seed=0)
    m = wrapper.Llama3Model(tc, params=_np_tree(jm.params), device="cpu")
    ids = np.array([[1, 2, 3, 4]])
    out = m(input_ids=torch.as_tensor(ids))
    assert tuple(out.hidden_states.shape) == (1, 4, 32) and out.kv_cache is None
    want = jm(input_ids=jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(out.hidden_states.numpy(), np.asarray(want.hidden_states), **TOL)

    out2 = m(input_ids=torch.as_tensor(ids), kv_cache=init_kv_cache(tc, 1, "cpu"))
    want2 = jm(input_ids=jnp.asarray(ids, jnp.int32), kv_cache=jax_init_kv_cache(jtc, 1))
    assert out2.kv_cache.pos == int(want2.kv_cache.pos) == 4
    np.testing.assert_allclose(out2.hidden_states.numpy(), out.hidden_states.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_wrappers_random_init_from_a_seed():
    """Without ``params`` a wrapper draws its weights from ``seed`` on an
    explicit generator: the same seed gives the same weights."""
    cfg = tiny_mllama_config()
    a, b, c = (wrapper.MllamaForConditionalGeneration(cfg, seed=s, device="cpu")
               for s in (0, 0, 1))
    wa, wb, wc = (m.language_model.model.blocks[0].att.W_query.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    tc = cfg.text_config
    lm = wrapper.Llama3ForCausalLM(tc, seed=0, device="cpu")
    assert lm.lm_head is not None
    assert torch.isfinite(wrapper.Llama3Model(tc, seed=0, device="cpu").tok_emb).all()


def test_module_classes_match_functional_ops():
    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    res = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32)
    jnorm = JaxRMSNorm(16, eps=1e-5)
    norm = LLAMARMSNorm(16, eps=1e-5, device="cpu")
    got = norm(torch.as_tensor(x), residual=torch.as_tensor(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnorm(jnp.asarray(x),
                                                             residual=jnp.asarray(res))), **TOL)
    assert torch.equal(got, fused_add_rmsnorm(torch.as_tensor(x), norm.weight, 1e-5,
                                              residual=torch.as_tensor(res)))

    jsw = JaxSwiGLU(16, 32, key=jax.random.PRNGKey(2))
    sw = FusedSwiGLU(16, 32, device="cpu")
    assert tuple(sw.w_gate.shape) == (16, 32)  # [hidden, inter], as the JAX class
    assert sw.w_gate.t().is_contiguous()  # the [inter, hidden] the op takes, no copy
    with torch.no_grad():
        sw.w_gate.copy_(torch.as_tensor(np.array(jsw.w_gate)))
        sw.w_up.copy_(torch.as_tensor(np.array(jsw.w_up)))
    got = sw(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsw(jnp.asarray(x))), **TOL)
    assert torch.equal(got, fused_swiglu(torch.as_tensor(x), sw.w_gate.t(), sw.w_up.t()))
    biased = FusedSwiGLU(16, 32, bias=True, device="cpu")
    assert tuple(biased.b_gate.shape) == (32,) and biased(torch.as_tensor(x)).shape == (2, 5, 32)


def test_top_level_exports():
    """The JAX package's public names, resolved in the port."""
    for name in ("Llama3Model", "LLAMARMSNorm", "FusedSwiGLU"):
        assert getattr(pkg, name) is not None
    assert set(pkg._LAZY_EXPORTS) == set(jax_pkg._LAZY_EXPORTS)
    assert set(pkg.__all__) == set(jax_pkg.__all__)
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None, name
    assert pkg.MllamaForConditionalGeneration is wrapper.MllamaForConditionalGeneration
    assert pkg.init_kv_cache is init_kv_cache
    with pytest.raises(AttributeError):
        pkg.not_a_name  # noqa: B018


@pytest.mark.parametrize("cls", [wrapper.MllamaForConditionalGeneration,
                                 wrapper.Llama3ForCausalLM, wrapper.Llama3Model,
                                 LLAMARMSNorm, FusedSwiGLU])
def test_object_api_defaults_to_cuda(cls):
    assert inspect.signature(cls).parameters["device"].default == "cuda"
