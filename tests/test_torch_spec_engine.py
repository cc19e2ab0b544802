"""Speculative decoding in the port's ``InferenceEngine`` against the JAX
engine (``impl="xla"``) on the tiny fp32 config: prompt lookup
(``spec_lookup``) and a draft model (``spec_draft`` with a ``CausalLM``
from ``convert.py::causal_lm_from_jax``) give the JAX spec engine's greedy
tokens, ``num_generated`` and verify ``steps``, and the port's own plain
engine's tokens (which ``test_torch_engine.py`` holds to JAX). The cases
that need no JAX key are held to the plain engine alone: eos mid-chunk,
bucketing, int8 weights with the int8 KV cache, a repetition penalty,
sampling, the self-draft, and the argument checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.configs import LLAMA32Config as JaxLLAMA32Config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.models.language import causal_lm_forward as jax_causal_lm_forward
from llama32mm_tpu.models.language import init_causal_lm_params
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu_torch.configs import LLAMA32Config, tiny_mllama_config
from llama32mm_tpu_torch.convert import causal_lm_from_jax, from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.models.language import causal_lm_forward
from llama32mm_tpu_torch.models.quantize import quantize_llama_params

MAX_LEN = 96
DRAFT = dict(hidden_size=32, n_heads=2, n_layers=1, hidden_dim=48, n_kv_groups=1)


@pytest.fixture(scope="module")
def tiny():
    # seed 2 gives a tiny model whose greedy tokens vary from step to step
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    tc = jcfg.text_config
    djcfg = JaxLLAMA32Config(vocab_size=tc.vocab_size, dtype=tc.dtype,
                             max_cache_length=tc.max_cache_length, **DRAFT)
    dparams = init_causal_lm_params(jax.random.PRNGKey(42), djcfg)
    dcfg = LLAMA32Config(vocab_size=tc.vocab_size, dtype=tc.dtype,
                         max_cache_length=tc.max_cache_length, **DRAFT)
    draft = causal_lm_from_jax(jax.tree.map(np.asarray, dparams), dcfg, "cpu")
    return {"params": params, "jcfg": jcfg, "model": model, "cfg": cfg,
            "dparams": dparams, "djcfg": djcfg, "draft": draft, "dcfg": dcfg}


def _prompt(seed=2, s=11, image=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 240, (1, s))
    if image:
        ids[:, 1:5] = 250
    px = rs.randn(1, 3, 28, 28).astype(np.float32)
    return ids, (px if image else None)


def _jax(tiny, ids, px, new, **kw):
    if kw.get("spec_draft"):
        kw = {**kw, "draft_params": tiny["dparams"], "draft_config": tiny["djcfg"]}
    eng = JaxEngine(tiny["params"], tiny["jcfg"], max_cache_length=MAX_LEN, impl="xla", **kw)
    return eng.generate(jnp.asarray(ids), None if px is None else jnp.asarray(px),
                        max_new_tokens=new)


def _port(tiny, ids, px, new, model=None, eos=-1, gen_kw=None, **kw):
    if kw.get("spec_draft") and "draft_params" not in kw:
        kw = {**kw, "draft_params": tiny["draft"], "draft_config": tiny["dcfg"]}
    eng = InferenceEngine(model or tiny["model"], tiny["cfg"], "cpu", max_cache_length=MAX_LEN,
                          **kw)
    return eng.generate(ids, px, max_new_tokens=new, eos_token_id=eos, **(gen_kw or {}))


def _valid(res):
    return res.tokens[0, :int(res.num_generated[0])].tolist()


def _assert_same_as_jax(jres, pres):
    np.testing.assert_array_equal(pres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(pres.num_generated.numpy(), np.asarray(jres.num_generated))
    assert int(pres.steps) == int(jres.steps)


@pytest.mark.parametrize("max_new", [1, 5, 24])
def test_lookup_matches_jax_and_plain(tiny, max_new):
    ids, px = _prompt()
    pres = _port(tiny, ids, px, max_new, spec_lookup=3)
    _assert_same_as_jax(_jax(tiny, ids, px, max_new, spec_lookup=3), pres)
    assert torch.equal(pres.tokens, _port(tiny, ids, px, max_new).tokens)
    assert int(pres.steps) <= max_new


def test_lookup_accepts_on_cyclic_continuation(tiny):
    """The tiny model's greedy output falls into cycles; the bigram lookup
    then drafts whole accepted chunks: fewer verify steps than tokens."""
    ids, px = _prompt()
    pres = _port(tiny, ids, px, 40, spec_lookup=4)
    _assert_same_as_jax(_jax(tiny, ids, px, 40, spec_lookup=4), pres)
    assert torch.equal(pres.tokens, _port(tiny, ids, px, 40).tokens)
    assert int(pres.num_generated[0]) == 40 and int(pres.steps) < 39


@pytest.mark.parametrize("kind", ["lookup", "draft"])
def test_eos_mid_chunk(tiny, kind):
    spec = {"spec_lookup": 3} if kind == "lookup" else {"spec_draft": 3}
    ids, px = _prompt()
    ref = _valid(_port(tiny, ids, px, 24))
    eos = ref[6]
    want = _port(tiny, ids, px, 24, eos=eos)
    got = _port(tiny, ids, px, 24, eos=eos, **spec)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.num_generated, want.num_generated)
    assert _valid(got)[-1] == eos and len(_valid(got)) == ref.index(eos) + 1


def test_bucketed_prompt_matches_unbucketed(tiny):
    # bucket padding moves the cache slots, not the RoPE positions or the lookup buffer
    ids, px = _prompt()
    want = _port(tiny, ids, px, 16).tokens
    assert torch.equal(_port(tiny, ids, px, 16, spec_lookup=3, prompt_buckets=(16,)).tokens, want)
    assert torch.equal(_port(tiny, ids, px, 16, spec_draft=3, prompt_buckets=(16,)).tokens, want)


def test_int8_weights_with_int8_kv_cache(tiny):
    """A verify writes K+1 quantized entries at once; stale ones stay masked."""
    qmodel = quantize_llama_params(tiny["model"], bits=8)
    ids, px = _prompt()
    want = _port(tiny, ids, px, 20, model=qmodel, kv_dtype="int8").tokens
    for spec in ({"spec_lookup": 3}, {"spec_draft": 2}):
        got = _port(tiny, ids, px, 20, model=qmodel, kv_dtype="int8", **spec).tokens
        assert torch.equal(got, want), spec


def test_repetition_penalty_composes(tiny):
    ids, px = _prompt(s=14)
    pen = {"repetition_penalty": 1.4}
    want = _port(tiny, ids, px, 20, gen_kw=pen).tokens
    for spec in ({"spec_lookup": 3}, {"spec_draft": 3}):
        assert torch.equal(_port(tiny, ids, px, 20, gen_kw=pen, **spec).tokens, want), spec


def test_auto_buckets_reserve_headroom(tiny):
    """A prompt that fits unbucketed (s + max_new + K = cache) must not be
    padded into the verify's headroom and refused."""
    cache, max_new, k = 128, 6, 2
    ids = np.random.RandomState(9).randint(0, 240, (1, cache - max_new - k))
    want = InferenceEngine(tiny["model"], tiny["cfg"], "cpu", max_cache_length=cache).generate(
        ids, max_new_tokens=max_new).tokens
    eng = InferenceEngine(tiny["model"], tiny["cfg"], "cpu", max_cache_length=cache,
                          spec_lookup=k, prompt_buckets="auto")
    assert torch.equal(eng.generate(ids, max_new_tokens=max_new).tokens, want)
    with pytest.raises(ValueError, match="needs K extra cache slots"):
        eng.generate(ids, max_new_tokens=max_new + 1)


@pytest.mark.parametrize("kind", ["lookup", "draft"])
def test_sampled_generation_keeps_its_budget(tiny, kind):
    spec = {"spec_lookup": 3} if kind == "lookup" else {"spec_draft": 2}
    ids, px = _prompt()
    runs = [_port(tiny, ids, px, 9, gen_kw=dict(temperature=0.9, top_p=0.85, top_k=7,
                                                rng=torch.Generator().manual_seed(5)), **spec)
            for _ in range(2)]
    assert int(runs[0].num_generated[0]) == 9
    toks = runs[0].tokens[0]
    assert bool(((toks >= 0) & (toks < tiny["cfg"].text_config.vocab_size)).all())
    assert torch.equal(runs[0].tokens, runs[1].tokens)  # reproducible per generator


@pytest.mark.parametrize("max_new", [1, 6, 20])
def test_draft_matches_jax_image(tiny, max_new):
    ids, px = _prompt()
    pres = _port(tiny, ids, px, max_new, spec_draft=3)
    _assert_same_as_jax(_jax(tiny, ids, px, max_new, spec_draft=3), pres)
    assert torch.equal(pres.tokens, _port(tiny, ids, px, max_new).tokens)


def test_draft_matches_jax_text(tiny):
    ids, _ = _prompt(seed=3, s=13, image=False)
    pres = _port(tiny, ids, None, 16, spec_draft=2)
    _assert_same_as_jax(_jax(tiny, ids, None, 16, spec_draft=2), pres)
    assert torch.equal(pres.tokens, _port(tiny, ids, None, 16).tokens)


def test_self_draft_accepts_nearly_everything(tiny):
    """The target's own language model as the draft agrees with the verify
    almost always: about (K+1) tokens a step."""
    ids, _ = _prompt(seed=5, s=9, image=False)
    k, max_new = 4, 40
    lm = tiny["model"].language_model
    got = _port(tiny, ids, None, max_new, spec_draft=k, draft_params=lm,
                draft_config=tiny["cfg"].text_config)
    assert torch.equal(got.tokens, _port(tiny, ids, None, max_new).tokens)
    floor = -(-(max_new - 1) // (k + 1))  # every step fully accepted
    assert int(got.steps) <= 2 * floor, (int(got.steps), floor)


def test_causal_lm_from_jax_matches_jax_forward(tiny):
    """The converted draft (tied head) and an untied one give the JAX
    causal LM's logits."""
    ids = np.random.RandomState(7).randint(0, 256, (2, 6))
    for tie in (True, False):
        jp = tiny["dparams"] if tie else init_causal_lm_params(
            jax.random.PRNGKey(43), tiny["djcfg"], tie_weights=False)
        want, _ = jax_causal_lm_forward(jp, tiny["djcfg"], input_ids=jnp.asarray(ids), impl="xla")
        lm = causal_lm_from_jax(jax.tree.map(np.asarray, jp), tiny["dcfg"], "cpu")
        assert (lm.lm_head is None) == tie
        got, _ = causal_lm_forward(lm, tiny["dcfg"], input_ids=torch.from_numpy(ids))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_spec_argument_checks(tiny):
    model, cfg, draft, dcfg = tiny["model"], tiny["cfg"], tiny["draft"], tiny["dcfg"]
    for kw, err, match in (
        ({"spec_lookup": -1}, ValueError, "spec_lookup must be >= 0"),
        ({"spec_draft": -1}, ValueError, "spec_draft must be >= 0"),
        ({"spec_lookup": 2, "spec_draft": 2, "draft_params": draft, "draft_config": dcfg},
         ValueError, "mutually exclusive"),
        ({"spec_draft": 2}, ValueError, "needs draft_params"),
        ({"spec_draft": 2, "draft_params": {"model": {}}, "draft_config": dcfg},
         TypeError, "CausalLM"),
        ({"spec_draft": 2, "draft_params": draft,
          "draft_config": LLAMA32Config(vocab_size=100, **DRAFT)}, ValueError, "draft vocab"),
    ):
        with pytest.raises(err, match=match):
            InferenceEngine(model, cfg, "cpu", **kw)
    two = np.concatenate([_prompt(image=False)[0]] * 2)
    for spec, which in (({"spec_lookup": 3}, "spec"), ({"spec_draft": 2}, "specd")):
        with pytest.raises(ValueError, match=f"{which} decoding supports batch size 1"):
            _port(tiny, two, None, 4, **spec)
