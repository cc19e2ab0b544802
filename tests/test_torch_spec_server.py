"""Prompt-lookup speculative decoding in the port's continuous-batching
server on the tiny fp32 config: staggered requests through a shared slot
pool, each slot drafting from its own history and the pool verifying in one
(K+1)-token forward, give the JAX spec server's tokens and acceptance
statistic, and each request the tokens of a solo engine run (the port's,
which ``test_torch_engine.py`` holds to JAX); so do admissions mid-decode,
chunked admission, a penalised request and the int8 KV cache. Also the
headroom check and the statistic's count of kept tokens only."""

import jax
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.server import ContinuousBatchingServer as JaxServer
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

MAX_LEN = 64
PX = np.random.RandomState(0).randn(3, 28, 28).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return {"jcfg": jcfg, "params": params, "cfg": cfg, "model": model}


def _repetitive(s, seed, period=4):
    """A prompt with a repeating pattern, so bigram drafts hit."""
    base = np.random.RandomState(seed).randint(0, 240, period)
    return np.tile(base, s // period + 1)[:s]


def _requests():
    """(ids, pixel values or None, budget): repetitive text, an image
    prompt, a prompt whose drafts mostly miss."""
    img = np.random.RandomState(5).randint(0, 240, 12)
    img[:4] = 250
    return [(_repetitive(9, 1), None, 8), (img, PX, 10), (_repetitive(12, 2, 3), None, 9),
            (np.random.RandomState(3).randint(0, 240, 10), None, 6)]


def _solo(tiny, ids, px, new, kv_dtype=None, pen=1.0):
    eng = InferenceEngine(tiny["model"], tiny["cfg"], "cpu", max_cache_length=MAX_LEN,
                          kv_dtype=kv_dtype)
    out = eng.generate(ids[None], None if px is None else px[None], max_new_tokens=new,
                       repetition_penalty=pen)
    return out.tokens[0, :int(out.num_generated[0])].tolist()


def _server(tiny, **kw):
    kw = {"slots": 2, "max_cache_length": MAX_LEN, "prompt_buckets": None, "eos_token_id": -1,
          "steps_per_sync": 2, "spec_lookup": 3, **kw}
    return ContinuousBatchingServer(tiny["model"], tiny["cfg"], "cpu", **kw)


def _serve(srv, reqs):
    rids = [srv.submit(ids, px, max_new_tokens=n) for ids, px, n in reqs]
    results = srv.run()
    return [results[r].tolist() for r in rids]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_staggered_requests_match_jax_spec_server(tiny, kv_dtype):
    reqs = _requests()
    jsrv = JaxServer(tiny["params"], tiny["jcfg"], slots=2, max_cache_length=MAX_LEN,
                     prompt_buckets=None, kv_dtype=kv_dtype, steps_per_sync=2, eos_token_id=-1,
                     spec_lookup=3, impl="xla")
    want = _serve(jsrv, reqs)
    srv = _server(tiny, kv_dtype=kv_dtype)
    got = _serve(srv, reqs)
    assert got == want
    assert got == [_solo(tiny, ids, px, n, kv_dtype) for ids, px, n in reqs]
    st, jst = srv.stats(), jsrv.stats()
    assert st["spec_lookup"] == 3
    assert st["spec_tokens_per_step"] == jst["spec_tokens_per_step"] > 1.0


def test_mid_decode_admission(tiny):
    reqs = _requests()[:2]
    srv = _server(tiny, slots=1, steps_per_sync=1)
    r0 = srv.submit(reqs[0][0], None, max_new_tokens=9)
    srv.step()
    assert len(srv.tokens_so_far(r0)) >= 1
    r1 = srv.submit(reqs[1][0], reqs[1][1], max_new_tokens=5)  # waits for the one slot
    results = srv.run()
    assert results[r0].tolist() == _solo(tiny, reqs[0][0], None, 9)
    assert results[r1].tolist() == _solo(tiny, reqs[1][0], reqs[1][1], 5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_chunked_admission(tiny, kv_dtype):
    reqs = _requests()
    got = _serve(_server(tiny, prefill_chunk=4, kv_dtype=kv_dtype), reqs)
    assert got == [_solo(tiny, ids, px, n, kv_dtype) for ids, px, n in reqs]


def test_penalised_request_matches_solo(tiny):
    """A penalised slot's verify context is its history plus the drafts it
    accepts; beside a plain greedy slot."""
    reqs = _requests()[:3]
    srv = _server(tiny)
    rids = [srv.submit(ids, px, max_new_tokens=n, repetition_penalty=1.5 if i == 0 else None)
            for i, (ids, px, n) in enumerate(reqs)]
    results = srv.run()
    for i, (rid, (ids, px, n)) in enumerate(zip(rids, reqs)):
        assert results[rid].tolist() == _solo(tiny, ids, px, n, pen=1.5 if i == 0 else 1.0)


def test_sampled_requests_keep_their_budgets(tiny):
    reqs = _requests()
    srv = _server(tiny, temperature=0.8, top_k=20, rng=torch.Generator().manual_seed(3))
    got = _serve(srv, reqs)
    for toks, (_, _, n) in zip(got, reqs):
        assert len(toks) == n and all(0 <= t < tiny["cfg"].text_config.vocab_size for t in toks)


def test_spec_validation(tiny):
    with pytest.raises(ValueError, match="spec_lookup must be >= 0"):
        _server(tiny, spec_lookup=-1)
    srv = _server(tiny, slots=1, spec_lookup=4)
    with pytest.raises(ValueError, match="spec headroom"):
        srv.submit(np.arange(10), None, max_new_tokens=MAX_LEN - 10 - 2)  # 2 < K slots left
    srv.submit(np.arange(10), None, max_new_tokens=MAX_LEN - 10 - 4)  # exactly K left
    assert "spec_lookup" not in _server(tiny, spec_lookup=0).stats()


def test_stats_count_only_kept_tokens(tiny):
    """Verify steps after a request's budget commit tokens that ``_emit``
    drops; ``spec_tokens_per_step`` must not count them."""
    srv = _server(tiny, max_cache_length=96, prompt_buckets=(16,), steps_per_sync=4,
                  spec_lookup=2)
    ids = np.random.RandomState(40).randint(0, 240, 9)
    # 5 is not a multiple of the K+1 = 3 tokens a step may commit
    r1 = srv.submit(ids, None, max_new_tokens=5)
    r2 = srv.submit(ids, None, max_new_tokens=7)
    res = srv.run()
    kept = (len(res[r1]) - 1) + (len(res[r2]) - 1)  # the first token comes from the prefill
    assert srv._spec_tokens == kept, (srv._spec_tokens, kept)
    assert 0 < srv.stats()["spec_tokens_per_step"] <= srv.spec_lookup + 1



@pytest.mark.parametrize("spec_lookup,max_new", [(0, 18), (1, 10), (3, 18)])
def test_budget_spent_mid_chunk_at_capacity(tiny, spec_lookup, max_new):
    """A request that fills the cache to its last slot (prompt + budget + K
    == S) and whose budget runs out partway through an 8-step chunk: its slot
    stops committing at the budget, so no position passes the cache, and its
    tokens are the solo engine's. The prompt repeats the tiny model's greedy
    fixed point (token 251), so at K = 1 every draft is accepted and the
    commits outrun the chunk's length (9 tokens left, 8 steps of 2)."""
    ids = np.full(MAX_LEN - max_new - spec_lookup, 251)
    srv = _server(tiny, slots=2, steps_per_sync=8, spec_lookup=spec_lookup)
    rid = srv.submit(ids, None, max_new_tokens=max_new)
    other = srv.submit(_repetitive(9, 1), None, max_new_tokens=30)
    res = srv.run()
    assert res[rid].tolist() == _solo(tiny, ids, None, max_new) == [251] * max_new
    assert res[other].tolist() == _solo(tiny, _repetitive(9, 1), None, 30)
    assert int(srv.state.rope_pos[0]) == MAX_LEN - 1 - spec_lookup  # its last token's position
