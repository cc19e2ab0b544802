"""The port's continuous-batching server against the JAX package's engine on
the tiny fp32 config: staggered requests in a shared slot pool (admitted
mid-decode, into freed slots, monolithic and chunked, float and int8 KV
cache, image and text-only prompts, eos) give the greedy tokens of a solo
JAX ``InferenceEngine.generate`` per request, exactly; so do penalised
requests, and the port engine's repetition penalty. Also the scheduler's
hygiene (cancel, release, deadlines, the bounded queue, argument checks)
and the options outside the slice, which raise."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer, QueueFullError
from llama32mm_tpu_torch.ops import cuda as kernels

MAX_LEN = 64
SPECS = [(9, 1, 6), (12, 5, 10), (14, 7, 4)]  # (prompt length, seed, max_new_tokens)


@pytest.fixture(scope="module")
def tiny():
    # seed 2 gives a tiny model whose greedy tokens vary from step to step
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return {"jcfg": jcfg, "params": params, "cfg": cfg, "model": model, "engines": {}}


def _prompt(s, seed, image=True):
    ids = np.random.RandomState(seed).randint(0, 240, (1, s))
    if image:
        ids[:, :4] = 250  # the tiny config's <image> id
    return ids


PX = np.random.RandomState(0).randn(1, 3, 28, 28).astype(np.float32)


JAX_NEW = 13  # every JAX engine run generates this many; a budget takes its prefix


def _jax_tokens(tiny, ids, px, max_new, buckets=None, kv_dtype=None, pen=1.0, eos=-1,
                params=None, key="float"):
    """The greedy tokens of a solo JAX engine run with a budget of
    ``max_new``: the first ``max_new`` of a ``JAX_NEW``-token run (greedy
    tokens do not depend on the budget), so one engine per configuration
    compiles once per prompt shape."""
    ekey = (key, buckets, kv_dtype)
    if ekey not in tiny["engines"]:
        tiny["engines"][ekey] = JaxEngine(params or tiny["params"], tiny["jcfg"],
                                          max_cache_length=MAX_LEN, impl="xla",
                                          prompt_buckets=buckets, kv_dtype=kv_dtype)
    assert max_new <= JAX_NEW
    out = tiny["engines"][ekey].generate(
        jnp.asarray(ids), None if px is None else jnp.asarray(px), max_new_tokens=JAX_NEW,
        repetition_penalty=pen, eos_token_id=eos)
    return np.asarray(out.tokens)[0, :min(max_new, int(out.num_generated[0]))].tolist()


def _server(tiny, model=None, **kw):
    kw = {"slots": 2, "max_cache_length": MAX_LEN, "eos_token_id": -1, **kw}
    return ContinuousBatchingServer(model or tiny["model"], tiny["cfg"], "cpu", **kw)


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_staggered_requests_match_jax_engine(tiny, kv_dtype, chunk):
    """3 ragged requests through 2 slots: r0 and r1 start together, r2 waits
    for a freed slot and is admitted while r1 decodes. Monolithic admission
    pads to the (16, 24) buckets; chunked admission prefills 4 tokens per
    step into the slot, decode chunks of the live slot in between."""
    buckets = (16, 24) if chunk is None else None
    want = [_jax_tokens(tiny, _prompt(s, seed), PX, mn, buckets, kv_dtype)
            for s, seed, mn in SPECS]
    assert len(set(want[1])) > 2  # the comparison is not degenerate
    srv = _server(tiny, prompt_buckets=buckets, kv_dtype=kv_dtype, steps_per_sync=3,
                  prefill_chunk=chunk)
    kernels.reset_counters()
    rids = [srv.submit(_prompt(s, seed)[0], PX[0], max_new_tokens=mn) for s, seed, mn in SPECS]
    results = srv.run()
    for i, rid in enumerate(rids):
        assert results[rid].tolist() == want[i], f"request {i} diverged from the JAX engine"
    plain = kernels.plain_counts()
    # every decode step (and the short prefills) ran the split-KV merge
    assert plain["flash_decode_int8kv" if kv_dtype else "flash_decode"] > 0
    assert srv.stats()["finished"] == 3 and srv._by_slot == [None, None]


def test_chunked_text_only_and_progress_stats(tiny):
    ids = _prompt(10, 9, image=False)
    want = _jax_tokens(tiny, ids, None, 5)
    srv = _server(tiny, slots=1, prompt_buckets=None, prefill_chunk=3)
    rid = srv.submit(ids[0], None, max_new_tokens=5)
    srv.step()  # first chunk only
    st = srv.stats()
    assert st["admitting"] == rid and st["admit_progress"] == "3/12"
    assert srv.run()[rid].tolist() == want


def test_mid_decode_admission_and_text_only_neighbour(tiny):
    """An image request decodes while a text-only request arrives and takes
    the other slot."""
    srv = _server(tiny, prompt_buckets=(16,), steps_per_sync=2)
    r0 = srv.submit(_prompt(9, 1)[0], PX[0], max_new_tokens=9)
    srv.step()
    assert not srv.is_finished(r0) and len(srv.tokens_so_far(r0)) >= 1
    text = _prompt(10, 9, image=False)
    r1 = srv.submit(text[0], None, max_new_tokens=5)
    results = srv.run()
    assert results[r0].tolist() == _jax_tokens(tiny, _prompt(9, 1), PX, 9, (16,))
    assert results[r1].tolist() == _jax_tokens(tiny, text, None, 5, (16,))


def test_eos_frees_slot(tiny):
    toks = _jax_tokens(tiny, _prompt(12, 5), PX, 10, (16,))
    eos = toks[3]
    want = _jax_tokens(tiny, _prompt(12, 5), PX, 10, (16,), eos=eos)
    srv = _server(tiny, slots=1, prompt_buckets=(16,), steps_per_sync=4, eos_token_id=eos)
    rid = srv.submit(_prompt(12, 5)[0], PX[0], max_new_tokens=10)
    got = srv.run()[rid].tolist()
    assert got == want and got[-1] == eos and len(got) == toks.index(eos) + 1
    assert srv._by_slot == [None]


def test_int4_params_serve_through_server(tiny):
    """int4-packed weights (g=32) with the int8 KV cache: token-equal to the
    JAX package's int4 engine."""
    qtree = jq.quantize_llama_params(tiny["params"], bits=4, group_size=32)
    qmodel = from_jax_params(jax.tree.map(np.asarray, qtree), tiny["cfg"], "cpu")
    ids = _prompt(11, 3)
    want = _jax_tokens(tiny, ids, PX, 6, (16,), "int8", params=qtree, key="int4")
    srv = _server(tiny, qmodel, prompt_buckets=(16,), kv_dtype="int8", steps_per_sync=3)
    rid = srv.submit(ids[0], PX[0], max_new_tokens=6)
    assert srv.run()[rid].tolist() == want


def test_penalised_greedy_matches_jax_engine(tiny):
    """One penalised and one plain request decoding together: each matches
    its own JAX engine run (per-slot penalties)."""
    ids_a, ids_b = _prompt(9, 1), _prompt(12, 5)
    want_a = _jax_tokens(tiny, ids_a, PX, 8, (16, 24), pen=1.5)
    want_b = _jax_tokens(tiny, ids_b, PX, 8, (16, 24))
    assert want_a != _jax_tokens(tiny, ids_a, PX, 8, (16, 24))
    srv = _server(tiny, prompt_buckets=(16, 24), steps_per_sync=3)
    ra = srv.submit(ids_a[0], PX[0], max_new_tokens=8, repetition_penalty=1.5)
    rb = srv.submit(ids_b[0], PX[0], max_new_tokens=8)
    got = srv.run()
    assert got[ra].tolist() == want_a and got[rb].tolist() == want_b


def test_chunked_admission_penalised_matches_jax_engine(tiny):
    """The first token, sampled at the end of a chunked admission, sees the
    prompt's presence too."""
    ids = _prompt(14, 7)
    want = _jax_tokens(tiny, ids, PX, 6, (16, 24), pen=1.6)
    srv = _server(tiny, prompt_buckets=(16, 24), steps_per_sync=3, prefill_chunk=8)
    r = srv.submit(ids[0], PX[0], max_new_tokens=6, repetition_penalty=1.6)
    assert srv.run()[r].tolist() == want


def test_engine_repetition_penalty_matches_jax(tiny):
    """The port engine's penalty (prompt presence without the image ids, then
    each generated token) against the JAX engine, greedy."""
    ids = _prompt(12, 5)
    want = _jax_tokens(tiny, ids, PX, 10, pen=1.3)
    assert want != _jax_tokens(tiny, ids, PX, 10)
    got = InferenceEngine(tiny["model"], tiny["cfg"], "cpu", max_cache_length=MAX_LEN).generate(
        ids, PX, max_new_tokens=10, repetition_penalty=1.3)
    assert got.tokens[0].tolist() == want


def test_min_p_one_forces_greedy(tiny):
    ids = _prompt(9, 1)
    want = _jax_tokens(tiny, ids, PX, 8, (16, 24))
    srv = _server(tiny, prompt_buckets=(16, 24), steps_per_sync=3)
    r = srv.submit(ids[0], PX[0], max_new_tokens=8, temperature=0.9, min_p=1.0, top_p=1.0,
                   top_k=0)
    assert srv.run()[r].tolist() == want


def test_per_request_sampling_is_reproducible(tiny):
    """A greedy and a sampled request together: the greedy one stays equal
    to the JAX engine, the sampled one differs from it and repeats under the
    same server generator."""
    ids = _prompt(10, 30, image=False)

    def run():
        srv = _server(tiny, prompt_buckets=(16,), steps_per_sync=2,
                      rng=torch.Generator().manual_seed(7))
        g = srv.submit(ids[0], None, max_new_tokens=8)
        s = srv.submit(ids[0], None, max_new_tokens=8, temperature=5.0, top_k=0, top_p=1.0)
        res = srv.run()
        return res[g].tolist(), res[s].tolist()

    (g1, s1), (g2, s2) = run(), run()
    assert g1 == _jax_tokens(tiny, ids, None, 8, (16,))
    assert s1 == s2 and s1 != g1


def test_decode_chunk_ladder_and_warmup(tiny):
    """Chunks are powers of two up to steps_per_sync; a warm-up with a live
    slot changes nothing; budgets shorter than a chunk are honoured."""
    srv = _server(tiny, prompt_buckets=(16,), steps_per_sync=8)
    assert [srv._chunk_steps(m) for m in (1, 2, 3, 5, 8, 13)] == [1, 2, 4, 8, 8, 8]
    ids = _prompt(10, 21, image=False)
    full = _jax_tokens(tiny, ids, None, 13, (16,))
    r0 = srv.submit(ids[0], None, max_new_tokens=13)
    srv.step()
    srv.warmup()
    rids = [srv.submit(ids[0], None, max_new_tokens=m) for m in (1, 3, 5)]
    results = srv.run()
    assert results[r0].tolist() == full
    for rid, m in zip(rids, (1, 3, 5)):
        assert results[rid].tolist() == full[:m]


def test_cancel_release_and_slot_hygiene(tiny):
    srv = _server(tiny, slots=1, prompt_buckets=(16,), steps_per_sync=2)
    ids = _prompt(10, 20, image=False)
    r0 = srv.submit(ids[0], None, max_new_tokens=8, temperature=0.9)
    r1 = srv.submit(ids[0], None, max_new_tokens=8)
    req0 = srv._results[r0]
    srv.step()
    assert req0.input_ids is None and req0.pixel_values is None  # payload dropped
    assert srv._slot_sampler[0][0] == 0.9
    assert srv.cancel(r1) and srv.is_finished(r1)  # cancelled while queued
    assert not srv.is_finished(r0) and not srv.release(r0)  # running: refused
    assert srv.cancel(r0) and srv._by_slot == [None] and not srv.cancel(r0)
    assert srv._slot_sampler[0] == (0.0, 0.9, 50, 0.0, 1.0)  # back to greedy
    assert srv.release(r0) and r0 not in srv._results
    r2 = srv.submit(ids[0], None, max_new_tokens=4)
    assert srv.run()[r2].tolist() == _jax_tokens(tiny, ids, None, 4, (16,))


def test_queue_bound_and_deadlines(tiny):
    srv = _server(tiny, slots=1, prompt_buckets=None, max_queue=2, steps_per_sync=1)
    ids = _prompt(5, 1, image=False)[0]
    srv.submit(ids, None, 4)
    srv.submit(ids, None, 4)
    with pytest.raises(QueueFullError):
        srv.submit(ids, None, 4)
    srv.run()
    assert srv.stats()["max_queue"] == 2
    queued = srv.submit(ids, None, 4, timeout_s=0.01)
    time.sleep(0.03)
    srv.step()  # expiry runs before admission
    assert srv._results[queued].timed_out and srv.stats()["timeouts"] == 1
    running = srv.submit(ids, None, 50, timeout_s=0.3)
    srv.step()
    assert 0 < len(srv.tokens_so_far(running)) and not srv.is_finished(running)
    time.sleep(0.35)
    srv.step()
    req = srv._results[running]
    assert req.finished and req.timed_out and 0 < len(req.tokens) < 50
    again = srv.submit(ids, None, 3)
    srv.run()
    assert len(srv.tokens_so_far(again)) == 3


@pytest.mark.parametrize("kwargs, match", [
    ({"timeout_s": -1.0}, "timeout_s"),
    ({"repetition_penalty": 0.0}, "repetition_penalty"),
    ({"min_p": 1.5, "temperature": 0.5}, "min_p"),
    ({"min_p": -0.1, "temperature": 0.5}, "min_p"),
    ({"max_new_tokens": 60}, "exceeds cache capacity"),
    ({"adapter_id": 1}, "adapter_bank"),
])
def test_submit_validates_arguments(tiny, kwargs, match):
    srv = _server(tiny, slots=1)
    kwargs = {"max_new_tokens": 4, **kwargs}
    with pytest.raises(ValueError, match=match):
        srv.submit(_prompt(9, 1)[0], None, **kwargs)


def test_submit_refuses_a_batch_and_bad_queue_bound(tiny):
    with pytest.raises(ValueError, match="ONE prompt"):
        _server(tiny).submit(np.zeros((2, 5), np.int64), None, 4)
    with pytest.raises(ValueError, match="max_queue"):
        _server(tiny, max_queue=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        _server(tiny, kv_dtype="int4")


@pytest.mark.parametrize("what", ["spec_lookup", "adapter_bank", "gemv_routes",
                                  "register_prefix", "prefix_id"])
def test_options_outside_the_slice_raise(tiny, what):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if what == "spec_lookup":
            _server(tiny, spec_lookup=2)
        elif what == "adapter_bank":
            _server(tiny, adapter_bank={})
        elif what == "gemv_routes":
            _server(tiny, gemv_routes={"lm_head": 1 << 20})
        elif what == "register_prefix":
            _server(tiny).register_prefix(np.arange(4))
        else:
            _server(tiny).submit(_prompt(9, 1)[0], None, 4, prefix_id=0)
    assert _server(tiny)._match_prefix(np.arange(4), 0) is None
