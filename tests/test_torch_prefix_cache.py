"""Prefix caching in the port's continuous-batching server on the tiny fp32
config: requests that share a registered prompt prefix copy its K/V rows
into their slot and prefill only the suffix, and give the greedy tokens of
a solo JAX ``InferenceEngine.generate`` on the full prompt, exactly (float
and int8 KV cache, monolithic and chunked admission, a text prefix matched
on its own and an image prefix pinned by id, with speculative decoding);
the JAX server's tokens and prefix statistics on the same traffic; the JAX
package's bucket policy for a prefixed admission; every validation error;
and ``drop_prefix``, which frees the prefix's rows."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.inference.server import ContinuousBatchingServer as JaxServer
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

MAX_LEN = 64
JAX_NEW = 8  # every JAX engine run generates this many; a budget takes its prefix
PX = np.random.RandomState(0).randn(3, 28, 28).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    # seed 2 gives a tiny model whose greedy tokens vary from step to step
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    return {"jcfg": jcfg, "params": params, "cfg": cfg, "model": model, "engines": {}}


def _ids(s, seed):
    return np.random.RandomState(seed).randint(0, 240, s)


def _repetitive(s, seed, period=4):
    """A prompt with a repeating pattern, so bigram drafts hit."""
    return np.tile(np.random.RandomState(seed).randint(0, 240, period), s // period + 1)[:s]


def _image_head(n_text, seed):
    """The tiny config's 4 ``<image>`` ids, then ``n_text`` text ids."""
    head = _ids(4 + n_text, seed)
    head[:4] = 250
    return head


def _jax_tokens(tiny, ids, max_new, px=None, kv_dtype=None):
    """The greedy tokens of a solo JAX engine run on the full prompt (the
    first ``max_new`` of a ``JAX_NEW``-token run: greedy tokens do not depend
    on the budget, so one engine compiles once per prompt length)."""
    key = kv_dtype
    if key not in tiny["engines"]:
        tiny["engines"][key] = JaxEngine(tiny["params"], tiny["jcfg"], max_cache_length=MAX_LEN,
                                         impl="xla", prompt_buckets=None, kv_dtype=kv_dtype)
    assert max_new <= JAX_NEW
    out = tiny["engines"][key].generate(
        jnp.asarray(ids)[None], None if px is None else jnp.asarray(px)[None],
        max_new_tokens=JAX_NEW, eos_token_id=-1)
    return np.asarray(out.tokens)[0, :max_new].tolist()


def _server(tiny, **kw):
    kw = {"slots": 2, "max_cache_length": MAX_LEN, "prompt_buckets": None, "eos_token_id": -1,
          "steps_per_sync": 3, **kw}
    return ContinuousBatchingServer(tiny["model"], tiny["cfg"], "cpu", **kw)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_text_prefix_auto_match_token_identical(tiny, kv_dtype):
    prefix = _ids(8, 11)
    prompts = [np.concatenate([prefix, _ids(5, 12)]), np.concatenate([prefix, _ids(9, 13)])]
    want = [_jax_tokens(tiny, p, 6, kv_dtype=kv_dtype) for p in prompts]
    assert want[0] != want[1]  # the comparison is not degenerate
    srv = _server(tiny, kv_dtype=kv_dtype)
    pid = srv.register_prefix(prefix)
    rids = [srv.submit(p, None, max_new_tokens=6) for p in prompts]
    assert all(srv._results[r].prefix is srv._prefixes[pid] for r in rids)
    results = srv.run()
    for i, rid in enumerate(rids):
        assert results[rid].tolist() == want[i], f"prefixed request {i} diverged"
    assert srv._prefixes[pid].hits == 2
    st = srv.stats()
    assert (st["prefixes"], st["prefix_hits"], st["prefix_tokens_cached"]) == (1, 2, 8)
    srv.drop_prefix(pid)
    assert "prefixes" not in srv.stats()


def test_prefix_with_chunked_admission(tiny):
    """The admission starts at off = P and chunks only the suffix: the
    7-token suffix, chunk-aligned to 8, after a 10-token prefix reads
    14/18 after the first chunk."""
    prefix = _ids(10, 21)
    prompt = np.concatenate([prefix, _ids(7, 22)])
    srv = _server(tiny, slots=1, steps_per_sync=2, prefill_chunk=4)
    srv.register_prefix(prefix)
    rid = srv.submit(prompt, None, max_new_tokens=5)
    srv.step()
    st = srv.stats()
    assert st.get("admitting") == rid and st["admit_progress"] == "14/18"
    assert srv.run()[rid].tolist() == _jax_tokens(tiny, prompt, 5)


def test_chunked_prefixed_admission_beside_a_decoding_slot(tiny):
    """A prefixed chunked admission whose chunks interleave with another
    slot's decode steps: those steps write the admitting slot's row at S-1,
    never over its prefix rows."""
    prefix = _image_head(6, 23)
    srv = _server(tiny, steps_per_sync=1, prefill_chunk=2)
    pid = srv.register_prefix(prefix, pixel_values=PX)
    first = _ids(9, 24)
    r0 = srv.submit(first, None, max_new_tokens=8)
    srv.step()
    srv.step()
    prompt = np.concatenate([prefix, _ids(5, 25)])
    r1 = srv.submit(prompt, None, max_new_tokens=6, prefix_id=pid)
    results = srv.run()
    assert results[r0].tolist() == _jax_tokens(tiny, first, 8)
    assert results[r1].tolist() == _jax_tokens(tiny, prompt, 6, px=PX)


def test_image_prefix_explicit_id(tiny):
    """The image and its template as a prefix: the request carries the
    prefix's ids and its own, and no pixel values."""
    head = _image_head(6, 31)
    full = np.concatenate([head, _ids(5, 32)])
    srv = _server(tiny, slots=1)
    pid = srv.register_prefix(head, pixel_values=PX[None])
    assert not srv._prefixes[pid].auto_match and srv._prefixes[pid].has_image
    rid = srv.submit(full, None, max_new_tokens=6, prefix_id=pid)
    assert srv.run()[rid].tolist() == _jax_tokens(tiny, full, 6, px=PX)
    assert srv._prefixes[pid].hits == 1


def test_image_prefix_is_not_auto_matched(tiny):
    head = _image_head(6, 33)
    srv = _server(tiny, slots=1)
    srv.register_prefix(head, pixel_values=PX)
    rid = srv.submit(np.concatenate([head, _ids(3, 34)]), PX, max_new_tokens=2)
    assert srv._results[rid].prefix is None


def test_longest_prefix_wins_and_nonmatch_ignored(tiny):
    p_short = _ids(4, 41)
    p_long = np.concatenate([p_short, _ids(5, 42)])
    other = _ids(12, 43)
    srv = _server(tiny, slots=1)
    srv.register_prefix(p_short)
    pid_long = srv.register_prefix(p_long)
    prompt = np.concatenate([p_long, _ids(3, 44)])
    r0 = srv.submit(prompt, None, max_new_tokens=4)
    r1 = srv.submit(other, None, max_new_tokens=4)  # no prefix matches
    r2 = srv.submit(p_long, None, max_new_tokens=4)  # a prefix must be shorter than the prompt
    results = srv.run()
    assert results[r0].tolist() == _jax_tokens(tiny, prompt, 4)
    assert results[r1].tolist() == _jax_tokens(tiny, other, 4)
    assert srv._prefixes[pid_long].hits == 1
    assert srv._results[r1].prefix is None
    assert srv._results[r2].prefix is not None and srv._results[r2].prefix.length == 4


def test_prefix_with_spec_lookup_and_chunked_admission(tiny):
    """Prefix caching composed with speculative decoding (K=2) and chunked
    admission (the JAX package's ``test_server_spec.py`` case)."""
    prefix = _repetitive(8, 7)
    prompt = np.concatenate([prefix, _repetitive(6, 8, period=3)])
    srv = _server(tiny, steps_per_sync=2, spec_lookup=2, prefill_chunk=4)
    srv.register_prefix(prefix)
    rid = srv.submit(prompt, None, max_new_tokens=7)
    assert srv.run()[rid].tolist() == _jax_tokens(tiny, prompt, 7)
    assert srv.stats()["prefix_hits"] == 1


def test_prefixed_request_matches_jax_server(tiny):
    """The JAX server and the port's on the same traffic: a text prefix
    matched on its own, pinned by id, and an unprefixed neighbour; the same
    tokens and prefix statistics."""
    prefix = _ids(8, 51)
    prompts = [np.concatenate([prefix, _ids(5, 52)]), np.concatenate([prefix, _ids(4, 53)]),
               _ids(10, 54)]
    outs, stats = [], []
    for make in (lambda **kw: JaxServer(tiny["params"], tiny["jcfg"], impl="xla", **kw),
                 lambda **kw: ContinuousBatchingServer(tiny["model"], tiny["cfg"], "cpu", **kw)):
        srv = make(slots=2, max_cache_length=MAX_LEN, prompt_buckets=None, eos_token_id=-1,
                   steps_per_sync=2)
        pid = srv.register_prefix(prefix)
        rids = [srv.submit(prompts[0], None, max_new_tokens=6),
                srv.submit(prompts[1], None, max_new_tokens=5, prefix_id=pid),
                srv.submit(prompts[2], None, max_new_tokens=4)]
        results = srv.run()
        outs.append([np.asarray(results[r]).tolist() for r in rids])
        stats.append({k: srv.stats()[k] for k in ("prefixes", "prefix_hits",
                                                  "prefix_tokens_cached", "finished")})
    assert outs[1] == outs[0]
    assert stats[1] == stats[0] == {"prefixes": 1, "prefix_hits": 2, "prefix_tokens_cached": 8,
                                    "finished": 3}


def _bucket_after_admission(srv, rid) -> int:
    """The admission's ``filled`` (the bucket): the slot's write offset less
    the decode steps since (each emitted one token after the first)."""
    req = srv._results[rid]
    return int(srv.state.pos[req.slot]) - (len(req.tokens) - 1)


@pytest.mark.parametrize("max_len,buckets,chunk,want", [
    (256, "auto", None, 8 + 128),  # the suffix one chunk, rounded up to 128 rows
    (64, "auto", None, 13),  # P + 128 would eat the headroom: the prompt's length
    (64, None, None, 13),  # the suffix's own length
    (64, (16, 32), None, 13),  # explicit buckets: the suffix's own length
    (64, None, 4, 8 + 8),  # P + ceil(5 / 4) * 4
    (64, None, 3, 8 + 6),
])
def test_prefixed_bucket_follows_jax(tiny, max_len, buckets, chunk, want):
    """``bucket = P + ceil(n_suffix / C) * C`` with ``C = prefill_chunk``, the
    suffix rounded up to 128 under ``"auto"``, else the suffix length;
    ``bucket = s`` when that leaves too little room (JAX ``server.py``
    ``_start_admission``)."""
    prefix = _ids(8, 61)
    prompt = np.concatenate([prefix, _ids(5, 62)])
    srv = _server(tiny, slots=1, max_cache_length=max_len, prompt_buckets=buckets,
                  prefill_chunk=chunk, steps_per_sync=1)
    srv.register_prefix(prefix)
    rid = srv.submit(prompt, None, max_new_tokens=6)
    while not srv._results[rid].tokens:
        srv.step()
    assert _bucket_after_admission(srv, rid) == want
    assert srv.run()[rid].tolist() == _jax_tokens(tiny, prompt, 6)


def test_prefixed_admission_prefills_only_the_suffix(tiny, monkeypatch):
    """The decoder runs over the suffix's rows, at offsets from P; the slot's
    token history (``seq``, the lookup's and the penalty's context) holds the
    whole prompt."""
    prefix = _ids(9, 63)
    prompt = np.concatenate([prefix, _ids(6, 64)])
    srv = _server(tiny, slots=1, steps_per_sync=1)
    srv.register_prefix(prefix)
    calls = []
    orig = srv._prefill_rows
    monkeypatch.setattr(srv, "_prefill_rows",
                        lambda embeds, pad_row, off, view, lora:
                        calls.append((off, embeds.shape[1])) or orig(embeds, pad_row, off, view,
                                                                    lora))
    rid = srv.submit(prompt, None, max_new_tokens=3)
    srv.step()
    assert calls == [(9, 6)]
    slot = srv._results[rid].slot
    assert srv.state.seq[slot, :15].tolist() == prompt.tolist()
    assert srv.state.kv_valid[slot, :15].tolist() == [1] * 15


def test_penalised_prefixed_request_matches_solo_engine(tiny):
    """The repetition penalty's presence set covers the prefix's tokens."""
    prefix = _repetitive(8, 65)
    prompt = np.concatenate([prefix, _repetitive(6, 66, period=3)])
    srv = _server(tiny, slots=1)
    srv.register_prefix(prefix)
    rid = srv.submit(prompt, None, max_new_tokens=6, repetition_penalty=1.5)
    eng = InferenceEngine(tiny["model"], tiny["cfg"], "cpu", max_cache_length=MAX_LEN)
    out = eng.generate(torch.as_tensor(prompt)[None], max_new_tokens=6, repetition_penalty=1.5)
    assert srv.run()[rid].tolist() == out.tokens[0].tolist()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefix_keeps_only_its_rows(tiny, kv_dtype):
    """A prefix holds the K/V (and int8 scales) of its P positions, equal to
    those rows of a full prefill of the same ids into a slot."""
    tc = tiny["cfg"].text_config
    prefix = _ids(7, 67)
    srv = _server(tiny, slots=1, kv_dtype=kv_dtype)
    cache = srv._prefixes[srv.register_prefix(prefix)].cache
    assert tuple(cache.k.shape) == (tc.n_layers, 1, tc.n_kv_groups, 7, tc.head_dim)
    assert tuple(cache.v.shape) == tuple(cache.k.shape)
    assert cache.quantized == (kv_dtype == "int8")
    if kv_dtype:
        assert tuple(cache.k_scale.shape) == (tc.n_layers, 1, tc.n_kv_groups, 7)
    rid = srv.submit(np.concatenate([prefix, _ids(3, 68)]), None, max_new_tokens=1)
    srv.release(rid)
    plain = _server(tiny, slots=1, kv_dtype=kv_dtype)
    plain.submit(prefix, None, max_new_tokens=1)
    plain.run()
    full = plain.state.cache
    torch.testing.assert_close(cache.k, full.k[:, :1, :, :7], rtol=0, atol=1e-5)
    torch.testing.assert_close(cache.v, full.v[:, :1, :, :7], rtol=0, atol=1e-5)


def test_drop_prefix_frees_its_rows(tiny):
    prefix = _ids(8, 71)
    prompt = np.concatenate([prefix, _ids(4, 72)])
    srv = _server(tiny, slots=1)
    pid = srv.register_prefix(prefix)
    pfx = srv._prefixes[pid]
    rows = weakref.ref(pfx.cache.k)
    srv.drop_prefix(pid)
    gc.collect()
    assert pfx.cache is None and rows() is None
    assert "prefixes" not in srv.stats()
    with pytest.raises(KeyError):
        srv.submit(prompt, None, max_new_tokens=4, prefix_id=pid)
    with pytest.raises(KeyError):
        srv.drop_prefix(pid)


def test_dropped_prefix_serves_its_queued_request_then_frees(tiny):
    prefix = _ids(8, 73)
    prompt = np.concatenate([prefix, _ids(4, 74)])
    srv = _server(tiny, slots=1)
    pid = srv.register_prefix(prefix)
    pfx = srv._prefixes[pid]
    rid = srv.submit(prompt, None, max_new_tokens=4)
    srv.drop_prefix(pid)
    assert pfx.cache is not None  # the queued request still needs it
    assert srv.run()[rid].tolist() == _jax_tokens(tiny, prompt, 4)
    assert pfx.cache is None and pfx.hits == 1
    # a cancelled queued request lets go of it too
    pid = srv.register_prefix(prefix)
    pfx = srv._prefixes[pid]
    rid = srv.submit(prompt, None, max_new_tokens=4)
    srv.drop_prefix(pid)
    srv.cancel(rid)
    assert pfx.cache is None


@pytest.mark.parametrize("case", ["short_prompt", "other_tokens", "image_auto_match",
                                  "image_twice", "empty_prefix", "prefix_fills_cache"])
def test_prefix_validation_errors(tiny, case):
    srv = _server(tiny, slots=1)
    prefix = _ids(6, 81)
    pid = srv.register_prefix(prefix)
    head = np.full(6, 250)
    if case == "short_prompt":
        with pytest.raises(ValueError, match="extend past the prefix"):
            srv.submit(prefix, None, max_new_tokens=4, prefix_id=pid)
    elif case == "other_tokens":
        with pytest.raises(ValueError, match="does not start with"):
            srv.submit(_ids(9, 82), None, max_new_tokens=4, prefix_id=pid)
    elif case == "image_auto_match":
        with pytest.raises(ValueError, match="auto-match"):
            srv.register_prefix(head, pixel_values=PX, auto_match=True)
    elif case == "image_twice":
        img_pid = srv.register_prefix(head, pixel_values=PX)
        with pytest.raises(ValueError, match="already carries the image"):
            srv.submit(np.concatenate([head, _ids(3, 83)]), PX, max_new_tokens=4,
                       prefix_id=img_pid)
    elif case == "empty_prefix":
        with pytest.raises(ValueError, match="prefix length 0"):
            srv.register_prefix(np.zeros(0, np.int64))
    else:
        with pytest.raises(ValueError, match=f"prefix length {MAX_LEN} must be in"):
            srv.register_prefix(_ids(MAX_LEN, 84))
    assert len(srv._queue) == 0
