"""Multi-LoRA serving in the port on the tiny fp32 config: the adapter-bank
helpers (``zero_lora_params``, ``stack_adapter_bank``,
``gather_adapter_bank``) against the JAX package's, to 1e-6; the per-row
branch of ``maybe_lora`` against JAX ``_maybe_lora``'s 3-D branch; and the
continuous-batching server with a bank: requests with different adapters
decoding in one pool give the greedy tokens of a JAX engine on the model
with their adapter merged (also with speculative decoding and chunked
admission, and through an adapter-specific prefix), the identity adapter
gives the base model's, and the JAX bank server's tokens on the same
traffic. The bank is gathered by slot only when a slot's adapter changes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.inference.server import ContinuousBatchingServer as JaxServer
from llama32mm_tpu.models import language as jax_language
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax
from llama32mm_tpu_torch.inference import server as server_mod
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.models.language import lm_head_apply, maybe_lora
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.train import (
    gather_adapter_bank,
    init_lora_params,
    stack_adapter_bank,
    zero_lora_params,
)
from llama32mm_tpu_torch.train.lora import lora_leaves

MAX_LEN = 64
JAX_NEW = 8


@pytest.fixture(scope="module")
def tiny():
    """The tiny model and a 3-adapter bank (rank 4, default targets and the
    head): the identity, then two adapters whose B is nonzero."""
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    adapters = [jax_lora.zero_lora_params(jcfg.text_config, rank=4)]
    for i in (1, 2):
        a = jax_lora.init_lora_params(jax.random.PRNGKey(100 + i), jcfg.text_config, rank=4)
        adapters.append(jax.tree.map(lambda x, i=i: x + 0.02 * i, a))  # nonzero B: real deltas
    np_adapters = [jax.tree.map(np.asarray, a) for a in adapters]
    return {"jcfg": jcfg, "params": params, "cfg": cfg, "model": model,
            "jax_adapters": adapters, "jax_bank": jax_lora.stack_adapter_bank(adapters),
            "adapters": [lora_from_jax(a, "cpu") for a in np_adapters],
            "bank": stack_adapter_bank([lora_from_jax(a, "cpu") for a in np_adapters]),
            "engines": {}}


def _ids(s, seed):
    return np.random.RandomState(seed).randint(0, 240, s)


def _merged_tokens(tiny, aid, ids, max_new):
    """Greedy tokens of a JAX engine on the base weights with adapter
    ``aid`` merged in (the first ``max_new`` of a ``JAX_NEW``-token run)."""
    if aid not in tiny["engines"]:
        params = jax_lora.merge_lora_into_params(tiny["params"], tiny["jax_adapters"][aid])
        tiny["engines"][aid] = JaxEngine(params, tiny["jcfg"], max_cache_length=MAX_LEN,
                                         impl="xla", prompt_buckets=None)
    out = tiny["engines"][aid].generate(jnp.asarray(ids)[None], None, max_new_tokens=JAX_NEW,
                                        eos_token_id=-1)
    return np.asarray(out.tokens)[0, :max_new].tolist()


def _server(tiny, **kw):
    kw = {"slots": 3, "max_cache_length": MAX_LEN, "prompt_buckets": None, "eos_token_id": -1,
          "steps_per_sync": 2, "adapter_bank": tiny["bank"], **kw}
    return ContinuousBatchingServer(tiny["model"], tiny["cfg"], "cpu", **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_trees_close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_stack_adapter_bank_matches_jax(tiny):
    _assert_trees_close(tiny["bank"], tiny["jax_bank"])
    n_layers = tiny["cfg"].text_config.n_layers
    assert tiny["bank"]["blocks"]["W_query"]["lora_a"].shape[:2] == (3, n_layers)


@pytest.mark.parametrize("idx", [[2, 0, 1, 1], [0], [1, 1, 2]])
def test_gather_adapter_bank_matches_jax(tiny, idx):
    got = gather_adapter_bank(tiny["bank"], idx)
    _assert_trees_close(got, jax_lora.gather_adapter_bank(tiny["jax_bank"], jnp.asarray(idx)))
    a = got["blocks"]["w_down"]["lora_a"]
    assert a.is_contiguous() and a.shape[:2] == (tiny["cfg"].text_config.n_layers, len(idx))
    assert got["lm_head"]["scaling"].shape == (len(idx),)


def test_zero_lora_params_is_the_identity(tiny):
    tc = tiny["cfg"].text_config
    ident = zero_lora_params(tc, rank=4, device="cpu")
    want = jax_lora.zero_lora_params(tiny["jcfg"].text_config, rank=4)
    assert sorted(_flat(ident)) == sorted(_flat(want))
    for name, t in lora_leaves(ident).items():
        assert tuple(t.shape) == tuple(_flat(want)[name].shape), name
        if name.endswith("lora_b"):
            assert not t.any()
    assert init_lora_params(torch.Generator().manual_seed(0), tc, rank=4)["lm_head"][
        "lora_a"].equal(ident["lm_head"]["lora_a"])


@pytest.mark.parametrize("case", ["empty", "targets", "rank", "head"])
def test_stack_adapter_bank_refuses(tiny, case):
    tc = tiny["cfg"].text_config
    gen = torch.Generator().manual_seed(1)
    one = init_lora_params(gen, tc, rank=4)
    other = {"empty": None,
             "targets": init_lora_params(gen, tc, rank=4, targets=("W_query",)),
             "rank": init_lora_params(gen, tc, rank=8),
             "head": init_lora_params(gen, tc, rank=4, include_lm_head=False)}[case]
    if case == "empty":
        with pytest.raises(ValueError, match="need at least one adapter"):
            stack_adapter_bank([])
    else:
        with pytest.raises(ValueError, match="mismatched structures"):
            stack_adapter_bank([one, other])


@pytest.mark.parametrize("t", [1, 3])
def test_per_row_maybe_lora_matches_jax(tiny, t):
    """``x [B, t, in]`` with each row's adapter from the bank (a layer of
    the gathered blocks), against JAX ``_maybe_lora``'s 3-D branch."""
    idx = [2, 0, 1]
    layer = 1
    got_bank = gather_adapter_bank(tiny["bank"], idx)["blocks"]["W_query"]
    n_in, n_out = got_bank["lora_a"].shape[-2], got_bank["lora_b"].shape[-1]
    rs = np.random.RandomState(t)
    x = rs.randn(3, t, n_in).astype(np.float32)
    base = rs.randn(3, t, n_out).astype(np.float32)
    jax_bank = jax_lora.gather_adapter_bank(tiny["jax_bank"], jnp.asarray(idx))["blocks"]["W_query"]
    got = maybe_lora(torch.from_numpy(x), torch.from_numpy(base), got_bank, layer)
    want = jax_language._maybe_lora(jnp.asarray(x), jnp.asarray(base),
                                    jax.tree.map(lambda leaf: leaf[layer], jax_bank))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(want)).max())
    # each row's delta is its own adapter's
    for b, aid in enumerate(idx):
        row = maybe_lora(torch.from_numpy(x[b:b + 1]), torch.from_numpy(base[b:b + 1]),
                         tiny["adapters"][aid]["blocks"]["W_query"], layer)
        torch.testing.assert_close(got[b:b + 1], row, rtol=0, atol=1e-6)


def test_per_row_head_adapter_in_vlm_forward(tiny):
    """``vlm_forward`` with a bank gathered for 3 rows gives each row the
    logits of a forward with that row's adapter alone."""
    idx = [1, 2, 0]
    ids = torch.as_tensor(np.stack([_ids(6, 5 + i) for i in range(3)]))
    lora = gather_adapter_bank(tiny["bank"], idx)
    with torch.inference_mode():
        got = vlm_forward(tiny["model"], tiny["cfg"], input_ids=ids, lora=lora).logits
        for b, aid in enumerate(idx):
            want = vlm_forward(tiny["model"], tiny["cfg"], input_ids=ids[b:b + 1],
                               lora=tiny["adapters"][aid]).logits
            torch.testing.assert_close(got[b:b + 1], want, rtol=0, atol=1e-5)
        h = torch.randn(3, 2, tiny["cfg"].text_config.hidden_size)
        lm = tiny["model"].language_model
        head = lm_head_apply(lm, tiny["cfg"].text_config, h, lora=lora["lm_head"])
        for b, aid in enumerate(idx):
            torch.testing.assert_close(
                head[b:b + 1], lm_head_apply(lm, tiny["cfg"].text_config, h[b:b + 1],
                                             lora=tiny["adapters"][aid]["lm_head"]),
                rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 4])
def test_concurrent_adapters_match_merged_engines(tiny, chunk):
    """Three requests with adapters 0 / 1 / 2 decode together in one pool;
    each gives the tokens of a JAX engine on its merged model."""
    prompts = [_ids(9, 1), _ids(12, 2), _ids(10, 3)]
    want = [_merged_tokens(tiny, aid, p, 6) for aid, p in enumerate(prompts)]
    srv = _server(tiny, prefill_chunk=chunk)
    rids = [srv.submit(p, None, max_new_tokens=6, adapter_id=aid) for aid, p in enumerate(prompts)]
    results = srv.run()
    for aid, rid in enumerate(rids):
        assert results[rid].tolist() == want[aid], f"adapter {aid} diverged from its merged model"
    assert srv.stats()["adapters"] == 3


def test_identity_adapter_is_the_base_model(tiny):
    p = _ids(11, 5)
    want = _merged_tokens(tiny, 0, p, 7)
    engine = JaxEngine(tiny["params"], tiny["jcfg"], max_cache_length=MAX_LEN, impl="xla",
                       prompt_buckets=None)
    base = engine.generate(jnp.asarray(p)[None], None, max_new_tokens=7, eos_token_id=-1)
    assert np.asarray(base.tokens)[0].tolist() == want
    srv = _server(tiny, slots=1, steps_per_sync=3)
    rid = srv.submit(p, None, max_new_tokens=7)  # adapter_id defaults to 0
    assert srv.run()[rid].tolist() == want


def test_adapters_compose_with_spec_and_chunked(tiny):
    p = np.tile(_ids(4, 7), 4)[:14]  # repetitive, so drafts hit
    other = _ids(9, 8)
    srv = _server(tiny, slots=2, spec_lookup=2, prefill_chunk=4)
    r0 = srv.submit(p, None, max_new_tokens=6, adapter_id=2)
    r1 = srv.submit(other, None, max_new_tokens=6, adapter_id=1)
    results = srv.run()
    assert results[r0].tolist() == _merged_tokens(tiny, 2, p, 6)
    assert results[r1].tolist() == _merged_tokens(tiny, 1, other, 6)


def test_adapter_specific_prefix(tiny):
    """A prefix's K/V belong to the adapter it was computed with: auto-match
    only hits prefixes of the request's adapter; a pinned mismatch errors."""
    prefix = _ids(8, 9)
    prompt = np.concatenate([prefix, _ids(5, 10)])
    srv = _server(tiny, slots=1, steps_per_sync=3)
    pid1 = srv.register_prefix(prefix, adapter_id=1)
    with pytest.raises(ValueError, match="adapter-specific"):
        srv.submit(prompt, None, max_new_tokens=5, prefix_id=pid1, adapter_id=2)
    rid = srv.submit(prompt, None, max_new_tokens=5, adapter_id=1)  # auto-match
    assert srv._results[rid].prefix is srv._prefixes[pid1]
    assert srv.run()[rid].tolist() == _merged_tokens(tiny, 1, prompt, 5)
    assert srv._prefixes[pid1].hits == 1
    r2 = srv.submit(prompt, None, max_new_tokens=5, adapter_id=2)  # no match across adapters
    assert srv._results[r2].prefix is None
    assert srv.run()[r2].tolist() == _merged_tokens(tiny, 2, prompt, 5)


@pytest.mark.parametrize("case", ["out_of_range", "negative", "no_bank", "prefix_no_bank"])
def test_adapter_validation(tiny, case):
    if case in ("out_of_range", "negative"):
        srv = _server(tiny, slots=1)
        with pytest.raises(ValueError, match=r"out of range \[0, 3\)"):
            srv.submit(_ids(8, 11), None, max_new_tokens=4, adapter_id=3 if case == "out_of_range"
                       else -1)
    else:
        srv = _server(tiny, slots=1, adapter_bank=None)
        with pytest.raises(ValueError, match="no adapter_bank"):
            if case == "no_bank":
                srv.submit(_ids(8, 12), None, max_new_tokens=4, adapter_id=1)
            else:
                srv.register_prefix(_ids(8, 12), adapter_id=1)
        assert "adapters" not in srv.stats()
    assert len(srv._queue) == 0


def test_bank_gathered_only_when_a_slot_changes_adapter(tiny, monkeypatch):
    """Decode gathers the bank by slot once per change of the slots'
    adapter ids, not once per step."""
    calls = []
    real = server_mod.gather_adapter_bank
    monkeypatch.setattr(server_mod, "gather_adapter_bank",
                        lambda bank, idx: calls.append(idx.tolist()) or real(bank, idx))
    srv = _server(tiny, slots=2, steps_per_sync=1)
    r0 = srv.submit(_ids(9, 13), None, max_new_tokens=6, adapter_id=1)
    r1 = srv.submit(_ids(9, 14), None, max_new_tokens=3, adapter_id=1)
    srv.run()
    assert calls == [[1, 1]]  # 5 decode steps, one gather; freed slots keep their adapter
    r2 = srv.submit(_ids(9, 15), None, max_new_tokens=3, adapter_id=2)
    srv.run()
    assert calls == [[1, 1], [2, 1]]
    assert all(srv.is_finished(r) for r in (r0, r1, r2))
    assert "projector" not in srv._slot_bank[1]


def test_bank_server_matches_jax_bank_server(tiny):
    """The JAX server and the port's, each with the bank, on the same
    staggered traffic (a request submitted after a step takes a freed
    slot): the same tokens."""
    prompts = [(_ids(9, 21), 1, 5), (_ids(12, 22), 2, 3), (_ids(10, 23), 0, 4)]
    outs = []
    for make in (lambda **kw: JaxServer(tiny["params"], tiny["jcfg"], impl="xla",
                                        adapter_bank=tiny["jax_bank"], **kw),
                 lambda **kw: _server(tiny, **kw)):
        srv = make(slots=2, max_cache_length=MAX_LEN, prompt_buckets=None, eos_token_id=-1,
                   steps_per_sync=2)
        rids = [srv.submit(p, None, max_new_tokens=n, adapter_id=a) for p, a, n in prompts[:2]]
        srv.step()
        rids += [srv.submit(p, None, max_new_tokens=n, adapter_id=a) for p, a, n in prompts[2:]]
        results = srv.run()
        outs.append([np.asarray(results[r]).tolist() for r in rids])
        assert srv.stats()["adapters"] == 3
    assert outs[1] == outs[0]
