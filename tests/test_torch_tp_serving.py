"""The serving features once refused under tensor parallelism, and the
subpackages' public surface, held to the JAX package on the CPU.

Ranks spawned over gloo (``tests/torch_tp_serving_ranks.py``, which imports
no jax), one world of 2 (tp=2) and one of 4 (dp=2 x tp=2), each spawned
once: an adapter bank over the sharded model (greedy tokens equal to the
JAX bank server's), draft-model speculation with the draft whole and
sharded (the JAX ``spec_draft`` engine's tokens), the HTTP front end on
world rank 0 with the other ranks following its log (the JAX server's
tokens for the same bodies, with a prefix and a cancel), the server at
dp=2 x tp=2 (greedy equal to the JAX server, sampled equal to the port's
tp=2 server, deadlines expiring on every rank at once), and full
fine-tuning with ``vision_tp`` and the ViT's attention dropout (loss and
gradients equal to the port's one-device step at rtol 1e-5, fp32). Every
rank's tokens must be the same.

Without a spawn: every name of the JAX subpackages' ``__all__`` resolves in
the port's, and each function the port added for it (the dense mask
functions, the initialisers, ``vision_encoder_forward``, ``default_impl``,
the cache updates) against its JAX counterpart."""

import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.configs import LLAMA32Config as JaxLLAMA32Config
from llama32mm_tpu.inference import engine as jax_engine
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.inference.server import ContinuousBatchingServer as JaxServer
from llama32mm_tpu.models import language as jax_language
from llama32mm_tpu.models import vision as jax_vision
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.ops import dispatch as jax_dispatch
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu.utils import kvcache as jax_kvcache
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax, to_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.train.lora import merge_lora_into_params

import torch_tp_ranks
import torch_tp_serving_ranks as ranks

MAX_LEN = ranks.MAX_LEN
SERVE = "torch_tp_serving_ranks"


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trees: the tiny VLM (seed 2) tied and untied, a 3-adapter
    bank (the identity and two adapters with nonzero B) and the draft."""
    jcfg = jax_tiny_config()
    adapters = [jax_lora.zero_lora_params(jcfg.text_config, rank=4)]
    for i in (1, 2):
        a = jax_lora.init_lora_params(jax.random.PRNGKey(100 + i), jcfg.text_config, rank=4)
        adapters.append(jax.tree.map(lambda x, i=i: x + 0.02 * i, a))
    tc = jcfg.text_config
    djcfg = JaxLLAMA32Config(vocab_size=tc.vocab_size, dtype=tc.dtype,
                             max_cache_length=tc.max_cache_length, **ranks.DRAFT)
    return {"jcfg": jcfg, "djcfg": djcfg,
            "tied": init_vlm_params(jax.random.PRNGKey(2), jcfg),
            "untied": init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False),
            "adapters": adapters,
            "draft": jax_language.init_causal_lm_params(jax.random.PRNGKey(42), djcfg)}


@pytest.fixture(scope="module")
def inputs(jax_side):
    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    return {"trees": {k: np_tree(jax_side[k]) for k in ("tied", "untied")},
            "adapters": [np_tree(a) for a in jax_side["adapters"]],
            "draft": np_tree(jax_side["draft"])}


@pytest.fixture(scope="module")
def world2(inputs):
    return torch_tp_ranks.run_world(2, inputs, module=SERVE)


@pytest.fixture(scope="module")
def world4(inputs):
    return torch_tp_ranks.run_world(4, inputs, module=SERVE)


def _results(results, case):
    """Every rank's result of ``case`` (a failed rank fails the test)."""
    assert case in results, f"case {case} did not run (an earlier case failed): {results.keys()}"
    for r, v in enumerate(results[case]):
        assert not (isinstance(v, tuple) and v and v[0] == "error"), f"rank {r}:\n{v[1]}"
    return results[case]


def _same(values):
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(values[0]))
    return np.asarray(values[0])


def _jax_server(jax_side, submits, prefix=None, step_after=None, **kw):
    """The JAX server's tokens for ``submits`` (``(ids, pixel values,
    budget, submit keywords)``), with ``prefix`` ``(ids, keywords)``
    registered first and one step after the first ``step_after`` submits."""
    kw = {"slots": 2, "max_cache_length": MAX_LEN, "prompt_buckets": None,
          "eos_token_id": -1, "steps_per_sync": 2, "impl": "xla", **kw}
    srv = JaxServer(jax_side["untied"], jax_side["jcfg"], **kw)
    if prefix is not None:
        srv.register_prefix(prefix[0], **prefix[1])
    rids = []
    for i, (ids, px, budget, skw) in enumerate(submits):
        if i == step_after:
            srv.step()
        rids.append(srv.submit(ids, px, max_new_tokens=budget, **skw))
    res = srv.run()
    return [np.asarray(res[r]).tolist() for r in rids]


# -- the adapter bank, the draft ----------------------------------------------------


def test_bank_server_at_tp2_matches_jax_bank_server(world2, jax_side, inputs):
    """Adapters 1, 0, 2, then 1 into a freed slot through its adapter's
    prefix: each request's tokens equal the JAX bank server's and a port
    engine's on the model with the adapter merged, on every rank."""
    res = _results(world2, "bank")
    ids, pfx = ranks.bank_prompts()
    submits = [(i, None, mn, {"adapter_id": a}) for i, (_, _, a, mn) in zip(ids, ranks.BANK_SPECS)]
    want = _jax_server(jax_side, submits, prefix=(pfx, {"adapter_id": ranks.BANK_SPECS[-1][2]}),
                       step_after=3, adapter_bank=jax_lora.stack_adapter_bank(
                           jax_side["adapters"]))
    cfg = tiny_mllama_config()
    model = from_jax_params(inputs["trees"]["untied"], cfg, "cpu")
    for i, (_, _, aid, mn) in enumerate(ranks.BANK_SPECS):
        got = _same([r["tokens"][i] for r in res])
        np.testing.assert_array_equal(got, want[i], err_msg=f"request {i}")
        merged = merge_lora_into_params(model, lora_from_jax(inputs["adapters"][aid], "cpu"))
        solo = InferenceEngine(merged, cfg, "cpu", max_cache_length=MAX_LEN).generate(
            ids[i][None], max_new_tokens=mn, eos_token_id=-1).tokens[0].numpy()
        np.testing.assert_array_equal(got, solo, err_msg=f"request {i} (merged engine)")
    assert len({tuple(w) for w in want}) == len(want)  # the adapters change the tokens
    assert [r["prefix_hits"] for r in res] == [1, 1]


@pytest.mark.parametrize("kind", ["whole", "sharded"])
def test_draft_engine_at_tp2_matches_jax(world2, jax_side, kind):
    """The draft whole on every rank, or sharded on the target's mesh (its
    one kv head held by both ranks): the JAX ``spec_draft`` engine's
    tokens."""
    res = [r[kind] for r in _results(world2, "draft")]
    got = _same([r["tokens"] for r in res])
    assert len({r["steps"] for r in res}) == 1
    ids, px = torch_tp_ranks.engine_prompt()
    eng = JaxEngine(jax_side["tied"], jax_side["jcfg"], max_cache_length=MAX_LEN, impl="xla",
                    spec_draft=ranks.SPEC_K, draft_params=jax_side["draft"],
                    draft_config=jax_side["djcfg"])
    want = np.asarray(eng.generate(jnp.asarray(ids), jnp.asarray(px), max_new_tokens=12,
                                   eos_token_id=-1).tokens)
    assert len(set(want[0].tolist())) > 2
    np.testing.assert_array_equal(got, want)
    assert res[0]["kv_heads"] == (1 if kind == "sharded" else None)


# -- the HTTP front end over a sharded server ----------------------------------------


def _http_oracle(jax_side, **kw):
    pfx, bodies = ranks.http_bodies()
    submits = [(np.asarray(b["input_ids"]), None if "pixel_values" not in b else
                np.asarray(b["pixel_values"], np.float32), b["max_new_tokens"], {})
               for b in bodies]
    return _jax_server(jax_side, submits, prefix=(pfx, {}), steps_per_sync=3, **kw)


@pytest.mark.parametrize("world", [2, 4])
def test_http_over_a_sharded_server_matches_jax(world, world2, world4, jax_side):
    """World rank 0 serves HTTP (a prefix, three ``/generate`` bodies and a
    stream at once, a cancel, the prefix dropped); the other ranks follow
    its log. The bodies' tokens are the JAX server's; every rank holds the
    same records, the cancelled request finished early on all of them, and
    the dropped prefix is gone on all of them."""
    res = _results(world2 if world == 2 else world4,
                   "http" if world == 2 else "http_dp2")
    want = _http_oracle(jax_side, **({} if world == 2 else {"slots": 4}))
    head = res[0]
    assert head["tokens"] == want
    assert head["stats"]["prefix_hits"] == 3 and head["dropped"][0] == 200
    assert head["cancelled"] == (200, {"cancelled": True})
    assert head["cancel_result"]["finished"]
    assert len(head["cancel_result"]["tokens"]) < ranks.CANCEL_BUDGET
    assert not head["thread_alive"]
    for r in res:
        assert r["records"] == head["records"] and r["prefixes"] == []
    for rid, toks in zip(head["rids"], want):
        assert head["records"][rid] == (toks, True)


# -- the server at dp = 2 ----------------------------------------------------------


def _pool_submits(aids=None):
    aids = aids or [0] * len(ranks.POOL_SPECS)
    return [(torch_tp_ranks.prompt(s, seed)[0], ranks.PX[0], mn, {"adapter_id": a})
            for (s, seed, mn), a in zip(ranks.POOL_SPECS, aids)]


@pytest.mark.parametrize("run", ["greedy", "chunked", "bank"])
def test_server_dp2_tp2_greedy_matches_jax(world2, world4, jax_side, run):
    """Greedy traffic through 4 slots: at dp=2 x tp=2 (two slots a group)
    and at tp=2, every rank's tokens are the JAX server's."""
    kw = dict(ranks.POOL_RUNS[run], slots=4)
    aids = None
    if kw.pop("adapter_bank", False):
        kw["adapter_bank"] = jax_lora.stack_adapter_bank(jax_side["adapters"])
        aids = [i % 3 for i in range(len(ranks.POOL_SPECS))]
    want = _jax_server(jax_side, _pool_submits(aids), **kw)
    assert len(set(want[1])) > 2
    for results in (world2, world4):
        res = _results(results, "pool")
        for i in range(len(want)):
            np.testing.assert_array_equal(_same([r[run][i] for r in res]), want[i],
                                          err_msg=f"request {i}")


@pytest.mark.parametrize("run", ["sampled", "spec_sampled"])
def test_server_dp2_tp2_sampled_matches_tp2(world2, world4, run):
    """Sampled traffic under one seed: the samplers draw at the whole pool's
    shape and each group takes its rows, so dp=2 x tp=2 gives the tp=2
    server's tokens."""
    tp2, dp2 = _results(world2, "pool"), _results(world4, "pool")
    want = [_same([r[run][i] for r in tp2]) for i in range(len(ranks.POOL_SPECS))]
    for i in range(len(want)):
        np.testing.assert_array_equal(_same([r[run][i] for r in dp2]), want[i],
                                      err_msg=f"request {i}")
    greedy = [_same([r["greedy"][i] for r in tp2]) for i in range(len(want))]
    assert any(not np.array_equal(w, g) for w, g in zip(want, greedy))  # it did sample


def test_server_dp2_holds_its_groups_rows(world2, world4):
    assert [r["rows"] for r in _results(world2, "pool")] == [4, 4]
    assert [r["rows"] for r in _results(world4, "pool")] == [2, 2, 2, 2]


def test_deadline_expires_on_every_rank_of_both_groups(world4):
    """Only rank 3's clock passes the deadlines: all four ranks time out
    every request at one step, with the same tokens, each a prefix of the
    request's tokens without a deadline."""
    res = _results(world4, "deadline_dp2")
    full = _results(world4, "pool")[0]["greedy"]
    for r in res:
        assert r["timed_out"] == [True] * len(ranks.POOL_SPECS)
    for i in range(len(ranks.POOL_SPECS)):
        got = _same([r["tokens"][i] for r in res])
        assert len(got) < ranks.POOL_SPECS[i][2]
        np.testing.assert_array_equal(got, full[i][:len(got)], err_msg=f"request {i}")


# -- the ViT's attention dropout under vision_tp ----------------------------------


def test_vit_dropout_under_tp_matches_one_device(world2):
    """Full fine-tuning with ``vision_tp`` and attention dropout 0.25: the
    tp=2 step's loss, two steps' losses and each rank's gradient slices of
    the tower equal the one-device step's under the same generator, at rtol
    1e-5 of each element or of the tower's largest gradient (the
    row-parallel sums add the ranks' fp32 partial products in another
    order; the key bias's gradient is zero but for that rounding)."""
    for r in _results(world2, "vit_dropout"):
        assert r["split"] > 0
        np.testing.assert_allclose(*r["loss"], rtol=1e-5)
        np.testing.assert_allclose(*r["losses"], rtol=1e-5)
        scale = max(np.abs(want).max() for _, want in r["grads"].values())
        for name, (got, want) in r["grads"].items():
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


# -- the subpackages' public surface ---------------------------------------------


@pytest.mark.parametrize("sub", ["inference", "models", "ops", "utils"])
def test_subpackage_exports_every_jax_name(sub):
    jax_mod = importlib.import_module(f"llama32mm_tpu.{sub}")
    port = importlib.import_module(f"llama32mm_tpu_torch.{sub}")
    assert set(jax_mod.__all__) <= set(port.__all__)
    for name in jax_mod.__all__:
        assert getattr(port, name) is not None, name


def test_serving_frontend_is_imported_on_first_use():
    code = ("import sys, llama32mm_tpu_torch.inference as inf\n"
            "mod = 'llama32mm_tpu_torch.inference.http_server'\n"
            "assert mod not in sys.modules\n"
            "assert inf.ServingFrontend.__module__ == mod and mod in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _pad_mask():
    rs = np.random.RandomState(3)
    pad = np.ones((2, 6), np.int32)
    pad[1, 4:] = 0
    return pad, rs


def test_dense_masks_match_jax():
    from llama32mm_tpu_torch.inference import build_decode_mask, build_prefill_mask
    from llama32mm_tpu_torch.models import prepare_attention_mask, prepare_position_ids

    pad, _ = _pad_mask()
    tp = torch.from_numpy(pad)
    np.testing.assert_array_equal(build_prefill_mask(tp, 10).numpy(),
                                  np.asarray(jax_engine.build_prefill_mask(jnp.asarray(pad), 10)))
    np.testing.assert_array_equal(
        build_decode_mask(tp, 8, 10).numpy(),
        np.asarray(jax_engine.build_decode_mask(jnp.asarray(pad), 8, 10)))
    for mask in (None, pad):
        got = prepare_attention_mask(None if mask is None else tp, 2, 6, torch.float32, "cpu")
        want = jax_language.prepare_attention_mask(None if mask is None else jnp.asarray(pad),
                                                   2, 6, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = torch.zeros(2, 1, 6, 6)
    assert prepare_attention_mask(dense, 2, 6, torch.float32, "cpu") is not None
    np.testing.assert_array_equal(prepare_position_ids(None, 2, 6, "cpu").numpy(),
                                  np.asarray(jax_language.prepare_position_ids(None, 2, 6)))
    given = torch.arange(12).reshape(2, 6)
    assert prepare_position_ids(given, 2, 6, "cpu") is given


def _same_distribution(got: dict, want: dict, path=""):
    """Same tree, shapes and dtypes; constant leaves equal; random leaves
    of one distribution (U(±1/sqrt(fan_in)) or N(0, 1)), by their range
    and spread."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _same_distribution(g, w, f"{path}/{k}")
            continue
        if w is None:
            assert g is None, f"{path}/{k}"
            continue
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (f"{path}/{k}", g.shape, w.shape)
        if w.min() == w.max():
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
            continue
        assert np.abs(g).max() <= 1.1 * np.abs(w).max(), f"{path}/{k}"
        assert np.abs(g).max() >= 0.5 * np.abs(w).max(), f"{path}/{k}"
        assert 0.5 < g.std() / w.std() < 2.0, f"{path}/{k}"


@pytest.mark.parametrize("what", ["llama", "causal_lm_tied", "causal_lm_untied", "vision"])
def test_initialisers_match_jax(what):
    """The port's initialisers build the JAX trees' shapes from the JAX
    initialisers' distributions (held through ``to_jax_params``)."""
    from llama32mm_tpu_torch.models import (
        init_causal_lm_params,
        init_llama_params,
        init_vision_params,
    )

    cfg, jcfg = tiny_mllama_config(), jax_tiny_config()
    key, gen = jax.random.PRNGKey(5), torch.Generator().manual_seed(5)
    vlm = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))
    if what == "llama":
        vlm.language_model.model = init_llama_params(cfg.text_config, "cpu", gen)
        got = to_jax_params(vlm)["language_model"]["model"]
        want = jax_language.init_llama_params(key, jcfg.text_config)
    elif what == "vision":
        vlm.vision_model = init_vision_params(cfg.vision_config, "cpu", gen)
        got = to_jax_params(vlm)["vision_model"]
        want = jax_vision.init_vision_params(key, jcfg.vision_config)
    else:
        tied = what == "causal_lm_tied"
        vlm.language_model = init_causal_lm_params(cfg.text_config, "cpu", gen, tie_weights=tied)
        got = to_jax_params(vlm)["language_model"]
        want = jax_language.init_causal_lm_params(key, jcfg.text_config, tie_weights=tied)
    _same_distribution(got, jax.tree.map(np.asarray, want))


def test_vision_encoder_forward_matches_jax():
    from llama32mm_tpu_torch.models import vision_encoder_forward

    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tiny_mllama_config(), "cpu")
    px = np.random.RandomState(4).randn(2, 3, 28, 28).astype(np.float32)
    got = vision_encoder_forward(model.vision_model, model.config.vision_config,
                                 torch.from_numpy(px))
    want = jax_vision.vision_encoder_forward(params["vision_model"], jcfg.vision_config,
                                             jnp.asarray(px), impl="xla")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_default_impl_names_the_plain_path_on_the_cpu_as_jax_does():
    """JAX's ``default_impl`` is XLA off the TPU; the port's is ``"auto"``,
    which is the plain version on a CPU tensor and the kernels on a CUDA
    one."""
    from llama32mm_tpu_torch.ops import default_impl, resolve_impl

    assert jax_dispatch.default_impl() == "xla"
    assert default_impl() == "auto"
    assert resolve_impl(default_impl(), torch.zeros(1)) == "torch"


@pytest.mark.parametrize("pos", ["scalar", "per_row_t1", "per_row_t2"])
def test_cache_updates_match_jax(pos):
    from llama32mm_tpu_torch.utils import update_layer_cache, update_stacked

    rs = np.random.RandomState(6)
    k_all, v_all = (rs.randn(2, 3, 2, 8, 4).astype(np.float32) for _ in range(2))
    t = 2 if pos == "per_row_t2" else 1
    k_new, v_new = (rs.randn(3, 2, t, 4).astype(np.float32) for _ in range(2))
    p = 5 if pos == "scalar" else np.array([0, 3, 6])
    tk, tv = torch.from_numpy(k_all.copy()), torch.from_numpy(v_all.copy())
    out = update_stacked(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), 1,
                         p if pos == "scalar" else torch.from_numpy(p))
    want = jax_kvcache.update_stacked(jnp.asarray(k_all), jnp.asarray(v_all),
                                      jnp.asarray(k_new), jnp.asarray(v_new), 1, jnp.asarray(p))
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if pos == "scalar":
        got = update_layer_cache(torch.from_numpy(k_all[0].copy()), torch.from_numpy(
            v_all[0].copy()), torch.from_numpy(k_new), torch.from_numpy(v_new), 5)
        want = jax_kvcache.update_layer_cache(jnp.asarray(k_all[0]), jnp.asarray(v_all[0]),
                                              jnp.asarray(k_new), jnp.asarray(v_new), 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
