"""Tensor-parallel serving of the port (``llama32mm_tpu_torch/parallel/``) on
the CPU: ranks spawned over gloo (``tests/torch_tp_ranks.py``, which imports
no jax), once per world size, each running every case; this module holds
their results to the JAX package's single-device oracles (logits to 2e-4,
as ``tests/test_sharding.py``; greedy tokens exactly) or, for what the JAX
engine does not share with the port (sampling, the prefix cache, the lookup
speculation), to the port on one device. Every rank's tokens must be the
same. Also the mesh and the layout without a spawn: the placements, the 90B
layout at tp=8 on the ``meta`` device, and a one-device forward that makes
no collective call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.inference.engine import InferenceEngine as JaxEngine
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu_torch.configs import llama32_90b_vision_config, tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.io.checkpoint import save_checkpoint_params
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration, init_vlm, vlm_forward
from llama32mm_tpu_torch.parallel import (
    Mesh,
    kv_cache_sharding,
    param_shardings,
    single_device_mesh,
)

import torch_tp_ranks as ranks

TOL = dict(atol=2e-4, rtol=2e-4)
JAX_NEW = 10  # every JAX engine run generates this many; a budget takes its prefix


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_tiny_config()
    # seed 2: greedy tokens that vary from step to step (tests/test_torch_engine.py)
    return {"jcfg": jcfg,
            "tied": init_vlm_params(jax.random.PRNGKey(2), jcfg),
            "untied": init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)}


@pytest.fixture(scope="module")
def trees(jax_params):
    return {k: jax.tree.map(np.asarray, jax_params[k]) for k in ("tied", "untied")}


@pytest.fixture(scope="module")
def world2(trees, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    cfg = tiny_mllama_config()
    save_checkpoint_params(str(ckpt), from_jax_params(trees["untied"], cfg, "cpu"), cfg)
    return ranks.run_world(2, {"trees": trees, "ckpt": str(ckpt)})


@pytest.fixture(scope="module")
def world4(trees):
    return ranks.run_world(4, {"trees": trees})


def _ok(results, case):
    """Every rank's result of ``case`` (a failed rank fails the test)."""
    assert case in results, f"case {case} did not run (an earlier case failed): {results.keys()}"
    for r, v in enumerate(results[case]):
        assert not (isinstance(v, tuple) and v and v[0] == "error"), f"rank {r}:\n{v[1]}"
    return results[case]


def _same_on_every_rank(values):
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(values[0]))
    return np.asarray(values[0])


def _jax_logits(params, jcfg):
    ids, px = ranks.batch()
    return np.asarray(jax_vlm_forward(params, jcfg, input_ids=jnp.asarray(ids),
                                      pixel_values=jnp.asarray(px), impl="xla").logits)


def _jax_generate(params, jcfg, ids, px, new=JAX_NEW, **kw):
    eng = JaxEngine(params, jcfg, max_cache_length=ranks.MAX_LEN, impl="xla", **kw)
    out = eng.generate(jnp.asarray(ids), None if px is None else jnp.asarray(px),
                       max_new_tokens=new, eos_token_id=-1)
    return np.asarray(out.tokens), np.asarray(out.prefill_logits)


# -- the mesh and the layout ------------------------------------------------------


def test_mesh_creation(world2):
    for r, res in enumerate(_ok(world2, "mesh")):
        assert res["shape"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 2}
        assert res["coords"] == {"dp": 0, "pp": 0, "sp": 0, "tp": r}
        assert len(res["errors"]) == 3 and all("needs" in e for e in res["errors"])


def test_mesh_creation_dp2_tp2(world4):
    for r, res in enumerate(_ok(world4, "mesh4")):
        assert res["shape"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        assert res["coords"] == {"dp": r // 2, "pp": 0, "sp": 0, "tp": r % 2}
        assert len(res["errors"]) == 2 and all("needs" in e for e in res["errors"])


def test_single_device_mesh_makes_no_collective():
    mesh = single_device_mesh("cpu")
    assert mesh.shape == {"dp": 1, "pp": 1, "sp": 1, "tp": 1} and mesh.member
    x = torch.ones(3)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x


def test_param_sharding_placement(world2, trees):
    wq = trees["untied"]["language_model"]["model"]["blocks"]["att"]["W_query"]["weight"][0].T
    for r, res in enumerate(_ok(world2, "placement")):
        assert res["W_query"] == (32, 64) and res["W_key"] == (16, 64)
        assert res["out_proj"] == (64, 32) and res["w_down"] == (64, 64)
        assert res["tok_emb"] == (128, 64) and res["lm_head"] == (128, 64)
        assert res["patch_embedding"] == (32, 3 * 14 * 14)  # the ViT stays whole by default
        assert res["vit_q_proj"] == (16, 32) and res["vit_fc1_bias"] == (32,)
        assert res["vit_fc2_bias"] == (32,)  # a row-parallel bias is whole, added once
        assert res["tp"] == (2, 1, r * 128, 128)
        np.testing.assert_array_equal(res["rows_of_W_query"], wq[r * 32:(r + 1) * 32])


def test_param_shardings_rules():
    """Which dim each leaf splits, float and quantized, without a spawn."""
    cfg = tiny_mllama_config()
    mesh = Mesh({"tp": 2})
    plan = param_shardings(cfg, mesh)
    b = "language_model.model.blocks.0."
    dims = {n: plan[n].dim for n in (b + "att.W_query.weight", b + "att.W_key.weight",
                                     b + "att.out_proj.weight", b + "ff.w_gate.weight",
                                     b + "ff.w_down.weight", b + "norm1.weight",
                                     "language_model.model.tok_emb",
                                     "language_model.lm_head.weight",
                                     "vision_model.layers.0.q_proj.weight",
                                     "multi_modal_projector.weight")}
    assert dims == {b + "att.W_query.weight": 0, b + "att.W_key.weight": 0,
                    b + "att.out_proj.weight": 1, b + "ff.w_gate.weight": 0,
                    b + "ff.w_down.weight": 1, b + "norm1.weight": None,
                    "language_model.model.tok_emb": 0, "language_model.lm_head.weight": 0,
                    "vision_model.layers.0.q_proj.weight": None,
                    "multi_modal_projector.weight": None}
    vplan = param_shardings(cfg, mesh, vision_tp=True)
    v = "vision_model.layers.0."
    assert [vplan[v + n].dim for n in ("q_proj.weight", "q_proj.bias", "fc1.bias",
                                       "out_proj.weight", "out_proj.bias", "fc2.bias")] == \
        [0, 0, 0, 1, None, None]
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0), tie_weights=False)
    for bits, scale_dim in ((8, None), (4, 1)):
        q = quantize_llama_params(model, bits=bits, group_size=32)
        qplan = param_shardings(cfg, mesh, q)
        key = "q" if bits == 8 else "q4"
        assert qplan[b + f"att.out_proj.{key}"].dim == 1
        assert qplan[b + "att.out_proj.scale"].dim == scale_dim  # int8 scales follow the out axis
        assert qplan[b + "att.W_query.scale"].dim == 0
    with pytest.raises(ValueError, match="does not divide"):
        param_shardings(cfg, Mesh({"tp": 3}))
    cache = kv_cache_sharding(Mesh({"dp": 2, "tp": 4}), cfg)  # 2 kv heads over tp=4
    assert [pl.local_shape((2, 4, 2, 64, 16)) for pl in cache["k"]] == [(2, 2, 2, 64, 16),
                                                                        (2, 4, 1, 64, 16)]


def test_90b_layout_shards_evenly():
    """Every leaf of the Llama-3.2-90B-Vision layout divides over tp=8 (on the
    meta device: no memory, no spawn), one kv head a rank."""
    cfg = llama32_90b_vision_config()
    model = MllamaForConditionalGeneration(cfg, "meta", tie_weights=False)
    mesh = Mesh({"dp": 2, "tp": 8})
    plan = param_shardings(cfg, mesh, model)
    split = 0
    for name, t in list(model.named_parameters()):
        pl = plan[name]
        if pl.dim is None:
            continue
        split += 1
        local = pl.local_shape(t.shape)
        assert pl.full_shape(local) == tuple(t.shape), name
    assert split == 7 * cfg.text_config.n_layers + 2  # the decoder's linears, embedding, head
    kv = plan["language_model.model.blocks.0.att.W_key.weight"]
    assert kv.local_shape((1024, 8192)) == (128, 8192)


def test_single_device_forward_calls_no_collective(monkeypatch, trees):
    """Without a mesh the forward is the one-device path: no collective."""
    def refuse(*a, **k):
        raise AssertionError("a collective ran on one device")

    for name in ("all_reduce", "all_gather", "broadcast"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    cfg = tiny_mllama_config()
    model = from_jax_params(trees["tied"], cfg, "cpu")
    ids, px = ranks.batch()
    with torch.inference_mode():
        out = vlm_forward(model, cfg, input_ids=torch.as_tensor(ids),
                          pixel_values=torch.as_tensor(px))
    assert torch.isfinite(out.logits).all()


# -- forwards ----------------------------------------------------------------------


def _check_logits(results, case, want):
    got = _same_on_every_rank(_ok(results, case))  # the logits are all-gathered
    np.testing.assert_allclose(got, want, **TOL)


def test_tp2_forward_matches_jax(world2, jax_params):
    _check_logits(world2, "forward_tied", _jax_logits(jax_params["tied"], jax_params["jcfg"]))


def test_tp2_untied_forward_matches_jax(world2, jax_params):
    _check_logits(world2, "forward_untied",
                  _jax_logits(jax_params["untied"], jax_params["jcfg"]))


def test_tp4_forward_matches_jax(world4, jax_params, trees):
    """tp=4 over 2 kv heads: each rank keeps the whole kv head its query head
    reads (ranks 0-1 head 0, ranks 2-3 head 1)."""
    res = _ok(world4, "forward_tp4")
    _same_on_every_rank([r["logits"] for r in res])
    np.testing.assert_allclose(res[0]["logits"],
                               _jax_logits(jax_params["tied"], jax_params["jcfg"]), **TOL)
    wk = trees["tied"]["language_model"]["model"]["blocks"]["att"]["W_key"]["weight"][0].T
    for r, rr in enumerate(res):
        assert rr["kv_heads"] == 1
        np.testing.assert_array_equal(rr["W_key"], wk[(r // 2) * 16:(r // 2 + 1) * 16])


def test_vision_tp_forward_matches_jax(world2, jax_params):
    _check_logits(world2, "vision_tp", _jax_logits(jax_params["tied"], jax_params["jcfg"]))


def test_sharded_int8_forward_matches_jax(world2, jax_params):
    q = jq.quantize_llama_params(jax_params["untied"])
    _check_logits(world2, "int8_forward", _jax_logits(q, jax_params["jcfg"]))


def test_sharded_int4_forward_matches_jax(world2, jax_params):
    """Row-parallel int4 leaves split on group boundaries (K/tp = 32 = g)."""
    q = jq.quantize_llama_params(jax_params["untied"], bits=4, group_size=32)
    _check_logits(world2, "int4_forward", _jax_logits(q, jax_params["jcfg"]))


# -- the engine and the server ---------------------------------------------------


def test_sharded_engine_generate_matches_jax(world2, jax_params):
    res = _ok(world2, "engine_greedy")
    got = _same_on_every_rank([r["tokens"] for r in res])
    want, pre = _jax_generate(jax_params["tied"], jax_params["jcfg"], *ranks.engine_prompt())
    assert len(set(want[0].tolist())) > 2  # the comparison is not degenerate
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(res[0]["prefill_logits"], pre, **TOL)


def test_sharded_sampled_generate_matches_port(world2, trees):
    """Sampling: the ranks draw alike from generators seeded alike, and as the
    port on one device draws."""
    got = _same_on_every_rank([r["tokens"] for r in _ok(world2, "engine_sampled")])
    cfg = tiny_mllama_config()
    eng = InferenceEngine(from_jax_params(trees["tied"], cfg, "cpu"), cfg, "cpu",
                          max_cache_length=ranks.MAX_LEN)
    want = eng.generate(*ranks.engine_prompt(), max_new_tokens=10, temperature=0.8,
                        top_p=0.9, top_k=20, eos_token_id=-1,
                        rng=torch.Generator().manual_seed(5)).tokens.numpy()
    np.testing.assert_array_equal(got, want)


def test_sharded_int8_kv_engine_decode_matches(world4, jax_params):
    """int8 weights and the int8 KV cache over dp=2 x tp=2: each dp group
    generates one of the two rows, every rank returns both."""
    got = _same_on_every_rank([r["tokens"] for r in _ok(world4, "engine_dp2_tp2_int8")])
    ids, px = ranks.batch(2, 10, seed=21)
    want, _ = _jax_generate(jq.quantize_llama_params(jax_params["untied"]), jax_params["jcfg"],
                            ids, px, new=6, kv_dtype="int8")
    assert len(set(got.ravel().tolist())) > 2
    np.testing.assert_array_equal(got, want)


def test_sharded_int4_mixed_engine_matches_jax(world2, jax_params):
    from llama32mm_tpu.ops.quant import INT4_MIXED_RECIPE

    got = _same_on_every_rank([r["tokens"] for r in _ok(world2, "engine_int4_mixed")])
    assert len(set(got[0].tolist())) > 2
    q = jq.quantize_llama_params(jax_params["untied"], bits=4, group_size=32,
                                 recipe=INT4_MIXED_RECIPE)
    want, _ = _jax_generate(q, jax_params["jcfg"], *ranks.engine_prompt(), kv_dtype="int8")
    np.testing.assert_array_equal(got, want)


def _server_oracle(jax_params, **kw):
    """Each server request's tokens from a solo JAX engine run."""
    eng = JaxEngine(jax_params["untied"], jax_params["jcfg"], max_cache_length=ranks.MAX_LEN,
                    impl="xla", **kw)
    out = []
    for s, seed, budget in ranks.SERVER_SPECS:
        res = eng.generate(jnp.asarray(ranks.prompt(s, seed)), jnp.asarray(ranks.PX),
                           max_new_tokens=JAX_NEW, eos_token_id=-1)
        out.append(np.asarray(res.tokens)[0, :budget])
    return out


@pytest.mark.parametrize("case,kw", [
    ("server_monolithic", dict(prompt_buckets=(16, 24))),
    ("server_chunked_int8kv", dict(kv_dtype="int8")),
])
def test_sharded_server_matches_jax_engine(world2, jax_params, case, kw):
    res = _ok(world2, case)
    want = _server_oracle(jax_params, **kw)
    assert len(set(want[1].tolist())) > 2  # the comparison is not degenerate
    for i in range(len(want)):
        got = _same_on_every_rank([r[i] for r in res])
        np.testing.assert_array_equal(got, want[i], err_msg=f"request {i}")


def test_deadline_expires_on_every_rank_at_once(world2):
    """Rank 1's clock passes the deadlines, rank 0's does not: both ranks
    time out every request at the same step, with the same tokens, each a
    prefix of the same request's tokens without a deadline."""
    res = _ok(world2, "deadline_skew")
    full = _ok(world2, "server_monolithic")
    for rank, r in enumerate(res):
        assert r["timed_out"] == [True] * len(ranks.SERVER_SPECS), (rank, r)
        assert r["timeouts"] == len(ranks.SERVER_SPECS), (rank, r)
    for i in range(len(ranks.SERVER_SPECS)):
        got = _same_on_every_rank([r["tokens"][i] for r in res])
        assert len(got) < ranks.SERVER_SPECS[i][2]
        np.testing.assert_array_equal(got, full[0][i][:len(got)], err_msg=f"request {i}")


def test_sharded_prefix_cache_matches_port(world2, trees):
    res = _ok(world2, "prefix")
    cfg = tiny_mllama_config()
    srv = ContinuousBatchingServer(from_jax_params(trees["tied"], cfg, "cpu"), cfg, "cpu",
                                   slots=2, max_cache_length=ranks.MAX_LEN, eos_token_id=-1,
                                   steps_per_sync=3, prompt_buckets=None)
    ids = ranks.prompt(14, 11, image=False)[0]
    pid = srv.register_prefix(ids[:8])
    rids = [srv.submit(ids, max_new_tokens=6), srv.submit(ids[:11], max_new_tokens=5,
                                                          prefix_id=pid)]
    out = srv.run()
    for r in res:
        assert r["hits"] == 2
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(r["tokens"][i], out[rid])


def test_sharded_spec_lookup_matches_port(world2, trees):
    res = _ok(world2, "spec_lookup")
    cfg = tiny_mllama_config()
    model = from_jax_params(trees["tied"], cfg, "cpu")
    ids = np.tile(ranks.prompt(6, 13, image=False), (1, 3))
    eng = InferenceEngine(model, cfg, "cpu", max_cache_length=ranks.MAX_LEN, spec_lookup=2)
    want_eng = eng.generate(ids, None, max_new_tokens=10, eos_token_id=-1).tokens.numpy()
    srv = ContinuousBatchingServer(model, cfg, "cpu", slots=2, max_cache_length=ranks.MAX_LEN,
                                   eos_token_id=-1, steps_per_sync=3, prompt_buckets=None,
                                   spec_lookup=2)
    rids = [srv.submit(ranks.prompt(s, seed)[0], ranks.PX[0], max_new_tokens=mn)
            for s, seed, mn in ranks.SERVER_SPECS]
    out = srv.run()
    np.testing.assert_array_equal(_same_on_every_rank([r["engine"] for r in res]), want_eng)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(_same_on_every_rank([r["server"][i] for r in res]),
                                      out[rid])


# -- the sharded checkpoint load ---------------------------------------------------


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_sharded_load_equals_the_unsharded_load(world2, jax_params, kind):
    """Each rank's tensors equal its slices of the unsharded load, byte for
    byte; for int8 that includes the row-parallel leaves, whose scale is the
    whole row's maximum (reduced across the ranks before quantizing)."""
    res = _ok(world2, "load_sharded")
    for r in res:
        assert r[kind]["equal"] and r[kind]["split"] > 0
    q = {"float": jax_params["untied"],
         "int8": jq.quantize_llama_params(jax_params["untied"]),
         "int4": jq.quantize_llama_params(jax_params["untied"], bits=4, group_size=32)}[kind]
    got = _same_on_every_rank([r[kind]["logits"] for r in res])
    np.testing.assert_allclose(got, _jax_logits(q, jax_params["jcfg"]), **TOL)


def test_abstract_state_takes_the_local_shapes(world2):
    for r, shapes in enumerate(_ok(world2, "abstract_state")):
        assert shapes["language_model.model.blocks.0.att.W_query.weight"] == (32, 64)
        assert shapes["language_model.model.blocks.0.ff.w_down.weight"] == (64, 64)
        assert shapes["language_model.lm_head.weight"] == (128, 64)
        assert shapes["vision_model.layers.0.q_proj.weight"] == (32, 32)


# -- what was once refused under TP ------------------------------------------------


@pytest.mark.parametrize("feature", ["lora", "training", "sequence_parallel", "adapter_bank",
                                     "draft", "http"])
def test_once_refused_under_tp_runs(world2, feature):
    """LoRA and gradients under tensor parallelism, once refused, now run
    (their agreement with the JAX package: tests/test_torch_tp_train.py);
    so does a mesh with ``sp = 2``, whose chunks' logits equal the
    one-device forward's (tests/test_torch_seq_parallel.py holds training
    over ``sp`` to the JAX package), and so do the adapter bank server, the
    draft engine and the HTTP front end over the sharded server
    (tests/test_torch_tp_serving.py holds their tokens to the JAX
    package)."""
    for r in _ok(world2, "refusals"):
        assert r[feature] == "ran", r[feature]


def test_server_at_dp2_runs(world4, jax_params):
    """The server at dp=2 x tp=2 (one slot a data-parallel group), once
    refused: every rank returns every request's tokens, the JAX engine's."""
    res = _ok(world4, "server_dp2")
    want = _server_oracle(jax_params, prompt_buckets=(16, 24))
    for i in range(len(want)):
        got = _same_on_every_rank([r[i] for r in res])
        np.testing.assert_array_equal(got, want[i], err_msg=f"request {i}")
