"""Training across ranks in the port (``parallel/``, ``train/``,
``io/distributed.py``) on the CPU, held to the JAX package on one device.

Ranks are spawned over gloo once per world size (``tests/
torch_tp_train_ranks.py``, which imports no jax) and run every case while
this module computes the JAX oracles: world 4 is a dp=2 × tp=2 mesh, world
2 a tp=2 one. Tiny config, fp32, the (4, 12) batch of
``tests/test_sharding.py``, each dp rank given its two rows.

Tolerances: a LoRA step's loss 1e-4 relative (``tests/test_sharding.py``)
and every adapter leaf after the step 2e-5 (``tests/test_seq_parallel.py``);
full fine-tuning's params after 3 steps rtol 3e-4 / atol 2e-4
(``tests/test_full_train.py``'s ZeRO bound), except elements whose true
gradient is 0 (the ViT's key bias), which move on rounding noise by up to
Adam's 2 lr a step. Results that every rank holds whole (the losses, the
adapters, replicated parameters) must be bit-equal across ranks; the
checkpoints restore bit-exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu.train import full as jax_full
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax, to_jax_params
from llama32mm_tpu_torch.train.lora import lora_leaves, make_lora_train_step

import torch_tp_train_ranks as ranks

LR, STEPS = ranks.LR, ranks.STEPS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lora_trees(jcfg):
    """The adapters as numpy (rank 4): the decoder's alone, and the
    decoder's with the head's and the projector's; B from numpy, so that
    every leaf has a gradient."""
    text = _np(jax_lora.init_lora_params(jax.random.PRNGKey(3), jcfg.text_config, rank=4,
                                         include_lm_head=False))
    head = _np(jax_lora.init_lora_params(jax.random.PRNGKey(3), jcfg, rank=4,
                                         include_projector=True))
    rs = np.random.RandomState(3)
    for tree in (text, head):
        for ad in [*tree["blocks"].values(), *(tree[k] for k in ("lm_head", "projector")
                                               if k in tree)]:
            ad["lora_b"] = (rs.randn(*ad["lora_b"].shape) * 0.05).astype(np.float32)
    return {"text": text, "head": head}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, both worlds started, and the JAX side's trees."""
    jcfg = jax_tiny_config()
    tied = init_vlm_params(jax.random.PRNGKey(0), jcfg)
    untied = init_vlm_params(jax.random.PRNGKey(0), jcfg, tie_weights=False)
    trees = {"tied": _np(tied), "untied": _np(untied),
             "int8": _np(jq.quantize_llama_params(untied, bits=8)),
             "int4_mixed": _np(jq.quantize_llama_params(untied, bits=4, group_size=32,
                                                        recipe=jq.INT4_MIXED_RECIPE))}
    lora = _lora_trees(jcfg)
    inputs = {"trees": trees, "lora": lora}
    worlds = {w: ranks.start_world(w, dict(inputs, dir=str(tmp_path_factory.mktemp(f"w{w}"))))
              for w in (4, 2)}
    yield {"jcfg": jcfg, "tied": tied, "trees": trees, "lora": lora, "worlds": worlds}
    for run in worlds.values():  # a world no selected test read: drain it, so its ranks end
        run.results()


def _ok(setup, world, case):
    results = setup["worlds"][world].results()
    assert case in results, f"case {case} did not run (an earlier case failed): {results.keys()}"
    for r, v in enumerate(results[case]):
        assert not (isinstance(v, tuple) and v and v[0] == "error"), f"rank {r}:\n{v[1]}"
    return results[case]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _same_on_every_rank(values):
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(values[0]))
    return values[0]


def _jax_lora_step(setup, params, kind, kw, batch):
    init, step = jax_lora.make_lora_train_step(setup["jcfg"], learning_rate=LR, impl="xla", **kw)
    state = init(jax.tree.map(jnp.asarray, setup["lora"][kind]))
    state, loss = jax.jit(step)(params, state, _jbatch(batch), jax.random.PRNGKey(0))
    return float(loss), {k: np.asarray(v) for k, v in
                         lora_leaves(lora_from_jax(_np(state.lora), "cpu")).items()}


def _check_lora(got_ranks, want_loss, want):
    losses = _same_on_every_rank([r["loss"] for r in got_ranks])
    np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
    for name, w in want.items():
        g = _same_on_every_rank([r["lora"][name] for r in got_ranks])
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=name)


# -- LoRA at dp=2 x tp=2 -------------------------------------------------------


@pytest.mark.parametrize("variant", [v for v in ranks.LORA_VARIANTS if v != "dropout"] + ["tp4"])
def test_lora_step_dp2_tp2_matches_jax(setup, variant):
    """Loss and every adapter leaf after one step: the decoder's adapters
    alone, with the head's (and the projector's, whole on every rank), with
    ``remat``, ``loss_chunk``, and ``accum_steps=2`` where dp rank 1's rows
    of the first microbatch are all -100; and at tp=4, where two ranks read
    each kv head's columns of ``lora_b``."""
    kw, kind = ranks.LORA_VARIANTS.get(variant, ({}, "head"))
    batch = ranks.tiny_batch()
    if kw.get("accum_steps"):
        batch = ranks.accum_batch(batch)
    got = [r[variant] for r in _ok(setup, 4, "lora")]
    _check_lora(got, *_jax_lora_step(setup, setup["tied"], kind, kw, batch))


def test_lora_dropout_dp2_tp2_equals_one_device(setup):
    """Dropout masks are drawn at the one-device shape and sliced, so the
    sharded step with a seed equals the port's one-device step with it."""
    kw, kind = ranks.LORA_VARIANTS["dropout"]
    cfg = tiny_mllama_config()
    model = from_jax_params(setup["trees"]["tied"], cfg, "cpu")
    init, step = make_lora_train_step(cfg, learning_rate=LR, **kw)
    state = init(lora_from_jax(setup["lora"][kind], "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in ranks.tiny_batch().items()}
    state, loss = step(model, state, batch, torch.Generator().manual_seed(ranks.DROPOUT_SEED))
    want = {k: t.detach().numpy() for k, t in lora_leaves(state.lora).items()}
    plain_loss, _ = _jax_lora_step(setup, setup["tied"], kind, {}, ranks.tiny_batch())
    assert abs(loss.item() - plain_loss) > 1e-4  # the dropout is on
    _check_lora([r["dropout"] for r in _ok(setup, 4, "lora")], loss.item(), want)


@pytest.mark.parametrize("kind", ["int8", "int4_mixed"])
def test_qlora_tp2_matches_jax(setup, kind):
    """QLoRA over a quantized base sharded at tp=2 (the int8 and int4
    shards' ``dx`` under ``f`` and ``g``) against the JAX step on one
    device; the base's bytes unchanged."""
    got = [r[kind] for r in _ok(setup, 2, "qlora")]
    assert all(r["base_unchanged"] for r in got)
    params = jax.tree.map(jnp.asarray, setup["trees"][kind])
    _check_lora(got, *_jax_lora_step(setup, params, "head", {}, ranks.tiny_batch()))


# -- full fine-tuning ------------------------------------------------------------


def _assemble(per_rank: list, name: str, shape) -> np.ndarray:
    """The whole tensor from the ranks' ``(box, array)`` slices; where
    several ranks hold a part, they must agree bit for bit."""
    out = np.full(shape, np.nan, np.float32)
    for r in per_rank:
        box, arr = r[name]
        idx = tuple(slice(s, s + n) for s, n in box)
        prev = out[idx]
        seen = ~np.isnan(prev)
        np.testing.assert_array_equal(prev[seen], arr[seen], err_msg=f"{name}: ranks disagree")
        out[idx] = arr
    assert not np.isnan(out).any(), name
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _as_jax_paths(named: dict, trees) -> dict:
    holder = from_jax_params(trees["tied"], tiny_mllama_config(), "cpu")
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(torch.from_numpy(named[name]))
    return _flat(to_jax_params(holder))


def _jax_full(setup, **kw):
    init, step = jax_full.make_train_step(setup["jcfg"], learning_rate=LR, impl="xla", **kw)
    step = jax.jit(step)
    state = init(setup["tied"])
    batch, losses = _jbatch(ranks.tiny_batch()), []
    for i in range(STEPS):
        state, loss = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _flat(_np(state.full_params()))


def _check_full(setup, run: list, want_losses, want):
    losses = _same_on_every_rank([r["losses"] for r in run])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    shapes = {n: tuple(a.shape) for n, a in
              from_jax_params(setup["trees"]["tied"], tiny_mllama_config(), "cpu")
              .state_dict().items()}
    got = _as_jax_paths({n: _assemble([r["params"] for r in run], n, shapes[n])
                         for n in shapes}, setup["trees"])
    for path, w in want.items():
        if path[0] == "vision_model" and "k_proj" in path and path[-1] == "bias":
            assert np.abs(got[path] - w).max() <= 2 * STEPS * LR, path  # gradient 0: noise
            continue
        np.testing.assert_allclose(got[path], w, rtol=3e-4, atol=2e-4, err_msg=str(path))


@pytest.fixture(scope="module")
def jax_full_adamw(setup):
    return _jax_full(setup)


@pytest.mark.parametrize("run", list(ranks.FULL_RUNS))
def test_full_ft_dp2_tp2_matches_jax(setup, jax_full_adamw, run):
    """Three AdamW steps (clip 1.0) at dp=2 × tp=2: TP layout alone, ZeRO-1,
    ZeRO-1 with dp-sharded masters; the moments on ``zero1_shardings``
    (a quarter of a tp=2-split leaf's elements on each rank); and at tp=4,
    where each kv head's ``W_key`` / ``W_value`` gradients are summed over
    the two ranks that hold it."""
    res = [r[run] for r in _ok(setup, 4, "full")]
    _check_full(setup, res, *jax_full_adamw)
    for r in res:
        want = r["z1_shapes"] if run.startswith("zero1") else r["tp_shapes"]
        assert r["mu_shapes"] == want
    if run.startswith("zero1"):
        wq = "language_model.model.blocks.0.att.W_query.weight"
        whole = np.prod(res[0]["whole_shapes"][wq])
        assert all(np.prod(r["mu_shapes"][wq]) * 4 == whole for r in res)


@pytest.mark.parametrize("run,kw", [("adafactor", dict(optimizer="adafactor",
                                                       max_grad_norm=1e-2)),
                                    ("clip", dict(max_grad_norm=1e-2)),
                                    ("vision_tp", dict())])
def test_full_ft_tp2_optimizers_match_jax(setup, run, kw):
    """Adafactor (its block RMS over split leaves) and a clip that acts each
    step (``max_grad_norm`` 1e-2, its norm summed over the ranks) at tp=2,
    and the ViT trained tensor-parallel (``vision_tp``), against JAX."""
    _check_full(setup, [r[run] for r in _ok(setup, 2, "optimizers")], *_jax_full(setup, **kw))


def test_differentiable_collectives(setup):
    """rank r holds x + r; the backward's cotangent is w (1 + r)."""
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    xs = [x, x + 1]
    res = _ok(setup, 2, "collectives")
    for r, got in enumerate(res):
        w = [np.arange(6, dtype=np.float32).reshape(2, 3) * (1 + q) for q in (0, 1)]
        np.testing.assert_array_equal(got["f"]["y"], xs[r])
        np.testing.assert_array_equal(got["f"]["grad"], w[0] + w[1])  # summed over tp
        np.testing.assert_array_equal(got["g"]["y"], xs[0] + xs[1])
        np.testing.assert_array_equal(got["g"]["grad"], w[r])  # passed through
        full = np.concatenate(xs, axis=-1)
        np.testing.assert_array_equal(got["gather"]["y"], full)
        wf = np.arange(full.size, dtype=np.float32).reshape(full.shape) * (1 + r)
        np.testing.assert_array_equal(got["gather"]["grad"], wf[:, 3 * r:3 * r + 3])  # its slice
        rows = np.concatenate(xs, axis=0)
        np.testing.assert_array_equal(got["all_gather"]["y"], rows)
        wr = [np.arange(rows.size, dtype=np.float32).reshape(rows.shape) * (1 + q) for q in (0, 1)]
        np.testing.assert_array_equal(got["all_gather"]["grad"],
                                      (wr[0] + wr[1])[2 * r:2 * r + 2])  # reduce-scattered
        np.testing.assert_array_equal(got["reduce_scatter"]["y"], (xs[0] + xs[1])[r:r + 1])
        ws = [np.arange(3, dtype=np.float32).reshape(1, 3) * (1 + q) for q in (0, 1)]
        np.testing.assert_array_equal(got["reduce_scatter"]["grad"],
                                      np.concatenate(ws, axis=0))  # all-gathered
        assert not any(got[k]["is_x"] for k in ("g", "gather", "all_gather", "reduce_scatter"))
        np.testing.assert_array_equal(got["g_in_place"], xs[0] + xs[1])


def test_adafactor_factored_statistics_over_a_split(setup):
    """A factored Adafactor leaf split over tp on either dim equals the
    one-device update (its row and column means summed over the split)."""
    for r in _ok(setup, 2, "adafactor_factored"):
        assert r[0] < 1e-6 and r[1] < 1e-6, r
        assert r["0_stats"] == r["1_stats"] == 2


def test_collect_stats_tp2_matches_jax(setup):
    b = ranks.tiny_batch()
    want = jax_vlm_forward(setup["tied"], setup["jcfg"], input_ids=jnp.asarray(b["input_ids"]),
                           pixel_values=jnp.asarray(b["pixel_values"]), impl="xla",
                           collect_stats=True).stats
    res = _ok(setup, 2, "collect_stats")
    for key, w in want.items():
        got = _same_on_every_rank([r[key] for r in res])
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=key)


# -- the sharded checkpointer ----------------------------------------------------


def test_sharded_train_state_exact_resume(setup):
    for r in _ok(setup, 4, "ckpt_resume"):
        assert r["got"] == r["ref"] and r["params_equal"] and r["mu_equal"]
        assert r["step"] == 4 and r["count"] == 4


def test_restore_onto_different_mesh(setup):
    """Saved at dp=2 × tp=2 (ZeRO-1 masters and moments), restored onto
    dp=4 × tp=1 and onto tp=4: every rank's slices assemble to the saved
    tensors, bit for bit."""
    res = _ok(setup, 4, "ckpt_other_mesh")
    for part in ("params", "mu"):
        saved = [r["saved"][part] for r in res]
        for name in saved[0]:
            shape = ranks_whole_shape(saved, name)
            want = _assemble(saved, name, shape)
            for label in ("dp4", "tp4"):
                got = _assemble([r[label][part] for r in res], name, shape)
                np.testing.assert_array_equal(got, want, err_msg=f"{label} {part} {name}")
    # dp=4 x tp=1: a quarter of W_query's rows or columns on each rank
    name = "language_model.model.blocks.0.att.W_query.weight"
    assert {r["dp4"]["params"][name][1].size for r in res} == {64 * 64 // 4}


def ranks_whole_shape(per_rank: list, name: str) -> tuple:
    """The whole shape spanned by the ranks' boxes of ``name``."""
    boxes = [r[name][0] for r in per_rank]
    return tuple(max(b[d][0] + b[d][1] for b in boxes) for d in range(len(boxes[0])))


def test_async_save_overlaps_training(setup):
    for r in _ok(setup, 4, "ckpt_async"):
        assert r["restored_equal"] and r["moved"] and r["step"] == 1


def test_quantized_base_roundtrips_sharded(setup):
    for r in _ok(setup, 4, "ckpt_quantized"):
        for kind in ("int8", "int4_mixed"):
            assert r[kind]["equal"], kind
        assert "torch.int8" in r["int8"]["dtypes"] and "torch.uint8" in r["int4_mixed"]["dtypes"]


def test_manager_rotates_and_resumes_sharded(setup):
    for r in _ok(setup, 4, "ckpt_manager"):
        assert r["steps"] == [3, 4] and r["latest"] == 4, r
        assert r["latest_equal"] and r["three_equal"] and r["resumed_equal"]

