"""Sequence parallelism in the port (``sp``: ``Mesh.ppermute``, the ring and
all-gather attention layouts of ``ops/attention.py``, LoRA and full
fine-tuning on token chunks) on the CPU, held to the JAX package on one
device, which is what the JAX package's own sequence-parallel tests compare
with.

Ranks are spawned over gloo once per world size (``tests/
torch_sp_pp_ranks.py``, which imports no jax) while this module computes
the JAX oracles: world 4 runs the permutes, the attention at sp=4, full
fine-tuning and ``collect_stats`` at dp=2 x sp=2; world 8 the LoRA step at
dp=2 x tp=2 x sp=2.

Tolerances: the attention's output and its three gradients 2e-5
(``tests/test_ring_attention.py``); a LoRA step's loss rtol 2e-5 and every
adapter leaf atol 2e-5 (``tests/test_seq_parallel.py``); full fine-tuning's
losses rtol 1e-5 and parameters after 3 steps rtol 3e-4 / atol 2e-4
(``tests/test_full_train.py``), except the ViT's key bias, whose true
gradient is 0 and which moves on rounding noise by up to Adam's 2 lr a
step. What every rank holds whole (losses, adapters, parameters) must be
bit-equal across ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.train import full as jax_full
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax, to_jax_params
from llama32mm_tpu_torch.train.lora import lora_leaves, make_lora_train_step

import torch_sp_pp_ranks as ranks

LR, STEPS = ranks.LR, ranks.STEPS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lora_trees(jcfg):
    """The adapters as numpy (rank 4): the decoder's alone, and with the
    head's and the projector's; B from numpy, so that every leaf has a
    gradient."""
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
def setup():
    jcfg = jax_tiny_config()
    tied = init_vlm_params(jax.random.PRNGKey(0), jcfg)
    inputs = {"tied": _np(tied), "lora": _lora_trees(jcfg)}
    worlds = {w: ranks.start_world("sp", w, inputs) for w in (4, 8)}
    yield {"jcfg": jcfg, "tied": tied, "inputs": inputs, "worlds": worlds}
    for run in worlds.values():  # a world no selected test read: drain it, so its ranks end
        run.results()


def _ok(setup, world, case):
    results = setup["worlds"][world].results()
    assert case in results, f"case {case} did not run (an earlier case failed): {results.keys()}"
    for r, v in enumerate(results[case]):
        assert not (isinstance(v, tuple) and v and v[0] == "error"), f"rank {r}:\n{v[1]}"
    return results[case]


def _same_on_every_rank(values):
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(values[0]))
    return values[0]


# -- the permute -----------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ppermute_forward_and_backward(setup, n):
    """Rank r holds ``x + r``: shift +1 gives rank r the ``x`` of rank r-1,
    shift -1 that of rank r+1; the gradient of ``sum(y * w_r)`` comes back
    by the reverse rotation."""
    base = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    for r, got in enumerate(_ok(setup, 4, "ppermute")[:n]):
        for shift in (1, -1):
            res = got[n, shift]
            np.testing.assert_array_equal(res["y"], base + (r - shift) % n)
            np.testing.assert_array_equal(res["plain"], res["y"])
            np.testing.assert_array_equal(res["grad"], base * (1 + (r + shift) % n))


# -- attention --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_attention():
    """JAX's single-device flash (interpret mode): out, dq, dk, dv of
    ``sum(out ** 2)`` per case."""
    q, k, v = ranks.attn_inputs()
    want = {}
    for case, (n_valid, q_offset) in ranks.ATTN_CASES.items():
        kvv = jnp.asarray(ranks.kv_valid(n_valid))

        def attn(q, k, v):
            return flash_gqa_attention(q, k, v, kvv, q_offset, block_q=128, block_k=128)

        out = jax.jit(attn)(q, k, v)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(attn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
        want[case] = [np.asarray(t) for t in (out, *grads)]
    return want


@pytest.mark.parametrize("layout", ["ring", "gather"])
@pytest.mark.parametrize("case", list(ranks.ATTN_CASES))
def test_attention_sp4_matches_single_device_flash(setup, jax_attention, case, layout):
    """T=512 over sp=4, 4 query / 2 kv heads, hd 16, fp32, causal: the
    chunks' output and dq, dk, dv equal JAX's single-device flash, with
    every key valid, a ragged validity row (300 of 512) and q_offset 17."""
    res = _ok(setup, 4, "attention")
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[case, layout][i] for r in res], axis=2)
        np.testing.assert_allclose(got, jax_attention[case][i], rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_int8_kv_attention_sp4_matches_single_device_flash(setup):
    """int8 K/V with per-position scales (the serving cache's form) over
    sp=4: the all-gather layout, against JAX's single-device flash
    (``tests/test_seq_parallel.py``'s int8-KV case, 1e-5)."""
    q = ranks.attn_inputs()[0]
    k8, v8, ks, vs = ranks.int8_kv()
    want = flash_gqa_attention(q, k8, v8, jnp.asarray(ranks.kv_valid(ranks.ATTN_T)), 0,
                               block_q=128, block_k=128, k_scale=ks, v_scale=vs)
    got = np.concatenate([r["int8"] for r in _ok(setup, 4, "attention")], axis=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


# -- LoRA at dp=2 x tp=2 x sp=2 ---------------------------------------------------


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_lora_step(setup, kind, kw, impl="xla"):
    init, step = jax_lora.make_lora_train_step(setup["jcfg"], learning_rate=LR, impl=impl, **kw)
    state = init(jax.tree.map(jnp.asarray, setup["inputs"]["lora"][kind]))
    state, loss = jax.jit(step)(setup["tied"], state, _jbatch(ranks.sp_batch()),
                                jax.random.PRNGKey(0))
    return float(loss), {k: np.asarray(v) for k, v in
                         lora_leaves(lora_from_jax(_np(state.lora), "cpu")).items()}


def _check_lora(got_ranks, want_loss, want):
    loss = _same_on_every_rank([r["loss"] for r in got_ranks])
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    for name, w in want.items():
        g = _same_on_every_rank([r["lora"][name] for r in got_ranks])
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lora_step_dp2_tp2_sp2_matches_jax(setup, impl):
    """The decoder's adapters, against the JAX step on the dense (``xla``)
    and the flash (``pallas``) path; the batch's images start at 0, across
    the chunk boundary and at the second chunk's start, and one row's shift
    crosses the boundary onto -100."""
    kw, kind = ranks.LORA_VARIANTS["plain"]
    _check_lora([r["plain"] for r in _ok(setup, 8, "lora")],
                *_jax_lora_step(setup, kind, kw, impl))


@pytest.mark.parametrize("variant", ["head", "remat", "loss_chunk"])
def test_lora_variants_dp2_tp2_sp2_match_jax(setup, variant):
    """With the head's and the projector's adapters (the projector's
    gradient comes only from the chunks holding image tokens), ``remat``
    and ``loss_chunk``."""
    kw, kind = ranks.LORA_VARIANTS[variant]
    _check_lora([r[variant] for r in _ok(setup, 8, "lora")], *_jax_lora_step(setup, kind, kw))


def test_lora_dropout_dp2_tp2_sp2_equals_one_device(setup):
    """Dropout masks are drawn at the one-device shape and the rank's rows,
    tokens and features taken, so the sharded step with a seed equals the
    port's one-device step with it."""
    kw, kind = ranks.LORA_VARIANTS["dropout"]
    cfg = tiny_mllama_config()
    model = from_jax_params(setup["inputs"]["tied"], cfg, "cpu")
    init, step = make_lora_train_step(cfg, learning_rate=LR, **kw)
    state = init(lora_from_jax(setup["inputs"]["lora"][kind], "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in ranks.sp_batch().items()}
    state, loss = step(model, state, batch, torch.Generator().manual_seed(ranks.DROPOUT_SEED))
    want = {k: t.detach().numpy() for k, t in lora_leaves(state.lora).items()}
    plain_loss, _ = _jax_lora_step(setup, kind, {})
    assert abs(loss.item() - plain_loss) > 1e-4  # the dropout is on
    _check_lora([r["dropout"] for r in _ok(setup, 8, "lora")], loss.item(), want)


# -- full fine-tuning at dp=2 x sp=2 ----------------------------------------------


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_full_ft_dp2_sp2_matches_jax(setup):
    """Three AdamW steps (clip 1.0): the losses and every parameter against
    JAX's ``make_train_step`` on one device."""
    init, step = jax_full.make_train_step(setup["jcfg"], learning_rate=LR, impl="xla")
    step = jax.jit(step)
    state, batch, want_losses = init(setup["tied"]), _jbatch(ranks.sp_batch()), []
    for i in range(STEPS):
        state, loss = step(state, batch, jax.random.PRNGKey(i))
        want_losses.append(float(loss))
    want = _flat(_np(state.full_params()))
    res = _ok(setup, 4, "full_ft")
    losses = _same_on_every_rank([r["losses"] for r in res])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    holder = from_jax_params(setup["inputs"]["tied"], tiny_mllama_config(), "cpu")
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(torch.from_numpy(_same_on_every_rank([r["params"][name] for r in res])))
    got = _flat(to_jax_params(holder))
    for path, w in want.items():
        if path[0] == "vision_model" and "k_proj" in path and path[-1] == "bias":
            assert np.abs(got[path] - w).max() <= 2 * STEPS * LR, path  # gradient 0: noise
            continue
        np.testing.assert_allclose(got[path], w, rtol=3e-4, atol=2e-4, err_msg=str(path))


def test_collect_stats_dp2_sp2_matches_jax(setup):
    """The decoder's per-layer statistics, each rank's means averaged over
    ``dp`` and ``sp``, equal the one-device statistics."""
    b = ranks.sp_batch()
    want = jax_vlm_forward(setup["tied"], setup["jcfg"], input_ids=jnp.asarray(b["input_ids"]),
                           pixel_values=jnp.asarray(b["pixel_values"]), impl="xla",
                           collect_stats=True).stats
    res = _ok(setup, 4, "collect_stats")
    for key, w in want.items():
        got = _same_on_every_rank([r[key] for r in res])
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=key)
