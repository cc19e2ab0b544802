"""The port's model against the JAX package and the vendored reference trace:
parameter conversion, the golden logits and loss, the VLM forward, and
cached decode against full-sequence logits. Tiny config, fp32, CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.language import causal_lm_forward as jax_causal_lm_forward
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params
from llama32mm_tpu_torch.models.language import causal_lm_forward
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_vlm_trace.npz")


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(_np_tree(params), tiny_mllama_config(), "cpu")
    return jcfg, params, tiny_mllama_config(), model


@pytest.mark.parametrize("tie_weights", [True, False])
def test_param_roundtrip_is_bitwise(tie_weights):
    params = _np_tree(init_vlm_params(jax.random.PRNGKey(1), jax_tiny_config(), tie_weights))
    back = to_jax_params(from_jax_params(params, tiny_mllama_config(), "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for want, got in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert want.shape == got.shape and want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)


def test_converted_linears_are_out_in(tiny):
    _, params, _, model = tiny
    w_jax = np.asarray(params["language_model"]["model"]["blocks"]["att"]["W_key"]["weight"][1])
    w = model.language_model.model.blocks[1].att.W_key.weight
    np.testing.assert_array_equal(w.numpy(), w_jax.T)
    assert model.language_model.lm_head is None  # tied: the embedding is the head


def test_golden_trace_through_port():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden trace missing")
    trace = np.load(GOLDEN)
    jcfg = jax_tiny_config()
    struct = jax.eval_shape(lambda k: init_vlm_params(k, jcfg, tie_weights=False),
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree.flatten(struct)
    leaves = [trace[f"param_{i}"] for i in range(len(flat))]
    model = from_jax_params(jax.tree.unflatten(treedef, leaves), tiny_mllama_config(), "cpu")
    out = vlm_forward(
        model, tiny_mllama_config(),
        input_ids=torch.from_numpy(trace["input_ids"]),
        pixel_values=torch.from_numpy(trace["pixel_values"]),
        attention_mask=torch.from_numpy(trace["attention_mask"]),
        labels=torch.from_numpy(trace["labels"]),
    )
    np.testing.assert_allclose(out.logits.numpy(), trace["logits"], atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(float(out.loss), float(trace["loss"]), atol=1e-4)


def test_vlm_forward_matches_jax_pallas(tiny):
    jcfg, params, cfg, model = tiny
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 240, (2, 12))
    ids[:, 2:6] = cfg.image_token_index
    px = rs.randn(2, 3, 28, 28).astype(np.float32)
    mask = np.ones((2, 12), np.int64)
    mask[1, 9:] = 0  # right padding on row 1
    labels = np.where(ids == cfg.image_token_index, -100, ids)
    want = jax_vlm_forward(params, jcfg, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                           attention_mask=jnp.asarray(mask), labels=jnp.asarray(labels),
                           impl="pallas")
    got = vlm_forward(model, cfg, input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(px),
                      attention_mask=torch.from_numpy(mask), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(got.loss), float(want.loss), atol=1e-4)


def test_logits_positions_pick_rows(tiny):
    _, _, cfg, model = tiny
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 240, (2, 7)))
    full = vlm_forward(model, cfg, input_ids=ids).logits
    pos = torch.tensor([[6], [3]])
    picked = vlm_forward(model, cfg, input_ids=ids, logits_positions=pos).logits
    torch.testing.assert_close(picked[:, 0], full[torch.arange(2), pos[:, 0]], atol=1e-5, rtol=1e-5)


def test_decode_equals_prefill_logits(tiny):
    """Incremental decode through the preallocated cache reproduces the
    full-sequence logits of the port and of the JAX package."""
    jcfg, params, cfg, model = tiny
    tc, lm = cfg.text_config, model.language_model
    b, s, max_len = 1, 8, 16
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size - 10, (b, s))
    full, _ = causal_lm_forward(lm, tc, input_ids=torch.from_numpy(ids))
    jax_full, _ = jax_causal_lm_forward(params["language_model"], jcfg.text_config,
                                        input_ids=jnp.asarray(ids), impl="xla")

    cache = init_kv_cache(tc, b, "cpu", max_length=max_len)
    steps = []
    for t in range(s):
        kv_valid = (torch.arange(max_len) < t + 1).to(torch.int32)[None]
        logits, cache = causal_lm_forward(
            lm, tc, input_ids=torch.from_numpy(ids[:, t:t + 1]),
            attention_mask=AttnMask(kv_valid, t), position_ids=torch.full((b, 1), t),
            kv_cache=cache,
        )
        steps.append(logits[:, 0])
    assert cache.pos == s
    stepped = torch.stack(steps, dim=1).numpy()
    np.testing.assert_allclose(stepped, full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(stepped, np.asarray(jax_full), atol=1e-4, rtol=1e-4)


def test_init_vlm_distributions():
    """``init_vlm`` draws the JAX package's distributions: U(±1/sqrt(fan_in))
    linears, N(0, 1) embeddings, unit norms; the pad row is zero."""
    import dataclasses

    cfg = tiny_mllama_config()
    cfg = dataclasses.replace(
        cfg, text_config=dataclasses.replace(cfg.text_config, pad_token_index=3))
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))
    blk = model.language_model.model.blocks[0]
    assert float(blk.ff.w_down.weight.abs().max()) <= 1 / np.sqrt(cfg.text_config.hidden_dim)
    assert float(blk.norm1.weight.min()) == 1.0 == float(blk.norm1.weight.max())
    emb = model.language_model.model.tok_emb
    assert float(emb[3].abs().max()) == 0.0
    assert 0.8 < float(emb.std()) < 1.2
    proj = model.multi_modal_projector
    assert float(proj.bias.abs().max()) <= 1 / np.sqrt(cfg.vision_config.hidden_size)
