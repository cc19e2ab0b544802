"""The rest of training in the port, held to the JAX package: the chunked
loss (``loss_chunk``), the Adafactor optimizer, the ViT's attention dropout
under training and the dense additive attention mask.

Tiny config, fp32, CPU, the same JAX weights on both sides (``convert.py``).
Tolerances, each the largest |difference| over the largest |reference|:

- chunked against unchunked loss in the port 1e-6 (the same products,
  summed in chunks), against JAX's chunked loss 1e-5; their gradients 1e-6
  and 1e-5 likewise;
- Adafactor against optax 1e-5 on a tree with a factored 128x256 matrix;
  in full fine-tuning the losses to 1e-5 and each parameter within the step
  bound (Adafactor's first update is ±lr on every element, so a gradient
  that is rounding noise may take either sign: 2 lr a step) and, where the
  first gradient is clear, within 1e-5 of its magnitude plus 1e-3 of its
  update;
- the ViT with dropout at p = 1e-9 (nothing dropped) against JAX's explicit
  path 1e-5; the keep rate at p = 0.5 within 0.02 of 0.5 over 32768
  weights (4.5 standard deviations);
- the dense mask's logits 1e-5 against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llama32mm_tpu import init_kv_cache as jax_init_kv_cache
from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models import vision as jax_vision
from llama32mm_tpu.models import vlm as jax_vlm
from llama32mm_tpu.train import full as jax_full
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params
from llama32mm_tpu_torch.models.vision import dropout_attention
from llama32mm_tpu_torch.models.vlm import chunked_shifted_cross_entropy, vlm_forward
from llama32mm_tpu_torch.train import make_optimizer, make_train_step
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tied():
    jcfg = jax_tiny_config()
    # one jitted init: faster here than the eager ops
    return jcfg, jax.jit(lambda k: init_vlm_params(k, jcfg))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def untied(tied):
    """The tied weights with a seeded untied head."""
    jcfg, params = tied
    rs = np.random.RandomState(9)
    head = rs.uniform(-0.125, 0.125, (64, 256)).astype(np.float32)
    lm = {**params["language_model"], "lm_head": {"weight": jnp.asarray(head)}}
    return jcfg, {**params, "language_model": lm}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=1, b=2, s=12):
    cfg = tiny_mllama_config()
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size - 10, (b, s))
    ids[:, :4] = cfg.image_token_index
    labels = np.where(ids == cfg.image_token_index, -100, ids)
    labels[-1, s - 3:] = -100
    mask = np.ones((b, s), np.int64)
    mask[-1, s - 3:] = 0
    px = rs.randn(b, 3, 28, 28).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask, "pixel_values": px}


# --- the chunked loss --------------------------------------------------------


@pytest.mark.parametrize("head", ["tied", "untied"])
def test_chunked_cross_entropy_matches_unchunked_and_jax(tied, untied, head):
    """Chunk 5 over 11 shifted positions (5 + 5 + 1), with a head adapter;
    the loss and its gradients for the hidden states and the adapter."""
    jcfg, params = tied if head == "tied" else untied
    cfg = tiny_mllama_config()
    model = from_jax_params(_np(params), cfg, "cpu")
    rs = np.random.RandomState(0)
    hidden = rs.randn(2, 12, 64).astype(np.float32)
    labels = rs.randint(0, 240, (2, 12))
    labels[1, 8:] = -100
    lora = {"lora_a": (rs.randn(64, 4) * 0.1).astype(np.float32),
            "lora_b": (rs.randn(4, 256) * 0.1).astype(np.float32),
            "scaling": np.asarray(4.0, np.float32)}

    def jax_loss(h, ad):
        return jax_vlm.chunked_shifted_cross_entropy(
            params["language_model"], jcfg.text_config, h, jnp.asarray(labels), -100, chunk=5,
            lora=ad, impl="xla")

    loss_j, (dh_j, dad_j) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jax.tree.map(jnp.asarray, lora))

    def port(chunk):
        h = torch.from_numpy(hidden).requires_grad_(True)
        ad = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lora.items()}
        lm = model.language_model
        if chunk is None:
            from llama32mm_tpu_torch.models.language import lm_head_apply
            from llama32mm_tpu_torch.models.vlm import shifted_cross_entropy

            loss = shifted_cross_entropy(lm_head_apply(lm, cfg.text_config, h, lora=ad),
                                         torch.from_numpy(labels), -100)
        else:
            loss = chunked_shifted_cross_entropy(lm, cfg.text_config, h,
                                                 torch.from_numpy(labels), -100, chunk=chunk,
                                                 lora=ad)
        grads = torch.autograd.grad(loss, [h, ad["lora_a"], ad["lora_b"], ad["scaling"]])
        return loss.detach(), grads

    (l5, g5), (lfull, gfull) = port(5), port(None)
    np.testing.assert_allclose(l5.item(), lfull.item(), rtol=1e-6)
    np.testing.assert_allclose(l5.item(), float(loss_j), rtol=1e-5)
    for a, b in zip(g5, gfull):
        _close(a, b.numpy(), 1e-6)
    for a, key in zip(g5[1:], ("lora_a", "lora_b", "scaling")):
        _close(a, np.asarray(dad_j[key]), 1e-5)
    _close(g5[0], np.asarray(dh_j), 1e-5)


def test_loss_chunk_in_vlm_forward_and_the_steps(tied):
    """``vlm_forward(loss_chunk=N)`` returns the plain loss with no logits
    and needs labels; the full fine-tuning step with it equals the step
    without (the LoRA step: tests/test_torch_qlora.py)."""
    jcfg, params = tied
    cfg = tiny_mllama_config()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model = from_jax_params(_np(params), cfg, "cpu")
    kw = dict(input_ids=b["input_ids"], pixel_values=b["pixel_values"],
              attention_mask=b["attention_mask"])
    plain = vlm_forward(model, cfg, labels=b["labels"], **kw)
    chunked = vlm_forward(model, cfg, labels=b["labels"], loss_chunk=4, **kw)
    assert chunked.logits is None
    np.testing.assert_allclose(chunked.loss.item(), plain.loss.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="loss_chunk requires labels"):
        vlm_forward(model, cfg, loss_chunk=4, **kw)
    losses = []
    for chunk in (None, 4):
        m = from_jax_params(_np(params), cfg, "cpu")
        init, step = make_train_step(cfg, learning_rate=1e-4, freeze_vision=True,
                                     loss_chunk=chunk, remat=chunk is not None)
        state = init(m)
        for _ in range(2):
            state, loss = step(state, b)
        losses.append((loss.item(), {n: p.detach().clone() for n, p in state.params.items()}))
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-6)
    for name, p in losses[0][1].items():
        _close(losses[1][1][name], p.numpy(), 1e-5)


# --- Adafactor ---------------------------------------------------------------


@pytest.mark.parametrize("weight_decay,max_grad_norm", [(0.0, None), (0.1, 1.0)])
def test_adafactor_follows_optax(weight_decay, max_grad_norm):
    """Three steps against the JAX package's optax chain on the same
    gradients: a 128x256 matrix (factored: a row and a column vector), a
    256x100 one and a vector (kept whole), a 3-D one factored over its two
    largest dimensions; the gradient scales let the per-block clip act."""
    rs = np.random.RandomState(0)
    shapes = {"w": (128, 256), "n": (256, 100), "b": (256,), "t": (2, 130, 128)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rs.randn(*s) * scale * (1 + 9 * (k == "w"))).astype(np.float32)
              for k, s in shapes.items()} for scale in (1e-2, 3e-3, 1e-2)]
    tx = jax_full.make_optimizer(1e-2, weight_decay, max_grad_norm, optimizer="adafactor")
    pj, sj = dict(params), tx.init(params)
    update = jax.jit(tx.update)
    opt = make_optimizer(1e-2, weight_decay, max_grad_norm, optimizer="adafactor")
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(pt)
    assert set(st.v_row) == {"w", "t"} and tuple(st.v_row["w"].shape) == (128,)
    assert tuple(st.v_col["w"].shape) == (256,) and set(st.v) == {"n", "b"}
    assert tuple(st.v_row["t"].shape) == (2, 128) and tuple(st.v_col["t"].shape) == (2, 130)
    for g in grads:
        upd, sj = update(g, sj, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.step(pt, {k: torch.from_numpy(v) for k, v in g.items()}, st)
    assert st.count == 3
    for k in shapes:
        _close(pt[k], np.asarray(pj[k]), 1e-5)


def test_adafactor_full_fine_tuning_matches_jax(tied):
    """Two ``make_train_step(optimizer="adafactor")`` steps against JAX's:
    the per-block clip's RMS spans all layers of a JAX stack
    (``optim.stacked_leaf``)."""
    jcfg, params = tied
    cfg = tiny_mllama_config()
    lr, steps = 1e-4, 2
    batch = _batch()
    init_j, step_j = jax_full.make_train_step(jcfg, learning_rate=lr, freeze_vision=True,
                                              impl="xla", optimizer="adafactor")
    step_j = jax.jit(step_j)
    state_j = init_j(params)
    model = from_jax_params(_np(params), cfg, "cpu")
    init_p, step_p = make_train_step(cfg, learning_rate=lr, freeze_vision=True,
                                     optimizer="adafactor")
    state_p = init_p(model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    first = torch.autograd.grad(vlm_forward(model, cfg, **tb).loss, list(state_p.params.values()))
    grads = _flat_named({n: g for n, g in zip(state_p.params, first)}, params)
    for i in range(steps):
        state_j, loss_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
        state_p, loss_p = step_p(state_p, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(_np(state_j.full_params()))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(model))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(_np(params))[0])
    for path, w in want:
        if path[0].key == "vision_model":
            np.testing.assert_array_equal(got[path], start[path])
            continue
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * steps * lr * 1.0001, path
        g1 = np.abs(grads[path])
        clear = g1 >= 1e-2 * g1.max()
        tol = 1e-5 * np.abs(w).max() + 1e-3 * np.abs(w - start[path]).max()
        assert err[clear].max() <= tol, (path, err[clear].max(), tol)


def _flat_named(named: dict, params) -> dict:
    """``{JAX tree path: array}`` of ``{port parameter name: tensor}`` (the
    names missing from ``named`` as zeros)."""
    holder = from_jax_params(_np(params), tiny_mllama_config(), "cpu")
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(named[name]) if name in named else p.zero_()
    return dict(jax.tree_util.tree_flatten_with_path(to_jax_params(holder))[0])


# --- ViT attention dropout ---------------------------------------------------


def _with_dropout(cfg, p):
    return dataclasses.replace(
        cfg, vision_config=dataclasses.replace(cfg.vision_config, attention_dropout=p))


def test_vit_dropout_p_to_zero_matches_jax(tied):
    """At p = 1e-9 the explicit path drops nothing: the tower equals JAX's
    explicit path, and the flash path without a generator."""
    jcfg, params = tied
    cfg = _with_dropout(tiny_mllama_config(), 1e-9)
    px = np.random.RandomState(0).randn(2, 3, 28, 28).astype(np.float32)
    want = jax_vision.vision_encoder_forward(
        params["vision_model"], _with_dropout(jcfg, 1e-9).vision_config, jnp.asarray(px),
        impl="xla", dropout_rng=jax.random.PRNGKey(0))
    model = from_jax_params(_np(params), cfg, "cpu")
    got = model.vision_model(torch.from_numpy(px), dropout_rng=torch.Generator().manual_seed(0))
    _close(got, np.asarray(want), 1e-5)
    _close(model.vision_model(torch.from_numpy(px)), np.asarray(want), 1e-5)


def test_vit_dropout_rule_and_determinism(tied):
    """p = 0.5: the keep rate of the weights, inverted scaling, the same
    generator seed giving the same output and another seed another; without a
    generator (inference) the tower is the deterministic flash path."""
    rs = np.random.RandomState(1)
    q, k = (torch.from_numpy(rs.randn(2, 4, 64, 16).astype(np.float32)) for _ in range(2))
    eye = torch.eye(64).expand(2, 4, 64, 64)  # v = I: the output is the weights
    dropped = dropout_attention(q, k, eye, 0.5, seed=7)
    full = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * 16 ** -0.5, dim=-1)
    kept = dropped != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    _close(dropped[kept], (full[kept] / 0.5).numpy(), 1e-6)
    assert torch.equal(dropout_attention(q, k, eye, 0.5, seed=7), dropped)
    assert not torch.equal(dropout_attention(q, k, eye, 0.5, seed=8), dropped)

    jcfg, params = tied
    cfg = _with_dropout(tiny_mllama_config(), 0.5)
    model = from_jax_params(_np(params), cfg, "cpu")
    px = torch.from_numpy(rs.randn(1, 3, 28, 28).astype(np.float32))
    a = model.vision_model(px, dropout_rng=torch.Generator().manual_seed(3))
    b = model.vision_model(px, dropout_rng=torch.Generator().manual_seed(3))
    c = model.vision_model(px, dropout_rng=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    plain = from_jax_params(_np(params), tiny_mllama_config(), "cpu")
    assert torch.equal(model.vision_model(px), plain.vision_model(px))


# --- the dense additive mask -------------------------------------------------


def test_dense_mask_with_cache_matches_jax(tied):
    """The verify skill's drive: a prefill with the dense ``[B, 1, S, MAXLEN]``
    mask into a KV cache, then one decode step with its ``[B, 1, 1, MAXLEN]``
    mask; logits equal JAX's and the cache advances."""
    jcfg, params = tied
    cfg = tiny_mllama_config()
    b, s, maxlen = 1, 12, 64
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size - 10, (b, s))
    ids[:, :4] = cfg.image_token_index
    px = rs.randn(b, 3, 28, 28).astype(np.float32)
    neg = np.finfo(np.float32).min
    m = np.zeros((b, 1, s, maxlen), np.float32)
    m[:, :, :, s:] = neg
    for qi in range(s):
        m[:, :, qi, qi + 1:s] = -np.inf
    jcache = jax_init_kv_cache(jcfg.text_config, b, max_length=maxlen, dtype=jnp.float32)
    want = jax_vlm.vlm_forward(params, jcfg, input_ids=jnp.asarray(ids),
                               pixel_values=jnp.asarray(px), attention_mask=jnp.asarray(m),
                               kv_cache=jcache)
    model = from_jax_params(_np(params), cfg, "cpu")
    cache = init_kv_cache(cfg.text_config, b, "cpu", max_length=maxlen, dtype=torch.float32)
    got = vlm_forward(model, cfg, input_ids=torch.from_numpy(ids),
                      pixel_values=torch.from_numpy(px), attention_mask=torch.from_numpy(m),
                      kv_cache=cache)
    _close(got.logits, np.asarray(want.logits), 1e-5)
    assert cache.pos == s

    tok = int(np.asarray(want.logits)[0, -1].argmax())
    step = np.zeros((b, 1, 1, maxlen), np.float32)
    step[:, :, :, s + 1:] = neg
    want2 = jax_vlm.vlm_forward(params, jcfg, input_ids=jnp.asarray([[tok]]),
                                attention_mask=jnp.asarray(step), kv_cache=want.kv_cache,
                                position_ids=jnp.asarray([[s]]))
    got2 = vlm_forward(model, cfg, input_ids=torch.tensor([[tok]]),
                       attention_mask=torch.from_numpy(step), kv_cache=cache,
                       position_ids=torch.tensor([[s]]))
    _close(got2.logits, np.asarray(want2.logits), 1e-5)
