"""The port's LoRA fine-tuning against the JAX package: loss and adapter
gradients (JAX ``impl="xla"`` and ``"pallas"``, the latter in interpret mode
on the CPU), three Adam steps, gradient accumulation, the merge, dropout,
remat, adapter files and train-state resume, and the refused features.

Tiny config, fp32, CPU. Both packages start from the same JAX weights
(``convert.py``) and the same adapters, whose B is drawn from numpy so that
every adapter leaf gets a gradient. Tolerance: ``_close``, 1e-5 of the
largest magnitude of each compared tensor: the two sides sum in different
orders, nothing more. The Adam steps run at lr 1e-3: Adam divides each
gradient by its own magnitude, so an element whose gradient is near zero
moves by up to ~lr on rounding noise, which differs between the packages
(at lr 1e-2 one such element of 256 reached 1.03e-5 of its tensor).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.vlm import vlm_forward as jax_vlm_forward
from llama32mm_tpu.train import accum as jax_accum
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax, lora_to_jax, to_jax_params
from llama32mm_tpu_torch.models.language import Dropout, maybe_lora
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.train import (
    Linear_LORA,
    accumulate_grads,
    init_lora_params,
    load_lora_adapters,
    load_train_state,
    make_lora_train_step,
    merge_lora_into_params,
    save_lora_adapters,
    save_train_state,
    stack_adapter_bank,
)
from llama32mm_tpu_torch.train.lora import lora_leaves


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tiny_mllama_config(), "cpu")
    return jcfg, params, tiny_mllama_config(), model


def _np_lora(jcfg, seed=3, rank=4, random_b=True, **kw):
    """The JAX package's adapters as numpy, B drawn from numpy (init makes it
    zero, which would leave every A without a gradient)."""
    tree = jax.tree.map(np.asarray, jax_lora.init_lora_params(
        jax.random.PRNGKey(seed), jcfg, rank=rank, include_projector=True, **kw))
    rs = np.random.RandomState(seed)
    for ad in [*tree["blocks"].values(), tree["lm_head"], tree["projector"]]:
        if random_b:
            ad["lora_b"] = (rs.randn(*ad["lora_b"].shape) * 0.05).astype(np.float32)
    return tree


def _port_lora(np_tree, requires_grad=False):
    lora = lora_from_jax(np_tree, "cpu")
    for t in lora_leaves(lora).values():
        t.requires_grad_(requires_grad)
    return lora


def _batch(cfg, seed=1, b=2, s=12):
    """4 ``<image>`` ids then text; labels -100 on the image positions and
    on row 1's padded tail, which the attention mask also blocks."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size - 10, (b, s))
    ids[:, :4] = cfg.image_token_index
    labels = np.where(ids == cfg.image_token_index, -100, ids)
    mask = np.ones((b, s), np.int64)
    mask[-1, s - 3:] = 0
    labels[-1, s - 3:] = -100
    px = rs.randn(b, 3, 28, 28).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask, "pixel_values": px}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss(model, cfg, lora, batch, **kw):
    b = _t(batch)
    return vlm_forward(model, cfg, input_ids=b["input_ids"], pixel_values=b["pixel_values"],
                       attention_mask=b["attention_mask"], labels=b["labels"], lora=lora,
                       **kw).loss


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_loss_and_adapter_grads_match_jax(tiny, jax_impl):
    jcfg, params, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    jb = _j(batch)

    def jax_loss(lora):
        return jax_vlm_forward(params, jcfg, input_ids=jb["input_ids"],
                               pixel_values=jb["pixel_values"],
                               attention_mask=jb["attention_mask"], labels=jb["labels"],
                               lora=lora, impl=jax_impl).loss

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(jax.tree.map(jnp.asarray, np_lora))
    lora = _port_lora(np_lora, requires_grad=True)
    leaves = lora_leaves(lora)
    loss = _port_loss(model, cfg, lora, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    want = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, grads_j), "cpu"))
    assert list(want) == list(leaves)
    for name, g in zip(leaves, grads):
        _close(g, want[name].numpy())


def test_three_adam_steps_match_jax(tiny):
    jcfg, params, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    init_j, step_j = jax_lora.make_lora_train_step(jcfg, learning_rate=1e-3, impl="xla")
    step_j = jax.jit(step_j)
    state_j = init_j(jax.tree.map(jnp.asarray, np_lora))
    init_p, step_p = make_lora_train_step(cfg, learning_rate=1e-3)
    state_p = init_p(_port_lora(np_lora))
    for i in range(3):
        state_j, loss_j = step_j(params, state_j, _j(batch), jax.random.PRNGKey(i))
        state_p, loss_p = step_p(model, state_p, _t(batch))
        np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    assert state_p.step == 3 and state_p.opt_state.count == 3
    want = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, state_j.lora), "cpu"))
    for name, t in lora_leaves(state_p.lora).items():
        _close(t, want[name].numpy())


def test_grads_reach_only_the_adapters(tiny):
    _, _, cfg, model = tiny
    jcfg = jax_tiny_config()
    lora = _port_lora(_np_lora(jcfg), requires_grad=True)
    _port_loss(model, cfg, lora, _batch(cfg)).backward()
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    grads = [t.grad for t in lora_leaves(lora).values()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert all(bool(g.abs().sum() > 0) for g in grads)


def test_zero_b_adapter_gives_the_base_model(tiny):
    jcfg, _, cfg, model = tiny
    lora = _port_lora(_np_lora(jcfg, random_b=False))
    b = _t(_batch(cfg))
    base = vlm_forward(model, cfg, input_ids=b["input_ids"], pixel_values=b["pixel_values"])
    with_lora = vlm_forward(model, cfg, input_ids=b["input_ids"], pixel_values=b["pixel_values"],
                            lora=lora)
    assert torch.equal(with_lora.logits, base.logits)


def test_merged_model_gives_the_lora_forward(tiny):
    """Blocks, the tied head (which the merge unties) and the projector; the
    merged weights also equal the JAX package's merge."""
    jcfg, params, cfg, model = tiny
    np_lora = _np_lora(jcfg)
    lora = _port_lora(np_lora)
    merged = merge_lora_into_params(model, lora)
    assert model.language_model.lm_head is None and merged.language_model.lm_head is not None
    b = _t(_batch(cfg))
    with torch.no_grad():
        want = vlm_forward(model, cfg, input_ids=b["input_ids"], pixel_values=b["pixel_values"],
                           lora=lora).logits
        got = vlm_forward(merged, cfg, input_ids=b["input_ids"],
                          pixel_values=b["pixel_values"]).logits
    _close(got, want.numpy())
    jax_merged = jax.tree.map(np.asarray, jax_lora.merge_lora_into_params(
        params, jax.tree.map(jnp.asarray, np_lora)))
    port_tree = to_jax_params(merged)
    for want_leaf, got_leaf in zip(jax.tree.leaves(jax_merged), jax.tree.leaves(port_tree)):
        _close(got_leaf, want_leaf)
    # the original model is untouched (the merge copies modules, not tensors)
    for want_leaf, got_leaf in zip(jax.tree.leaves(params), jax.tree.leaves(to_jax_params(model))):
        np.testing.assert_array_equal(got_leaf, np.asarray(want_leaf))


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_gives_the_same_loss_and_grads(tiny, dropout):
    """``remat=True`` recomputes each block in the backward; the per-layer
    dropout streams are seeded, so the recomputed masks are the same."""
    jcfg, _, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    res = []
    for remat in (False, True):
        lora = _port_lora(np_lora, requires_grad=True)
        gen = torch.Generator().manual_seed(11)
        loss = _port_loss(model, cfg, lora, batch, remat=remat, dropout_rng=gen,
                          lora_dropout=dropout)
        loss.backward()
        res.append((loss.detach(), [t.grad for t in lora_leaves(lora).values()]))
    (l0, g0), (l1, g1) = res
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_accum_steps_equal_the_big_batch_and_jax(tiny):
    """Two microbatches with different padding: the valid-target-weighted
    accumulation equals one step on the whole batch, and JAX's
    ``accumulate_grads``."""
    jcfg, params, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    micro = {k: v[:, None] for k, v in batch.items()}  # [A=2, B=1, ...]
    states = []
    for accum, b in ((1, batch), (2, micro)):
        init_state, step = make_lora_train_step(cfg, learning_rate=1e-2, accum_steps=accum)
        states.append(step(model, init_state(_port_lora(np_lora)), _t(b)))
    (s1, l1), (s2, l2) = states
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for name, t in lora_leaves(s2.lora).items():
        _close(t, lora_leaves(s1.lora)[name].detach().numpy())

    def jax_loss(lora, mb, rng):
        return jax_vlm_forward(params, jcfg, input_ids=mb["input_ids"],
                               pixel_values=mb["pixel_values"],
                               attention_mask=mb["attention_mask"], labels=mb["labels"],
                               lora=lora, impl="xla").loss

    loss_j, grads_j = jax_accum.accumulate_grads(
        jax_loss, jax.tree.map(jnp.asarray, np_lora), _j(micro), jax.random.PRNGKey(0), 2,
        jcfg.ignore_index)
    lora = _port_lora(np_lora, requires_grad=True)
    leaves = lora_leaves(lora)
    loss, grads = accumulate_grads(lambda mb: _port_loss(model, cfg, lora, {
        k: v.numpy() for k, v in mb.items()}), list(leaves.values()), _t(micro), 2,
        cfg.ignore_index)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    want = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, grads_j), "cpu"))
    for name, g in zip(leaves, grads):
        _close(g, want[name].numpy())


def test_dropout_zero_is_parity_and_dropout_scales_the_adapter_branch_only(tiny):
    jcfg, _, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    lora = _port_lora(np_lora)
    with torch.no_grad():
        plain = _port_loss(model, cfg, lora, batch)
        rate0 = _port_loss(model, cfg, lora, batch, dropout_rng=torch.Generator().manual_seed(1),
                           lora_dropout=0.0)
        drop = [_port_loss(model, cfg, lora, batch, lora_dropout=0.5,
                           dropout_rng=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(rate0, plain)
    assert torch.equal(drop[0], drop[1]) and not torch.equal(drop[0], drop[2])
    assert not torch.equal(drop[0], plain)

    # One adapter with A = B = I and scaling 1: its delta is dropout(x) itself.
    rate, n = 0.3, 64
    x = torch.ones(512, n)
    base = torch.randn(512, n, generator=torch.Generator().manual_seed(0))
    eye = {"lora_a": torch.eye(n), "lora_b": torch.eye(n), "scaling": torch.tensor(1.0)}
    delta = maybe_lora(x, base, eye, dropout=Dropout(rate, 5)) - base
    kept = delta.abs() > 0.5
    torch.testing.assert_close(delta[kept], torch.full_like(delta[kept], 1 / (1 - rate)))
    assert torch.all(delta[~kept].abs() < 1e-6)  # dropped: the base output alone
    frac = 1 - kept.float().mean().item()
    assert abs(frac - rate) < 4 * np.sqrt(rate * (1 - rate) / x.numel()), frac


def test_adapter_files_round_trip_between_packages(tiny, tmp_path):
    jcfg, _, _, _ = tiny
    np_lora = _np_lora(jcfg)
    lora = _port_lora(np_lora)
    port_file, jax_file = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_adapters(port_file, lora)
    jax_lora.save_lora_adapters(jax_file, jax.tree.map(jnp.asarray, np_lora))
    want = lora_leaves(lora)
    for path in (port_file, jax_file):  # the port reads its own file and the JAX package's
        got = lora_leaves(load_lora_adapters(path, device="cpu"))
        assert list(got) == list(want)
        for name, t in got.items():
            assert t.dtype == torch.float32 and torch.equal(t, want[name])
    from_port = lora_to_jax(_port_lora(jax.tree.map(np.asarray, jax_lora.load_lora_adapters(
        port_file))))  # and the JAX package reads the port's
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(np_lora)):
        np.testing.assert_array_equal(a, b)


def test_bf16_adapter_file_round_trip(tmp_path):
    lora = init_lora_params(torch.Generator().manual_seed(0), tiny_mllama_config(), rank=2,
                            dtype=torch.bfloat16, include_projector=True)
    path = str(tmp_path / "bf16.safetensors")
    save_lora_adapters(path, lora)
    got = lora_leaves(load_lora_adapters(path, device="cpu"))
    for name, t in lora_leaves(lora).items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)


def test_load_lora_adapters_needs_a_device(tmp_path):
    path = str(tmp_path / "a.safetensors")
    save_lora_adapters(path, init_lora_params(torch.Generator().manual_seed(0),
                                              tiny_mllama_config(), rank=2))
    with pytest.raises(TypeError):
        load_lora_adapters(path)


def test_train_state_save_and_resume(tiny, tmp_path):
    jcfg, _, cfg, model = tiny
    np_lora, batch = _np_lora(jcfg), _batch(cfg)
    init_state, step = make_lora_train_step(cfg, learning_rate=1e-2)
    state = init_state(_port_lora(np_lora))
    for _ in range(2):
        state, _ = step(model, state, _t(batch))
    path = str(tmp_path / "state")
    save_train_state(path, state)
    resumed = load_train_state(path, init_state(_port_lora(_np_lora(jcfg, seed=9))))
    assert resumed.step == 2 and resumed.opt_state.count == 2
    state, loss = step(model, state, _t(batch))
    resumed, loss_r = step(model, resumed, _t(batch))
    assert torch.equal(loss, loss_r)
    got = lora_leaves(resumed.lora)
    for name, t in lora_leaves(state.lora).items():
        assert torch.equal(got[name], t)


def test_init_lora_params_matches_jax_layout():
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    want = jax.tree.map(np.asarray, jax_lora.init_lora_params(
        jax.random.PRNGKey(0), jcfg, rank=4, alpha=8.0, include_projector=True))
    got = lora_to_jax(init_lora_params(torch.Generator().manual_seed(0), cfg, rank=4, alpha=8.0,
                                       include_projector=True))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    back = lora_to_jax(lora_from_jax(want, "cpu"))  # convert.py round trip, bitwise
    for b, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(b, w)
    blocks = got["blocks"]
    assert all(np.all(ad["lora_b"] == 0) and np.all(ad["scaling"] == 2.0)
               for ad in blocks.values())
    a = blocks["w_down"]["lora_a"]
    assert np.abs(a).max() <= 1 / np.sqrt(cfg.text_config.hidden_dim) and np.abs(a).max() > 0


def test_linear_lora_formula():
    gen = torch.Generator().manual_seed(0)
    lin = Linear_LORA(16, 8, rank=4, alpha=8.0, dropout=0.5, gen=gen)
    x = torch.randn(3, 16, generator=gen)
    want = x @ lin.weight.t() + 2.0 * (x @ lin.lora_a) @ lin.lora_b
    torch.testing.assert_close(lin(x), want, rtol=1e-6, atol=1e-6)
    assert not lin.weight.requires_grad and lin.lora_a.requires_grad
    lin(x, dropout_seed=3).sum().backward()
    assert lin.weight.grad is None and lin.lora_b.grad is not None


def _refusals(model, cfg, lora):
    b = _t(_batch(cfg))
    ids, px = b["input_ids"], b["pixel_values"]
    bank = {"lm_head": {k: v[None] for k, v in lora["lm_head"].items()}}
    vit_dropout = dataclasses.replace(
        cfg, vision_config=dataclasses.replace(cfg.vision_config, attention_dropout=0.1))
    return {
        "loss_chunk": lambda: make_lora_train_step(cfg, loss_chunk=4),
        "adapter_bank": lambda: vlm_forward(model, cfg, input_ids=ids, lora=bank),
        "stack_adapter_bank": lambda: stack_adapter_bank([lora, lora]),
        "qlora": lambda: vlm_forward(quantize_llama_params(model), cfg, input_ids=ids,
                                     lora=lora),
        "vit_attention_dropout": lambda: vlm_forward(
            model, vit_dropout, input_ids=ids, pixel_values=px,
            dropout_rng=torch.Generator().manual_seed(0)),
    }


@pytest.mark.parametrize("feature", ["loss_chunk", "adapter_bank", "stack_adapter_bank",
                                     "qlora", "vit_attention_dropout"])
def test_refused_features_raise(tiny, feature):
    jcfg, _, cfg, model = tiny
    lora = _port_lora(_np_lora(jcfg), requires_grad=True)
    with pytest.raises(NotImplementedError):
        _refusals(model, cfg, lora)[feature]()
