"""The port's full fine-tuning against the JAX package: three steps of
``make_train_step`` (losses and every trained tensor) with the vision tower
frozen and training, with ``clip_by_global_norm`` active and inactive;
optax's update rules in the optimizer; fp32 masters under a bf16 compute
dtype; gradient accumulation; train-state resume; the refused features.

Tiny config, fp32, CPU, the same JAX weights on both sides (``convert.py``).
Tolerance: 1e-5 of the largest magnitude of each compared tensor, and for
parameters after several Adam steps as ``test_three_steps_match_jax`` says.
The ViT's key biases are the exception: a softmax ignores a shift of all its
logits, so their true gradient is 0 and what each package computes is
rounding noise, which Adam scales up to a step of up to ~lr; they are held
to that bound instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.train import full as jax_full
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.train import (
    load_full_train_state,
    make_optimizer,
    make_train_step,
    save_full_train_state,
    split_trainable,
)

LR = 1e-3


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_params():
    return init_vlm_params(jax.random.PRNGKey(0), jax_tiny_config())


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), tiny_mllama_config(), "cpu")


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


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=()):
    """``{path: leaf}`` of a nested dict, paths as tuples of keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _adam_mu(opt_state):
    """The first moments of an optax chain's ``ScaleByAdamState``."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state.mu
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            mu = _adam_mu(sub)
            if mu is not None:
                return mu
    return None


def _as_jax_tree(named: dict, jax_params) -> dict:
    """``{path: array}`` of a ``{parameter name: tensor}`` dict in the JAX
    package's tree layout (missing names as zeros)."""
    holder = _model(jax_params)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(named[name]) if name in named else p.zero_()
    return _flat(to_jax_params(holder))


def _is_vit_key_bias(path) -> bool:
    return path[0] == "vision_model" and "k_proj" in path and path[-1] == "bias"


@pytest.mark.parametrize("freeze_vision,max_grad_norm", [
    (True, None), (True, 1e-2), (False, 1e4), (False, 1e-2),
])
def test_three_steps_match_jax(jax_params, freeze_vision, max_grad_norm):
    """``max_grad_norm`` 1e-2 clips every step (the tiny model's global norm
    is far above it), 1e4 never does, None leaves the clip out.

    The losses of the three steps and the first step's first moments
    (``(1 - b1)`` times the clipped gradient) are held to 1e-5. After three
    steps every parameter is within Adam's bound (2 lr a step) of JAX's,
    and where its first gradient is at least 1e-2 of its tensor's largest,
    within 1e-5 of the tensor's magnitude plus 1e-3 of its largest update:
    Adam's step divides a gradient by its own size, so a small gradient's
    rounding noise (2e-6 of the largest) grows in the step, and biases that
    start at 0 are no larger than their updates."""
    lr, steps = 1e-4, 3
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    batch = _batch()
    init_j, step_j = jax_full.make_train_step(jcfg, learning_rate=lr, max_grad_norm=max_grad_norm,
                                              freeze_vision=freeze_vision, impl="xla")
    step_j = jax.jit(step_j)
    state_j = init_j(jax_params)
    model = _model(jax_params)
    init_p, step_p = make_train_step(cfg, learning_rate=lr, max_grad_norm=max_grad_norm,
                                     freeze_vision=freeze_vision)
    state_p = init_p(model)
    for i in range(steps):
        state_j, loss_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
        state_p, loss_p = step_p(state_p, _t(batch))
        np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
        if i == 0:
            mu_j = _flat(jax.tree.map(np.asarray, _adam_mu(state_j.opt_state)))
            mu_p = _as_jax_tree(state_p.opt_state.mu, jax_params)
            for path, w in mu_j.items():
                if not _is_vit_key_bias(path):
                    _close(mu_p[path], w)
    assert state_p.step == steps and state_p.opt_state.count == steps
    want = _flat(jax.tree.map(np.asarray, state_j.full_params()))
    got = _flat(to_jax_params(model))
    assert set(got) == set(want)
    start = _flat(jax.tree.map(np.asarray, jax_params))
    for path, w in want.items():
        if freeze_vision and path[0] == "vision_model":
            np.testing.assert_array_equal(got[path], start[path])
            continue
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * steps * lr, path
        if _is_vit_key_bias(path):
            continue
        g1 = np.abs(mu_j[path])
        clear = g1 >= 1e-2 * g1.max()
        tol = 1e-5 * np.abs(w).max() + 1e-3 * np.abs(w - start[path]).max()
        assert err[clear].max() <= tol, (path, err[clear].max(), tol)


def test_optimizer_follows_optax():
    """``clip_by_global_norm`` then ``adamw``, and a learning-rate schedule,
    against optax on the same gradients: the clip scales by ``max / norm``
    (no epsilon) only when the norm is at least ``max``."""
    rs = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # small norms, so that torch's clip_grad_norm_ rule (max / (norm + 1e-6))
    # would be 2e-4 off
    grads = [{k: (rs.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (1e-3, 1e-5, 3e-3)]
    norms = [np.sqrt(sum(np.sum(g ** 2) for g in gs.values())) for gs in grads]
    max_norm = 1e-3
    assert norms[0] > max_norm > norms[1]  # clipped, not clipped
    schedule = optax.linear_schedule(1e-2, 1e-3, 3)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(schedule, weight_decay=0.1))
    pj, sj = dict(params), tx.init(params)
    opt = make_optimizer(learning_rate=lambda n: float(schedule(n)), weight_decay=0.1,
                         max_grad_norm=max_norm)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(pt)
    for g in grads:
        upd, sj = tx.update(g, sj, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.step(pt, {k: torch.from_numpy(v) for k, v in g.items()}, st)
    for k in shapes:
        _close(pt[k].numpy(), np.asarray(pj[k]))
        _close(st.mu[k].numpy(), np.asarray(_adam_mu(sj)[k]))


def test_fp32_masters_under_bf16_compute(jax_params):
    """The forward and backward run on a bf16 twin; the masters stay fp32
    and take the update; the vision tower, frozen, is cast once and never
    changes; the loss is close to the JAX package's bf16 loss."""
    jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    batch = _batch()
    model = _model(jax_params)
    init_p, step_p = make_train_step(cfg, learning_rate=LR, freeze_vision=True,
                                     compute_dtype="bfloat16")
    state = init_p(model)
    assert state.module is not model
    assert all(p.dtype == torch.bfloat16 for p in state.module.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not any(p.requires_grad for p in state.module.vision_model.parameters())
    before = {n: p.clone() for n, p in model.named_parameters()}
    init_j, step_j = jax_full.make_train_step(jcfg, learning_rate=LR, freeze_vision=True,
                                              compute_dtype="bfloat16", impl="xla")
    _, loss_j = jax.jit(step_j)(init_j(jax_params), {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0))
    state, loss = step_p(state, _t(batch))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-2)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if name in state.frozen:
            assert torch.equal(p, before[name])
        else:
            assert name in state.opt_state.mu
    assert sum(not torch.equal(p, before[n]) for n, p in state.params.items()) > 0
    # the next step casts the updated masters into the twin before its forward
    after_one = {n: p.clone() for n, p in state.params.items()}
    state, _ = step_p(state, _t(batch))
    twin = dict(state.module.named_parameters())
    for name, p in after_one.items():
        assert torch.equal(twin[name], p.to(torch.bfloat16)), name


def test_accum_steps_equal_the_big_batch(jax_params):
    """Two microbatches with different padding give the big batch's loss and
    gradient (compared through the first moments, linear in it)."""
    cfg = tiny_mllama_config()
    batch = _batch()
    micro = {k: v[:, None] for k, v in batch.items()}
    out = []
    for accum, b in ((1, batch), (2, micro)):
        init_state, step = make_train_step(cfg, learning_rate=LR, accum_steps=accum)
        state, loss = step(init_state(_model(jax_params)), _t(b))
        out.append((loss, state.opt_state.mu))
    (l1, m1), (l2, m2) = out
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
    for name, t in m2.items():
        if not (name.startswith("vision_model") and "k_proj.bias" in name):
            _close(t.numpy(), m1[name].numpy())


def test_save_and_resume(jax_params, tmp_path):
    cfg = tiny_mllama_config()
    batch = _t(_batch())
    init_state, step = make_train_step(cfg, learning_rate=LR, freeze_vision=True)
    state = init_state(_model(jax_params))
    state, _ = step(state, batch)
    path = str(tmp_path / "full.safetensors")
    save_full_train_state(path, state)
    other = init_vlm(cfg, "cpu", torch.Generator().manual_seed(5))
    resumed = load_full_train_state(path, init_state(other))
    assert resumed.step == 1 and resumed.opt_state.count == 1
    state, loss = step(state, batch)
    resumed, loss_r = step(resumed, batch)
    assert torch.equal(loss, loss_r)
    for name, t in state.full_params().items():
        assert torch.equal(resumed.full_params()[name], t), name


def test_split_trainable_freezes_the_vision_tower(jax_params):
    model = _model(jax_params)
    trainable, frozen = split_trainable(model, freeze_vision=True)
    assert frozen and all(n.startswith("vision_model.") for n in frozen)
    assert not any(n.startswith("vision_model.") for n in trainable)
    assert len(trainable) + len(frozen) == len(list(model.parameters()))
    assert split_trainable(model)[1] == {}


@pytest.mark.parametrize("kwargs,error,match", [
    ({"optimizer": "adagrad"}, ValueError, "optimizer must be"),
])
def test_refused_options_raise(kwargs, error, match):
    """An unknown optimizer is an error; ``optimizer="adafactor"`` and
    ``loss_chunk`` are ported (tests/test_torch_train_ext.py), and so is
    ZeRO-1 (below; across ranks: tests/test_torch_tp_train.py)."""
    with pytest.raises(error, match=match):
        make_train_step(tiny_mllama_config(), **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"zero1_params": True},
    {"zero1_masters": True},
    {"zero1_params": True, "zero1_masters": True, "loss_chunk": 4},
])
def test_once_refused_zero1_options_run(jax_params, kwargs):
    """The ZeRO-1 options that were refused now train. On a one-rank mesh
    (``shard_params`` over ``single_device_mesh``) there is no ``dp`` axis
    to split over, so two steps equal the plain step's bit for bit; with
    ``zero1_masters`` the masters are the state's own copies, and the
    model's parameters stay as they were."""
    from llama32mm_tpu_torch.parallel import shard_params, single_device_mesh

    cfg = tiny_mllama_config()
    batch = _t(_batch())
    kw = {k: v for k, v in kwargs.items() if k != "zero1_params"}
    plain_init, plain_step = make_train_step(cfg, learning_rate=1e-3,
                                             loss_chunk=kw.get("loss_chunk"))
    want = plain_init(_model(jax_params))
    model = shard_params(_model(jax_params), cfg, single_device_mesh("cpu"))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if kwargs.get("zero1_params"):
        kw["zero1_params"] = model
    init, step = make_train_step(cfg, learning_rate=1e-3, **kw)
    state = init(model)
    for _ in range(2):
        want, loss_want = plain_step(want, batch)
        state, loss = step(state, batch)
        assert torch.equal(loss, loss_want)
    assert state.opt_state.count == 2
    for name, t in want.params.items():
        assert torch.equal(state.params[name], t), name
        assert torch.equal(state.opt_state.mu[name], want.opt_state.mu[name]), name
    masters_apart = kwargs.get("zero1_params") and kwargs.get("zero1_masters")
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) == bool(masters_apart), name


def test_vit_attention_dropout_refused(jax_params):
    """Once refused, ViT attention dropout now trains: a step with a
    generator runs the explicit dropout path (a finite loss that differs
    from the step without dropout), and the same seed repeats it."""
    cfg = tiny_mllama_config()
    cfg = dataclasses.replace(
        cfg, vision_config=dataclasses.replace(cfg.vision_config, attention_dropout=0.1))
    losses = []
    for seed in (0, 0, None):
        init_state, step = make_train_step(cfg)
        state = init_state(_model(jax_params))
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        losses.append(step(state, _t(_batch()), rng=rng)[1].item())
    assert all(np.isfinite(losses)) and losses[0] == losses[1] != losses[2]
