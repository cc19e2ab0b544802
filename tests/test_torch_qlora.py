"""QLoRA in the port: LoRA adapters trained over a frozen quantized base,
held to the JAX package.

- ``ops/gemv.py::qlinear_dx`` (the backward of a quantized linear) against
  ``jax.vjp`` of the JAX ``qlinear``: int8, and int4 on both sides of JAX's
  64-row switch (the grouped einsum at 8 rows, the dequantized matmul at 80);
- the loss and every adapter gradient of a 48-row batch (JAX's int4 einsum
  branch) over ``quantize_llama_params`` in int8, int4 and
  ``INT4_MIXED_RECIPE``, against ``jax.value_and_grad`` of the JAX loss, with
  and without ``remat=True`` plus ``loss_chunk``;
- one Adam step of ``make_lora_train_step`` against JAX's, and the base's
  bytes unchanged.

Tiny config, fp32, CPU. Tolerances: the loss 1e-5 relative; gradients and
``dx`` 1e-4 of each tensor's largest magnitude (the two sides sum in other
orders; in fp32 nothing else differs); the adapters after an Adam step at lr
1e-4 to 1e-5 of their magnitude (Adam divides each gradient by its own
size, so a near-zero gradient's rounding moves its element by up to ~lr).
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
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops.gemv import qlinear, qlinear_dx
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE, quantize_weight, quantize_weight_int4
from llama32mm_tpu_torch.train.lora import lora_leaves, make_lora_train_step

MODES = {
    "int8": dict(bits=8),
    "int4": dict(bits=4, group_size=32),
    "mixed": dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE),
}


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rows", [8, 80])
@pytest.mark.parametrize("bits", [8, 4])
def test_qlinear_dx_matches_jax_vjp(bits, rows):
    rs = np.random.RandomState(bits + rows)
    w = rs.randn(128, 48).astype(np.float32) * 0.1  # JAX [in, out]
    x = rs.randn(rows, 128).astype(np.float32)
    dy = rs.randn(rows, 48).astype(np.float32)
    if bits == 8:
        jqw, qw = jq.quantize_weight(jnp.asarray(w)), quantize_weight(torch.from_numpy(w.T.copy()))
    else:
        jqw = jq.quantize_weight_int4(jnp.asarray(w), group_size=32)
        qw = quantize_weight_int4(torch.from_numpy(w.T.copy()), group_size=32)
    _, vjp = jax.vjp(lambda xx: jq.qlinear(xx, jqw, impl="xla"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    _close(qlinear_dx(torch.from_numpy(dy), qw), want, 1e-4)
    # through autograd: the same forward as without a gradient, dx for x only
    xt = torch.from_numpy(x).requires_grad_(True)
    out = qlinear(xt, qw)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert torch.equal(out.detach(), qlinear(torch.from_numpy(x), qw))
    out.backward(torch.from_numpy(dy))
    assert torch.equal(xt.grad, qlinear_dx(torch.from_numpy(dy), qw))
    assert not any(t.requires_grad for t in qw.values())


@pytest.fixture(scope="module")
def untied():
    jcfg = jax_tiny_config()
    # one jitted init: faster here than the eager ops
    return jcfg, jax.jit(lambda k: init_vlm_params(k, jcfg, tie_weights=False))(
        jax.random.PRNGKey(0))


def _np_lora(jcfg, seed=3):
    """JAX adapters (default targets and the head) as numpy, B from numpy so
    that every leaf gets a gradient."""
    tree = jax.tree.map(np.asarray, jax_lora.init_lora_params(
        jax.random.PRNGKey(seed), jcfg.text_config, rank=4))
    rs = np.random.RandomState(seed)
    for ad in [*tree["blocks"].values(), tree["lm_head"]]:
        ad["lora_b"] = (rs.randn(*ad["lora_b"].shape) * 0.05).astype(np.float32)
    return tree


def _batch(seed=0, b=2, s=24):
    """48 rows of text; row 1's tail is not scored."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 240, (b, s))
    labels = ids.copy()
    labels[1, s - 4:] = -100
    return ids, labels


def _port_lora(np_tree):
    lora = lora_from_jax(np_tree, "cpu")
    for t in lora_leaves(lora).values():
        t.requires_grad_(True)
    return lora


@pytest.mark.parametrize("mode", sorted(MODES))
def test_qlora_loss_and_grads_match_jax(untied, mode):
    jcfg, params = untied
    qtree = jq.quantize_llama_params(params, **MODES[mode])
    np_lora = _np_lora(jcfg)
    ids, labels = _batch()

    def jax_loss(lora):
        return jax_vlm_forward(qtree, jcfg, input_ids=jnp.asarray(ids),
                               labels=jnp.asarray(labels), lora=lora, impl="xla").loss

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(jax.tree.map(jnp.asarray, np_lora))
    want = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, grads_j), "cpu"))
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, qtree), cfg, "cpu")
    buffers = [b.clone() for b in model.buffers()]
    results = {}
    for label, kw in (("plain", {}), ("remat_chunked", dict(remat=True, loss_chunk=7))):
        lora = _port_lora(np_lora)
        leaves = lora_leaves(lora)
        out = vlm_forward(model, cfg, input_ids=torch.from_numpy(ids),
                          labels=torch.from_numpy(labels), lora=lora, **kw)
        grads = torch.autograd.grad(out.loss, list(leaves.values()))
        np.testing.assert_allclose(out.loss.item(), float(loss_j), rtol=1e-5)
        for name, g in zip(leaves, grads):
            _close(g, want[name].numpy(), 1e-4)
        results[label] = (out.loss.detach(), grads)
    (l0, g0), (l1, g1) = results["plain"], results["remat_chunked"]
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for a, b in zip(g1, g0):
        _close(a, b.numpy(), 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), buffers))  # base frozen


def test_qlora_adam_step_matches_jax(untied):
    """One ``make_lora_train_step`` step over the int8 base: the JAX step
    plain, the port's with ``remat`` and ``loss_chunk``."""
    jcfg, params = untied
    qtree = jq.quantize_llama_params(params, bits=8)
    np_lora = _np_lora(jcfg)
    ids, labels = _batch(seed=1)
    init_j, step_j = jax_lora.make_lora_train_step(jcfg, learning_rate=1e-4, impl="xla")
    state_j, loss_j = jax.jit(step_j)(qtree, init_j(jax.tree.map(jnp.asarray, np_lora)),
                                      {"input_ids": jnp.asarray(ids),
                                       "labels": jnp.asarray(labels)}, jax.random.PRNGKey(0))
    cfg = tiny_mllama_config()
    model = from_jax_params(jax.tree.map(np.asarray, qtree), cfg, "cpu")
    init, step = make_lora_train_step(cfg, learning_rate=1e-4, remat=True, loss_chunk=16)
    state, loss = step(model, init(lora_from_jax(np_lora, "cpu")),
                       {"input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, state_j.lora), "cpu"))
    for name, t in lora_leaves(state.lora).items():
        _close(t, want[name].numpy(), 1e-5)
    assert state.step == 1
