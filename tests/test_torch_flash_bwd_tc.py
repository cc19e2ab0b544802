"""The tensor-core flash backward's plain versions (``flash_attention_bwd_dq_tc``
and ``flash_attention_bwd_dkv_tc``, p and ds rounded to bf16 before the
products, as the Pallas kernels round them to q's dtype) against the JAX
package in bf16: ``jax.vjp`` of ``flash_gqa_attention`` (the Pallas
``_flash_backward``, interpret mode on the CPU), the backward's route by
dtype, and one tiny bf16 LoRA step against the JAX trainer.

Inputs come from numpy with a fixed seed and are rounded to bf16 on both
sides. Tolerance of the op comparisons: 1.6e-2 of the largest magnitude of
each compared tensor, two bf16 ulps (2^-7 relative each) of the output
rounding. The two forwards round O to bf16 after different softmax orders
(online in Pallas, dense in the port), so delta = rowsum(dO * O), and with
it ds, differs by about one ulp of O; a bf16 p or ds next to a rounding
boundary may round the other way; dq, dk and dv are then rounded to bf16
from fp32 sums taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.train import lora as jax_lora
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, _route_bwd, gqa_attention
from llama32mm_tpu_torch.train import make_lora_train_step
from llama32mm_tpu_torch.train.lora import lora_leaves

TOL = 1.6e-2
TC = ("flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")
SIMT = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# (b, nq, nkv, tq, tk, hd, q_offset, causal, key validity)
CASES = {
    "hd8_group4_causal_qoffset": (1, 4, 1, 9, 30, 8, 21, True, "all"),
    "hd16_group1_noncausal": (2, 2, 2, 12, 12, 16, 0, False, "all"),
    "hd16_group4_holes_fully_masked_row": (2, 4, 1, 8, 40, 16, 20, True, "holes"),
    "hd80_ragged_tq_tk_qoffset": (1, 2, 2, 5, 131, 80, 126, True, "prefix129"),
    "hd80_group4_noncausal_padded_keys": (1, 4, 1, 9, 70, 80, 0, False, "prefix60"),
}


def _inputs(case):
    b, nq, nkv, tq, tk, hd, q_offset, causal, validity = CASES[case]
    rs = np.random.RandomState(3)
    q, k, v, do = (rs.randn(*shape).astype(np.float32) for shape in (
        (b, nq, tq, hd), (b, nkv, tk, hd), (b, nkv, tk, hd), (b, nq, tq, hd)))
    kv_valid = np.ones((b, tk), np.int32)
    if validity.startswith("prefix"):
        kv_valid[:, int(validity[6:]):] = 0
    elif validity == "holes":
        kv_valid = (rs.rand(b, tk) > 0.3).astype(np.int32)
        kv_valid[:, q_offset + tq:] = 0  # cache tail
        kv_valid[0, :q_offset + 1] = 0  # batch 0, query 0 sees no key
    return q, k, v, do, kv_valid, q_offset, causal


def _bf16(a, grad=False):
    return torch.from_numpy(a).to(torch.bfloat16).requires_grad_(grad)


def _close(got, want, tol=TOL):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_backward_plain_matches_pallas_vjp_in_bf16(case):
    q, k, v, do, kv_valid, q_offset, causal = _inputs(case)

    def jax_fn(a, b, c):
        return flash_gqa_attention(a, b, c, jnp.asarray(kv_valid), q_offset, causal=causal,
                                   block_q=8, block_k=128)

    out_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    dq_j, dk_j, dv_j = (g.astype(jnp.float32) for g in vjp(jnp.asarray(do, jnp.bfloat16)))
    qt, kt, vt = _bf16(q, True), _bf16(k, True), _bf16(v, True)
    kernels.reset_counters()
    out = gqa_attention(qt, kt, vt, AttnMask(torch.from_numpy(kv_valid), q_offset),
                        causal=causal, impl="torch")
    out.backward(_bf16(do))
    calls = kernels.plain_counts()
    assert [calls[n] for n in TC + SIMT] == [1, 1, 0, 0]
    assert qt.grad.dtype == kt.grad.dtype == vt.grad.dtype == torch.bfloat16
    _close(out.detach(), out_j.astype(jnp.float32))
    _close(qt.grad, dq_j)
    _close(kt.grad, dk_j)
    _close(vt.grad, dv_j)
    if case == "hd16_group4_holes_fully_masked_row":
        assert torch.all(qt.grad[0, :, 0] == 0)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, TC), (torch.float32, SIMT),
                                        (torch.float64, SIMT)])
def test_backward_route_by_dtype(dtype, want):
    """bf16 takes the tensor-core pair, fp32 (and the fp64 of the gradient
    checks) the SIMT pair; on the CPU each name's plain version runs."""
    assert _route_bwd(dtype) == want
    q, k, v, do, kv_valid, q_offset, causal = _inputs("hd16_group1_noncausal")
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    kernels.reset_counters()
    out = gqa_attention(qt, kt, vt, AttnMask(torch.from_numpy(kv_valid), q_offset),
                        causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    calls = kernels.plain_counts()
    assert all(calls[n] == 1 for n in want)
    assert all(calls[n] == 0 for n in TC + SIMT if n not in want)
    assert not any(kernels.launch_counts().values())


def test_tc_plain_rounds_p_and_ds_like_pallas():
    """In bf16 the tensor-core plain dv equals the Pallas dv bit for bit on
    this input (the same p rounded to bf16, the same fp32 sums of exact
    products), while the SIMT plain version, which keeps p in fp32, does
    not."""
    q, k, v, do, kv_valid, q_offset, causal = _inputs("hd16_group1_noncausal")

    def jax_fn(a, b, c):
        return flash_gqa_attention(a, b, c, jnp.asarray(kv_valid), q_offset, causal=causal,
                                   block_q=8, block_k=128)

    out_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    dv_j = np.asarray(vjp(jnp.asarray(do, jnp.bfloat16))[2].astype(jnp.float32))
    args = (_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(kv_valid), q_offset, causal)
    out, lse = kernels.flash_attention_tc_lse_plain(*args)
    delta = (_bf16(do).float() * out.float()).sum(-1)
    bwd = (*args, lse, delta, _bf16(do))
    dv_tc = kernels.flash_attention_bwd_dkv_tc_plain(*bwd)[1].float().numpy()
    dv_simt = kernels.flash_attention_bwd_dkv_plain(*bwd)[1].float().numpy()
    np.testing.assert_array_equal(dv_tc, dv_j)
    assert not np.array_equal(dv_simt, dv_j)


def _lora_batch(seed=1, b=2, s=12):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 246, (b, s))
    ids[:, :4] = 250  # the tiny config's <image> id
    labels = np.where(ids == 250, -100, ids)
    mask = np.ones((b, s), np.int64)
    mask[-1, s - 3:] = 0
    labels[-1, s - 3:] = -100
    px = rs.randn(b, 3, 28, 28).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask, "pixel_values": px}


def test_tiny_bf16_lora_step_matches_the_jax_trainer():
    """One Adam step of LoRA on the tiny model in bf16 (bf16 base weights,
    fp32 adapters): the port (plain versions on the CPU, so the tensor-core
    backward's) against the JAX trainer with ``impl="pallas"`` (the Pallas
    flash backward in interpret mode). Loss within 5e-3 relative; each
    adapter's first moment (0.1 x its gradient) within 0.1 of its largest
    magnitude. Every activation is rounded to bf16 on both sides, at other
    places (XLA fuses elementwise chains that the port rounds after each
    op), which moves the loss by ~1e-3 and single gradient entries by up to
    ~7e-2 of their tensor's largest on this batch; an error in the attention
    backward (a wrong mask, a missing scale, the group sum) moves them by
    far more."""
    jcfg, cfg = jax_tiny_config(dtype="bfloat16"), tiny_mllama_config(dtype="bfloat16")
    params = init_vlm_params(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tree = jax.tree.map(np.asarray, jax_lora.init_lora_params(
        jax.random.PRNGKey(3), jcfg, rank=4, include_projector=True))
    rs = np.random.RandomState(3)
    for ad in [*tree["blocks"].values(), tree["lm_head"], tree["projector"]]:
        ad["lora_b"] = (rs.randn(*ad["lora_b"].shape) * 0.05).astype(np.float32)
    batch = _lora_batch()

    init_j, step_j = jax_lora.make_lora_train_step(jcfg, learning_rate=1e-3, impl="pallas")
    state_j, loss_j = jax.jit(step_j)(params, init_j(jax.tree.map(jnp.asarray, tree)),
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(0))
    init_p, step_p = make_lora_train_step(cfg, learning_rate=1e-3)
    kernels.reset_counters()
    state_p, loss_p = step_p(model, init_p(lora_from_jax(tree, "cpu")),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    calls = kernels.plain_counts()
    assert all(calls[n] == cfg.text_config.n_layers for n in TC)
    assert all(calls[n] == 0 for n in SIMT)
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=5e-3)
    mu_j = lora_leaves(lora_from_jax(jax.tree.map(np.asarray, state_j.opt_state[0].mu), "cpu"))
    assert list(mu_j) == list(state_p.opt_state.mu)
    for name, mu in state_p.opt_state.mu.items():
        _close(mu, mu_j[name].numpy(), tol=0.1)
