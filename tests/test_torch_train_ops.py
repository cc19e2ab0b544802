"""The port's backward ops against the JAX package's Pallas custom VJPs
(interpret mode on the CPU), the plain backward formulas against
``torch.autograd.gradcheck`` in fp64, and the autograd guards: under grad no
bare kernel call cuts the graph, and the inference-only ops raise.

Inputs and cotangents come from numpy with a fixed seed; the comparisons are
fp32. Tolerance: 1e-5 of the largest magnitude of each compared tensor
(``_close``): the two sides sum in different orders, nothing more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.ops.pallas.rmsnorm import fused_add_rmsnorm_pallas
from llama32mm_tpu.ops.pallas.swiglu import fused_swiglu_pallas
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, _FlashAttention, gqa_attention
from llama32mm_tpu_torch.ops.gemv import linear, qlinear
from llama32mm_tpu_torch.ops.quant import quantize_weight
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu
from llama32mm_tpu_torch.train.full import make_train_step
from llama32mm_tpu_torch.utils.kvcache import quantize_kv


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


@pytest.mark.parametrize("shape", [(4, 7, 64), (3, 160), (1, 33)])
@pytest.mark.parametrize("with_residual", [True, False])
def test_rmsnorm_grads_match_pallas_vjp(shape, with_residual):
    rs = np.random.RandomState(0)
    x, res, g = _rand(rs, *shape), _rand(rs, *shape), _rand(rs, *shape)
    w = _rand(rs, shape[-1]) + 1.0
    eps = 1e-5
    res_j = res if with_residual else np.zeros_like(x)
    out_j, vjp = jax.vjp(lambda a, b, c: fused_add_rmsnorm_pallas(a, b, c, eps),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(res_j))
    dx_j, dw_j, dres_j = vjp(jnp.asarray(g))
    xt, wt, rt = _leaf(x), _leaf(w), _leaf(res) if with_residual else None
    out = fused_add_rmsnorm(xt, wt, eps, residual=rt, impl="torch")
    out.backward(torch.from_numpy(g))
    _close(out.detach(), out_j)
    _close(xt.grad, dx_j)
    _close(wt.grad, dw_j)
    if with_residual:
        _close(rt.grad, dres_j)
        assert torch.equal(rt.grad, xt.grad)  # x and the residual share dt


@pytest.mark.parametrize("rows", [1, 7, 33, 130])  # not multiples of the kernel's rows in flight
@pytest.mark.parametrize("frozen", [True, False])
def test_rmsnorm_bwd_row_counts_match_pallas_vjp(rows, frozen):
    """The backward at row counts that leave the kernel's blocks uneven (it
    walks every P-th row, D rows in flight), with the weight trained (``dw``
    summed over the rows) or frozen, as the LoRA step's norms are: no ``dw``
    is asked for, and dt, the gradient of x and of the residual, still
    equals the Pallas VJP's."""
    rs = np.random.RandomState(rows)
    c, eps = 96, 1e-5
    x, res, g = _rand(rs, rows, c), _rand(rs, rows, c), _rand(rs, rows, c)
    w = _rand(rs, c) + 1.0
    _, vjp = jax.vjp(lambda a, b, e: fused_add_rmsnorm_pallas(a, b, e, eps),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(res))
    dx_j, dw_j, dres_j = vjp(jnp.asarray(g))
    xt, rt = _leaf(x), _leaf(res)
    wt = torch.tensor(w) if frozen else _leaf(w)
    kernels.reset_counters()
    fused_add_rmsnorm(xt, wt, eps, residual=rt, impl="torch").backward(torch.from_numpy(g))
    assert kernels.plain_counts()["rmsnorm_bwd"] == 1
    _close(xt.grad, dx_j)
    _close(rt.grad, dres_j)
    if frozen:
        assert wt.grad is None
    else:
        _close(wt.grad, dw_j)


@pytest.mark.parametrize("r,h,i", [(1, 64, 128), (10, 96, 200), (33, 128, 384)])
def test_swiglu_grads_match_pallas_vjp(r, h, i):
    rs = np.random.RandomState(1)
    x, g = _rand(rs, r, h), _rand(rs, r, i)
    wg, wu = _rand(rs, h, i, scale=0.1), _rand(rs, h, i, scale=0.1)
    out_j, vjp = jax.vjp(fused_swiglu_pallas, jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    dx_j, dwg_j, dwu_j = vjp(jnp.asarray(g))
    xt, wgt, wut = _leaf(x), _leaf(wg.T.copy()), _leaf(wu.T.copy())  # the port stores [I, H]
    out = fused_swiglu(xt, wgt, wut, impl="torch")
    out.backward(torch.from_numpy(g))
    _close(out.detach(), out_j)
    _close(xt.grad, dx_j)
    _close(wgt.grad.T, dwg_j)
    _close(wut.grad.T, dwu_j)


@pytest.mark.parametrize("r,h,i", [(3, 64, 128), (10, 96, 200)])
def test_swiglu_bwd_offset_cotangent_matches_pallas_vjp(r, h, i):
    """The cotangent as a contiguous view that starts one element into its
    buffer (``buf[1:].view(R, I)``: in bf16 on the card, not 4-byte aligned).
    The plain backward's d_gate and d_up, taken through the autograd
    function's formulas for dx and the weight gradients, give the Pallas
    VJP's gradients; in bf16 they equal, bit for bit, those of an aligned
    copy of the same cotangent."""
    rs = np.random.RandomState(1)
    x, g = _rand(rs, r, h), _rand(rs, r, i)
    wg, wu = _rand(rs, h, i, scale=0.1), _rand(rs, h, i, scale=0.1)
    _, vjp = jax.vjp(fused_swiglu_pallas, jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    dx_j, dwg_j, dwu_j = vjp(jnp.asarray(g))
    buf = torch.cat([torch.zeros(1), torch.from_numpy(g).reshape(-1)])
    g_off = buf[1:].view(r, i)
    assert g_off.is_contiguous() and g_off.storage_offset() == 1
    xt, wgt, wut = torch.from_numpy(x), torch.from_numpy(wg.T.copy()), torch.from_numpy(wu.T.copy())
    d_gate, d_up = kernels.fused_swiglu_bwd_plain(xt, wgt, wut, g_off)
    _close(d_gate @ wgt + d_up @ wut, dx_j)
    _close((d_gate.t() @ xt).t(), dwg_j)
    _close((d_up.t() @ xt).t(), dwu_j)
    bf = [t.bfloat16() for t in (xt, wgt, wut)]
    off = buf.bfloat16()[1:].view(r, i)
    for a, b in zip(kernels.fused_swiglu_bwd_plain(*bf, off),
                    kernels.fused_swiglu_bwd_plain(*bf, off.clone())):
        assert torch.equal(a, b)


# (b, nq, nkv, tq, tk, hd, q_offset, causal, key validity)
FLASH_CASES = {
    "noncausal_group1": (1, 4, 4, 12, 12, 16, 0, False, "all"),
    "causal_group4": (2, 4, 1, 16, 16, 16, 0, True, "all"),
    "qoffset_holes_fully_masked_row": (2, 4, 2, 8, 40, 16, 20, True, "holes"),
    "ragged_tk_hd80_qoffset": (1, 2, 2, 5, 131, 80, 126, True, "prefix129"),
    "noncausal_padded_keys_hd8": (2, 4, 2, 9, 9, 8, 0, False, "prefix6"),
}


def _flash_inputs(case, rs):
    b, nq, nkv, tq, tk, hd, q_offset, causal, validity = FLASH_CASES[case]
    q, k, v = _rand(rs, b, nq, tq, hd), _rand(rs, b, nkv, tk, hd), _rand(rs, b, nkv, tk, hd)
    do = _rand(rs, b, nq, tq, hd)
    kv_valid = np.ones((b, tk), np.int32)
    if validity.startswith("prefix"):
        kv_valid[:, int(validity[6:]):] = 0
    elif validity == "holes":
        kv_valid = (rs.rand(b, tk) > 0.3).astype(np.int32)
        kv_valid[:, q_offset + tq:] = 0  # cache tail
        kv_valid[0, :q_offset + 1] = 0  # batch 0, query 0 sees no key
    return q, k, v, do, kv_valid, q_offset, causal


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_grads_match_pallas_vjp(case):
    rs = np.random.RandomState(3)
    q, k, v, do, kv_valid, q_offset, causal = _flash_inputs(case, rs)

    def jax_fn(a, b, c):
        return flash_gqa_attention(a, b, c, jnp.asarray(kv_valid), q_offset, causal=causal,
                                   block_q=8, block_k=128)

    out_j, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
    out = gqa_attention(qt, kt, vt, AttnMask(torch.from_numpy(kv_valid), q_offset),
                        causal=causal, impl="torch")
    out.backward(torch.from_numpy(do))
    _close(out.detach(), out_j)
    _close(qt.grad, dq_j)
    _close(kt.grad, dk_j)
    _close(vt.grad, dv_j)
    if case == "qoffset_holes_fully_masked_row":
        assert torch.all(out[0, :, 0] == 0) and torch.all(qt.grad[0, :, 0] == 0)


def _f64(*shape, gen):
    return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("op", ["rmsnorm_residual", "rmsnorm", "swiglu", "flash_causal",
                                "flash_noncausal", "flash_tc_causal", "flash_tc_noncausal"])
def test_plain_backward_formulas_pass_gradcheck(op):
    """Each plain backward (the formula written out) against finite
    differences of its plain forward, in fp64. ``flash_tc_*``: the
    tensor-core pair's plain versions (in fp64 their rounding of p and ds to
    q's dtype is exact), through the autograd function with those names."""
    gen = torch.Generator().manual_seed(7)
    if op.startswith("rmsnorm"):
        x, w, r = _f64(3, 5, 8, gen=gen), _f64(8, gen=gen), _f64(3, 5, 8, gen=gen)
        if op == "rmsnorm":
            fn, args = (lambda a, b: fused_add_rmsnorm(a, b, 1e-5, impl="torch")), (x, w)
        else:
            fn, args = (lambda a, b, c: fused_add_rmsnorm(a, b, 1e-5, c, impl="torch")), (x, w, r)
    elif op == "swiglu":
        fn = lambda a, b, c: fused_swiglu(a, b, c, impl="torch")  # noqa: E731
        args = (_f64(4, 6, gen=gen), _f64(10, 6, gen=gen), _f64(10, 6, gen=gen))
    else:
        causal = op in ("flash_causal", "flash_tc_causal")
        kvv = torch.ones(2, 9, dtype=torch.int32)
        kvv[1, :3] = 0
        kvv[0, 7:] = 0
        mask = AttnMask(kvv, 2 if causal else 0)
        fn = lambda a, b, c: gqa_attention(a, b, c, mask, causal=causal, impl="torch")  # noqa: E731
        if op.startswith("flash_tc"):
            names = ("flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")
            fn = lambda a, b, c: _FlashAttention.apply(  # noqa: E731
                a, b, c, kvv, mask.q_offset, causal, "torch", "flash_attention_tc_lse", names)
        args = (_f64(2, 4, 5, 8, gen=gen), _f64(2, 2, 9, 8, gen=gen), _f64(2, 2, 9, 8, gen=gen))
    assert torch.autograd.gradcheck(fn, args)


def test_short_linear_under_grad_skips_the_gemv():
    """The decode gemv has no backward: under autograd a linear with at most
    32 rows is a matmul, and its input gets the right gradient."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, generator=gen, requires_grad=True)
    w = torch.randn(8, 16, generator=gen)
    g = torch.randn(3, 8, generator=gen)
    kernels.reset_counters()
    linear(x, w).backward(g)
    assert kernels.plain_counts()["gemv"] == 0
    torch.testing.assert_close(x.grad, g @ w, rtol=0, atol=0)
    with torch.no_grad():  # without autograd the gemv route stays
        linear(x, w)
    assert kernels.plain_counts()["gemv"] == 1


def test_training_runs_no_inference_op():
    """A full fine-tuning step (everything trains) goes through the
    autograd functions only: no inference-only forward runs (the SwiGLU
    forward serves both, as in the Pallas custom VJP), and every training op
    does."""
    cfg = tiny_mllama_config()
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 240, (2, 12), generator=gen)
    ids[:, :4] = cfg.image_token_index
    batch = {"input_ids": ids, "labels": ids, "pixel_values": torch.randn(2, 3, 28, 28)}
    init_state, step = make_train_step(cfg, learning_rate=1e-4)
    state = init_state(model)
    kernels.reset_counters()
    step(state, batch)
    calls = kernels.plain_counts()
    for name in ("rmsnorm", "gemv", "flash_attention"):
        assert calls[name] == 0, (name, calls)
    for name in ("rmsnorm_fwd_train", "rmsnorm_bwd", "swiglu", "swiglu_bwd", "flash_attention_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert calls[name] > 0, (name, calls)


def test_inference_only_ops_raise_under_grad():
    """The int8-KV attention stays inference-only; a quantized linear (once
    refused) records a backward for its input alone (QLoRA,
    tests/test_torch_qlora.py)."""
    x = torch.randn(2, 16, requires_grad=True)
    qw = quantize_weight(torch.randn(4, 16))
    out = qlinear(x, qw)
    out.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape and not qw["q"].requires_grad
    q = torch.randn(1, 2, 3, 16, requires_grad=True)
    (kq, ks), (vq, vs) = quantize_kv(torch.randn(1, 2, 3, 16)), quantize_kv(torch.randn(1, 2, 3, 16))
    with pytest.raises(NotImplementedError, match="int8-KV"):
        gqa_attention(q, kq, vq, AttnMask(torch.ones(1, 3), 0), k_scale=ks, v_scale=vs)
    with torch.no_grad():  # inference still runs
        assert gqa_attention(q, kq, vq, AttnMask(torch.ones(1, 3), 0), k_scale=ks,
                             v_scale=vs).shape == (1, 2, 3, 16)
