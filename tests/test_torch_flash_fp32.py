"""The fp32 flash kernels' plain versions (the functions that the 3xTF32
forward, its LSE and int8-KV instantiations and the dq and dk/dv backward
compute on the card) against the JAX package's Pallas kernels in fp32:
``_flash_forward(..., emit_lse=True)`` and ``_flash_backward``, interpret
mode on the CPU. The cases sit at the edges the kernels' tiles create: hd
32 / 64 / 96 / 128, Tq and Tk on both sides of the 64-row tiles, GQA groups
3 and 4, a negative ``q_offset`` (a ring chunk wholly in the future) and one
at or past Tk (a chunk wholly in the past), int8 K/V with fp32 q, and a fully
masked row. Then the routes: fp32 calls reach the five fp32 kernels' names,
bf16 calls never.

Inputs come from numpy with a fixed seed. Tolerance: 1e-5 of the largest
magnitude of each compared tensor (the bar ``chip_smoke.py`` holds the
kernels to on the card): both sides compute in fp32, in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.pallas.attention import _flash_backward, _flash_forward
from llama32mm_tpu.utils import kvcache as jkv
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, _route, _route_bwd, gqa_attention
from llama32mm_tpu_torch.ops.cuda.attention import NEG_BIG
from llama32mm_tpu_torch.utils.kvcache import quantize_kv

TOL = 1e-5
FP32_KERNELS = ("flash_attention", "flash_attention_int8kv", "flash_attention_lse",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# (b, nq, nkv, tq, tk, hd, q_offset, causal, key validity)
CASES = {
    "hd32_group4_tq_tk_cross_64": (1, 8, 2, 70, 130, 32, 60, True, "all"),
    "hd64_group3_noncausal_padded": (1, 6, 2, 65, 65, 64, 0, False, "prefix61"),
    "hd96_group1_tq_below_tk": (2, 2, 2, 63, 129, 96, 66, True, "all"),
    "hd128_group4_causal": (1, 4, 1, 66, 66, 128, 0, True, "all"),
    "hd128_group3_negative_offset": (1, 3, 1, 40, 70, 128, -70, True, "all"),
    "hd64_group4_offset_past_tk": (1, 4, 1, 33, 80, 64, 80, True, "all"),
    "hd16_group2_fully_masked_row": (2, 4, 2, 37, 100, 16, 5, True, "masked_row"),
}


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _inputs(case):
    b, nq, nkv, tq, tk, hd, q_offset, causal, validity = CASES[case]
    rs = np.random.RandomState(7)
    q, do = _rand(rs, b, nq, tq, hd), _rand(rs, b, nq, tq, hd)
    k, v = _rand(rs, b, nkv, tk, hd), _rand(rs, b, nkv, tk, hd)
    kv_valid = np.ones((b, tk), np.int32)
    if validity.startswith("prefix"):
        kv_valid[:, int(validity[6:]):] = 0
    elif validity == "masked_row":
        kv_valid[:, 90:] = 0
        kv_valid[0, :q_offset + 1] = 0  # batch row 0, query 0 sees no key
    return q, k, v, do, kv_valid, q_offset, causal


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-30))


def _close_lse(got, want):
    """The LSE rows with an allowed key within TOL; the empty rows NEG_BIG
    on both sides."""
    got, want = got.numpy().reshape(-1), np.asarray(want).reshape(-1)
    empty = want <= NEG_BIG / 2
    assert np.array_equal(got <= NEG_BIG / 2, empty)
    assert np.all(got[empty] == np.float32(NEG_BIG))
    if (~empty).any():
        _close(got[~empty], want[~empty])
    return empty


def _jax_forward(q, k, v, kv_valid, q_offset, causal, **scaled):
    return _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid),
                          q_offset, causal, block_q=64, block_k=128, emit_lse=not scaled,
                          **scaled)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_forward_and_lse_match_pallas(case):
    """``flash_attention`` and ``flash_attention_lse``: out and the LSE."""
    q, k, v, _, kv_valid, q_offset, causal = _inputs(case)
    want_out, want_lse = _jax_forward(q, k, v, kv_valid, q_offset, causal)
    out, lse = kernels.flash_attention_fwd_lse_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset,
                                                     causal)
    _close(out, want_out)
    empty = _close_lse(lse, want_lse)
    assert torch.all(out.reshape(-1, q.shape[-1])[torch.from_numpy(empty)] == 0)
    if q_offset < 0 and causal:  # a chunk wholly in the future: every row masked
        assert empty.all()
    plain = kernels.flash_attention_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset, causal)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_dkv_matches_pallas(case):
    """``flash_attention_bwd_dkv``: dk and dv summed over each kv head's
    group, each side fed its own forward's output and LSE."""
    q, k, v, do, kv_valid, q_offset, causal = _inputs(case)
    want_out, want_lse = _jax_forward(q, k, v, kv_valid, q_offset, causal)
    _, want_dk, want_dv = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid), q_offset, want_out,
        want_lse, jnp.asarray(do), causal, 64, 128)
    out, lse = kernels.flash_attention_fwd_lse_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset,
                                                     causal)
    delta = (_t(do) * out).sum(-1)
    dk, dv = kernels.flash_attention_bwd_dkv_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset,
                                                   causal, lse, delta, _t(do))
    _close(dk, want_dk)
    _close(dv, want_dv)
    if q_offset < 0 and causal:
        assert not dk.any() and not dv.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_dq_matches_pallas(case):
    """``flash_attention_bwd_dq``: each side fed its own forward's output
    and LSE; a row with no allowed key (and every row of a chunk wholly in
    the future) gets dq exactly 0."""
    q, k, v, do, kv_valid, q_offset, causal = _inputs(case)
    want_out, want_lse = _jax_forward(q, k, v, kv_valid, q_offset, causal)
    want_dq, _, _ = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid), q_offset, want_out,
        want_lse, jnp.asarray(do), causal, 64, 128)
    out, lse = kernels.flash_attention_fwd_lse_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset,
                                                     causal)
    delta = (_t(do) * out).sum(-1)
    dq = kernels.flash_attention_bwd_dq_plain(_t(q), _t(k), _t(v), _t(kv_valid), q_offset, causal,
                                              lse, delta, _t(do))
    _close(dq, want_dq)
    empty = (lse <= NEG_BIG / 2).reshape(-1)
    assert not dq.reshape(-1, q.shape[-1])[empty].any()
    if q_offset < 0 and causal:
        assert empty.all()


@pytest.mark.parametrize("case", ["hd32_group4_tq_tk_cross_64", "hd128_group3_negative_offset",
                                  "hd16_group2_fully_masked_row"])
def test_fp32_q_int8_kv_matches_pallas(case):
    """``flash_attention_int8kv`` with fp32 q over int8 K/V and their fp32
    per-position scales."""
    q, k, v, _, kv_valid, q_offset, causal = _inputs(case)
    kq, ks = jkv.quantize_kv(jnp.asarray(k))
    vq, vs = jkv.quantize_kv(jnp.asarray(v))
    want = _jax_forward(q, kq, vq, kv_valid, q_offset, causal, k_scale=ks, v_scale=vs)
    got = kernels.flash_attention_int8kv_plain(_t(q), _t(kq), _t(vq), _t(ks), _t(vs),
                                               _t(kv_valid), q_offset, causal)
    _close(got, want)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_routes_by_dtype(dtype, int8_kv):
    """A call with more than 32 query rows per kv head: fp32 takes the 3xTF32
    forward's name (its plain version on the CPU), bf16 the tensor-core one
    and never an fp32 kernel's."""
    q, k, v, _, kv_valid, q_offset, causal = _inputs("hd32_group4_tq_tk_cross_64")
    q, k, v = (_t(a).to(dtype) for a in (q, k, v))
    scales = {}
    if int8_kv:  # the int8 cache's bytes and scales
        (k, ks), (v, vs) = (quantize_kv(t.float()) for t in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    kernels.reset_counters()
    gqa_attention(q, k, v, AttnMask(_t(kv_valid), q_offset), causal=causal, **scales)
    calls = kernels.plain_counts()
    name = ("flash_attention_int8kv" if int8_kv else "flash_attention") if (
        dtype == torch.float32) else ("flash_attention_tc_int8kv" if int8_kv else
                                      "flash_attention_tc")
    assert calls[name] == 1 and sum(calls.values()) == 1
    assert not any(calls[n] for n in FP32_KERNELS if n != name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_routes_by_dtype(dtype):
    """Under autograd fp32 runs the LSE forward and the fp32 dq and dk/dv;
    bf16 their tensor-core twins and no fp32 kernel."""
    q, k, v, do, kv_valid, q_offset, causal = _inputs("hd64_group3_noncausal_padded")
    leaves = [_t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    kernels.reset_counters()
    out = gqa_attention(*leaves, AttnMask(_t(kv_valid), q_offset), causal=causal)
    out.backward(_t(do).to(dtype))
    calls = kernels.plain_counts()
    fp32 = ("flash_attention_lse",) + _route_bwd(torch.float32)
    want = fp32 if dtype == torch.float32 else ("flash_attention_tc_lse",) + _route_bwd(dtype)
    assert {n for n, c in calls.items() if c} == set(want)
    assert all(calls[n] == 1 for n in want)
    assert (dtype == torch.float32) == ("flash_attention_bwd_dkv" in want)
    assert _route(dtype, q.shape[2], q.shape[1] // k.shape[1], False, True) == want[0]
