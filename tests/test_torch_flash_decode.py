"""The split-KV flash decode's plain version (the algorithm the CUDA kernels
run: per-split partials at fixed absolute key ranges, merged in split order)
against the JAX package's flash kernel in interpret mode and its densified
per-row path, its batch- and length-invariance, and the attention route.
Inputs come from numpy with a fixed seed; everything is fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops import attention as jattn
from llama32mm_tpu.ops.pallas.attention import flash_gqa_attention
from llama32mm_tpu.utils import kvcache as jkv
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, _route, gqa_attention
from llama32mm_tpu_torch.ops.cuda.flash_decode import (
    DECODE_MAX_ROWS,
    KV_SPLIT,
    flash_decode_int8kv_plain,
    flash_decode_plain,
)

NKV, TK, Q_OFFSET = 2, 200, 150


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, g, tq, hd, tk=TK):
    """q, k, v and a key validity with holes and an invalid cache tail past
    the last query (position ``Q_OFFSET + tq - 1``)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, NKV * g, tq, hd).astype(np.float32)
    k, v = (rs.randn(b, NKV, tk, hd).astype(np.float32) for _ in range(2))
    kv_valid = (rs.rand(b, tk) > 0.3).astype(np.int32)
    kv_valid[:, Q_OFFSET + tq:] = 0
    return q, k, v, kv_valid


def _int8(k, v):
    (kq, ks), (vq, vs) = (jkv.quantize_kv(jnp.asarray(a)) for a in (k, v))
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("hd", [16, 80, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("tq", [1, 3])
def test_split_kv_matches_pallas(tq, g, hd):
    """split=16: 13 splits, those past the causal limit empty."""
    q, k, v, kv_valid = _inputs(0, 2, g, tq, hd)
    want = flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(kv_valid), Q_OFFSET, block_q=8, block_k=128)
    got = flash_decode_plain(_t(q), _t(k), _t(v), _t(kv_valid), Q_OFFSET, split=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("tq", [1, 3])
def test_split_kv_int8_matches_pallas(tq):
    q, k, v, kv_valid = _inputs(1, 2, 4, tq, 64)
    kq, vq, ks, vs = _int8(k, v)
    want = flash_gqa_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                               jnp.asarray(kv_valid), Q_OFFSET, block_q=8, block_k=128,
                               k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = flash_decode_int8kv_plain(_t(q), _t(kq), _t(vq), _t(ks), _t(vs), _t(kv_valid),
                                    Q_OFFSET, split=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_split_kv_per_row_offsets_match_jax_dense(int8_kv):
    """Per-row offsets (the server's slots at their own fill levels) against
    the JAX package's densified per-row mask."""
    q, k, v, kv_valid = _inputs(2, 3, 4, 1, 32)
    offsets = np.array([150, 37, 199], np.int32)
    kv_valid = (np.arange(TK)[None, :] <= offsets[:, None]).astype(np.int32)
    kv_valid[:, 20:30] = 0  # a bucket-padding hole
    ks = vs = None
    if int8_kv:
        k, v, ks, vs = _int8(k, v)
    want = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               structured=jattn.AttnMask(jnp.asarray(kv_valid),
                                                         jnp.asarray(offsets)),
                               impl="xla", k_scale=None if ks is None else jnp.asarray(ks),
                               v_scale=None if vs is None else jnp.asarray(vs))
    if int8_kv:
        got = flash_decode_int8kv_plain(_t(q), _t(k), _t(v), _t(ks), _t(vs), _t(kv_valid),
                                        _t(offsets), split=16)
    else:
        got = flash_decode_plain(_t(q), _t(k), _t(v), _t(kv_valid), _t(offsets), split=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_split_kv_row_is_batch_and_length_invariant(int8_kv):
    """A row's bits depend only on its own keys: row 1 of a B=3 call equals
    the same row alone, and a cache of 264 slots whose tail is invalid gives
    the 200-slot result."""
    q, k, v, kv_valid = _inputs(3, 3, 4, 1, 16, tk=264)
    kv_valid[:, TK:] = 0
    offsets = np.array([60, Q_OFFSET, 199], np.int32)

    def run(rows, tk, offs):
        kk, vv, valid = k[rows, :, :tk], v[rows, :, :tk], _t(kv_valid[rows, :tk])
        if int8_kv:
            kq, vq, ks, vs = _int8(kk, vv)
            return flash_decode_int8kv_plain(_t(q[rows]), _t(kq), _t(vq), _t(ks), _t(vs), valid,
                                             offs)
        return flash_decode_plain(_t(q[rows]), _t(kk), _t(vv), valid, offs)

    batch = run(slice(0, 3), 264, _t(offsets))
    alone = run(slice(1, 2), 264, int(offsets[1]))
    short = run(slice(1, 2), TK, int(offsets[1]))
    assert torch.equal(batch[1:2], alone)
    assert torch.equal(alone, short)


def test_split_kv_row_without_allowed_key_is_zero():
    q, k, v, _ = _inputs(4, 2, 4, 3, 16)
    kv_valid = np.ones((2, TK), np.int32)
    kv_valid[0, :Q_OFFSET + 1] = 0  # batch row 0, query 0 sees no key
    got = flash_decode_plain(_t(q), _t(k), _t(v), _t(kv_valid), Q_OFFSET)
    assert torch.all(got[0, :, 0] == 0)
    assert torch.all(got[0, :, 1:] != 0) and torch.all(got[1] != 0)


@pytest.mark.parametrize("dtype,tq,group,int8_kv,grad,want", [
    (torch.bfloat16, 1632, 4, False, False, "flash_attention_tc"),
    (torch.bfloat16, 1632, 4, True, False, "flash_attention_tc_int8kv"),
    (torch.bfloat16, 1600, 1, False, False, "flash_attention_tc"),  # the ViT
    (torch.float32, 1632, 4, False, False, "flash_attention"),
    (torch.float32, 1632, 4, True, False, "flash_attention_int8kv"),
    (torch.bfloat16, 1, 4, False, False, "flash_decode"),
    (torch.float32, 1, 4, True, False, "flash_decode_int8kv"),
    (torch.bfloat16, 8, 4, False, False, "flash_decode"),
    (torch.bfloat16, 9, 4, False, False, "flash_attention_tc"),
    (torch.bfloat16, 1632, 4, False, True, "flash_attention_tc_lse"),
    (torch.float32, 1, 4, False, True, "flash_attention_lse"),
])
def test_route(dtype, tq, group, int8_kv, grad, want):
    assert _route(dtype, tq, group, int8_kv, grad) == want
    assert want in kernels.KERNELS


def test_cpu_decode_call_runs_split_kv_plain():
    q, k, v, kv_valid = _inputs(5, 1, 4, 1, 16)
    assert 4 <= DECODE_MAX_ROWS and TK > KV_SPLIT  # more than one split
    kernels.reset_counters()
    got = gqa_attention(_t(q), _t(k), _t(v), AttnMask(_t(kv_valid), Q_OFFSET))
    assert flash_decode_plain.calls == 1 and sum(kernels.plain_counts().values()) == 1
    want = kernels.flash_attention_plain(_t(q), _t(k), _t(v), _t(kv_valid), Q_OFFSET)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_bf16_prefill_runs_the_tensor_core_route_plain(grad):
    """A bf16 call with more than 32 query rows per kv head takes the
    tensor-core forward's plain version (its LSE twin under autograd)."""
    q, k, v, kv_valid = _inputs(6, 1, 4, 12, 16, tk=40)
    q, k, v = (_t(a).to(torch.bfloat16).requires_grad_(grad) for a in (q, k, v))
    kernels.reset_counters()
    got = gqa_attention(q, k, v, AttnMask(_t(kv_valid), 20))
    name = "flash_attention_tc_lse" if grad else "flash_attention_tc"
    assert kernels.plain_counts()[name] == 1 and sum(kernels.plain_counts().values()) == 1
    want = kernels.flash_attention_plain(q.detach(), k.detach(), v.detach(), _t(kv_valid), 20)
    assert torch.equal(got.detach(), want)
    if grad:
        got.float().sum().backward()
        assert q.grad is not None and k.grad is not None and v.grad is not None
