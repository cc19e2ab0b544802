"""The port's speculative-decoding verifier (``utils/sampling.py::
spec_verify_tokens``) against the JAX package's: greedy rows equal, bit for
bit, with and without a repetition penalty, also beside sampled rows; the
first committed token of a sampled row distributed as the row's filtered
``p``. And the server's verify mask: the JAX server's dense ``mask4`` and the
port's structured mask (``kv_valid | [wp, wp+K]``, ``q_offset = wp``, causal)
give the same attention on a state with holes and stale slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.ops.attention import gqa_attention as jax_gqa_attention
from llama32mm_tpu.utils.sampling import spec_verify_tokens as jax_spec_verify
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.utils.sampling import filter_logits_traced, spec_verify_tokens

B, K, V = 4, 3, 40


def _case(seed, b=B, k=K, v=V):
    """Seeded logits ``[b, k+1, v]`` and drafts ``[b, k]``; about half of the
    drafts are the argmax, so acceptance runs of every length occur."""
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, k + 1, v) * 3.0).astype(np.float32)
    drafts = rs.randint(0, v, (b, k))
    hit = rs.rand(b, k) < 0.6
    drafts = np.where(hit, logits[:, :k].argmax(-1), drafts)
    return logits, drafts


def _settings(temps, top_p=0.9, top_k=20, min_p=0.0):
    n = len(temps)
    return (np.asarray(temps, np.float32), np.full(n, top_p, np.float32),
            np.full(n, top_k, np.int32), np.full(n, min_p, np.float32))


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("penalty", [None, 1.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_verify_matches_jax(seed, penalty):
    logits, drafts = _case(seed)
    samp = _settings([0.0] * B)
    pres = pen = None
    if penalty is not None:
        pres = np.random.RandomState(seed + 10).rand(B, V) < 0.3
        pen = np.full(B, penalty, np.float32)
    j_nxt, j_acc = jax_spec_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(0),
        *[jnp.asarray(a) for a in samp],
        presence=None if pres is None else jnp.asarray(pres),
        penalty=None if pen is None else jnp.asarray(pen))
    args = dict(presence=None if pres is None else torch.from_numpy(pres),
                penalty=None if pen is None else torch.from_numpy(pen))
    for all_greedy in (True, False):
        nxt, acc = spec_verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts),
                                      torch.Generator().manual_seed(0), *_torch(samp),
                                      all_greedy=all_greedy, **args)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_nxt))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    lengths = np.cumprod(np.asarray(j_acc), axis=1).sum(axis=1)
    assert len(set(lengths.tolist())) > 1  # the case is not degenerate


def test_mixed_batch_keeps_greedy_rows_exact():
    logits, drafts = _case(3)
    samp = _settings([0.0, 0.8, 0.0, 1.2])
    j_nxt, j_acc = jax_spec_verify(jnp.asarray(logits), jnp.asarray(drafts),
                                   jax.random.PRNGKey(1), *[jnp.asarray(a) for a in samp])
    nxt, acc = spec_verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts),
                                  torch.Generator().manual_seed(1), *_torch(samp))
    for row in (0, 2):
        np.testing.assert_array_equal(nxt[row].numpy(), np.asarray(j_nxt)[row])
        np.testing.assert_array_equal(acc[row].numpy(), np.asarray(j_acc)[row])
    # a sampled row commits only tokens its filter keeps; an accepted draft stays the draft
    filt = filter_logits_traced(torch.from_numpy(logits).reshape(-1, V),
                                *[t.repeat_interleave(K + 1) for t in _torch(samp)[:3]])
    kept = torch.isfinite(filt).reshape(B, K + 1, V)
    for row in (1, 3):
        assert bool(kept[row].gather(1, nxt[row][:, None]).all())
        assert bool((nxt[row, :K][acc[row]] == torch.from_numpy(drafts)[row][acc[row]]).all())


def test_out_of_vocab_draft_is_never_accepted():
    logits, drafts = _case(4)
    drafts[:, 0] = V  # e.g. the image placeholder, one past the vocabulary
    for temps in ([0.0] * B, [0.7] * B):
        _, acc = spec_verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts),
                                    torch.Generator().manual_seed(2), *_torch(_settings(temps)))
        assert not bool(acc[:, 0].any())


N_DRAWS, TV_BOUND = 4000, 0.05  # as the JAX package's test


@pytest.mark.parametrize("which", ["likely", "unlikely"])
def test_committed_token_distribution(which):
    """The first committed token (the accepted draft, or the replacement
    after a miss) is distributed as the row's filtered ``p``: total variation
    below ``TV_BOUND`` over ``N_DRAWS`` draws (one batch of identical rows);
    so is the bonus token after an accepted likely draft."""
    rs = np.random.RandomState(3)
    v = 16
    logits = torch.from_numpy((rs.randn(1, 2, v) * 2.0).astype(np.float32))
    temp, top_p, top_k = torch.tensor([0.8]), torch.tensor([0.95]), torch.tensor([12])
    p = torch.softmax(filter_logits_traced(logits[:, 0], temp, top_p, top_k), dim=-1)[0]
    p_bonus = torch.softmax(filter_logits_traced(logits[:, 1], temp, top_p, top_k), dim=-1)[0]
    draft = int(p.argmax()) if which == "likely" else int(torch.where(p > 0, p, 2.0).argmin())
    n = N_DRAWS
    nxt, acc = spec_verify_tokens(
        logits.expand(n, 2, v), torch.full((n, 1), draft), torch.Generator().manual_seed(11),
        temp.expand(n), top_p.expand(n), top_k.expand(n))
    emp = torch.bincount(nxt[:, 0], minlength=v).double() / n
    tv = 0.5 * (emp - p.double()).abs().sum().item()
    assert tv < TV_BOUND, (draft, tv)
    assert bool((p[nxt[:, 0]] > 0).all())  # filtered-out tokens are never committed
    if which == "likely":  # enough accepted drafts to see the bonus token's law
        bonus = nxt[acc[:, 0], 1]
        emp_b = torch.bincount(bonus, minlength=v).double() / len(bonus)
        tv_b = 0.5 * (emp_b - p_bonus.double()).abs().sum().item()
        # the same bound, scaled for the smaller sample
        assert len(bonus) > 500 and tv_b < TV_BOUND * (n / len(bonus)) ** 0.5, (len(bonus), tv_b)


@pytest.mark.parametrize("k", [2, 3])
def test_structured_verify_mask_equals_dense(k):
    """The JAX server's dense verify mask (``inference/server.py``'s
    ``mask4``: a slot's valid keys, or the new slots ``wp..wp+j`` for fed
    token ``j``) against the port's structured one, on slots whose valid
    keys have holes (bucket padding), whose cache holds stale entries past
    ``wp``, and one clamped idle slot. Every valid key lies below ``wp``."""
    rs = np.random.RandomState(k)
    b, nq, nkv, hd, s = 4, 4, 2, 8, 24
    pos = np.array([7, 12, 3, s - 1])  # the last: an idle slot at the cache's end
    kv_valid = np.zeros((b, s), np.int32)
    for row, p in enumerate(pos[:3]):
        kv_valid[row, :p] = 1
        kv_valid[row, rs.randint(1, p)] = 0  # a hole below the write position
    wp = np.clip(pos, 0, s - 1 - k)
    q = rs.randn(b, nq, k + 1, hd).astype(np.float32)
    kk = rs.randn(b, nkv, s, hd).astype(np.float32)  # stale entries everywhere
    vv = rs.randn(b, nkv, s, hd).astype(np.float32)

    karange, jr = np.arange(s)[None, :], np.arange(k + 1)
    new_ok = ((karange[:, None, :] >= wp[:, None, None])
              & (karange[:, None, :] <= wp[:, None, None] + jr[None, :, None]))
    attend = (kv_valid != 0)[:, None, :] | new_ok
    mask4 = np.where(attend[:, None], 0.0, np.finfo(np.float32).min).astype(np.float32)
    want = jax_gqa_attention(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                             mask=jnp.asarray(mask4), impl="xla")

    valid = (kv_valid != 0) | ((karange >= wp[:, None]) & (karange <= wp[:, None] + k))
    mask = AttnMask(kv_valid=torch.from_numpy(valid.astype(np.int32)),
                    q_offset=torch.from_numpy(wp.astype(np.int32)))
    got = gqa_attention(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv), mask,
                        causal=True, impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
