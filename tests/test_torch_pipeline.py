"""GPipe pipeline parallelism in the port (``parallel/pipeline.py``) on the
CPU: the nine cases of ``tests/test_pipeline.py`` re-targeted at the port,
held to the JAX package's unpipelined model on one device (what those tests
compare with), at their tolerances, plus the replicated leaves' bit-equality
across stages.

Ranks are spawned over gloo once per world size (``tests/
torch_sp_pp_ranks.py``, which imports no jax) while this module computes
the JAX oracles: world 4 runs dp=2 x pp=2, pp=4 and dp=1 x pp=2 meshes,
world 8 the 3D dp=2 x pp=2 x tp=2 one. The model is
``tests/test_pipeline.py``'s tiny causal LM (4 layers, tied head, fp32) on a
(4, 16) batch made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.configs import LLAMA32Config
from llama32mm_tpu.models.language import init_causal_lm_params, llama_forward, lm_head_apply
from llama32mm_tpu.models.vlm import shifted_cross_entropy
from llama32mm_tpu.ops.quant import quantize_llama_params
from llama32mm_tpu.train.lora import init_lora_params
from llama32mm_tpu_torch.configs import LLAMA32Config as PortConfig
from llama32mm_tpu_torch.convert import causal_lm_from_jax, lora_from_jax

import torch_sp_pp_ranks as ranks

STEPS = ranks.STEPS


def _np(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def _ref_loss(params, tc, ids, lora=None):
    out = llama_forward(params["model"], tc, input_ids=ids, lora=lora, impl="xla")
    logits = lm_head_apply(params, tc, out.hidden_states,
                           lora=None if lora is None else lora.get("lm_head"), impl="xla")
    return shifted_cross_entropy(logits.astype(jnp.float32), ids, -100)


@pytest.fixture(scope="module")
def setup():
    tc = LLAMA32Config(**ranks.PP_CONFIG)
    params = init_causal_lm_params(jax.random.PRNGKey(0), tc)
    qp = quantize_llama_params({"language_model": params},
                               quantize_lm_head=False)["language_model"]
    tc3 = LLAMA32Config(vocab_size=64, hidden_size=32, n_heads=2, n_layers=3, hidden_dim=64,
                        n_kv_groups=1, dtype="float32")
    lora = init_lora_params(jax.random.PRNGKey(7), tc, rank=4)
    inputs = {"pp_trees": {"float": _np(params), "int8": _np(qp),
                           "three": _np(init_causal_lm_params(jax.random.PRNGKey(0), tc3))},
              "pp_lora": _np(lora)}
    worlds = {w: ranks.start_world("pp", w, inputs) for w in (4, 8)}
    ids = jnp.asarray(ranks.pp_ids())
    yield {"tc": tc, "params": params, "qp": qp, "lora": lora, "ids": ids, "inputs": inputs,
           "worlds": worlds}
    for run in worlds.values():
        run.results()


def _ok(setup, world, case):
    results = setup["worlds"][world].results()
    assert case in results, f"case {case} did not run (an earlier case failed): {results.keys()}"
    for r, v in enumerate(results[case]):
        assert not (isinstance(v, tuple) and v and v[0] == "error"), f"rank {r}:\n{v[1]}"
    return results[case]


def _same_on_every_rank(values):
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(values[0]))
    return values[0]


def _named(tree) -> dict:
    """``{port parameter name: array}`` of a JAX causal-LM tree (params or
    their gradients), through the port's converter."""
    lm = causal_lm_from_jax(_np(tree), PortConfig(**ranks.PP_CONFIG), "cpu")
    return {n: p.detach().numpy() for n, p in lm.named_parameters()}


def _assemble(per_rank: list, shapes: dict) -> dict:
    """The whole tensors from the ranks' ``{name: (box, array)}``; where
    several ranks hold a part, they must agree bit for bit (a stage's
    layers are on its ranks only)."""
    out = {}
    for name, shape in shapes.items():
        whole = np.full(shape, np.nan, np.float32)
        for r in per_rank:
            if name not in r:
                continue
            box, arr = r[name]
            idx = tuple(slice(s, s + n) for s, n in box)
            seen = ~np.isnan(whole[idx])
            np.testing.assert_array_equal(whole[idx][seen], arr[seen], err_msg=name)
            whole[idx] = arr
        assert not np.isnan(whole).any(), name
        out[name] = whole
    return out


@pytest.fixture(scope="module")
def jax_grads(setup):
    tc, ids = setup["tc"], setup["ids"]
    return _named(jax.grad(lambda p: _ref_loss(p, tc, ids))(setup["params"]))


@pytest.mark.parametrize("label", ["dp2_pp2", "pp4"])
def test_pipeline_loss_matches_unpipelined(setup, label):
    want = float(_ref_loss(setup["params"], setup["tc"], setup["ids"]))
    res = _ok(setup, 4, "pp_losses")
    assert {r[label]["layers"] for r in res} == {4 // {"dp2_pp2": 2, "pp4": 4}[label]}
    np.testing.assert_allclose(_same_on_every_rank([r[label]["loss"] for r in res]), want,
                               rtol=1e-5)


def _check_grads(per_rank, want):
    got = _assemble(per_rank, {n: w.shape for n, w in want.items()})
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=5e-5, atol=5e-6, err_msg=name)


def test_pipeline_grads_match_unpipelined(setup, jax_grads):
    """Every parameter's gradient at dp=2 x pp=2 (summed over dp): the
    stages' layers, and the embedding, final norm and tied head whole and
    bit-equal on every stage."""
    _check_grads([r["grads"] for r in _ok(setup, 4, "pp_grads")], jax_grads)


def test_pipeline_remat_exact(setup):
    """remat recomputes each layer within its stage: the same gradients."""
    for r in _ok(setup, 4, "pp_remat")[:2]:
        for name, (box, plain) in r["plain"].items():
            np.testing.assert_allclose(r["remat"][name][1], plain, rtol=1e-6, err_msg=name)


def test_pipeline_train_step_matches_unpipelined(setup):
    """Three Adam steps through the pipeline equal three through the plain
    model; the moments live on their stage; the replicated leaves are
    bit-equal on every rank after every step."""
    import optax

    tc, ids = setup["tc"], setup["ids"]
    tx = optax.adam(1e-3)
    ref_p, opt, ref_losses = setup["params"], tx.init(setup["params"]), []
    for _ in range(STEPS):
        loss, grads = jax.value_and_grad(lambda p: _ref_loss(p, tc, ids))(ref_p)
        updates, opt = tx.update(grads, opt, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        ref_losses.append(float(loss))
    res = _ok(setup, 4, "pp_train")
    losses = _same_on_every_rank([r["losses"] for r in res])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for i in range(STEPS):
        for name in res[0]["replicated"][i]:
            _same_on_every_rank([r["replicated"][i][name] for r in res])
    for r in res:  # a stage's moments: its own two layers and the replicated leaves
        layers = {n.split(".")[2] for n in r["moments"] if ".blocks." in n}
        assert len(layers) == 2, r["moments"]
    want = _named(ref_p)
    got = _assemble([r["params"] for r in res], {n: w.shape for n, w in want.items()})
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-6, err_msg=name)


def test_pipeline_3d_pp_tp_dp(setup, jax_grads):
    """dp=2 x pp=2 x tp=2: the loss and every gradient equal the
    unpipelined model's; each rank's w_gate gradient is its stage's layers'
    tp slice."""
    want = float(_ref_loss(setup["params"], setup["tc"], setup["ids"]))
    res = _ok(setup, 8, "pp_3d")
    np.testing.assert_allclose(_same_on_every_rank([r["loss"] for r in res]), want, rtol=1e-5)
    _check_grads([r["grads"] for r in res], jax_grads)
    tc = setup["tc"]
    for rank, r in enumerate(res):
        stage = rank // 2 % 2
        gates = {n: box for n, (box, _) in r["grads"].items() if n.endswith("ff.w_gate.weight")}
        assert {int(n.split(".")[2]) for n in gates} == {2 * stage, 2 * stage + 1}
        assert all(box[0][1] == tc.hidden_dim // 2 for box in gates.values())


def test_pipeline_chunked_ce_matches_full(setup):
    for full, chunked in _ok(setup, 4, "pp_chunked")[:2]:
        np.testing.assert_allclose(chunked, full, rtol=1e-6)


def test_pipeline_over_quantized_base(setup):
    """int8 block linears stage like float ones."""
    want = float(_ref_loss(setup["qp"], setup["tc"], setup["ids"]))
    res = _ok(setup, 4, "pp_quantized")
    assert all("torch.int8" in r["int8_blocks"] for r in res)
    np.testing.assert_allclose(_same_on_every_rank([r["loss"] for r in res]), want, rtol=1e-5)


def _port_qlora_steps(setup, steps: int) -> dict:
    """The port's unpipelined QLoRA: ``steps`` Adam steps (lr 1e-2) of the
    adapters over the whole int8 model on one device."""
    from llama32mm_tpu_torch.models.language import llama_forward as port_forward
    from llama32mm_tpu_torch.models.language import lm_head_apply as port_head
    from llama32mm_tpu_torch.models.vlm import shifted_cross_entropy as port_ce
    from llama32mm_tpu_torch.train.lora import lora_leaves
    from llama32mm_tpu_torch.train.optim import Adam

    lm = causal_lm_from_jax(setup["inputs"]["pp_trees"]["int8"], PortConfig(**ranks.PP_CONFIG),
                            "cpu")
    lora = lora_from_jax(setup["inputs"]["pp_lora"], "cpu")
    flat = lora_leaves(lora)
    for t in flat.values():
        t.requires_grad_(True)
    tx, ids = Adam(1e-2), torch.from_numpy(ranks.pp_ids())
    state = tx.init(flat)
    for _ in range(steps):
        h = port_forward(lm.model, lm.config, input_ids=ids, lora=lora).hidden_states
        loss = port_ce(port_head(lm, lm.config, h, lora=lora["lm_head"]).float(), ids, -100)
        state = tx.step(flat, dict(zip(flat, torch.autograd.grad(loss, list(flat.values())))),
                        state)
    return {k: t.detach().numpy() for k, t in flat.items()}


def test_pipeline_qlora_matches_unpipelined(setup):
    """QLoRA through the pipeline: adapters and their moments stage-local
    beside their frozen int8 layers; the losses of 2 steps equal the
    unpipelined JAX LoRA path's, the adapters after them the port's own
    unpipelined run's (the JAX test's pipelined-against-unpipelined check;
    the port and JAX differ by more than its 1e-7 on a few elements whose
    gradient is small, unpipelined alike); the head adapter bit-equal on
    every stage after every step; the base unchanged."""
    import optax

    tc, ids, qp = setup["tc"], setup["ids"], setup["qp"]
    tx = optax.adam(1e-2)
    ref_lo, ref_opt, ref_losses = setup["lora"], tx.init(setup["lora"]), []
    for _ in range(2):
        loss, g = jax.value_and_grad(lambda lo: _ref_loss(qp, tc, ids, lo))(ref_lo)
        up, ref_opt = tx.update(g, ref_opt, ref_lo)
        ref_lo = optax.apply_updates(ref_lo, up)
        ref_losses.append(float(loss))
    res = _ok(setup, 4, "pp_qlora")
    np.testing.assert_allclose(_same_on_every_rank([r["losses"] for r in res]), ref_losses,
                               rtol=1e-5)
    for i in range(2):
        for leaf in ("lora_a", "lora_b", "scaling"):
            _same_on_every_rank([r["heads"][i][leaf] for r in res])
    want_b = _port_qlora_steps(setup, 2)["blocks.W_query.lora_b"]
    for r in res:
        assert r["base_unchanged"]
        assert r["mu_shape"] == (2, 4, tc.n_heads * tc.head_dim)  # the stage's 2 layers
        np.testing.assert_allclose(r["W_query_b"], want_b[r["first"]:r["first"] + 2],
                                   rtol=5e-5, atol=1e-7)


def test_pipeline_validation(setup):
    """n_layers % pp, a batch that dp * microbatches does not divide, and a
    mesh with both sp and pp raise ValueError."""
    res = _ok(setup, 4, "pp_validation")
    for r in res:
        assert "must divide" in r["batch"], r
        assert "sp > 1 and pp > 1" in r["sp_and_pp"], r
    for r in res[:2]:
        assert "divisible" in r["layers"], r
