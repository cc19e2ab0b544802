"""The port's checkpoint loader and saver (``llama32mm_tpu_torch/io/checkpoint.py``)
against the JAX package's on the same files: the translation tables, the
manifest preflight on the real 11B-Vision manifest, ``build_config_from_hf``,
loads of checkpoints the JAX package wrote (and JAX loads of the port's),
bit for bit in fp32 and bf16, tied and untied, sharded with an index; the
hub layout, row gaps and vocab padding with equal ``LoadReport``s; the
streaming quantized loads (int8, uniform int4 and ``INT4_MIXED_RECIPE``,
whose per-leaf bits the JAX loader ignores). Tiny shapes, numpy/JAX seeds,
CPU."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from llama32mm_tpu import init_vlm_params
from llama32mm_tpu.configs import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.io import checkpoint as jck
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.io import checkpoint as ck
from llama32mm_tpu_torch.models.common import QuantLinear
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ASSETS, "llama32_11b_vision_manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def hub_config():
    with open(os.path.join(ASSETS, "llama32_11b_vision_config.json")) as f:
        return json.load(f)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_models_equal(got, want, skip=()):
    """Every parameter and buffer bit-equal, names in the same order; ``skip``
    holds state-dict names filled from init (drawn differently per package)."""
    a, b = got.state_dict(), want.state_dict()
    assert list(a) == list(b)
    for name in a:
        if name in skip:
            continue
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), path


def _reports_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# Tables, manifest, config
# ---------------------------------------------------------------------------


def test_translation_tables_match_jax(manifest):
    for name in ("_UNSUPPORTED_PREFIXES", "_TEXT_LAYER_LEAVES", "_VISION_LAYER_LEAVES",
                 "_VISION_HUB_LAYER_LEAVES", "_GLOBAL_LEAVES"):
        assert getattr(ck, name) == getattr(jck, name), name
    keys = list(manifest) + [
        "vision_model.vision_model.encoder.layers.7.self_attn.out_proj.bias",
        "vision_model.vision_model.patch_embedding.weight",
        "language_model.model.layers.3.mlp.unknown.weight",
        "multi_modal_projector.linear_1.weight", "something.else",
    ]
    for key in keys:
        assert ck.translate_hf_key(key) == jck.translate_hf_key(key), key


@pytest.mark.parametrize("which", ["tiny", "11b"])
def test_reference_shapes_match_jax(which, hub_config):
    """The port's view of the JAX tree (paths, shapes, order) is the JAX
    loader's ``_ref_shapes``."""
    if which == "tiny":
        jcfg, cfg = jax_tiny_config(), tiny_mllama_config()
    else:
        jcfg = jck.build_config_from_hf(hub_config)
        cfg = ck.build_config_from_hf(hub_config)

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), tuple(v.shape)

    assert list(walk(jck._ref_shapes(jcfg))) == list(ck._ref_shapes(cfg).items())


@pytest.mark.parametrize("form", ["shapes", "keys", "index_dir"])
def test_preflight_manifest_matches_jax(form, manifest, hub_config, tmp_path):
    """On the 906-key 11B-Vision manifest: the same skipped keys, missing
    leaves and cross-attention row gaps, list for list."""
    assert len(manifest) == 906
    if form == "shapes":
        arg = manifest
    elif form == "keys":
        arg = list(manifest)
    else:
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": {k: "model-00001.safetensors" for k in manifest}}, f)
        arg = str(tmp_path)
    got = ck.preflight_manifest(arg, ck.build_config_from_hf(hub_config))
    want = jck.preflight_manifest(arg, jck.build_config_from_hf(hub_config))
    _reports_equal(got, want)
    assert len(got.row_missing) == 4
    if form == "shapes":
        assert "multi_modal_projector.weight (shape mismatch)" in got.skipped


def _config_fields(cfg):
    out = {k: getattr(cfg, k) for k in ("ignore_index", "image_token_index", "vocab_size",
                                        "projection_dim", "hidden_size", "pad_token_index")}
    for sub in ("text_config", "vision_config"):
        c = getattr(cfg, sub)
        out[sub] = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    return out


@pytest.mark.parametrize("variant", ["hub", "plain_names"])
def test_build_config_from_hf_matches_jax(variant, hub_config):
    """The real config (``rope_scaling``, the hub's ``attention_heads`` /
    ``norm_eps``) and one with the plain names and no rope scaling."""
    cfg = hub_config
    if variant == "plain_names":
        cfg = json.loads(json.dumps(hub_config))
        cfg["text_config"].pop("rope_scaling", None)
        vc = cfg["vision_config"]
        vc["num_attention_heads"] = vc.pop("attention_heads")
        vc["layer_norm_eps"] = vc.pop("norm_eps")
    got = ck.build_config_from_hf(cfg, pad_token_id=7, dtype="float32", max_cache_length=512)
    want = jck.build_config_from_hf(cfg, pad_token_id=7, dtype="float32", max_cache_length=512)
    assert _config_fields(got) == _config_fields(want)
    if variant == "hub":
        assert got.text_config.rope_freq_dict["factor"] == 8.0


# ---------------------------------------------------------------------------
# Loads and saves against the JAX package
# ---------------------------------------------------------------------------


def _jax_params(dtype, tied, seed=3):
    jcfg = jax_tiny_config(dtype=dtype)
    return jcfg, init_vlm_params(jax.random.PRNGKey(seed), jcfg, tie_weights=tied)


@pytest.mark.parametrize("dtype,tied,shard_bytes", [
    ("float32", False, None), ("bfloat16", False, 64 * 1024),
    ("float32", True, 64 * 1024), ("bfloat16", True, None),
])
def test_loads_and_saves_bit_equal_to_jax(dtype, tied, shard_bytes, tmp_path):
    """A JAX-written checkpoint loads (host and streaming) into exactly
    ``from_jax_params`` of the JAX load, with an equal report; the port's
    save of that model loads in JAX into exactly the JAX load."""
    jcfg, params = _jax_params(dtype, tied)
    cfg = tiny_mllama_config(dtype=dtype)
    kw = {} if shard_bytes is None else {"max_shard_bytes": shard_bytes}
    jck.save_checkpoint_params(str(tmp_path / "jax"), params, jcfg, **kw)
    if shard_bytes is not None:
        assert os.path.exists(tmp_path / "jax" / "model.safetensors.index.json")

    jax_loaded, jax_report = jck.load_checkpoint_params(str(tmp_path / "jax"), jcfg,
                                                        verbose=False, return_report=True)
    want = from_jax_params(_np_tree(jax_loaded), cfg, "cpu")
    for streaming in (False, True):
        got, report = ck.load_checkpoint_params(str(tmp_path / "jax"), cfg, "cpu", verbose=False,
                                                streaming=streaming, return_report=True)
        _reports_equal(report, jax_report)
        assert (got.language_model.lm_head is None) == tied
        _assert_models_equal(got, want)

    ck.save_checkpoint_params(str(tmp_path / "port"), got, cfg, **kw)
    files = sorted(os.listdir(tmp_path / "port"))
    assert ("model.safetensors.index.json" in files) == (shard_bytes is not None)
    with open(tmp_path / "port" / "config.json") as f, open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)
    if shard_bytes is not None:
        with open(tmp_path / "port" / "model.safetensors.index.json") as f:
            index = json.load(f)
        assert set(index["weight_map"].values()) == {x for x in files if x.endswith(".safetensors")}
    back = jck.load_checkpoint_params(str(tmp_path / "port"), jcfg, verbose=False)
    _assert_trees_equal(back, jax_loaded)


def _flat_st(path):
    import safetensors.numpy as stnp

    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors"):
            out.update(stnp.load_file(os.path.join(path, f)))
            os.remove(os.path.join(path, f))
    return out


def _skip_names(model, report):
    """State-dict names of what the report says came from init: whole
    missing leaves, and the rows of ``row_missing``."""
    rows = {m: None for m in report.missing}
    for entry in report.row_missing:
        leaf, gaps = entry.split(" rows ")
        rows[leaf] = json.loads(gaps)
    by_id = {id(t): name for name, t in model.state_dict(keep_vars=True).items()}
    return {by_id[id(dst)] for dst, path, layer, _ in ck._entries(model)
            if ".".join(path) in rows
            and (rows[".".join(path)] is None or layer in rows[".".join(path)])}


@pytest.mark.parametrize("streaming", [False, True])
def test_row_gaps_and_vocab_padding_report_like_jax(streaming, tmp_path):
    """Layer 1's self_attn keys dropped and 8 vocab-padding rows on the
    embedding and the head: the same report (row gaps, padding notes) as
    the JAX loader; the gap rows come from the port's init (not zeros),
    everything else equals the JAX load."""
    from safetensors.numpy import save_file

    jcfg, params = _jax_params("float32", tied=False)
    cfg = tiny_mllama_config()
    jck.save_checkpoint_params(str(tmp_path), params, jcfg)
    tensors = _flat_st(tmp_path)
    for k in [k for k in tensors if k.startswith("language_model.model.layers.1.self_attn.")]:
        del tensors[k]
    rs = np.random.RandomState(0)
    for k in ("language_model.model.embed_tokens.weight", "language_model.lm_head.weight"):
        pad = rs.randn(8, tensors[k].shape[1]).astype(np.float32)
        tensors[k] = np.concatenate([tensors[k], pad])
    save_file(tensors, str(tmp_path / "model.safetensors"))

    jax_loaded, jax_report = jck.load_checkpoint_params(
        str(tmp_path), jcfg, verbose=False, streaming=streaming, return_report=True)
    got, report = ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", verbose=False,
                                            streaming=streaming, return_report=True)
    _reports_equal(report, jax_report)
    assert len(report.row_missing) == 4 and len(report.notes) == 2
    assert "dropped 8 vocab-padding rows" in report.notes[0]
    want = from_jax_params(_np_tree(jax_loaded), cfg, "cpu")
    gaps = _skip_names(got, report)
    assert len(gaps) == 4
    _assert_models_equal(got, want, skip=gaps)
    att = got.language_model.model.blocks[1].att
    for lin in (att.W_query, att.W_key, att.W_value, att.out_proj):
        w = lin.weight
        bound = 1.0 / np.sqrt(w.shape[1])
        assert w.abs().max() > 0 and w.abs().max() <= bound


def test_hub_layout_loads_like_jax(tmp_path):
    """A checkpoint in the real Mllama hub layout (``vision_model.transformer.
    layers.*``, bare projector, dropped subsystems, no vision biases): the
    same report as the JAX loader, every loaded leaf bit-equal."""
    from safetensors.numpy import save_file

    jcfg, params = _jax_params("float32", tied=False, seed=5)
    cfg = tiny_mllama_config()
    v = params["vision_model"]
    lyr = v["layers"]
    tensors = {}
    for i in range(jcfg.vision_config.num_hidden_layers):
        pre = f"vision_model.transformer.layers.{i}"
        for hf_ln, local in (("input_layernorm", "layernorm1"),
                             ("post_attention_layernorm", "layernorm2")):
            for wb in ("weight", "bias"):
                tensors[f"{pre}.{hf_ln}.{wb}"] = np.asarray(lyr[local][wb][i])
        for hf_p, local in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                            ("v_proj", "v_proj"), ("o_proj", "out_proj")):
            tensors[f"{pre}.self_attn.{hf_p}.weight"] = np.asarray(
                lyr["self_attn"][local]["weight"][i]).T.copy()
        for fc in ("fc1", "fc2"):
            tensors[f"{pre}.mlp.{fc}.weight"] = np.asarray(lyr["mlp"][fc]["weight"][i]).T.copy()
            tensors[f"{pre}.mlp.{fc}.bias"] = np.asarray(lyr["mlp"][fc]["bias"][i])
    pw = np.asarray(v["embeddings"]["patch_embedding"]["weight"])
    p = jcfg.vision_config.patch_size
    tensors["vision_model.patch_embedding.weight"] = (
        pw.T.reshape(pw.shape[1], jcfg.vision_config.num_channels, p, p).copy())
    for wb in ("weight", "bias"):
        tensors[f"vision_model.layernorm_post.{wb}"] = np.asarray(v["post_layernorm"][wb])
    proj = params["multi_modal_projector"]["linear"]
    tensors["multi_modal_projector.weight"] = np.asarray(proj["weight"]).T.copy()
    tensors["multi_modal_projector.bias"] = np.asarray(proj["bias"])
    tensors["vision_model.class_embedding"] = np.zeros(32, np.float32)
    tensors["vision_model.layernorm_pre.weight"] = np.ones(32, np.float32)
    tensors["language_model.model.layers.0.cross_attn.q_proj.weight"] = np.zeros((4, 4), np.float32)
    save_file(tensors, str(tmp_path / "model.safetensors"))

    jax_loaded, jax_report = jck.load_checkpoint_params(str(tmp_path), jcfg, verbose=False,
                                                        return_report=True)
    got, report = ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", verbose=False,
                                            return_report=True)
    _reports_equal(report, jax_report)
    assert "vision_model.class_embedding" in report.skipped
    assert "vision_model.layers.self_attn.q_proj.bias" in report.missing
    assert "language_model.model.tok_emb.weight" in report.missing
    want = from_jax_params(_np_tree(jax_loaded), cfg, "cpu")
    _assert_models_equal(got, want, skip=_skip_names(got, report))
    torch.testing.assert_close(got.vision_model.patch_embedding.weight,
                               torch.from_numpy(pw.T.copy()), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Quantize-on-load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_mixed"])
def test_streaming_quantized_load(mode, tmp_path, monkeypatch):
    """int8 and uniform int4: every QuantLinear byte and scale equal to the
    JAX streaming loader's. ``INT4_MIXED_RECIPE``: the decoder stacks equal
    JAX ``quantize_llama_params(recipe=...)`` of the float load and the head
    ``jax.jit(quantize_weight_int4)`` of it, each leaf at its recipe's bits —
    where the JAX loader makes every leaf int4. Embeddings, norms, the
    vision tower and the projector stay float and equal. Rows are quantized
    48 at a time here, so every weight ends in a ragged block."""
    monkeypatch.setattr(ck, "_QUANT_ROWS", 48)
    jcfg, params = _jax_params("float32", tied=False)
    cfg = tiny_mllama_config()
    jck.save_checkpoint_params(str(tmp_path), params, jcfg)
    g = 32
    kw = dict(quantize_int8=True) if mode == "int8" else dict(quantize_int4=True,
                                                                int4_group_size=g)
    if mode == "int4_mixed":
        kw["int4_recipe"] = INT4_MIXED_RECIPE
    got, report = ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", verbose=False,
                                            streaming=True, return_report=True, **kw)
    jkw = dict(kw, int4_recipe=jq.INT4_MIXED_RECIPE) if mode == "int4_mixed" else kw
    jax_streamed, jax_report = jck.load_checkpoint_params(
        str(tmp_path), jcfg, verbose=False, streaming=True, return_report=True, **jkw)
    _reports_equal(report, jax_report)

    if mode == "int4_mixed":
        jblocks = jax_streamed["language_model"]["model"]["blocks"]
        assert "q4" in jblocks["att"]["W_query"]["weight"]  # the JAX loader ignores the recipe
        float_tree = jck.load_checkpoint_params(str(tmp_path), jcfg, verbose=False)
        oracle = jq.quantize_llama_params(float_tree, bits=4, group_size=g,
                                          recipe=jq.INT4_MIXED_RECIPE)
        head = float_tree["language_model"]["lm_head"]["weight"]
        oracle["language_model"]["lm_head"]["weight"] = jax.jit(
            lambda w: jq.quantize_weight_int4(w, g))(head)
    else:
        oracle = jax_streamed
    want = from_jax_params(_np_tree(oracle), cfg, "cpu")
    _assert_models_equal(got, want)

    lm = got.language_model
    for blk in lm.model.blocks:
        for parent, names in ((blk.att, ("W_query", "W_key", "W_value", "out_proj")),
                              (blk.ff, ("w_gate", "w_up", "w_down"))):
            for name in names:
                lin = getattr(parent, name)
                assert isinstance(lin, QuantLinear)
                bits = 8 if mode == "int8" else (
                    INT4_MIXED_RECIPE[name] if mode == "int4_mixed" else 4)
                assert ("q" in lin.weight) == (bits == 8), (name, bits)
    assert isinstance(lm.lm_head, QuantLinear)
    assert not isinstance(lm.model.tok_emb, dict)
    assert all(not isinstance(m, QuantLinear) for m in got.vision_model.modules())


def test_quantized_load_never_builds_the_float_linears(tmp_path, monkeypatch):
    """With quantize-on-load, the model's tensors are materialized from the
    ``meta`` device at their final sizes: the float bytes allocated are the
    float parameters and the quantization scales, no float decoder linear
    or head."""
    jcfg, params = _jax_params("float32", tied=False)
    cfg = tiny_mllama_config()
    jck.save_checkpoint_params(str(tmp_path), params, jcfg)
    created = []
    real = torch.empty_like

    def spy(t, *args, **kwargs):
        out = real(t, *args, **kwargs)
        created.append(out)
        return out

    monkeypatch.setattr(torch, "empty_like", spy)
    model = ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", verbose=False, streaming=True,
                                      quantize_int4=True, int4_group_size=32)
    monkeypatch.undo()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts if t.is_floating_point())

    assert nbytes(created) == nbytes(list(model.parameters()) + list(model.buffers()))
    float_model = from_jax_params(_np_tree(params), cfg, "cpu")
    lm = float_model.language_model
    linears = [lm.lm_head.weight] + [getattr(m, n).weight for b in lm.model.blocks
                                     for m, names in ((b.att, ("W_query", "W_key", "W_value",
                                                               "out_proj")),
                                                      (b.ff, ("w_gate", "w_up", "w_down")))
                                     for n in names]
    assert nbytes(created) < nbytes(float_model.parameters()) - nbytes(linears) / 2


# ---------------------------------------------------------------------------
# Errors and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(quantize_int8=True), dict(streaming=True, quantize_int8=True, quantize_int4=True),
    dict(streaming=True, quantize_int8=True, int4_recipe={"w_up": 4}),
    dict(streaming=True, quantize_int4=True, int4_recipe={"w_up": 3}), dict(),
])
def test_load_errors_match_jax(kwargs, tmp_path):
    """The JAX loader's validation errors, text for text (the last case: a
    directory without shards)."""
    with pytest.raises((ValueError, FileNotFoundError)) as want:
        jck.load_checkpoint_params(str(tmp_path), jax_tiny_config(), verbose=False, **kwargs)
    with pytest.raises(want.type) as got:
        ck.load_checkpoint_params(str(tmp_path), tiny_mllama_config(), "cpu", verbose=False,
                                  **kwargs)
    assert str(got.value) == str(want.value)


def test_save_refuses_quantized_and_sharded_loads_refused(tmp_path):
    jcfg, params = _jax_params("float32", tied=False)
    cfg = tiny_mllama_config()
    model = from_jax_params(_np_tree(params), cfg, "cpu")
    with pytest.raises(ValueError, match="cannot save int8-quantized weight"):
        ck.save_checkpoint_params(str(tmp_path / "q"), quantize_llama_params(model), cfg)
    # sharded loads are ported (tests/test_torch_tp.py); a layout that is not
    # param_shardings' is refused
    with pytest.raises(ValueError, match="shardings"):
        ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", shardings={})
    with pytest.raises(ValueError, match="shardings"):
        ck.load_checkpoint_params(str(tmp_path), cfg, "cpu", shardings={"tok_emb": 0})
