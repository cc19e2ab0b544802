"""The port's activation statistics and AWQ equalization
(``models/language.py`` ``collect_stats``, ``ops/awq.py``) against the JAX
package, on the JAX AWQ tests' config: hidden 96, 3 decoder layers, an
untied head, so the square ``W_query`` (96x96) is not symmetric and a fold
on the wrong side of it would show.

Tolerances: the statistics 1e-5 of their largest value (fp32 means summed
in other orders); the equalized weights 1e-6 of each tensor's magnitude
(the same fp32 products; the scales' geometric mean is a reduction in
another order); the equalized model's logits 1e-4 of the float model's
(an exact refactoring, up to fp32 rounding through 3 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama32mm_tpu.configs import LLAMA32Config as JaxLLAMA32Config
from llama32mm_tpu.configs import MLLAMAConfig as JaxMLLAMAConfig
from llama32mm_tpu.configs import VisionEncoderConfig as JaxVisionConfig
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu.ops import awq as jax_awq
from llama32mm_tpu.ops import quant as jq
from llama32mm_tpu_torch.configs import LLAMA32Config, MLLAMAConfig, VisionEncoderConfig
from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops.awq import awq_equalize, calibrate_stats
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE

_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
               image_size=28, patch_size=14)
_TEXT = dict(vocab_size=256, hidden_size=96, n_heads=4, n_layers=3, hidden_dim=192,
             n_kv_groups=2, dtype="float32")
_TOP = dict(projection_dim=96, hidden_size=96, image_token_index=255)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxMLLAMAConfig(vision_config=JaxVisionConfig(**_VISION),
                           text_config=JaxLLAMA32Config(**_TEXT), **_TOP)
    cfg = MLLAMAConfig(vision_config=VisionEncoderConfig(**_VISION),
                       text_config=LLAMA32Config(**_TEXT), **_TOP)
    # one jitted init: faster here than the eager ops
    params = jax.jit(lambda k: init_vlm_params(k, jcfg, tie_weights=False))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 250, (2, 24))
    ids[0, 2:6] = 255  # an image's 4 patches in row 0
    px = rs.randn(2, 3, 28, 28).astype(np.float32)
    return jcfg, cfg, params, ids, px


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", ["float", "image", "int8"])
def test_calibrate_stats_match_jax(setup, case):
    """Text only, with an image spliced in, and over an int8-quantized model;
    the head runs at one position a row."""
    jcfg, cfg, params, ids, px = setup
    jparams = jq.quantize_llama_params(params) if case == "int8" else params
    jpx = jnp.asarray(px) if case == "image" else None
    want = jax_awq.calibrate_stats(jparams, jcfg, jnp.asarray(ids), pixel_values=jpx)
    model = from_jax_params(_np(jparams), cfg, "cpu")
    got = calibrate_stats(model, cfg, torch.from_numpy(ids),
                          pixel_values=None if jpx is None else torch.from_numpy(px))
    tc = cfg.text_config
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "norm1_absmean": (tc.n_layers, tc.hidden_size),
        "norm2_absmean": (tc.n_layers, tc.hidden_size),
        "inter_absmean": (tc.n_layers, tc.hidden_dim)}
    for key, w in want.items():
        _close(got[key], np.asarray(w), 1e-5)
        assert got[key].dtype == torch.float32 and not got[key].requires_grad
    assert vlm_forward(model, cfg, input_ids=torch.from_numpy(ids)).stats is None


def test_awq_equalize_matches_jax_and_keeps_the_function(setup):
    jcfg, cfg, params, ids, _ = setup
    stats_j = jax_awq.calibrate_stats(params, jcfg, jnp.asarray(ids))
    want = _np(jax_awq.awq_equalize(params, stats_j, alpha=0.5))
    model = from_jax_params(_np(params), cfg, "cpu")
    before = to_jax_params(model)
    eq = awq_equalize(model, calibrate_stats(model, cfg, torch.from_numpy(ids)), alpha=0.5)
    got = to_jax_params(eq)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_w) == set(flat_g)
    changed = 0
    for path, w in flat_w.items():
        _close(flat_g[path], w, 1e-6)
        changed += not np.array_equal(w, np.asarray(
            dict(jax.tree_util.tree_flatten_with_path(before)[0])[path]))
    assert changed == 8  # norm1, norm2, W_query/key/value, w_gate, w_up, w_down
    # the argument is untouched, and the fold computes the same function
    for path, w in jax.tree_util.tree_flatten_with_path(to_jax_params(model))[0]:
        np.testing.assert_array_equal(w, dict(jax.tree_util.tree_flatten_with_path(before)[0])[path])
    t = torch.from_numpy(ids)
    ref = vlm_forward(model, cfg, input_ids=t).logits
    _close(vlm_forward(eq, cfg, input_ids=t).logits, ref.numpy(), 1e-4)
    # and it quantizes like any float model
    q = quantize_llama_params(eq, bits=4, group_size=32, recipe=INT4_MIXED_RECIPE)
    assert torch.isfinite(vlm_forward(q, cfg, input_ids=t).logits).all()
