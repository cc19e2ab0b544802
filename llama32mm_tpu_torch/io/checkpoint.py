"""HF safetensors checkpoints (counterpart of ``llama32mm_tpu/io/checkpoint.py``):
key translation, the load report, config building, loading (with
quantize-on-load), saving and ``load_hf_model``.

Keys translate to the JAX package's parameter-tree paths (the same tables),
so every ``LoadReport`` string reads as the JAX loader's. A path names a
port tensor through ``convert.py``'s entries. Orientation: HF stores
linears ``[out, in]`` and so does the port (``nn.Linear``), so a ``"t"``
leaf is copied as it is (the JAX package transposes it), a ``"conv"`` patch
embedding ``[D, C, P, P]`` is reshaped to ``[D, C·P·P]``, and the vocabulary
padding of the embedding and of the ``[V, H]`` head is sliced off by rows.

Loading writes each tensor into its device parameter as it is read
(``io/native_st.py::iter_tensors``, views of the shard's mapping, one at a
time). With ``streaming=True`` and ``quantize_int8`` / ``quantize_int4``,
each decoder linear and an untied head are built as ``QuantLinear`` buffers
(the float linears are never allocated) and every weight is quantized on
the device as it arrives, at the bits ``int4_recipe`` names for it.
Embeddings, norms, the vision tower and the projector stay float, as
``models/quantize.py`` leaves them.

Fixed against the JAX loader: it validates ``int4_recipe`` and then makes
every leaf int4; here each leaf gets its recipe's bits. Rows and leaves no
key fills are drawn on the CPU, leaf by leaf, from ``init_vlm``'s
distributions with a ``torch.Generator`` seeded 0 (not JAX's PRNG draws),
and a missing quantized leaf is quantized from them (the JAX loader leaves
it float).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.convert import _entries, _quantizable
from llama32mm_tpu_torch.io.native_st import iter_tensors, native_available
from llama32mm_tpu_torch.models.common import QuantLinear
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration
from llama32mm_tpu_torch.parallel.mesh import AXIS_TP
from llama32mm_tpu_torch.parallel.sharding import Placement, param_shardings, shard_params
from llama32mm_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4
from llama32mm_tpu_torch.utils import st_file

# ---------------------------------------------------------------------------
# Key translation (the JAX package's tables)
# ---------------------------------------------------------------------------

_UNSUPPORTED_PREFIXES = (
    # reference-table naming
    "vision_model.global_transformer",
    "vision_model.vision_model.tile_",
    "vision_model.vision_model.pre_",
    "vision_model.vision_model.post_tile_",
    "vision_model.vision_model.gated_",
    "language_model.model.rotary_emb",
    # real Llama-3.2-Vision hub naming: the gated positional embedding, tile
    # embeddings, pre-LN, CLS token and global transformer have no
    # counterpart in the plain-ViT reinterpretation the model follows
    "vision_model.gated_positional_embedding",
    "vision_model.pre_tile_positional_embedding",
    "vision_model.post_tile_positional_embedding",
    "vision_model.layernorm_pre",
    "vision_model.class_embedding",
)

_TEXT_LAYER_RE = re.compile(r"^language_model\.model\.layers\.(\d+)\.(.+)$")
_VISION_LAYER_RE = re.compile(r"^vision_model\.vision_model\.encoder\.layers\.(\d+)\.(.+)$")
# the real meta-llama/Llama-3.2-*-Vision hub layout of the vision tower
_VISION_HUB_LAYER_RE = re.compile(r"^vision_model\.transformer\.layers\.(\d+)\.(.+)$")

# kind: how the source tensor maps onto the target leaf (JAX tree layout)
#   "t"     — 2D linear weight [out, in]; the JAX tree holds [in, out], the port [out, in]
#   "raw"   — copy as-is
#   "conv"  — [D, C, P, P] conv weight; the JAX tree holds [C·P·P, D], the port [D, C·P·P]
_TEXT_LAYER_LEAVES = {
    "self_attn.q_proj.weight": (("att", "W_query", "weight"), "t"),
    "self_attn.k_proj.weight": (("att", "W_key", "weight"), "t"),
    "self_attn.v_proj.weight": (("att", "W_value", "weight"), "t"),
    "self_attn.o_proj.weight": (("att", "out_proj", "weight"), "t"),
    "input_layernorm.weight": (("norm1", "weight"), "raw"),
    "post_attention_layernorm.weight": (("norm2", "weight"), "raw"),
    "mlp.gate_proj.weight": (("ff", "swiglu", "w_gate"), "t"),
    "mlp.up_proj.weight": (("ff", "swiglu", "w_up"), "t"),
    "mlp.down_proj.weight": (("ff", "w_down", "weight"), "t"),
}

_VISION_LAYER_LEAVES = {}
for _ln, _local in (("layer_norm1", "layernorm1"), ("layer_norm2", "layernorm2")):
    for _wb in ("weight", "bias"):
        _VISION_LAYER_LEAVES[f"{_ln}.{_wb}"] = ((_local, _wb), "raw")
for _proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
    _VISION_LAYER_LEAVES[f"self_attn.{_proj}.weight"] = (("self_attn", _proj, "weight"), "t")
    _VISION_LAYER_LEAVES[f"self_attn.{_proj}.bias"] = (("self_attn", _proj, "bias"), "raw")
for _fc in ("fc1", "fc2"):
    _VISION_LAYER_LEAVES[f"mlp.{_fc}.weight"] = (("mlp", _fc, "weight"), "t")
    _VISION_LAYER_LEAVES[f"mlp.{_fc}.bias"] = (("mlp", _fc, "bias"), "raw")

# Real-hub (Mllama) vision layer leaves: input_layernorm/post_attention_layernorm
# naming, o_proj for out_proj; the real vision attention has no biases (the
# ViT declares them, so they stay at init and are reported missing)
_VISION_HUB_LAYER_LEAVES = {}
for _ln, _local in (("input_layernorm", "layernorm1"),
                    ("post_attention_layernorm", "layernorm2")):
    for _wb in ("weight", "bias"):
        _VISION_HUB_LAYER_LEAVES[f"{_ln}.{_wb}"] = ((_local, _wb), "raw")
for _hfp, _localp in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                      ("v_proj", "v_proj"), ("o_proj", "out_proj")):
    _VISION_HUB_LAYER_LEAVES[f"self_attn.{_hfp}.weight"] = (("self_attn", _localp, "weight"), "t")
    _VISION_HUB_LAYER_LEAVES[f"self_attn.{_hfp}.bias"] = (("self_attn", _localp, "bias"), "raw")
for _fc in ("fc1", "fc2"):
    _VISION_HUB_LAYER_LEAVES[f"mlp.{_fc}.weight"] = (("mlp", _fc, "weight"), "t")
    _VISION_HUB_LAYER_LEAVES[f"mlp.{_fc}.bias"] = (("mlp", _fc, "bias"), "raw")

_GLOBAL_LEAVES = {
    "language_model.model.embed_tokens.weight": (
        ("language_model", "model", "tok_emb", "weight"), "raw"),
    "language_model.lm_head.weight": (("language_model", "lm_head", "weight"), "t"),
    "language_model.model.norm.weight": (
        ("language_model", "model", "final_norm", "weight"), "raw"),
    "vision_model.vision_model.patch_embedding.weight": (
        ("vision_model", "embeddings", "patch_embedding", "weight"), "conv"),
    "vision_model.vision_model.position_embedding.weight": (
        ("vision_model", "embeddings", "position_embedding", "weight"), "raw"),
    "vision_model.vision_model.post_layernorm.weight": (
        ("vision_model", "post_layernorm", "weight"), "raw"),
    "vision_model.vision_model.post_layernorm.bias": (
        ("vision_model", "post_layernorm", "bias"), "raw"),
    "multi_modal_projector.linear_1.weight": (
        ("multi_modal_projector", "linear", "weight"), "t"),
    "multi_modal_projector.linear_1.bias": (
        ("multi_modal_projector", "linear", "bias"), "raw"),
    # local-naming alias
    "multi_modal_projector.linear.weight": (
        ("multi_modal_projector", "linear", "weight"), "t"),
    "multi_modal_projector.linear.bias": (
        ("multi_modal_projector", "linear", "bias"), "raw"),
    # real-hub naming (Mllama): bare projector Linear, patch/post-LN directly
    # under vision_model (the real projector is [text_hidden, 7680], so at
    # 11B it shape-skips and stays at init)
    "vision_model.patch_embedding.weight": (
        ("vision_model", "embeddings", "patch_embedding", "weight"), "conv"),
    "vision_model.layernorm_post.weight": (
        ("vision_model", "post_layernorm", "weight"), "raw"),
    "vision_model.layernorm_post.bias": (
        ("vision_model", "post_layernorm", "bias"), "raw"),
    "multi_modal_projector.weight": (
        ("multi_modal_projector", "linear", "weight"), "t"),
    "multi_modal_projector.bias": (
        ("multi_modal_projector", "linear", "bias"), "raw"),
}


def translate_hf_key(hf_key: str) -> Optional[Tuple[Tuple[str, ...], Optional[int], str]]:
    """HF key → ``(target_path, layer_idx, kind)`` or None (dropped)."""
    if hf_key.startswith(_UNSUPPORTED_PREFIXES) or ".cross_attn" in hf_key:
        return None
    if hf_key in _GLOBAL_LEAVES:
        path, kind = _GLOBAL_LEAVES[hf_key]
        return path, None, kind
    for regex, table, prefix in (
        (_TEXT_LAYER_RE, _TEXT_LAYER_LEAVES, ("language_model", "model", "blocks")),
        (_VISION_LAYER_RE, _VISION_LAYER_LEAVES, ("vision_model", "layers")),
        (_VISION_HUB_LAYER_RE, _VISION_HUB_LAYER_LEAVES, ("vision_model", "layers")),
    ):
        m = regex.match(hf_key)
        if m:
            leaf = table.get(m.group(2))
            if leaf is None:
                return None
            path, kind = leaf
            return prefix + path, int(m.group(1)), kind
    return None


@dataclasses.dataclass
class LoadReport:
    """Conversion diagnostics.

    - ``skipped``: source keys dropped (unsupported subsystem, no target, or
      shape mismatch — the mismatch is recorded in the entry).
    - ``missing``: target leaves no shard touched (left at init).
    - ``row_missing``: stacked [L, ...] target leaves where some layer rows
      were never written (reverted to init) — e.g. the real 11B-Vision
      checkpoint's 8 cross-attention layers contribute no self_attn rows.
    """

    skipped: List[str]
    missing: List[str]
    row_missing: List[str]
    notes: List[str] = dataclasses.field(default_factory=list)

    def print(self, prefix: str = "[load]", limit: int = 8) -> None:
        def _show(name, items):
            if not items:
                return
            print(f"{prefix} {name}: {len(items)}")
            for it in items[:limit]:
                print(f"{prefix}   {it}")
            if len(items) > limit:
                print(f"{prefix}   ... and {len(items) - limit} more")

        _show("skipped source keys", self.skipped)
        _show("missing target keys (left at init)", self.missing)
        _show("partially-filled stacked targets (rows at init)", self.row_missing)
        _show("notes", self.notes)


# ---------------------------------------------------------------------------
# The JAX package's parameter tree
# ---------------------------------------------------------------------------

_HEAD = ("language_model", "lm_head", "weight")
_EMB = ("language_model", "model", "tok_emb", "weight")

# (destination: a parameter, or a QuantLinear's {"q"|"q4", "scale"} buffers;
#  the port's float shape of that leaf)
Target = Tuple[object, Tuple[int, ...]]


def _targets(model: MllamaForConditionalGeneration) -> Dict[tuple, Dict[Optional[int], Target]]:
    """JAX tree path → {layer (None for a single leaf): target}, paths
    sorted (the order in which the JAX loader walks its tree). A
    QuantLinear's shape is its float weight's ``[out, in]``."""
    found: Dict[tuple, Dict[Optional[int], Target]] = {}
    for dst, path, layer, _ in _entries(model):
        if isinstance(dst, dict):  # int8 q [out, in], or int4 q4 [out, in/2]
            shape = (tuple(dst["q"].shape) if "q" in dst
                     else (dst["q4"].shape[0], 2 * dst["q4"].shape[1]))
        else:
            shape = tuple(dst.shape)
        found.setdefault(path, {})[layer] = (dst, shape)
    return dict(sorted(found.items()))


def _ref_shapes(config: MLLAMAConfig) -> Dict[tuple, tuple]:
    """The JAX package's parameter tree (untied) as {path: shape}, paths
    sorted: a stacked leaf ``[L, ...]``, a linear ``[in, out]``, the patch
    embedding ``[C·P·P, D]``."""
    model = MllamaForConditionalGeneration(config, "meta", tie_weights=False)
    shapes = {}
    for dst, path, layer, transposed in _entries(model):
        shape = tuple(dst.shape)[::-1] if transposed else tuple(dst.shape)
        if layer is None:
            shapes[path] = shape
        elif layer == 0:
            shapes[path] = (len(model.language_model.model.blocks)
                            if path[0] == "language_model" else len(model.vision_model.layers),
                            ) + shape
    return dict(sorted(shapes.items()))


# The real Llama-3.2-Vision checkpoints pad the embedding table with 8 rows
# past vocab_size (embed_tokens is [128264, 4096]: the <|image|> id 128256 +
# reserved). The image-token rows are overwritten by the feature splice, so
# the padding is sliced off on load.
_VOCAB_ROW_PATHS = frozenset({_EMB, _HEAD})


def _source_shape_ok(src_shape, tshape, kind, stacked: bool, path=()) -> bool:
    """Would a source tensor of ``src_shape`` fit the target leaf of JAX
    shape ``tshape``?"""
    expected = tuple(tshape[1:]) if stacked else tuple(tshape)
    src = tuple(src_shape)
    if kind == "t":
        if src == expected[::-1]:
            return True
        return (path in _VOCAB_ROW_PATHS and len(src) == 2
                and src[1] == expected[0] and src[0] >= expected[1])
    if kind == "conv":
        # [D, C, P, P] → [C·P·P, D]
        return (len(src) == 4 and len(expected) == 2
                and src[0] == expected[1]
                and src[1] * src[2] * src[3] == expected[0])
    if src == expected:
        return True
    return (path in _VOCAB_ROW_PATHS and len(src) == 2 and len(expected) == 2
            and src[1] == expected[1] and src[0] >= expected[0])


def _slice_vocab_padding(path, t: torch.Tensor, shape, notes: List[str]) -> torch.Tensor:
    """Drop vocab-padding rows of the embedding or the head (both ``[V, H]``
    in the port, so both by rows), with the JAX loader's note."""
    if path not in _VOCAB_ROW_PATHS or t.dim() != 2:
        return t
    if t.shape[1] == shape[1] and t.shape[0] > shape[0]:
        notes.append(f"{'.'.join(path)}: dropped {t.shape[0] - shape[0]} vocab-padding rows")
        return t[: shape[0]]
    return t


def preflight_manifest(manifest, config: MLLAMAConfig) -> LoadReport:
    """Dry-run the HF→local key translation over a checkpoint *manifest* —
    no tensor bytes needed — and return the LoadReport a real
    ``load_checkpoint_params`` over that checkpoint would produce.

    ``manifest`` is one of:
    - a dict ``{hf_key: shape_list}`` (shape-checked),
    - an iterable of hf key names (translation-checked only),
    - a model directory containing ``model.safetensors.index.json``."""
    if isinstance(manifest, str):
        idx_path = os.path.join(manifest, "model.safetensors.index.json")
        with open(idx_path, encoding="utf-8") as f:
            manifest = {k: None for k in json.load(f)["weight_map"]}
    elif not isinstance(manifest, dict):
        manifest = {k: None for k in manifest}

    ref = _ref_shapes(config)
    skipped: List[str] = []
    touched: set = set()
    stacked_rows: Dict[Tuple[str, ...], set] = {}

    for key in sorted(manifest):
        tr = translate_hf_key(key)
        if tr is None:
            skipped.append(key)
            continue
        path, layer_idx, kind = tr
        shape = ref.get(path)
        if shape is None:
            skipped.append(key)
            continue
        src_shape = manifest[key]
        if src_shape is not None and not _source_shape_ok(
            src_shape, shape, kind, stacked=layer_idx is not None, path=path,
        ):
            skipped.append(f"{key} (shape mismatch)")
            continue
        if layer_idx is not None:
            stacked_rows.setdefault(path, set()).add(layer_idx)
        touched.add(path)

    row_missing = [f"{'.'.join(path)} rows {gaps}" for path in sorted(stacked_rows)
                   if (gaps := [i for i in range(ref[path][0]) if i not in stacked_rows[path]])]
    missing = [".".join(p) for p in sorted(ref) if p not in touched
               # tied-embedding checkpoints omit lm_head
               and not (p == _HEAD and _EMB in touched)]
    return LoadReport(skipped=skipped, missing=missing, row_missing=row_missing)


# ---------------------------------------------------------------------------
# Config building
# ---------------------------------------------------------------------------


def build_config_from_hf(cfg: dict, pad_token_id=None, dtype: str = "bfloat16",
                         max_cache_length: int = 2048) -> MLLAMAConfig:
    tc = cfg["text_config"]
    vc = cfg["vision_config"]
    text = dict(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        context_length=tc.get("max_position_embeddings", 131072),
        n_heads=tc["num_attention_heads"],
        n_layers=tc["num_hidden_layers"],
        hidden_dim=tc["intermediate_size"],
        max_position_embeddings=tc.get("max_position_embeddings", 2048),
        n_kv_groups=tc.get("num_key_value_heads", tc["num_attention_heads"]),
        rope_base=tc.get("rope_theta", 500000.0),
        rms_norm_eps=tc.get("rms_norm_eps", 1e-5),
        dtype=dtype,
        max_cache_length=max_cache_length,
    )
    # the checkpoint's rope_scaling becomes rope_freq (stored; applied only
    # with apply_rope_scaling=True)
    rs = tc.get("rope_scaling") or None
    if isinstance(rs, dict) and rs.get("rope_type", rs.get("type", "llama3")) == "llama3":
        text["rope_freq"] = {
            "factor": float(rs.get("factor", 32.0)),
            "low_freq_factor": float(rs.get("low_freq_factor", 1.0)),
            "high_freq_factor": float(rs.get("high_freq_factor", 4.0)),
            "original_context_length": int(
                rs.get("original_max_position_embeddings",
                       rs.get("original_context_length", 8192))
            ),
        }
    vision = dict(
        hidden_size=vc["hidden_size"],
        intermediate_size=vc["intermediate_size"],
        num_hidden_layers=vc["num_hidden_layers"],
        # the real Mllama hub config names these `attention_heads`/`norm_eps`
        num_attention_heads=vc.get("num_attention_heads", vc.get("attention_heads")),
        num_channels=vc.get("num_channels", 3),
        image_size=vc["image_size"],
        patch_size=vc["patch_size"],
        layer_norm_eps=vc.get("layer_norm_eps", vc.get("norm_eps", 1e-6)),
        attention_dropout=vc.get("attention_dropout", 0.0),
    )
    return MLLAMAConfig(
        vision_config=vision,
        text_config=text,
        ignore_index=cfg.get("ignore_index", -100),
        image_token_index=cfg["image_token_index"],
        vocab_size=cfg.get("vocab_size", text["vocab_size"]),
        projection_dim=cfg.get("vision_config", {}).get("projection_dim", text["hidden_size"]),
        hidden_size=text["hidden_size"],
        pad_token_index=pad_token_id,
    )


# ---------------------------------------------------------------------------
# Parameter loading
# ---------------------------------------------------------------------------

_NORMS = frozenset({"norm1", "norm2", "final_norm", "layernorm1", "layernorm2", "post_layernorm"})


def _init_value(path, shape, targets, config: MLLAMAConfig, dtype, gen) -> torch.Tensor:
    """One leaf (or layer row) drawn on the CPU from ``init_vlm``'s
    distribution for it."""
    t = torch.empty(shape, dtype=dtype)
    if path[-2] in _NORMS:
        return t.fill_(1.0) if path[-1] == "weight" else t.zero_()
    if path == _EMB:
        t.normal_(generator=gen)
        if config.text_config.pad_token_index is not None:
            t[config.text_config.pad_token_index] = 0.0
        return t
    if path[-2] == "position_embedding":
        return t.normal_(generator=gen)
    # a linear's weight or bias: U(±1/sqrt(fan_in)), fan_in from its weight [out, in]
    weight = path if path[-1] != "bias" else path[:-1] + ("weight",)
    fan_in = next(iter(targets[weight].values()))[1][1]
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=gen)


_QUANT_ROWS = 8192  # output rows quantized at once while loading


def _key_tensor(dst) -> torch.Tensor:
    """The tensor that names a target: the parameter, or a quantized
    linear's ``q`` / ``q4`` buffer."""
    if isinstance(dst, dict):
        return dst["q"] if "q" in dst else dst["q4"]
    return dst


def _shard_meta(model: MllamaForConditionalGeneration, config: MLLAMAConfig,
                shardings: Dict[str, Placement]):
    """This rank's local model of the ``meta`` model (``shard_params``) and
    the placement of each of its tensors by name. The mesh, and whether the
    ViT is split, come from ``shardings``; the placements of the quantized
    buffers are derived anew for this model."""
    any_pl = next(iter(shardings.values()))
    vision_tp = any(name.startswith("vision_model.layers.") and pl.dim is not None
                    for name, pl in shardings.items())
    plan = param_shardings(config, any_pl.mesh, model, vision_tp)
    return shard_params(model, config, any_pl.mesh, vision_tp), plan


def _quant_bits(name: str, quantize_int8: bool, int4_recipe: Optional[dict]) -> int:
    if quantize_int8:
        return 8
    return int4_recipe.get(name, 4) if int4_recipe else 4


def load_checkpoint_params(
    model_path: str,
    config: MLLAMAConfig,
    device,
    verbose: bool = True,
    streaming: bool = False,
    quantize_int8: bool = False,
    quantize_int4: bool = False,
    int4_group_size: int = 128,
    int4_recipe: Optional[dict] = None,
    return_report: bool = False,
    shardings=None,
):
    """Load every ``*.safetensors`` under ``model_path`` into a
    ``MllamaForConditionalGeneration`` on ``device``; unmapped source keys
    are skipped and missing targets reported (strict=False semantics).
    Returns the model, and the ``LoadReport`` with ``return_report=True``.

    Shards are read through the native reader (``io/native_st.py``), or
    through ``utils/st_file.py`` when it does not build (then the report's
    notes say so). Each tensor is written into its parameter on ``device``
    as it is read, cast to the config dtype.

    ``quantize_int8=True`` (requires ``streaming=True``) loads each decoder
    linear and an untied head as int8 + fp32 per-channel scales, quantized
    on the device as the weight arrives; the float linears never exist.
    ``quantize_int4=True``: packed int4 with per-(channel, group of
    ``int4_group_size``) scales. ``int4_recipe`` (requires
    ``quantize_int4``) maps weight names (``W_query`` ... ``w_down``,
    ``lm_head``) to 4 or 8 bits, as ``quantize_llama_params(recipe=...)``
    does; unnamed weights are int4. A checkpoint without ``lm_head`` but
    with an embedding loads tied (``lm_head`` None).

    ``shardings`` (``parallel/sharding.py::param_shardings`` on a mesh this
    rank belongs to) loads this rank's tensor-parallel model, as
    ``shard_params`` of the whole load would give it: each tensor read from
    the mapping is narrowed to this rank's slice before it is copied (or
    quantized) onto ``device``. The ViT is split when ``shardings`` splits
    it. A row-parallel int8 leaf's per-channel scale is the maximum over the
    whole input row, so its ranks reduce their slices' maxima (a ``MAX``
    all-reduce over ``tp``) before quantizing: the bytes equal those of the
    unsharded load, sliced."""
    if shardings is not None and not (shardings and all(
            isinstance(pl, Placement) for pl in shardings.values())):
        raise ValueError("shardings must be parallel/sharding.py::param_shardings(config, mesh)")
    if (quantize_int8 or quantize_int4) and not streaming:
        raise ValueError("quantize_int8/int4=True requires streaming=True")
    if quantize_int8 and quantize_int4:
        raise ValueError("choose one of quantize_int8 / quantize_int4")
    if int4_recipe is not None:
        if not quantize_int4:
            raise ValueError("int4_recipe requires quantize_int4=True")
        bad = set(int4_recipe.values()) - {4, 8}
        if bad:
            raise ValueError(f"int4_recipe bits must be 4 or 8, got {sorted(bad)}")

    files = sorted(
        os.path.join(model_path, fn)
        for fn in os.listdir(model_path)
        if fn.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(
            f"No .safetensors files under '{model_path}'. Run the download CLI first."
        )

    device = torch.device(device)
    dt = config.text_config.torch_dtype
    model = MllamaForConditionalGeneration(config, "meta", tie_weights=False)
    if quantize_int8 or quantize_int4:
        g = int4_group_size
        for parent, name, _, _ in _quantizable(model):
            n, k = getattr(parent, name).weight.shape
            if _quant_bits(name, quantize_int8, int4_recipe) == 8:
                qw = {"q": torch.empty(n, k, dtype=torch.int8, device="meta"),
                      "scale": torch.empty(n, dtype=torch.float32, device="meta")}
            else:
                if k % g or g % 2:
                    raise ValueError(f"input dim {k} must be divisible by even group_size {g}")
                qw = {"q4": torch.empty(n, k // 2, dtype=torch.uint8, device="meta"),
                      "scale": torch.empty(n, k // g, dtype=torch.float32, device="meta")}
            setattr(parent, name, QuantLinear(qw))
    placed: Dict[int, Placement] = {}
    if shardings is not None:
        model, plan = _shard_meta(model, config, shardings)
    model.to_empty(device=device)
    if shardings is not None:  # each tensor's placement, by id
        named = list(model.named_parameters()) + list(model.named_buffers())
        placed = {id(t): plan[name] for name, t in named}
    targets = _targets(model)
    if shardings is not None:  # a leaf's whole shape, as the checkpoint holds it
        targets = {path: {layer: (dst, placed[id(_key_tensor(dst))].full_shape(shape))
                          for layer, (dst, shape) in rows.items()}
                   for path, rows in targets.items()}

    def write(dst, t: torch.Tensor) -> None:
        pl = placed.get(id(_key_tensor(dst)))
        if pl is not None:  # this rank's slice of the whole tensor
            t = pl.local(t)
        if not isinstance(dst, dict):
            dst.copy_(t)
            return
        # quantize on the device, as the JAX loader's jitted writes, a block of
        # output rows at a time (each row's bits depend on that row alone), so
        # the fp32 temporaries of a 128256-row head stay a block's size
        row_parallel_int8 = "q" in dst and pl is not None and pl.dim == 1
        for r in range(0, t.shape[0], _QUANT_ROWS):
            w = t[r:r + _QUANT_ROWS].to(device=device, dtype=dt)
            if "q4" in dst:
                qw = quantize_weight_int4(w, int4_group_size, compiled=True)
            else:
                absmax = None
                if row_parallel_int8:  # the whole row's maximum, from every rank's slice
                    absmax = pl.mesh.all_reduce(w.float().abs().amax(dim=1), AXIS_TP,
                                                op=torch.distributed.ReduceOp.MAX)
                qw = quantize_weight(w, compiled=True, absmax=absmax)
            for key, buf in dst.items():
                buf[r:r + _QUANT_ROWS].copy_(qw[key])

    skipped: List[str] = []
    notes: List[str] = []
    loaded: set = set()
    # Per-row fill tracking for stacked targets: a checkpoint can touch a
    # leaf without covering every layer (the real 11B-Vision checkpoint's 8
    # cross-attention layers have no self_attn keys); such rows revert to
    # init and are reported.
    stacked_rows: Dict[Tuple[str, ...], set] = {}
    if not native_available():
        notes.append("read through utils/st_file.py: the native reader "
                     "(native/safetensors_reader.cpp) did not build")

    with torch.no_grad():
        for sf in files:
            # copy=False: each tensor is consumed (cast or quantized into its
            # target) within its iteration, before the mapping's view expires
            for key, tensor in iter_tensors(sf, copy=False):
                tr = translate_hf_key(key)
                if tr is None or tr[0] not in targets:
                    skipped.append(key)
                    continue
                path, layer_idx, kind = tr
                if kind == "conv":
                    tensor = tensor.reshape(tensor.shape[0], -1)
                if layer_idx is not None:
                    dst, shape = targets[path].get(layer_idx, (None, None))
                    if dst is None or tuple(tensor.shape) != shape:
                        skipped.append(f"{key} (shape mismatch)")
                        continue
                    write(dst, tensor)
                    stacked_rows.setdefault(path, set()).add(layer_idx)
                else:
                    dst, shape = targets[path][None]
                    tensor = _slice_vocab_padding(path, tensor, shape, notes)
                    if tuple(tensor.shape) != shape:
                        skipped.append(f"{key} (shape mismatch)")
                        continue
                    write(dst, tensor)
                    loaded.add(path)

        # Fill what no key wrote from init, drawn lazily on the CPU
        gen: List[torch.Generator] = []

        def fill(dst, path, shape) -> None:
            if not gen:
                gen.append(torch.Generator().manual_seed(0))
            write(dst, _init_value(path, shape, targets, config, dt, gen[0]))

        row_missing: List[str] = []
        for path in sorted(stacked_rows):
            gaps = [i for i in sorted(targets[path]) if i not in stacked_rows[path]]
            if gaps:
                row_missing.append(f"{'.'.join(path)} rows {gaps}")
            for i in gaps:
                dst, shape = targets[path][i]
                fill(dst, path, shape)

        missing: List[str] = []
        for path, rows in targets.items():
            if path in loaded or path in stacked_rows:
                continue
            if path == _HEAD and _EMB in loaded:
                # tied-embedding checkpoints (the normal 1B/3B HF layout) omit lm_head
                model.language_model.lm_head = None
                continue
            missing.append(".".join(path))
            for dst, shape in rows.values():
                fill(dst, path, shape)

    report = LoadReport(skipped=skipped, missing=missing, row_missing=row_missing, notes=notes)
    if verbose:
        report.print("[load_checkpoint_params]")
    if return_report:
        return model, report
    return model


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------


def save_checkpoint_params(
    model_path: str,
    model: MllamaForConditionalGeneration,
    config: MLLAMAConfig,
    max_shard_bytes: int = 8 * 1024**3,
) -> None:
    """Inverse of ``load_checkpoint_params``: write the model out as
    HF-named safetensors shards + ``config.json``.

    A quantized model raises (checkpoints store the float weights). Output
    exceeding ``max_shard_bytes`` is split into
    ``model-XXXXX-of-XXXXX.safetensors`` shards with a
    ``model.safetensors.index.json``; a single shard keeps the plain
    ``model.safetensors`` name. A tied head writes no ``lm_head``.

    The write streams: the shard plan comes from shapes alone, and each
    tensor is copied to the host when its bytes are written, so host memory
    holds one tensor at a time (``utils/st_file.py::write_file``)."""
    os.makedirs(model_path, exist_ok=True)

    inv_text = {tuple(v[0]): (k, v[1]) for k, v in _TEXT_LAYER_LEAVES.items()}
    inv_vision = {tuple(v[0]): (k, v[1]) for k, v in _VISION_LAYER_LEAVES.items()}
    inv_global = {}
    for hf_key, (path, kind) in _GLOBAL_LEAVES.items():
        inv_global.setdefault(path, (hf_key, kind))  # first alias wins
    vc = config.vision_config

    def hf_tensor(t: torch.Tensor, kind: str) -> torch.Tensor:
        if kind == "conv":  # [D, C·P·P] → [D, C, P, P]
            return t.reshape(t.shape[0], vc.num_channels, vc.patch_size, vc.patch_size)
        return t  # "t": the port's linears are HF's [out, in] already

    # (hf_key, dtype, shape, produce, nbytes), paths sorted, every layer of a
    # stacked leaf before the next leaf; a tied head has no target
    entries: List[tuple] = []
    for path, rows in _targets(model).items():
        for layer, (dst, _) in rows.items():
            if isinstance(dst, dict):
                raise ValueError(
                    f"cannot save int8-quantized weight at {'.'.join(path)}: checkpoints "
                    "store the canonical float tree. Dequantize first "
                    "(ops.quant.dequantize_weight) or save before quantize_llama_params."
                )
            if path in inv_global:
                hf_key, kind = inv_global[path]
            elif path[:3] == ("language_model", "model", "blocks") and path[3:] in inv_text:
                leaf_name, kind = inv_text[path[3:]]
                hf_key = f"language_model.model.layers.{layer}.{leaf_name}"
            elif path[:2] == ("vision_model", "layers") and path[2:] in inv_vision:
                leaf_name, kind = inv_vision[path[2:]]
                hf_key = f"vision_model.vision_model.encoder.layers.{layer}.{leaf_name}"
            else:
                continue
            out = hf_tensor(dst, kind)
            entries.append((hf_key, out.dtype, tuple(out.shape), lambda out=out: out,
                            out.numel() * out.element_size()))

    # Shard planning from byte counts alone: greedy fill up to max_shard_bytes
    # per file (a tensor larger than the limit gets its own shard).
    shards: List[List[tuple]] = [[]]
    shard_bytes = [0]
    for entry in entries:
        nb = entry[4]
        if shard_bytes[-1] > 0 and shard_bytes[-1] + nb > max_shard_bytes:
            shards.append([])
            shard_bytes.append(0)
        shards[-1].append(entry)
        shard_bytes[-1] += nb

    if len(shards) == 1:
        st_file.write_file(os.path.join(model_path, "model.safetensors"),
                           [e[:4] for e in shards[0]])
    else:
        n = len(shards)
        weight_map = {}
        for i, shard in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            st_file.write_file(os.path.join(model_path, fname), [e[:4] for e in shard])
            for e in shard:
                weight_map[e[0]] = fname
        index = {
            "metadata": {"total_size": int(sum(shard_bytes))},
            "weight_map": weight_map,
        }
        with open(
            os.path.join(model_path, "model.safetensors.index.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(index, f, indent=2)

    tc = config.text_config
    cfg_json = {
        "text_config": {
            "vocab_size": tc.vocab_size,
            "hidden_size": tc.hidden_size,
            "num_attention_heads": tc.n_heads,
            "num_hidden_layers": tc.n_layers,
            "intermediate_size": tc.hidden_dim,
            "num_key_value_heads": tc.n_kv_groups,
            "rope_theta": tc.rope_base,
            "rms_norm_eps": tc.rms_norm_eps,
            "max_position_embeddings": tc.context_length,
        },
        "vision_config": {
            "hidden_size": vc.hidden_size,
            "intermediate_size": vc.intermediate_size,
            "num_hidden_layers": vc.num_hidden_layers,
            "num_attention_heads": vc.num_attention_heads,
            "num_channels": vc.num_channels,
            "image_size": vc.image_size,
            "patch_size": vc.patch_size,
            "layer_norm_eps": vc.layer_norm_eps,
            "projection_dim": config.projection_dim,
        },
        "image_token_index": config.image_token_index,
        "vocab_size": config.vocab_size,
        "ignore_index": config.ignore_index,
    }
    with open(os.path.join(model_path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg_json, f, indent=2)


def load_hf_model(
    model_path: str,
    device,
    dtype: str = "bfloat16",
    max_cache_length: int = 2048,
    streaming: bool = False,
    quantize_int8: bool = False,
    quantize_int4: bool = False,
    return_report: bool = False,
    shardings=None,
):
    """``(MllamaForConditionalGeneration, tokenizer)`` from a checkpoint
    directory (safetensors, ``config.json`` and the tokenizer files), the
    head tied to the embedding unless it is quantized.

    ``quantize_int8`` / ``quantize_int4`` (with ``streaming=True``) load the
    decoder straight into serving form; a quantized head stays as loaded
    (the embedding stays float). ``return_report=True`` also returns the
    :class:`LoadReport`."""
    from transformers import AutoTokenizer

    # config.json first: a directory that is not a checkpoint fails here,
    # before the tokenizer could take its path for a hub repository id
    with open(os.path.join(model_path, "config.json"), encoding="utf-8") as f:
        cfg_dict = json.load(f)
    tokenizer = AutoTokenizer.from_pretrained(model_path, padding_side="right")
    config = build_config_from_hf(
        cfg_dict, tokenizer.pad_token_id, dtype=dtype, max_cache_length=max_cache_length
    )
    model, report = load_checkpoint_params(
        model_path, config, device, streaming=streaming,
        quantize_int8=quantize_int8, quantize_int4=quantize_int4,
        return_report=True, shardings=shardings,
    )
    if not isinstance(model.language_model.lm_head, QuantLinear):
        model.language_model.lm_head = None  # tie
    if return_report:
        return model, tokenizer, report
    return model, tokenizer
