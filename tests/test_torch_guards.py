"""Guards of the PyTorch port that hold without a GPU: it imports without
JAX, its kernel wrappers refuse CPU tensors instead of falling back,
``chip_smoke.py`` fails on a machine without a card, and features outside
the ported slice raise ``NotImplementedError``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.ops.cuda import build
from llama32mm_tpu_torch.ops.gemv import linear, qlinear
from llama32mm_tpu_torch.ops.quant import quantize_weight
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "llama32mm_tpu_torch.configs", "llama32mm_tpu_torch.convert",
    "llama32mm_tpu_torch.inference.engine", "llama32mm_tpu_torch.models.vlm",
    "llama32mm_tpu_torch.ops.cuda", "llama32mm_tpu_torch.preprocess.image",
    "llama32mm_tpu_torch.utils.sampling", "llama32mm_tpu_torch.ops.quant",
    "llama32mm_tpu_torch.models.quantize", "llama32mm_tpu_torch.ops.cuda.qgemv", "llama32mm_tpu_torch.ops.cuda.qmatmul", "chip_smoke",
    "llama32mm_tpu_torch.train", "llama32mm_tpu_torch.utils.st_file", "profile_train",
    "llama32mm_tpu_torch.inference.server", "profile_serve", "profile_flash",
    "llama32mm_tpu_torch.ops.cuda.flash_decode",
]


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        + "".join(f"import {m}\n" for m in PORT_MODULES)
        + "assert not any(m == 'llama32mm_tpu' or m.startswith('llama32mm_tpu.') for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _cpu_args(name):
    x = torch.randn(3, 16)
    if name in ("rmsnorm", "rmsnorm_fwd_train"):
        return x, torch.ones(16), 1e-5
    if name == "rmsnorm_bwd":
        return x, x, torch.ones(16), torch.ones(3)
    if name == "swiglu_bwd":
        return x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(3, 8)
    if name.startswith("flash_attention_bwd"):
        q, lse = torch.randn(1, 2, 3, 16), torch.zeros(1, 2, 3)
        return q, q, q, torch.ones(1, 3), 0, True, lse, lse, q
    if name == "gemv":
        return x, torch.randn(8, 16)
    if name == "swiglu":
        return x, torch.randn(8, 16), torch.randn(8, 16)
    if name == "swiglu_down":
        return x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(16, 8)
    if name in ("gemv_int8", "qmatmul"):
        return x, torch.randint(-127, 128, (8, 16), dtype=torch.int8), torch.rand(8)
    if name in ("gemv_int4", "gemv_int4_w4a8"):  # group size 8
        return x, torch.randint(0, 256, (8, 8), dtype=torch.uint8), torch.rand(8, 2)
    q = torch.randn(1, 2, 3, 16)
    if name in ("flash_attention_int8kv", "flash_attention_tc_int8kv", "flash_decode_int8kv"):
        kv = torch.randint(-127, 128, (1, 2, 3, 16), dtype=torch.int8)
        return q, kv, kv, torch.rand(1, 2, 3), torch.rand(1, 2, 3), torch.ones(1, 3), 0, True
    return q, q, q, torch.ones(1, 3), 0, True


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_wrapper_refuses_cpu_tensors(name):
    wrapper, plain = kernels.KERNELS[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*_cpu_args(name))
    assert wrapper.launches == before
    plain(*_cpu_args(name))  # the plain version takes them


@pytest.mark.parametrize("op", ["rmsnorm", "gemv", "swiglu", "attention", "qlinear"])
def test_impl_cuda_on_cpu_raises(op):
    x = torch.randn(2, 16)
    with pytest.raises(ValueError, match="impl='cuda'"):
        if op == "qlinear":
            qlinear(x, quantize_weight(torch.randn(4, 16)), impl="cuda")
        elif op == "rmsnorm":
            fused_add_rmsnorm(x, torch.ones(16), impl="cuda")
        elif op == "gemv":
            linear(x, torch.randn(4, 16), impl="cuda")
        elif op == "swiglu":
            fused_swiglu(x, torch.randn(4, 16), torch.randn(4, 16), impl="cuda")
        else:
            q = torch.randn(1, 2, 3, 16)
            gqa_attention(q, q, q, AttnMask(torch.ones(1, 3), 0), impl="cuda")


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl must be one of"):
        fused_add_rmsnorm(torch.randn(2, 16), torch.ones(16), impl="pallas")


def test_auto_on_cpu_counts_plain_calls_only():
    kernels.reset_counters()
    fused_add_rmsnorm(torch.randn(2, 16), torch.ones(16))
    linear(torch.randn(2, 16), torch.randn(4, 16))
    assert kernels.plain_counts()["rmsnorm"] == 1 and kernels.plain_counts()["gemv"] == 1
    assert not any(kernels.launch_counts().values())


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build.find_nvcc()


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tiny_mllama_config()
    return cfg, init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kwargs", [
    {"kv_dtype": "int4"}, {"spec_lookup": 2}, {"spec_draft": 2},
    {"gemv_routes": {"lm_head": 1 << 20}},
])
def test_engine_refuses_unported_options(tiny_model, kwargs):
    """Unported options raise NotImplementedError; a KV dtype the JAX engine
    does not know either (only None and "int8" exist) raises ValueError."""
    cfg, model = tiny_model
    error, match = ((ValueError, "kv_dtype") if "kv_dtype" in kwargs
                    else (NotImplementedError, "ROADMAP.md"))
    with pytest.raises(error, match=match):
        InferenceEngine(model, cfg, "cpu", **kwargs)


@pytest.mark.parametrize("variant", ["w4a8", "w4a8b"])
def test_int4_w4a8_variants_selected_by_env(variant):
    """The JAX package's environment variable (read at import) selects the
    int8-activation int4 gemv: an int4 linear runs the W4A8 plain version
    here and equals it; an int8 linear is unaffected."""
    code = (
        "import torch\n"
        "from llama32mm_tpu_torch.ops import cuda as kernels\n"
        "from llama32mm_tpu_torch.ops.cuda.qgemv import gemv_int4_w4a8_plain\n"
        "from llama32mm_tpu_torch.ops.gemv import qlinear\n"
        "from llama32mm_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4\n"
        "x = torch.randn(2, 64)\n"
        "assert qlinear(x, quantize_weight(torch.randn(8, 64))).shape == (2, 8)\n"
        "qw = quantize_weight_int4(torch.randn(8, 64), group_size=32)\n"
        "kernels.reset_counters()\n"
        "out = qlinear(x, qw)\n"
        "assert kernels.plain_counts()['gemv_int4_w4a8'] == 1\n"
        "assert torch.equal(out, gemv_int4_w4a8_plain(x, qw['q4'], qw['scale']))\n"
        "print('w4a8')\n"
    )
    env = dict(_child_env(), LLAMA32MM_INT4_VARIANT=variant)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["w4a8"]


# An adapter bank: a different head adapter per batch row (leading [B] axis).
_BANK = {"lm_head": {"lora_a": torch.zeros(1, 64, 2), "lora_b": torch.zeros(1, 2, 256),
                     "scaling": torch.ones(1)}}


@pytest.mark.parametrize("kwargs", [
    {"lora": _BANK}, {"attention_mask": torch.zeros(1, 1, 4, 4)}, {"loss_chunk": 4},
    {"collect_stats": True}, {"gemv_routes": {}},
])
def test_vlm_forward_refuses_unported_options(tiny_model, kwargs):
    """LoRA and remat are ported; adapter banks, dense 4D masks, the chunked
    loss, statistics and gemv routes are not."""
    cfg, model = tiny_model
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        vlm_forward(model, cfg, input_ids=torch.zeros(1, 4, dtype=torch.long), **kwargs)


def test_int8_kv_cache_refused():
    """``torch.int8`` is the quantized cache (int8 K/V plus fp32 per-position
    scales); other integer dtypes are refused."""
    tc = tiny_mllama_config().text_config
    cache = init_kv_cache(tc, 2, "cpu", max_length=8, dtype=torch.int8)
    assert cache.quantized
    assert cache.k.dtype == cache.v.dtype == torch.int8
    assert cache.k_scale.dtype == cache.v_scale.dtype == torch.float32
    assert tuple(cache.k_scale.shape) == (tc.n_layers, 2, tc.n_kv_groups, 8)
    assert not init_kv_cache(tc, 2, "cpu", max_length=8).quantized
    with pytest.raises(ValueError, match="int8"):
        init_kv_cache(tc, 1, "cpu", dtype=torch.uint8)


def test_convert_refuses_fused_and_quantized_trees(tiny_model):
    """The fused W_qkv / w_gateup layout is refused, and so is a quantized
    leaf whose shape does not fit its weight (well-formed quantized trees
    convert: tests/test_torch_quant.py)."""
    from llama32mm_tpu_torch.convert import from_jax_params, to_jax_params

    cfg, model = tiny_model
    tree = to_jax_params(model)
    fused = to_jax_params(model)
    fused["language_model"]["model"]["blocks"]["att"]["W_qkv"] = {}
    with pytest.raises(NotImplementedError, match="fused"):
        from_jax_params(fused, cfg, "cpu")
    quant = to_jax_params(model)
    w = quant["language_model"]["model"]["blocks"]["ff"]["w_down"]["weight"]  # [L, K, N]
    quant["language_model"]["model"]["blocks"]["ff"]["w_down"]["weight"] = {
        "q": np.zeros((w.shape[0], w.shape[1] + 1, w.shape[2]), np.int8),
        "scale": np.ones((w.shape[0], w.shape[2]), np.float32)}
    with pytest.raises(ValueError, match="does not fit"):
        from_jax_params(quant, cfg, "cpu")
    assert from_jax_params(tree, cfg, "cpu") is not None


def test_kv_cache_overflow_raises():
    cache = init_kv_cache(tiny_mllama_config().text_config, 1, "cpu", max_length=4)
    kv = torch.zeros(1, 2, 3, 16)
    cache.update(0, kv, kv)
    cache.advance(3)
    with pytest.raises(ValueError, match="overflow"):
        cache.update(0, kv, kv)
