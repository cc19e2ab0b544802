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
    "llama32mm_tpu_torch.ops.cuda.flash_decode", "profile_qgemv", "profile_qmatmul",
    "llama32mm_tpu_torch.ops.cuda.gemv", "llama32mm_tpu_torch.ops.cuda.swiglu", "profile_swiglu",
    "profile_rmsnorm", "llama32mm_tpu_torch.inference.http_server",
    "llama32mm_tpu_torch.io", "llama32mm_tpu_torch.io.checkpoint",
    "llama32mm_tpu_torch.io.native_st", "llama32mm_tpu_torch.io.download",
    "llama32mm_tpu_torch.preprocess", "llama32mm_tpu_torch.preprocess.processor",
    "llama32mm_tpu_torch.inference.cli", "llama32mm_tpu_torch.evaluate",
    "llama32mm_tpu_torch.ops.awq", "llama32mm_tpu_torch.train.data",
    "llama32mm_tpu_torch.train.finetune", "llama32mm_tpu_torch.io.distributed",
    "llama32mm_tpu_torch.train.optim", "llama32mm_tpu_torch",
    "llama32mm_tpu_torch.models.wrapper", "llama32mm_tpu_torch.utils.profiling",
    "llama32mm_tpu_torch.parallel", "llama32mm_tpu_torch.parallel.mesh",
    "llama32mm_tpu_torch.parallel.sharding", "llama32mm_tpu_torch.train.accum",
    "llama32mm_tpu_torch.train.lora", "llama32mm_tpu_torch.train.full",
    "llama32mm_tpu_torch.parallel.pipeline",
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


def test_port_imports_without_the_host_only_packages():
    """The card has torch but no jax, transformers, PIL, safetensors or
    huggingface_hub: every port module and ``chip_smoke`` import without
    them (each is imported inside the function that needs it)."""
    absent = ("jax", "transformers", "PIL", "safetensors", "huggingface_hub")
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{name!r}] = None\n" for name in absent)
        + "".join(f"import {m}\n" for m in PORT_MODULES)
        + f"assert not any(sys.modules.get(n) for n in {absent!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


PROFILERS = ["profile_flash.py", "profile_qgemv.py", "profile_qmatmul.py", "profile_rmsnorm.py",
             "profile_serve.py", "profile_swiglu.py", "profile_train.py"]


@pytest.mark.parametrize("script", PROFILERS)
def test_profile_script_fails_without_gpu(script):
    """Each device-time profiler exits non-zero without a card and prints no
    measurement (its JSON line carries a "card" key; the others print
    kernel rows and ms)."""
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode != 0
    assert "device_ms" not in proc.stdout and '"card"' not in proc.stdout
    assert " ms" not in proc.stdout


def _cpu_args(name):
    x = torch.randn(3, 16)
    if name in ("rmsnorm", "rmsnorm_fwd_train"):
        return x, torch.ones(16), 1e-5
    if name == "rmsnorm_bwd":
        return x, x, torch.ones(16), torch.ones(3)
    if name in ("swiglu_bwd", "swiglu_bwd_tc", "swiglu_bwd_tf32", "swiglu_bwd_rows_tc",
                "swiglu_bwd_rows"):
        return x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(3, 8)
    if name.startswith("flash_attention_bwd"):
        q, lse = torch.randn(1, 2, 3, 16), torch.zeros(1, 2, 3)
        return q, q, q, torch.ones(1, 3), 0, True, lse, lse, q
    if name in ("gemv", "gemv_tc"):
        return x, torch.randn(8, 16)
    if name in ("swiglu", "swiglu_tc", "swiglu_rows_tc", "swiglu_tf32", "swiglu_rows"):
        return x, torch.randn(8, 16), torch.randn(8, 16)
    if name == "swiglu_down":
        return x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(16, 8)
    if name in ("gemv_int8", "gemv_int8_tc", "qmatmul", "qmatmul_tc"):
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
    {"kv_dtype": "int4"}, {"gemv_routes": {"lm_head": 1 << 20}},
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


@pytest.mark.parametrize("kwargs,error,match", [
    ({"attention_mask": torch.zeros(1, 4, 4)}, ValueError, "attention_mask must be"),
    ({"attention_mask": torch.zeros(4)}, ValueError, "attention_mask must be"),
    ({"loss_chunk": 4}, ValueError, "loss_chunk requires labels"),
    ({"gemv_routes": {"lm_head": 1 << 20}}, NotImplementedError, "ROADMAP.md"),
    ({"gemv_routes": {}}, NotImplementedError, "ROADMAP.md"),
])
def test_vlm_forward_refuses_unported_options(tiny_model, kwargs, error, match):
    """Of the JAX forward's options only gemv routes stay unported; a mask
    that is neither 2D, 4D nor an ``AttnMask`` and a chunked loss without
    labels are errors, as in JAX."""
    cfg, model = tiny_model
    with pytest.raises(error, match=match):
        vlm_forward(model, cfg, input_ids=torch.zeros(1, 4, dtype=torch.long), **kwargs)


def _once_refused_features(cfg, model):
    """Each feature that the port once refused with ``not_in_slice``, run once;
    those once refused under tensor parallelism on a one-rank mesh (a
    sharded model whose collectives make no call)."""
    import dataclasses

    from llama32mm_tpu_torch.inference.http_server import ServingFrontend
    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
    from llama32mm_tpu_torch.models.quantize import quantize_llama_params
    from llama32mm_tpu_torch.parallel import shard_params, single_device_mesh
    from llama32mm_tpu_torch.train.full import make_optimizer, make_train_step
    from llama32mm_tpu_torch.train.lora import (
        init_lora_params,
        lora_leaves,
        make_lora_train_step,
    )

    ids = torch.randint(0, 240, (1, 6), generator=torch.Generator().manual_seed(0))
    dense = torch.zeros(1, 1, 6, 6).masked_fill(torch.ones(6, 6).triu(1).bool(), float("-inf"))
    vit = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, attention_dropout=0.1))

    def one_rank(**kw):
        return shard_params(model, cfg, single_device_mesh("cpu"), **kw)

    def server(**kw):
        return ContinuousBatchingServer(one_rank(), cfg, "cpu", slots=2, max_cache_length=32,
                                        prompt_buckets=None, eos_token_id=-1, **kw)

    def bank():
        from llama32mm_tpu_torch.train.lora import stack_adapter_bank, zero_lora_params

        tc = cfg.text_config
        srv = server(adapter_bank=stack_adapter_bank([zero_lora_params(tc, rank=2, device="cpu"),
                                                      init_lora_params(torch.Generator(), tc,
                                                                       rank=2)]))
        rid = srv.submit(ids[0], max_new_tokens=3, adapter_id=1)
        return torch.as_tensor(srv.run()[rid])

    def http():
        frontend = ServingFrontend(server())
        try:
            rid = frontend.submit(ids[0].numpy(), None, 3)
            assert frontend.wait(rid, timeout=60)
            return torch.tensor(frontend.result(rid)["tokens"])
        finally:
            frontend.shutdown()

    def qlora():
        lora = init_lora_params(torch.Generator().manual_seed(1), cfg.text_config, rank=2)
        leaves = list(lora_leaves(lora).values())
        for t in leaves:
            t.requires_grad_(True)
        loss = vlm_forward(quantize_llama_params(model), cfg, input_ids=ids, labels=ids,
                           lora=lora).loss
        return torch.autograd.grad(loss, leaves[0])[0]

    return {
        "qlora": qlora,
        "collect_stats": lambda: vlm_forward(model, cfg, input_ids=ids,
                                             collect_stats=True).stats["inter_absmean"],
        "loss_chunk": lambda: vlm_forward(model, cfg, input_ids=ids, labels=ids,
                                          loss_chunk=2).loss,
        "loss_chunk_steps": lambda: torch.tensor([len(make_train_step(cfg, loss_chunk=2)),
                                                  len(make_lora_train_step(cfg, loss_chunk=2))]),
        "vit_attention_dropout": lambda: vlm_forward(
            model, vit, input_ids=ids, pixel_values=torch.randn(1, 3, 28, 28),
            dropout_rng=torch.Generator().manual_seed(0)).logits,
        "adafactor": lambda: make_optimizer(optimizer="adafactor").init(
            {"w": torch.zeros(128, 128)}).v_row["w"],
        "dense_mask": lambda: vlm_forward(model, cfg, input_ids=ids,
                                          attention_mask=dense).logits,
        "bank_on_a_one_rank_mesh": bank,
        "draft_on_a_one_rank_mesh": lambda: InferenceEngine(
            one_rank(), cfg, "cpu", max_cache_length=32, spec_draft=2,
            draft_params=model.language_model, draft_config=cfg.text_config).generate(
                ids, max_new_tokens=3).tokens,
        "http_on_a_one_rank_mesh": http,
        "vit_dropout_on_a_one_rank_mesh": lambda: vlm_forward(
            one_rank(vision_tp=True), vit, input_ids=ids, pixel_values=torch.randn(1, 3, 28, 28),
            dropout_rng=torch.Generator().manual_seed(0)).logits,
    }


@pytest.mark.parametrize("feature", ["qlora", "collect_stats", "loss_chunk", "loss_chunk_steps",
                                     "vit_attention_dropout", "adafactor", "dense_mask",
                                     "bank_on_a_one_rank_mesh", "draft_on_a_one_rank_mesh",
                                     "http_on_a_one_rank_mesh",
                                     "vit_dropout_on_a_one_rank_mesh"])
def test_refusals_of_earlier_slices_are_gone(tiny_model, feature):
    """Features the port once refused with ``not_in_slice`` now run (their
    agreement with the JAX package: tests/test_torch_{qlora,awq,train_ext}.py)."""
    cfg, model = tiny_model
    out = _once_refused_features(cfg, model)[feature]()
    assert torch.isfinite(out).all()


def test_not_in_slice_sites_left():
    """The refusals left in the port's sources: gemv routes (engine, server,
    language) and the fused layout, both on ROADMAP.md's "Do not port"
    list. ZeRO, the sharded checkpointer, training under tensor
    parallelism, sequence parallelism, the pipeline, and the ViT's dropout,
    adapter banks, the server at dp > 1, draft models and the HTTP front
    end under tensor parallelism are ported."""
    import glob

    sites = []
    for path in sorted(glob.glob(os.path.join(ROOT, "llama32mm_tpu_torch", "**", "*.py"),
                                 recursive=True)):
        with open(path, encoding="utf-8") as f:
            for line in f:
                if "not_in_slice(" in line and "def not_in_slice" not in line:
                    sites.append(os.path.relpath(path, ROOT))
    assert sorted(set(sites)) == [
        "llama32mm_tpu_torch/convert.py", "llama32mm_tpu_torch/inference/engine.py",
        "llama32mm_tpu_torch/inference/server.py", "llama32mm_tpu_torch/models/language.py"]


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


@pytest.mark.parametrize("entry", ["evaluate", "finetune", "prefetch"])
def test_new_entry_points_run_on_the_gpu_unless_asked(entry):
    """The evaluation and fine-tune command lines pick the GPU unless given
    ``--cpu``, and the prefetch stages on the GPU by default: without a card
    each fails instead of falling back to the CPU."""
    from llama32mm_tpu_torch import evaluate
    from llama32mm_tpu_torch.train import finetune
    from llama32mm_tpu_torch.train.data import prefetch_to_device

    if entry == "evaluate":
        args = evaluate.parse_args(["--hf-weights", "w", "--text", "t"])
        assert args.cpu is False and evaluate.parse_args(
            ["--hf-weights", "w", "--text", "t", "--cpu"]).cpu
        return
    if torch.cuda.is_available():
        pytest.skip("a card is present: the GPU path runs instead of failing")
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "finetune":
            assert finetune.parse_args([]).cpu is False
            finetune.main(["--steps", "1"])  # smoke mode on "cuda"
        else:
            next(prefetch_to_device(iter([{"x": np.zeros(1)}])))


def _new_entry_points():
    from llama32mm_tpu_torch.models import wrapper
    from llama32mm_tpu_torch.ops.rmsnorm import LLAMARMSNorm
    from llama32mm_tpu_torch.ops.swiglu import FusedSwiGLU
    from llama32mm_tpu_torch.parallel import mesh
    from llama32mm_tpu_torch.train.lora import zero_lora_params
    from llama32mm_tpu_torch.utils.profiling import trace

    return {"zero_lora_params": zero_lora_params, "trace": trace,
            "init_distributed": mesh.init_distributed,
            "single_device_mesh": mesh.single_device_mesh,
            "MllamaForConditionalGeneration": wrapper.MllamaForConditionalGeneration,
            "Llama3ForCausalLM": wrapper.Llama3ForCausalLM, "Llama3Model": wrapper.Llama3Model,
            "LLAMARMSNorm": LLAMARMSNorm, "FusedSwiGLU": FusedSwiGLU}


@pytest.mark.parametrize("name", ["zero_lora_params", "trace", "init_distributed",
                                  "single_device_mesh", "MllamaForConditionalGeneration",
                                  "Llama3ForCausalLM", "Llama3Model", "LLAMARMSNorm",
                                  "FusedSwiGLU"])
def test_entry_points_of_this_slice_default_to_cuda(name):
    """The object API, the profiler, the mesh and the identity adapter pick
    the card unless the caller asks for the CPU; without a card
    ``zero_lora_params`` fails instead of building on the CPU."""
    import inspect

    assert inspect.signature(_new_entry_points()[name]).parameters["device"].default == "cuda"
    if name == "zero_lora_params" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _new_entry_points()[name](tiny_mllama_config().text_config, rank=2)


def test_create_mesh_needs_a_device_or_a_single_process():
    """Without ``init_distributed`` a one-process mesh defaults to the card;
    no rule picks the CPU by itself."""
    from llama32mm_tpu_torch.parallel import create_mesh

    assert create_mesh().device == torch.device("cuda")
    assert create_mesh(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh(tp=2)
