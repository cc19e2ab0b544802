"""llama32mm_tpu_torch — the PyTorch/CUDA port of ``llama32mm_tpu`` for an
NVIDIA H100: the same configurations, models, serving, quantization,
training and tensor-parallel serving, with the TPU's Pallas kernels written
by hand in CUDA C++ (``csrc/``).

The public surface mirrors the JAX package's (``llama32mm_tpu/__init__.py``):
the configs, ``init_vlm_params`` (the port's ``models/vlm.py::init_vlm``,
``(config, device, generator)``), ``vlm_forward``, ``KVCache`` and
``init_kv_cache`` eagerly, and the rest by name on first use.
"""

from llama32mm_tpu_torch.configs import (
    LLAMA32Config,
    MLLAMAConfig,
    VisionEncoderConfig,
    llama32_11b_vision_config,
    llama32_90b_vision_config,
    tiny_mllama_config,
)
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.utils.kvcache import KVCache, init_kv_cache

init_vlm_params = init_vlm  # the JAX package's name

__version__ = "0.1.0"

# Imported when first touched (the tokenizer and image loaders those modules
# reach for are imported lazily in turn).
_LAZY_EXPORTS = {
    "MllamaForConditionalGeneration": "llama32mm_tpu_torch.models.wrapper",
    "Llama3ForCausalLM": "llama32mm_tpu_torch.models.wrapper",
    "Llama3Model": "llama32mm_tpu_torch.models.wrapper",
    "LLAMARMSNorm": "llama32mm_tpu_torch.ops.rmsnorm",
    "FusedSwiGLU": "llama32mm_tpu_torch.ops.swiglu",
    "load_hf_model": "llama32mm_tpu_torch.io.checkpoint",
    "MllamaImageProcessor": "llama32mm_tpu_torch.preprocess.processor",
    "Linear_LORA": "llama32mm_tpu_torch.train.lora",
    "InferenceEngine": "llama32mm_tpu_torch.inference.engine",
    "ContinuousBatchingServer": "llama32mm_tpu_torch.inference.server",
    "ServingFrontend": "llama32mm_tpu_torch.inference.http_server",
    "perplexity": "llama32mm_tpu_torch.evaluate",
    "agreement": "llama32mm_tpu_torch.evaluate",
}


def __getattr__(name: str):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'llama32mm_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    *_LAZY_EXPORTS,
    "LLAMA32Config",
    "MLLAMAConfig",
    "VisionEncoderConfig",
    "llama32_11b_vision_config",
    "llama32_90b_vision_config",
    "tiny_mllama_config",
    "init_vlm_params",
    "vlm_forward",
    "KVCache",
    "init_kv_cache",
    "__version__",
]
