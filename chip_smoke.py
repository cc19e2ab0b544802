"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``llama32mm_tpu_torch/csrc`` (nvcc,
   sm_90a);
3. compares every kernel with its plain PyTorch version at the shapes the
   bf16, the quantized and the training paths give it, and at ragged
   edges, in bf16, and times both (and the effective weight GB/s of the
   gemvs);
4. checks, on a tiny fp32 model, that the kernel path and the plain path
   generate the same tokens: in float, and quantized to int8 and to the
   int4-mixed recipe with an int8 KV cache;
5. checks, on the tiny fp32 model, that 3 LoRA steps (default targets,
   head and projector adapters) and 3 full fine-tuning steps (the vision
   tower training) agree between the kernel and the plain path, and that
   the kernel path launched every training kernel and no plain version;
6. builds Llama-3.2-11B-Vision shapes in bf16 from a seed, preprocesses a
   560x560 uint8 image on the card and runs ``InferenceEngine.generate``
   greedily for 64 tokens after a 1600-image-token + 32-text-token prompt,
   checking the output and that every kernel of the path, and no plain
   version, ran; prints, as information, the prefill logits' distance to
   the plain path;
7. does the same with an untied head, quantized to int8 and (from the same
   bf16 weights) to ``INT4_MIXED_RECIPE`` at g=128, each served with
   ``kv_dtype="int8"``;
8. LoRA fine-tuning of the 11B bf16 model (rank 16, the default targets
   and a head adapter, Adam) on one B=1, S=1632 batch: a warm-up step and
   3 timed steps; checks finite losses and moments, a bitwise unchanged
   base and the path's kernels; prints ms/step, tokens/s and peak GiB;
9. full fine-tuning of the JAX bench's 3B configuration (fp32 masters,
   bf16 compute, frozen vision tower, AdamW with global-norm clipping),
   the same batch shape and checks, plus a bitwise unchanged vision tower
   without optimizer state;
10. the continuous-batching server (``inference/server.py``): on the tiny
   fp32 model, staggered requests through 2 slots (monolithic and chunked
   admission, float and int8 KV cache) give each request the tokens of a
   solo ``InferenceEngine`` run on the kernel path, and the tiny int4 model
   under ``LLAMA32MM_INT4_VARIANT=w4a8`` decodes the same tokens on the
   kernel and the plain path; at 11B, ``server_bf16`` (the tied bf16 model)
   and ``server_int4_w4a8`` (the untied model in ``INT4_MIXED_RECIPE`` at
   g=128, int8 KV cache, the W4A8 gemv) each serve 10 image requests (S =
   1632, budgets 64 / 32) through 8 slots, 6 submitted at first and 4 after
   one step, checking budgets, ids and the path's kernels; printing
   aggregate decode tokens/s, ms per decode step with 8 slots busy, peak
   GiB and how many requests equal a solo engine run; and, as information,
   a B=1 generate A/B of the W4A8 and W4A16 int4 gemvs;
11. the ``swiglu_down`` op over the 40 layers' FFN weights of the bf16
   model at R=1, against and beside the unfused SwiGLU + gemv pair.

The flash forward runs as three kernels: the tensor-core forward for bf16
calls with many query rows (prefill, the ViT, training), the split-KV decode
kernel for calls with few rows per kv head (decode), and the SIMT forward
for fp32 (the tiny exactness phases). Step 3 also checks that every row of a
B=8 decode call equals, bit for bit, a B=1 call on that row, and prints the
tensor-core forward's time beside the SIMT forward's and SDPA's at the same
shapes. Every bf16 path at 11B and 3B must launch the new kernels and never
the SIMT forward.

Each kernel case also reports its bound (the larger of the bytes it must
move over 3.35 TB/s and its operations over the dense peak for its type)
and, where one PyTorch call computes the same function, that call's time.
The second-to-last line is a JSON summary of the kernels, the last line
``{"ok": true, "device": ...}``. A kernel's ``launches`` there sums the
11B and 3B runs of every path, each counted from 0 just before its
measured run (``launches_by_path`` splits them). Any failure raises before
that line and exits non-zero; without a CUDA device it exits non-zero at
once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from llama32mm_tpu_torch.configs import (
    LLAMA32Config,
    MLLAMAConfig,
    VisionEncoderConfig,
    llama32_11b_vision_config,
    tiny_mllama_config,
)
from llama32mm_tpu_torch.inference.engine import InferenceEngine, structured_prefill_mask
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops import gemv as gemv_mod
from llama32mm_tpu_torch.ops.gemv import linear
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu, swiglu_down
from llama32mm_tpu_torch.ops.cuda.attention import NEG_BIG, allowed_mask
from llama32mm_tpu_torch.ops.cuda.build import build_library
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops.quant import (
    INT4_MIXED_RECIPE,
    quantize_weight,
    quantize_weight_int4,
    unpack_int4,
)
from llama32mm_tpu_torch.preprocess.image import preprocess_image_device
from llama32mm_tpu_torch.train.full import make_train_step
from llama32mm_tpu_torch.train.lora import init_lora_params, lora_leaves, make_lora_train_step
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache, quantize_kv

# bf16 comparisons: |kernel - plain| <= TOL * max|plain|. 1.6e-2 is about two
# bf16 ulps (2^-7 each, relative) of the output rounding: the kernel and the
# plain version round intermediates at different places (fp32 vs bf16 gate
# and up in SwiGLU, bf16 vs fp32 probabilities in attention) and sum in
# different orders.
TOL = 1.6e-2

KERNEL_INFO = {
    "rmsnorm": ("llama32mm_tpu_torch/csrc/rmsnorm.cu", "llama32mm_tpu/ops/pallas/rmsnorm.py:55"),
    "gemv": ("llama32mm_tpu_torch/csrc/gemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:655"),
    "swiglu": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "flash_attention": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                        "llama32mm_tpu/ops/pallas/attention.py:36"),
    "gemv_int8": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:162"),
    "gemv_int4": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:272"),
    "qmatmul": ("llama32mm_tpu_torch/csrc/qmatmul.cu",
                "llama32mm_tpu/ops/pallas/quant_matmul.py:29"),
    "flash_attention_int8kv": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:36"),
    "rmsnorm_fwd_train": ("llama32mm_tpu_torch/csrc/rmsnorm.cu",
                          "llama32mm_tpu/ops/pallas/rmsnorm.py:44"),
    "rmsnorm_bwd": ("llama32mm_tpu_torch/csrc/rmsnorm.cu", "llama32mm_tpu/ops/pallas/rmsnorm.py:62"),
    "swiglu_bwd": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:136"),
    "flash_attention_lse": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                            "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_attention_bwd_dq": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:251"),
    "flash_attention_bwd_dkv": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                                "llama32mm_tpu/ops/pallas/attention.py:322"),
    "gemv_int4_w4a8": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:353"),
    "swiglu_down": ("llama32mm_tpu_torch/csrc/swiglu_down.cu",
                    "llama32mm_tpu/ops/pallas/swiglu.py:217"),
    "flash_attention_tc": ("llama32mm_tpu_torch/csrc/flash_attention_tc.cu",
                           "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_attention_tc_int8kv": ("llama32mm_tpu_torch/csrc/flash_attention_tc.cu",
                                  "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_attention_tc_lse": ("llama32mm_tpu_torch/csrc/flash_attention_tc.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_decode": ("llama32mm_tpu_torch/csrc/flash_decode.cu",
                     "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_decode_int8kv": ("llama32mm_tpu_torch/csrc/flash_decode.cu",
                            "llama32mm_tpu/ops/pallas/attention.py:36"),
}
# Pallas functions a kernel folds in beside the one it is listed against, and
# the pl.pallas_call sites that its Pallas functions reach.
_P = "llama32mm_tpu/ops/pallas/"
ALSO_REPLACES = {
    "rmsnorm": [_P + "rmsnorm.py:119"],
    "rmsnorm_fwd_train": [_P + "rmsnorm.py:91"],
    "rmsnorm_bwd": [_P + "rmsnorm.py:147"],
    "swiglu": [_P + "swiglu.py:98"],
    "swiglu_bwd": [_P + "swiglu.py:98"],
    "swiglu_down": [_P + "swiglu.py:255"],
    "flash_attention": [_P + "attention.py:198"],
    "flash_attention_int8kv": [_P + "attention.py:198"],
    "flash_attention_lse": [_P + "attention.py:198"],
    "flash_attention_tc": [_P + "attention.py:198"],
    "flash_attention_tc_int8kv": [_P + "attention.py:198"],
    "flash_attention_tc_lse": [_P + "attention.py:198"],
    "flash_decode": [_P + "attention.py:198"],
    "flash_decode_int8kv": [_P + "attention.py:198"],
    "flash_attention_bwd_dq": [_P + "attention.py:433"],
    "flash_attention_bwd_dkv": [_P + "attention.py:472"],
    "gemv": [_P + "gemv.py:55", _P + "gemv.py:105", _P + "gemv.py:81", _P + "gemv.py:133",
             _P + "gemv.py:677"],
    "gemv_int8": [_P + "gemv.py:701", _P + "gemv.py:185", _P + "gemv.py:724"],
    "gemv_int4": [_P + "gemv.py:216", _P + "gemv.py:592", _P + "gemv.py:618"],
    "gemv_int4_w4a8": [_P + "gemv.py:419", _P + "gemv.py:561"],
    "qmatmul": [_P + "quant_matmul.py:99", _P + "quant_matmul.py:75",
                _P + "quant_matmul.py:188"],
}
# The kernels each 11B and 3B path must launch: bf16 prefill and the ViT
# through the tensor-core flash forward, decode through the split-KV kernel.
BF16_ATTN = ("flash_attention_tc", "flash_decode")
INT8_KV_ATTN = ("flash_attention_tc", "flash_attention_tc_int8kv", "flash_decode_int8kv")
SERVER_INT4_KERNELS = ("rmsnorm", "gemv_int8", "gemv_int4_w4a8", "qmatmul") + INT8_KV_ATTN
PATH_KERNELS = {
    "bf16": ("rmsnorm", "gemv", "swiglu") + BF16_ATTN,
    "int8": ("rmsnorm", "gemv_int8", "qmatmul") + INT8_KV_ATTN,
    "int4_mixed": ("rmsnorm", "gemv_int8", "gemv_int4", "qmatmul") + INT8_KV_ATTN,
    "server_bf16": ("rmsnorm", "gemv", "swiglu") + BF16_ATTN,
    "server_int4_w4a8": SERVER_INT4_KERNELS,
    "swiglu_down_op": ("swiglu_down",),
}
# The kernels each training path must launch: the fp32 tiny model's forward
# with the LSE is the SIMT kernel's, the bf16 models' the tensor-core one's
# (the frozen ViT's no-grad forward too).
TRAIN_KERNELS = ("rmsnorm_fwd_train", "rmsnorm_bwd", "flash_attention_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
TRAIN_BF16_KERNELS = ("rmsnorm_fwd_train", "rmsnorm_bwd", "flash_attention_tc_lse",
                      "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_tc")
PATH_KERNELS.update({
    "lora_11b": TRAIN_BF16_KERNELS,
    "full_ft_3b": TRAIN_BF16_KERNELS + ("swiglu", "swiglu_bwd"),
})
# The SIMT fp32 forward: the bf16 paths above must never launch it.
SIMT_FORWARD = ("flash_attention", "flash_attention_int8kv", "flash_attention_lse")
# The tiny fp32 model's quantized paths: a 40-token prefill over the int8
# cache (SIMT), the 5-token ViT and decode (split-KV).
TINY_KERNELS = {
    "int8": ("rmsnorm", "gemv_int8", "qmatmul", "flash_attention_int8kv", "flash_decode",
             "flash_decode_int8kv"),
    "int4_mixed": ("rmsnorm", "gemv_int8", "gemv_int4", "qmatmul", "flash_attention_int8kv",
                   "flash_decode", "flash_decode_int8kv"),
}


def path_faults(path: str, launches: dict, plain_calls: dict) -> list:
    """What a path's run got wrong: kernels it should have launched and did
    not, SIMT forwards launched on a bf16 path, plain versions called."""
    faults = [f"skipped {k}" for k in PATH_KERNELS[path] if launches[k] == 0]
    if path != "swiglu_down_op":
        faults += [f"launched the SIMT {k} {launches[k]} times" for k in SIMT_FORWARD
                   if launches[k]]
    return faults + [f"ran plain {k} {n} times" for k, n in plain_calls.items() if n]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(dev, gen):
    """(kernel, label, args, main-path representative?) at the main path's
    shapes (Llama-3.2-11B-Vision, bf16) plus ragged edges."""
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    def valid(b, tk, n):
        kvv = torch.zeros(b, tk, dtype=torch.int32, device=dev)
        kvv[:, :n] = 1
        return kvv

    def q8(n, k):
        qw = quantize_weight(rnd(n, k, scale=0.02))
        return qw["q"], qw["scale"]

    def q4(n, k, g):
        qw = quantize_weight_int4(rnd(n, k, scale=0.02), g)
        return qw["q4"], qw["scale"]

    def kv8(*shape):
        """int8 K, V and their scales, as the int8 cache holds them."""
        (kq, ks), (vq, vs) = quantize_kv(rnd(*shape)), quantize_kv(rnd(*shape))
        return kq, vq, ks, vs

    h, inter, vocab = 4096, 14336, 128256
    cases = [
        ("rmsnorm", "prefill norm2 R=1632 C=4096 +residual",
         (rnd(1632, h), rnd(h), 1e-5, rnd(1632, h)), True),
        ("rmsnorm", "decode norm1 R=1 C=4096", (rnd(1, h), rnd(h), 1e-5, None), False),
        ("rmsnorm", "ragged R=3 C=100 +residual", (rnd(3, 100), rnd(100), 1e-5, rnd(3, 100)), False),
        ("gemv", "lm_head R=1 N=128256 K=4096", (rnd(1, h), rnd(vocab, h)), True),
        ("gemv", "W_query R=1 N=4096 K=4096", (rnd(1, h), rnd(h, h, scale=0.02)), False),
        ("gemv", "W_key R=1 N=1024 K=4096", (rnd(1, h), rnd(1024, h, scale=0.02)), False),
        ("gemv", "w_down R=1 N=4096 K=14336", (rnd(1, inter), rnd(h, inter, scale=0.01)), False),
        ("gemv", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), rnd(1000, 4100, scale=0.02)), False),
        ("swiglu", "prefill R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), True),
        ("swiglu", "decode R=1 H=4096 I=14336",
         (rnd(1, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), False),
        ("swiglu", "ragged R=33 H=100 I=200",
         (rnd(33, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("swiglu", "ragged decode rows R=3 H=100 I=200",
         (rnd(3, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("flash_attention", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1632), 0, True), True),
        ("flash_attention", "ViT-H nq=nkv=16 T=1600 hd=80 non-causal",
         (rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
          valid(1, 1600, 1600), 0, False), False),
        ("flash_attention", "decode Tq=1 Tk=2048 q_offset=1700 hd=128",
         (rnd(1, 32, 1, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1701), 1700, True), False),
        ("flash_attention", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), rnd(2, 2, 100, 16), rnd(2, 2, 100, 16),
          valid(2, 100, 90), 5, True), False),
        ("gemv_int8", "int8 lm_head R=1 N=128256 K=4096", (rnd(1, h), *q8(vocab, h)), True),
        ("gemv_int8", "w_gate R=1 N=14336 K=4096", (rnd(1, h), *q8(inter, h)), False),
        ("gemv_int8", "w_down R=1 N=4096 K=14336", (rnd(1, inter), *q8(h, inter)), False),
        ("gemv_int8", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), *q8(1000, 4100)), False),
        ("gemv_int4", "int4 lm_head R=1 N=128256 K=4096 g=128",
         (rnd(1, h), *q4(vocab, h, 128)), True),
        ("gemv_int4", "w_gate R=1 N=14336 K=4096 g=128", (rnd(1, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "ragged R=5 N=1000 K=4160 g=32", (rnd(5, 4160), *q4(1000, 4160, 32)), False),
        ("gemv_int4", "scalar path R=3 N=200 K=192 g=24", (rnd(3, 192), *q4(200, 192, 24)), False),
        ("qmatmul", "int4 w_gate R=1632 N=14336 K=4096 g=128",
         (rnd(1632, h), *q4(inter, h, 128)), True),
        ("qmatmul", "int8 w_down R=1632 N=4096 K=14336", (rnd(1632, inter), *q8(h, inter)), False),
        ("qmatmul", "int8 W_query R=33 N=4096 K=4096", (rnd(33, h), *q8(h, h)), False),
        ("qmatmul", "int4 w_up R=33 N=14336 K=4096 g=128", (rnd(33, h), *q4(inter, h, 128)), False),
        ("qmatmul", "ragged int8 R=100 N=1000 K=4100", (rnd(100, 4100), *q8(1000, 4100)), False),
        ("qmatmul", "ragged int4 R=70 N=1000 K=4160 g=32",
         (rnd(70, 4160), *q4(1000, 4160, 32)), False),
        ("qmatmul", "int4 element path R=40 N=200 K=192 g=24", (rnd(40, 192), *q4(200, 192, 24)),
         False),
        ("flash_attention_int8kv", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1632), 0, True), True),
        ("flash_attention_int8kv", "decode Tq=1 Tk=2048 q_offset=1700 hd=128",
         (rnd(1, 32, 1, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1701), 1700, True), False),
        ("flash_attention_int8kv", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), *kv8(2, 2, 100, 16), valid(2, 100, 90), 5, True), False),
        ("flash_attention_tc", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1632), 0, True), True),
        ("flash_attention_tc", "ViT-H nq=nkv=16 T=1600 hd=80 non-causal",
         (rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
          valid(1, 1600, 1600), 0, False), False),
        ("flash_attention_tc", "chunked prefill Tq=256 q_offset=1024 Tk=2048 hd=128",
         (rnd(1, 32, 256, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1280), 1024, True), False),
        ("flash_attention_tc", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), rnd(2, 2, 100, 16), rnd(2, 2, 100, 16), valid(2, 100, 90), 5, True),
         False),
        ("flash_attention_tc", "hd=8 nq=4 nkv=2 Tq=70 Tk=90 q_offset=20 causal",
         (rnd(1, 4, 70, 8), rnd(1, 2, 90, 8), rnd(1, 2, 90, 8), valid(1, 90, 90), 20, True), False),
        ("flash_attention_tc", "per-row q_offset B=3 nq=8 nkv=2 Tq=40 Tk=160 hd=64",
         (rnd(3, 8, 40, 64), rnd(3, 2, 160, 64), rnd(3, 2, 160, 64), valid(3, 160, 160),
          torch.tensor([10, 57, 120], dtype=torch.int32, device=dev), True), False),
        ("flash_attention_tc", "hd=96 nq=nkv=2 T=150 non-causal padded keys",
         (rnd(1, 2, 150, 96), rnd(1, 2, 150, 96), rnd(1, 2, 150, 96), valid(1, 150, 140), 0,
          False), False),
        ("flash_attention_tc", "hd=32 B=2 nq=8 nkv=1 Tq=200 Tk=260 q_offset=60 causal",
         (rnd(2, 8, 200, 32), rnd(2, 1, 260, 32), rnd(2, 1, 260, 32), valid(2, 260, 260), 60,
          True), False),
        ("flash_attention_tc_int8kv", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1632), 0, True), True),
        ("flash_attention_tc_int8kv", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), *kv8(2, 2, 100, 16), valid(2, 100, 90), 5, True), False),
    ]
    return cases + server_kernel_cases(rnd, q4, kv8) + training_kernel_cases(rnd, valid)


def server_kernel_cases(rnd, q4, kv8):
    """The server's kernels: the W4A8 int4 gemv at its decode shapes (8 slots;
    R=1 for one request), the SwiGLU+down op, and decode attention over 8
    slots at their own fill levels (per-row query offsets; the prompt's
    bucket padding 1632..1663 blocked, an idle slot at S-1)."""
    h, inter, vocab = 4096, 14336, 128256
    dev = rnd(1).device
    offsets = torch.tensor([1664, 1700, 1727, 1690, 1665, 1800, 2047, 1900], dtype=torch.int32,
                           device=dev)
    kvv = (torch.arange(2048, device=dev)[None, :] <= offsets[:, None].long()).to(torch.int32)
    kvv[:, 1632:1664] = 0
    zero_row = rnd(2, h)
    zero_row[0] = 0
    return [
        ("gemv_int4_w4a8", "w_gate R=8 N=14336 K=4096 g=128", (rnd(8, h), *q4(inter, h, 128)),
         True),
        ("gemv_int4_w4a8", "w_gate R=1 N=14336 K=4096 g=128", (rnd(1, h), *q4(inter, h, 128)),
         False),
        ("gemv_int4_w4a8", "int4 lm_head R=8 N=128256 K=4096 g=128",
         (rnd(8, h), *q4(vocab, h, 128)), False),
        ("gemv_int4_w4a8", "int4 lm_head R=1 N=128256 K=4096 g=128",
         (rnd(1, h), *q4(vocab, h, 128)), False),
        ("gemv_int4_w4a8", "per-channel R=8 N=4096 K=4096 g=4096", (rnd(8, h), *q4(h, h, h)),
         False),
        ("gemv_int4_w4a8", "scalar path R=3 N=200 K=192 g=24", (rnd(3, 192), *q4(200, 192, 24)),
         False),
        ("gemv_int4_w4a8", "an all-zero row R=2 N=1000 K=4096 g=128",
         (zero_row, *q4(1000, h, 128)), False),
        ("swiglu_down", "decode R=1 H=4096 I=14336",
         (rnd(1, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02),
          rnd(h, inter, scale=0.01)), True),
        ("swiglu_down", "R=8 H=4096 I=14336",
         (rnd(8, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02),
          rnd(h, inter, scale=0.01)), False),
        ("swiglu_down", "ragged I R=9 H=96 I=200",
         (rnd(9, 96), rnd(200, 96, scale=0.1), rnd(200, 96, scale=0.1), rnd(96, 200, scale=0.1)),
         False),
        ("swiglu_down", "ragged R=3 H=100 I=37",
         (rnd(3, 100), rnd(37, 100, scale=0.1), rnd(37, 100, scale=0.1), rnd(100, 37, scale=0.1)),
         False),
        ("flash_attention", "server decode B=8 per-row q_offset Tk=2048 hd=128",
         (rnd(8, 32, 1, 128), rnd(8, 8, 2048, 128), rnd(8, 8, 2048, 128), kvv, offsets, True),
         False),
        ("flash_attention_int8kv", "server decode B=8 per-row q_offset Tk=2048 hd=128",
         (rnd(8, 32, 1, 128), *kv8(8, 8, 2048, 128), kvv, offsets, True), False),
    ] + decode_kernel_cases(rnd, kv8, kvv, offsets)


def decode_kernel_cases(rnd, kv8, kvv, offsets):
    """The split-KV decode kernels: the server's 8 slots (main), one
    sequence, a ragged call with a row that sees no key, and fp32 q."""
    dev = kvv.device
    kvv1 = (torch.arange(2048, device=dev) <= 1700).to(torch.int32)[None]
    kvv3 = torch.ones(3, 100, dtype=torch.int32, device=dev)
    kvv3[:, 90:] = 0
    kvv3[0, :6] = 0  # batch row 0, query 0 (position 5) sees no key
    off3 = torch.tensor([5, 40, 80], dtype=torch.int32, device=dev)
    kvv_f = (torch.arange(300, device=dev) <= 250).to(torch.int32)[None].repeat(2, 1)
    cases = []
    for name, kv in (("flash_decode", lambda *sh: (rnd(*sh), rnd(*sh))),
                     ("flash_decode_int8kv", kv8)):
        cases += [
            (name, "server decode B=8 per-row q_offset Tk=2048 hd=128",
             (rnd(8, 32, 1, 128), *kv(8, 8, 2048, 128), kvv, offsets, True), True),
            (name, "decode B=1 Tq=1 Tk=2048 q_offset=1700 hd=128",
             (rnd(1, 32, 1, 128), *kv(1, 8, 2048, 128), kvv1, 1700, True), False),
            (name, "ragged B=3 nq=8 nkv=2 Tq=3 Tk=100 hd=16 per-row q_offset, an empty row",
             (rnd(3, 8, 3, 16), *kv(3, 2, 100, 16), kvv3, off3, True), False),
            (name, "fp32 q B=2 nq=8 nkv=2 Tq=2 Tk=300 q_offset=249 hd=64",
             (rnd(2, 8, 2, 64).float(),
              *(t.float() if t.dtype == torch.bfloat16 else t for t in kv(2, 2, 300, 64)),
              kvv_f, 249, True), False),
            (name, "fp32 q hd=8 nq=nkv=4 T=5 non-causal (the tiny ViT's shape)",
             (rnd(2, 4, 5, 8).float(),
              *(t.float() if t.dtype == torch.bfloat16 else t for t in kv(2, 4, 5, 8)),
              torch.ones(2, 5, dtype=torch.int32, device=dev), 0, False), False),
            (name, "hd=80 nq=nkv=16 Tq=2 Tk=130 non-causal",
             (rnd(1, 16, 2, 80), *kv(1, 16, 130, 80),
              torch.ones(1, 130, dtype=torch.int32, device=dev), 0, False), False),
        ]
    return cases


def training_kernel_cases(rnd, valid):
    """The training kernels at the training paths' shapes (11B LoRA and 3B
    full fine-tuning, B=1, S=1632; ViT-H at 1600 patches) and ragged edges."""
    h, inter = 4096, 14336

    def norm_bwd(r, c, need_dw=True):
        t = rnd(r, c)
        rms = t.float().square().mean(-1).add(1e-5).sqrt()
        return (rnd(r, c), t, rnd(c), rms, need_dw)

    cases = [
        ("rmsnorm_fwd_train", "R=1632 C=4096 +residual", (rnd(1632, h), rnd(h), 1e-5, rnd(1632, h)),
         True),
        ("rmsnorm_fwd_train", "ragged R=3 C=100 +residual",
         (rnd(3, 100), rnd(100), 1e-5, rnd(3, 100)), False),
        ("rmsnorm_bwd", "R=1632 C=4096", norm_bwd(1632, h), True),
        ("rmsnorm_bwd", "R=1632 C=4096 frozen weight", norm_bwd(1632, h, need_dw=False), False),
        ("rmsnorm_bwd", "ragged R=3 C=100", norm_bwd(3, 100), False),
        ("swiglu_bwd", "3B R=1632 H=3072 I=8192",
         (rnd(1632, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(1632, 8192)), True),
        ("swiglu_bwd", "11B R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02), rnd(1632, inter)),
         False),
        ("swiglu_bwd", "ragged R=33 H=100 I=200",
         (rnd(33, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1), rnd(33, 200)), False),
    ]
    masked = valid(2, 100, 90)
    masked[0, :6] = 0  # batch 0, query 0 (position 5) sees no key
    attn = [  # (label, q, k, v, kv_valid, q_offset, causal, main?)
        ("decoder nq=32 nkv=8 T=1632 hd=128 causal", rnd(1, 32, 1632, 128), rnd(1, 8, 1632, 128),
         rnd(1, 8, 1632, 128), valid(1, 1632, 1632), 0, True, True),
        ("3B nq=24 nkv=8 T=1632 hd=128 causal", rnd(1, 24, 1632, 128), rnd(1, 8, 1632, 128),
         rnd(1, 8, 1632, 128), valid(1, 1632, 1632), 0, True, False),
        ("ViT-H nq=nkv=16 T=1600 hd=80 non-causal", rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
         rnd(1, 16, 1600, 80), valid(1, 1600, 1600), 0, False, False),
        ("ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys, a fully masked row",
         rnd(2, 4, 37, 16), rnd(2, 2, 100, 16), rnd(2, 2, 100, 16), masked, 5, True, False),
    ]
    for label, q, k, v, kvv, q_offset, causal, main in attn:
        fwd = (q, k, v, kvv, q_offset, causal)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        dout = rnd(*q.shape)
        delta = (dout.float() * out.float()).sum(-1)
        cases += [("flash_attention_lse", label, fwd, main),
                  ("flash_attention_tc_lse", label, fwd, main),
                  ("flash_attention_bwd_dq", label, (*fwd, lse, delta, dout), main),
                  ("flash_attention_bwd_dkv", label, (*fwd, lse, delta, dout), main)]
    return cases


def max_err(got, want):
    """``(max |got - want|, max |want|)`` over a kernel's outputs (one tensor,
    or a tuple with None for an output not asked for). An lse entry at
    ``NEG_BIG`` (a row with no allowed key) must be so in both versions and
    is left out of both maxima."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = scale = 0.0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise RuntimeError("the kernel and its plain version return different outputs")
        if g is None:
            continue
        g, w = g.float(), w.float()
        empty = w <= NEG_BIG / 2
        if not torch.equal(g <= NEG_BIG / 2, empty):
            raise RuntimeError("the kernel and its plain version mark different rows empty")
        g, w = g[~empty], w[~empty]
        if g.numel():
            err = max(err, (g - w).abs().max().item())
            scale = max(scale, w.abs().max().item())
    return err, scale


# The card's published rates (NVIDIA H100 SXM, dense): 3.35 TB/s of HBM, and
# per operand type the peak that its operations could run at.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def _allowed(kv_valid, q_offset, causal, tq):
    """``[B, Tq, Tk]`` bool: the (query, key) pairs a flash call computes."""
    b, tk = kv_valid.shape
    return allowed_mask(kv_valid, q_offset, causal, tq, tk, kv_valid.device).expand(
        b, 1, 1, tq, tk)[:, 0, 0]


def bound(name, args, out):
    """``(bound_ms, bound_by)``: the larger of the bytes the function must
    move (each input read once, each output written once; for causal
    attention only the keys below each row's limit) over the HBM rate and
    its operations over the peak for its operand type."""
    outs = out if isinstance(out, tuple) else (out,)
    x = args[0]
    in_bytes = _nbytes(args)
    if name.startswith(("flash_attention", "flash_decode")):
        q = args[0]
        int8_kv = name.endswith("int8kv")  # (q, k, v, k_scale, v_scale, kv_valid, ...)
        kvv, q_offset, causal = (args[5], args[6], args[7]) if int8_kv else args[3:6]
        allowed = _allowed(kvv, q_offset, causal, q.shape[2])
        kv_tensors = args[1:5] if int8_kv else args[1:3]
        needed = allowed.any(dim=1).sum().item() / kvv.numel()  # keys some query sees
        in_bytes += (needed - 1.0) * _nbytes(kv_tensors)
        pairs = allowed.sum().item() * q.shape[1]
        per_pair = {"flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 8}.get(name, 4)
        ops = per_pair * q.shape[3] * pairs
    elif name.startswith(("gemv", "qmatmul")):
        rows, n = x.numel() // x.shape[-1], args[1].shape[0]
        ops = 2 * rows * n * x.shape[-1]
    elif name.startswith("swiglu"):
        rows, inter = x.numel() // x.shape[-1], args[1].shape[0]
        ops = {"swiglu_down": 6}.get(name, 4) * rows * x.shape[-1] * inter
    else:  # RMSNorm: a few operations per element
        ops = 4 * x.numel()
    peak = PEAK_OPS[torch.int8 if name == "gemv_int4_w4a8" else x.dtype]
    t_bytes = (in_bytes + _nbytes(outs)) / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _int4pack(q4, scale, x):
    """PyTorch's own int4 weight layout (``_convert_weight_to_int4pack``,
    ``(q - 8) * scale + 0``) holding the same weights, or None."""
    n, ng = scale.shape
    u = (unpack_int4(q4, ng) + 8).to(torch.uint8)  # [N, K] in [0, 15]
    packed = torch.ops.aten._convert_weight_to_int4pack(u[:, ::2] << 4 | u[:, 1::2], 8)
    zeros = torch.zeros_like(scale)
    sz = torch.stack([scale, zeros], dim=-1).transpose(0, 1).contiguous().to(x.dtype)
    return packed, x.shape[-1] // ng, sz


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same inputs
    (a yardstick, never called by the port), or None where there is none."""
    x = args[0]
    if name == "gemv":
        return lambda: F.linear(x, args[1])
    if name == "rmsnorm" and args[3] is None:
        return lambda: F.rms_norm(x, (x.shape[-1],), args[1], args[2])
    if name in ("gemv_int4", "qmatmul") and args[1].dtype == torch.uint8:
        packed, g, sz = _int4pack(args[1], args[2], x)
        x2 = x.reshape(-1, x.shape[-1])
        return lambda: torch._weight_int4pack_mm(x2, packed, g, sz)
    if name in ("gemv_int8", "qmatmul") and args[1].dtype == torch.int8:
        x2, sc = x.reshape(-1, x.shape[-1]), args[2].to(x.dtype)
        return lambda: torch._weight_int8pack_mm(x2, args[1], sc)
    if name in ("flash_attention", "flash_attention_lse", "flash_attention_tc",
                "flash_attention_tc_lse", "flash_decode") or name.startswith("flash_attention_bwd"):
        q, k, v, kvv, q_offset, causal = args[:6]
        mask = _allowed(kvv, q_offset, causal, q.shape[2])[:, None]
        if name.startswith("flash_attention_bwd"):  # SDPA's autograd backward: dq, dk, dv
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*qkv, attn_mask=mask, enable_gqa=True)
            return lambda: torch.autograd.grad(out, qkv, args[8], retain_graph=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    return None


def library_ms(name, label, args):
    """The library call's time, or None: there is none, or it refuses these
    shapes on this card and build (the reason is printed)."""
    try:
        fn = library_call(name, args)
        return None if fn is None else time_ms(fn)
    except (RuntimeError, NotImplementedError) as e:
        log(f"library call for {name} [{label}] unavailable: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]}")
        return None


def check_rows_alone(name, wrapper, args, got) -> None:
    """Each row of a batched decode call equals, bit for bit, the call on
    that row alone with its offset as one int (a solo engine's decode)."""
    offsets = args[-2]
    for b in range(offsets.shape[0]):
        one = [int(offsets[b]) if i == len(args) - 2 else
               a[b:b + 1].contiguous() if isinstance(a, torch.Tensor) else a
               for i, a in enumerate(args)]
        if not torch.equal(wrapper(*one), got[b:b + 1]):
            raise RuntimeError(f"{name}: row {b} of the B={offsets.shape[0]} call differs from "
                               f"the B=1 call on that row")
    log(f"kernel {name}: each of the {offsets.shape[0]} rows equals its B=1 call bit for bit")


def compare_kernels(dev, only=None) -> dict:
    """Every kernel case (those of the kernels in ``only``, when given)
    against its plain version; returns the main-path shapes' numbers."""
    gen = torch.Generator(device=dev).manual_seed(1)
    summary, times, failures = {}, {}, []
    for name, label, args, main in kernel_cases(dev, gen):
        if only is not None and name not in only:
            continue
        wrapper, plain = kernels.KERNELS[name]
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        if not err <= TOL * scale:
            failures.append(f"{name} [{label}] disagrees with its plain version: "
                            f"{err} > {TOL} * {scale}")
            log(failures[-1])
            if only is None:
                break
            continue
        if main and name.startswith("flash_decode"):
            check_rows_alone(name, wrapper, args, got)
        ms, plain_ms = time_ms(lambda: wrapper(*args)), time_ms(lambda: plain(*args))
        lib_ms = library_ms(name, label, args)
        bound_ms, bound_by = bound(name, args, want)
        times[name, label] = (ms, lib_ms)
        rate = ""
        if name.startswith("gemv"):  # weight (and scale) bytes streamed per call
            wbytes = sum(t.numel() * t.element_size() for t in args[1:])
            rate = f" weight_GB/s={wbytes / ms / 1e6:.6g} plain_weight_GB/s={wbytes / plain_ms / 1e6:.6g}"
        log(f"kernel {name} [{label}]: max_abs_err={err:.6g} max_abs_plain={scale:.6g} "
            f"ms={ms:.6g} plain_ms={plain_ms:.6g} library_ms={lib_ms} bound_ms={bound_ms:.6g} "
            f"({bound_by}) share_of_bound={bound_ms / ms:.4g}{rate}")
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if main:  # the summary line reports the main-path shape's times
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms)
        del got, want
    for label in ("decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
                  "ViT-H nq=nkv=16 T=1600 hd=80 non-causal",
                  "server decode B=8 per-row q_offset Tk=2048 hd=128"):
        new = "flash_decode" if label.startswith("server") else "flash_attention_tc"
        if (new, label) in times and ("flash_attention", label) in times:
            (ms, lib), (simt, _) = times[new, label], times["flash_attention", label]
            log(f"yardstick [{label}]: {new} {ms:.6g} ms, SIMT flash_attention {simt:.6g} ms "
                f"({simt / ms:.3g}x), SDPA {lib} ms ({'no slower' if lib and ms <= lib else 'SLOWER'}"
                f" than SDPA)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return summary


def check_tiny_paths_agree(dev) -> None:
    """On a tiny fp32 model, the kernel path and the plain path agree."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, 240, (1, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    raw = torch.randint(0, 256, (1, 28, 28, 3), generator=gen, device=dev, dtype=torch.uint8)
    px = preprocess_image_device(raw, cfg.vision_config.image_size)
    res = {impl: InferenceEngine(model, cfg, dev, impl=impl).generate(ids, px, max_new_tokens=8)
           for impl in ("cuda", "torch")}
    dl = (res["cuda"].prefill_logits - res["torch"].prefill_logits).abs().max().item()
    log(f"tiny fp32: tokens cuda={res['cuda'].tokens.tolist()} torch={res['torch'].tokens.tolist()} "
        f"max_abs_dlogit={dl:.3g}")
    if dl > 1e-4 or not torch.equal(res["cuda"].tokens, res["torch"].tokens):
        raise RuntimeError("tiny model: kernel path and plain path disagree")

    # Quantized, with the int8 cache. The 40-token prompt puts the prefill's
    # linears above the gemv limit, on the dequantizing GEMM.
    ids = torch.randint(0, 240, (1, 40), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    for mode, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE))):
        qmodel = quantize_llama_params(model, **kw)
        res = {}
        for impl in ("cuda", "torch"):
            kernels.reset_counters()
            res[impl] = InferenceEngine(qmodel, cfg, dev, impl=impl, kv_dtype="int8").generate(
                ids, px, max_new_tokens=8)
            if impl == "cuda":
                launches = kernels.launch_counts()
        dl = (res["cuda"].prefill_logits - res["torch"].prefill_logits).abs().max().item()
        log(f"tiny fp32 {mode}, int8 KV: tokens cuda={res['cuda'].tokens.tolist()} "
            f"torch={res['torch'].tokens.tolist()} max_abs_dlogit={dl:.3g} launches {launches}")
        missing = [k for k in TINY_KERNELS[mode] if launches[k] == 0]
        if dl > 1e-4 or not torch.equal(res["cuda"].tokens, res["torch"].tokens) or missing:
            raise RuntimeError(f"tiny {mode} model: kernel path and plain path disagree "
                               f"(or skipped {missing})")


def check_tiny_server(dev) -> None:
    """On the tiny fp32 model, on the kernel path: three staggered requests
    through 2 slots (``steps_per_sync=4``; monolithic admission into the
    (16, 24) buckets, or ``prefill_chunk=4``; float and int8 KV cache) each
    give the tokens of a solo ``InferenceEngine`` run, and no plain version
    runs. The tiny int4 model (g=32) under the W4A8 variant decodes the same
    tokens on the kernel and the plain path."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(4)
    px = torch.randn(1, 3, 28, 28, generator=gen, device=dev)
    prompts = []
    for s, max_new in ((9, 6), (12, 10), (14, 4)):
        ids = torch.randint(0, 240, (s,), generator=gen, device=dev)
        ids[:4] = cfg.image_token_index
        prompts.append((ids, max_new))
    for kv_dtype in (None, "int8"):
        for chunk in (None, 4):
            buckets = (16, 24) if chunk is None else None
            engine = InferenceEngine(model, cfg, dev, prompt_buckets=buckets, kv_dtype=kv_dtype)
            want = [engine.generate(ids[None], px, max_new_tokens=n).tokens[0].tolist()
                    for ids, n in prompts]
            srv = ContinuousBatchingServer(model, cfg, dev, slots=2, prompt_buckets=buckets,
                                           kv_dtype=kv_dtype, steps_per_sync=4,
                                           prefill_chunk=chunk)
            kernels.reset_counters()
            rids = [srv.submit(ids, px, max_new_tokens=n) for ids, n in prompts]
            results = srv.run()
            got = [results[r].tolist() for r in rids]
            plain_calls = kernels.plain_counts()
            log(f"tiny fp32 server kv={kv_dtype} prefill_chunk={chunk}: tokens {got} "
                f"solo engine {want}")
            if got != want or any(plain_calls.values()):
                raise RuntimeError(f"tiny server (kv {kv_dtype}, chunk {chunk}) differs from the "
                                   f"solo engine, or ran plain versions {plain_calls}")
    qmodel = quantize_llama_params(model, bits=4, group_size=32)
    ids = prompts[0][0][None]
    prev, gemv_mod._INT4_VARIANT = gemv_mod._INT4_VARIANT, "w4a8"
    try:
        res = {}
        for impl in ("cuda", "torch"):
            kernels.reset_counters()
            res[impl] = InferenceEngine(qmodel, cfg, dev, impl=impl, kv_dtype="int8").generate(
                ids, px, max_new_tokens=8).tokens
            if impl == "cuda":
                launches = kernels.launch_counts()
    finally:
        gemv_mod._INT4_VARIANT = prev
    log(f"tiny fp32 int4 w4a8: tokens cuda={res['cuda'].tolist()} torch={res['torch'].tolist()} "
        f"w4a8 launches {launches['gemv_int4_w4a8']}")
    if not torch.equal(res["cuda"], res["torch"]) or launches["gemv_int4_w4a8"] == 0:
        raise RuntimeError("tiny int4 w4a8: kernel path and plain path disagree (or no launch)")


def tiny_batch(cfg, dev, gen, b=2, s=12):
    """A tiny training batch: 4 ``<image>`` ids, then text; labels -100 on
    the image positions and on a padded tail of the last row."""
    ids = torch.randint(0, cfg.vocab_size - 10, (b, s), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    labels = ids.clone()
    labels[:, :4] = cfg.ignore_index
    labels[-1, s - 3:] = cfg.ignore_index
    px = torch.randn(b, 3, 28, 28, generator=gen, device=dev)
    return {"input_ids": ids, "labels": labels, "pixel_values": px}


def check_tiny_training(dev) -> None:
    """On a tiny fp32 model, 3 LoRA steps (default targets, head and
    projector adapters) and 3 full fine-tuning steps with the vision tower
    training (so the ViT's flash backward runs) agree between the kernel
    path and the plain path: each step's loss and every trained tensor,
    within 1e-4 relative. Every training kernel launches on the kernel path,
    and no plain version runs there. The learning rate is 1e-4: Adam
    normalizes each element's update, so an element whose true gradient is 0
    (the ViT key bias: a softmax ignores a shift of all its logits) moves by
    up to ~lr a step on rounding noise alone, which differs between the two
    paths; at 1e-3 that noise reached 1.9e-4 of such a tensor."""
    cfg = tiny_mllama_config()
    batch = tiny_batch(cfg, dev, torch.Generator(device=dev).manual_seed(5))

    def lora_run(impl):
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        lora = init_lora_params(torch.Generator(device=dev).manual_seed(3), cfg, rank=4,
                                include_projector=True)
        init_state, step = make_lora_train_step(cfg, learning_rate=1e-4, impl=impl)
        state, losses = init_state(lora), []
        for _ in range(3):
            state, loss = step(model, state, batch)
            losses.append(loss.item())
        return losses, lora_leaves(state.lora)

    def full_run(impl):
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        init_state, step = make_train_step(cfg, learning_rate=1e-4, max_grad_norm=1.0,
                                           freeze_vision=False, impl=impl)
        state, losses = init_state(model), []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(loss.item())
        return losses, state.params

    for label, run, need in (("LoRA", lora_run, TRAIN_KERNELS),
                             ("full FT", full_run, TRAIN_KERNELS + ("swiglu", "swiglu_bwd"))):
        res = {}
        for impl in ("torch", "cuda"):
            kernels.reset_counters()
            res[impl] = run(impl)
            if impl == "cuda":
                launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
        (lt, pt), (lc, pc) = res["torch"], res["cuda"]
        dloss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lc, lt))
        dparam = max(((pc[n] - pt[n]).abs().max() / pt[n].abs().max().clamp(min=1e-12)).item()
                     for n in pt)
        log(f"tiny fp32 {label}, 3 steps: losses cuda={lc} torch={lt} max_rel_dloss={dloss:.3g} "
            f"max_rel_dparam={dparam:.3g} over {len(pt)} tensors; launches {launches}")
        missing = [k for k in need if launches[k] == 0]
        if not dloss <= 1e-4 or not dparam <= 1e-4 or missing or any(plain_calls.values()):
            raise RuntimeError(f"tiny {label}: kernel path and plain path disagree, or skipped "
                               f"{missing}, or ran plain versions {plain_calls}")


def checksums(tensors) -> torch.Tensor:
    """One int64 per tensor: the sum of its bytes read as int16, so any
    changed element shows."""
    return torch.stack([t.detach().contiguous().view(torch.int16).sum(dtype=torch.int64)
                        for t in tensors])


def train_batch(cfg, dev):
    """B=1, S=1632: the 560x560 image's 1600 ``<image>`` ids then 32 text
    ids, labels -100 on the image positions; a random uint8 image."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    image = torch.full((1, vc.num_patches), cfg.image_token_index, device=dev)
    ids = torch.cat([image, text], dim=1)
    labels = torch.cat([torch.full_like(image, cfg.ignore_index), text], dim=1)
    px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
    return {"input_ids": ids, "labels": labels, "pixel_values": px}


def run_steps(path: str, step, state, batch, opt_moments):
    """One warm-up step, then 3 timed steps with the counters set to 0 just
    before them; checks losses and moments, returns ``(state, launches)``."""
    tokens = batch["input_ids"].numel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    log(f"[{path}] warm-up step {time.perf_counter() - t:.4f} s loss {loss.item():.6g}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    losses, times = [], []
    for _ in range(3):
        t = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    ms = 1e3 * statistics.median(times)
    log(f"[{path}] steps (s) {[round(x, 6) for x in times]} losses {losses}; median "
        f"{ms:.2f} ms/step, {tokens / ms * 1e3:.1f} tokens/s; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    mu = list(opt_moments(state))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"[{path}] non-finite loss {losses}")
    if not all(bool(torch.isfinite(m).all()) for m in mu) or not any(bool(m.any()) for m in mu):
        raise RuntimeError(f"[{path}] gradients (first moments) not finite, or all zero")
    faults = path_faults(path, launches, plain_calls)
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    return state, launches


def run_lora_11b(dev) -> dict:
    """LoRA fine-tuning at Llama-3.2-11B-Vision, bf16 base (tied head), rank
    16, alpha 16, the default targets and a head adapter, Adam lr 1e-4."""
    cfg, model = build_11b(dev, tie_weights=True)
    base = [p for p in model.parameters()]
    before = checksums(base)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), cfg, rank=16, alpha=16.0)
    init_state, step = make_lora_train_step(cfg, learning_rate=1e-4)
    state = init_state(lora)
    batch = train_batch(cfg, dev)
    with torch.inference_mode():  # information: the plain path's loss at the start
        plain = vlm_forward(model, cfg, input_ids=batch["input_ids"],
                            pixel_values=batch["pixel_values"], labels=batch["labels"],
                            lora=lora, impl="torch").loss.item()
    log(f"[lora_11b] initial loss, plain path: {plain:.6g}")
    state, launches = run_steps("lora_11b", lambda st, b: step(model, st, b), state, batch,
                                lambda st: st.opt_state.mu.values())
    if not torch.equal(checksums(base), before) or any(p.requires_grad for p in base):
        raise RuntimeError("[lora_11b] the base weights changed or require gradients")
    return launches


def bench_3b_config(dtype: str) -> MLLAMAConfig:
    """The JAX package's 3B bench configuration (bench.py): Llama-3.2-3B text
    widths at full depth, the ViT-H/14 560px vision tower."""
    return MLLAMAConfig(
        vision_config=VisionEncoderConfig(),
        text_config=LLAMA32Config(vocab_size=128256, hidden_size=3072, n_heads=24, n_layers=28,
                                  hidden_dim=8192, n_kv_groups=8, dtype=dtype),
        projection_dim=3072, hidden_size=3072,
    )


def run_full_ft_3b(dev) -> dict:
    """Full fine-tuning at the 3B bench config: fp32 masters, bf16 compute,
    frozen vision tower, AdamW lr 1e-5 with clip_by_global_norm(1.0)."""
    cfg = bench_3b_config("float32")
    t = time.perf_counter()
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"3B model: {sum(p.numel() for p in model.parameters())} parameters, fp32 masters, init "
        f"{time.perf_counter() - t:.3f} s, allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    vision = list(model.vision_model.parameters())
    before = checksums(vision)
    init_state, step = make_train_step(cfg, learning_rate=1e-5, max_grad_norm=1.0,
                                       freeze_vision=True, compute_dtype="bfloat16")
    state = init_state(model)
    batch = train_batch(bench_3b_config("bfloat16"), dev)
    state, launches = run_steps("full_ft_3b", step, state, batch, lambda st: st.opt_state.mu.values())
    frozen_in_opt = [n for n in state.opt_state.mu if n.startswith("vision_model.")]
    if not torch.equal(checksums(vision), before) or frozen_in_opt:
        raise RuntimeError("[full_ft_3b] the vision tower changed or has optimizer state")
    return launches


def build_11b(dev, tie_weights: bool):
    cfg = llama32_11b_vision_config()
    t0 = time.perf_counter()
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=tie_weights)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"11B model ({'tied' if tie_weights else 'untied'} head): {n_params} parameters, bf16, "
        f"init {time.perf_counter() - t0:.3f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return cfg, model


def run_11b(dev, cfg, model, path: str, kv_dtype=None) -> dict:
    """Generate 64 tokens on the 11B model, check the result and that the
    path's kernels, and no plain version, ran; return the launch counts."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    image = torch.full((1, vc.num_patches), cfg.image_token_index, device=dev)
    ids = torch.cat([image, text], dim=1)  # S = 1632
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype)

    def generate(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        res = engine.generate(ids, px, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    generate(2)  # warm-up: library handles, allocator
    _, ttft = generate(1)
    kernels.reset_counters()
    res, t64 = generate(64)
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    decode_tps = 63 / (t64 - ttft)
    log(f"[{path}] generate 64: {t64:.4f} s; TTFT (preprocess+prefill+first token) "
        f"{ttft * 1e3:.2f} ms; decode {decode_tps:.2f} tok/s (63 tokens after the first); "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    log(f"[{path}] tokens {res.tokens[0].tolist()}")

    if tuple(res.tokens.shape) != (1, 64) or int(res.num_generated[0]) != 64:
        raise RuntimeError(f"expected 64 tokens, got {tuple(res.tokens.shape)} / {res.num_generated}")
    if not bool(((res.tokens >= 0) & (res.tokens < tc.vocab_size)).all()):
        raise RuntimeError("generated ids outside the vocabulary")
    if tuple(res.prefill_logits.shape) != (1, tc.vocab_size) or not bool(
            torch.isfinite(res.prefill_logits).all()):
        raise RuntimeError("prefill logits are not finite [1, vocab]")
    faults = path_faults(path, launches, plain_calls)
    if faults:
        raise RuntimeError(f"[{path}] {faults}")

    # Information: the same prefill on the plain path (random-init greedy
    # tokens are near-ties, so token equality is not asserted).
    with torch.inference_mode():
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        pos = torch.tensor([[ids.shape[1] - 1]], device=dev)
        if kv_dtype is None:
            plain = vlm_forward(model, cfg, input_ids=ids, pixel_values=px, impl="torch",
                                logits_positions=pos)
        else:  # through an int8 cache, as the engine's prefill
            cache = init_kv_cache(tc, 1, dev, max_length=2048, dtype=torch.int8)
            mask = structured_prefill_mask(torch.ones_like(ids, dtype=torch.int32), 2048)
            plain = vlm_forward(model, cfg, input_ids=ids, pixel_values=px, impl="torch",
                                attention_mask=mask, kv_cache=cache, logits_positions=pos)
            del cache
    dl = (plain.logits[:, 0].float() - res.prefill_logits.float()).abs().max().item()
    log(f"[{path}] prefill logits, kernel path vs impl='torch': max_abs_dlogit={dl:.6g} "
        f"max_abs_logit={res.prefill_logits.float().abs().max().item():.6g}")
    return launches


def server_requests(cfg, dev, n: int = 10):
    """Request ``i``: a seeded 560x560 image (1600 ``<image>`` ids) and 32
    seeded text ids (S = 1632), a budget of 64 tokens when ``i`` is even and
    32 when it is odd; ``(ids [S], pixel values [1, 3, H, W], budget)``."""
    tc, vc = cfg.text_config, cfg.vision_config
    reqs = []
    for i in range(n):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
        text = torch.randint(0, tc.vocab_size, (32,), generator=gen, device=dev)
        ids = torch.cat([torch.full((vc.num_patches,), cfg.image_token_index, device=dev), text])
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        reqs.append((ids, px, 64 if i % 2 == 0 else 32))
    return reqs


def run_server(dev, cfg, model, path: str, kv_dtype=None) -> dict:
    """The continuous-batching server at 8 slots, S_max 2048: 10 requests,
    6 submitted, one step, then 4 more, so admissions land mid-decode and in
    freed slots. Checks budgets, ids and the path's kernels (and no plain
    version); prints decode tokens/s, ms per decode step with 8 slots busy,
    peak GiB, launches and how many requests equal a solo engine run."""
    tc = cfg.text_config
    reqs = server_requests(cfg, dev)
    srv = ContinuousBatchingServer(model, cfg, dev, slots=8, max_cache_length=2048,
                                   kv_dtype=kv_dtype)
    warm = srv.submit(reqs[0][0], reqs[0][1], max_new_tokens=2)  # handles, allocator
    srv.run()
    srv.release(warm)
    chunks = []  # (steps, busy slots, seconds) per decode chunk
    decode = srv._decode

    def timed_decode(n):
        busy = sum(r is not None for r in srv._by_slot)
        t = time.perf_counter()
        toks = decode(n)  # ends in the chunk's one device-to-host copy
        chunks.append((n, busy, time.perf_counter() - t))
        return toks

    srv._decode = timed_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    rids = [srv.submit(ids, px, max_new_tokens=n) for ids, px, n in reqs[:6]]
    srv.step()
    rids += [srv.submit(ids, px, max_new_tokens=n) for ids, px, n in reqs[6:]]
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    decode_s = sum(c[2] for c in chunks)
    decode_tokens = sum(len(results[r]) for r in rids) - len(rids)
    full = [1e3 * sec / n for n, busy, sec in chunks if busy == 8]
    log(f"[{path}] 10 requests in {wall:.4f} s; {len(chunks)} decode chunks, "
        f"{sum(c[0] for c in chunks)} steps, {decode_s:.4f} s: {decode_tokens} decode tokens, "
        f"{decode_tokens / decode_s:.2f} tok/s aggregate; ms per decode step with 8 slots busy: "
        f"median {statistics.median(full) if full else float('nan'):.4f} over {len(full)} chunks; "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    for i, r in enumerate(rids):
        toks = results[r]
        if len(toks) != reqs[i][2] or not ((toks >= 0) & (toks < tc.vocab_size)).all():
            raise RuntimeError(f"[{path}] request {i}: {len(toks)} tokens for a budget of "
                               f"{reqs[i][2]}, or ids outside the vocabulary")
    faults = path_faults(path, launches, plain_calls)
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    if launches["gemv_int4"]:
        raise RuntimeError(f"[{path}] the W4A16 gemv launched {launches['gemv_int4']} times")
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype,
                             prompt_buckets="auto")
    same = sum(engine.generate(ids[None], px, max_new_tokens=n).tokens[0].tolist()
               == results[r].tolist() for r, (ids, px, n) in zip(rids, reqs))
    log(f"[{path}] requests whose tokens equal a solo InferenceEngine run: {same}/{len(rids)}")
    return launches


def int4_variant_ab(dev, cfg, qmodel) -> None:
    """Information: B=1 generates of one request with the W4A16 (post) and
    the W4A8 int4 gemv, in turns (post, w4a8, w4a8, post)."""
    ids, px, _ = server_requests(cfg, dev, 1)[0]
    engine = InferenceEngine(qmodel, cfg, dev, max_cache_length=2048, kv_dtype="int8")

    def generate(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.generate(ids[None], px, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prev = gemv_mod._INT4_VARIANT
    try:
        for variant in ("post", "w4a8", "w4a8", "post"):
            gemv_mod._INT4_VARIANT = variant
            generate(2)
            ttft, t64 = generate(1), generate(64)
            log(f"[int4 A/B] {variant}: TTFT {ttft * 1e3:.2f} ms, decode "
                f"{63 / (t64 - ttft):.2f} tok/s (B=1, 63 tokens after the first)")
    finally:
        gemv_mod._INT4_VARIANT = prev


def run_swiglu_down_op(dev, model) -> dict:
    """The ``swiglu_down`` op over the 40 layers' FFN weights at R=1,
    checked against the unfused SwiGLU + gemv pair and timed beside it."""
    ffs = [(b.ff.w_gate.weight, b.ff.w_up.weight, b.ff.w_down.weight)
           for b in model.language_model.model.blocks]
    x = torch.randn(1, ffs[0][2].shape[0], generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).to(ffs[0][0].dtype)
    torch.cuda.synchronize()
    kernels.reset_counters()
    fused = [swiglu_down(x, *w) for w in ffs]
    torch.cuda.synchronize()
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    unfused = [linear(fused_swiglu(x, wg, wu), wd) for wg, wu, wd in ffs]
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(fused, unfused))
    scale = max(b.float().abs().max().item() for b in unfused)
    fused_ms = time_ms(lambda: [swiglu_down(x, *w) for w in ffs], reps=3) / len(ffs)
    unfused_ms = time_ms(lambda: [linear(fused_swiglu(x, wg, wu), wd) for wg, wu, wd in ffs],
                         reps=3) / len(ffs)
    log(f"[swiglu_down_op] {len(ffs)} layers, R=1: max_abs_err vs SwiGLU+gemv {err:.6g} "
        f"(max {scale:.6g}); ms per layer: swiglu_down {fused_ms:.6g}, SwiGLU + gemv "
        f"{unfused_ms:.6g}; launches {launches['swiglu_down']}")
    if launches["swiglu_down"] != len(ffs) or any(plain_calls.values()) or not err <= TOL * scale:
        raise RuntimeError(f"[swiglu_down_op] launches {launches['swiglu_down']}, plain calls "
                           f"{plain_calls}, or {err} > {TOL} * {scale}")
    return launches


def run_11b_paths(dev) -> dict:
    """The bf16 path (tied head) and its server, then int8 and int4-mixed
    quantized copies of one untied bf16 model, each served from an int8 KV
    cache; the int4-mixed copy also through the server with the W4A8 gemv."""
    by_path = {}
    cfg, model = build_11b(dev, tie_weights=True)
    by_path["bf16"] = run_11b(dev, cfg, model, "bf16")
    by_path["server_bf16"] = run_server(dev, cfg, model, "server_bf16")
    by_path["swiglu_down_op"] = run_swiglu_down_op(dev, model)
    del model
    torch.cuda.empty_cache()
    cfg, model = build_11b(dev, tie_weights=False)
    for path, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=128, recipe=INT4_MIXED_RECIPE))):
        t = time.perf_counter()
        qmodel = quantize_llama_params(model, **kw)
        torch.cuda.synchronize()
        log(f"[{path}] quantize {time.perf_counter() - t:.3f} s, "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats()
        by_path[path] = run_11b(dev, cfg, qmodel, path, kv_dtype="int8")
        if path == "int4_mixed":
            prev, gemv_mod._INT4_VARIANT = gemv_mod._INT4_VARIANT, "w4a8"
            try:
                by_path["server_int4_w4a8"] = run_server(dev, cfg, qmodel, "server_int4_w4a8",
                                                         kv_dtype="int8")
            finally:
                gemv_mod._INT4_VARIANT = prev
            int4_variant_ab(dev, cfg, qmodel)
        del qmodel
        torch.cuda.empty_cache()
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    lib = build_library()
    log(f"kernel build {time.perf_counter() - t:.3f} s: {lib.name}")

    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--kernels":  # a quick check of some kernels alone
        only = sys.argv[2].split(",")
    summary = compare_kernels(dev, only)
    if only is not None:
        return 0
    torch.cuda.empty_cache()
    check_tiny_paths_agree(dev)
    check_tiny_server(dev)
    check_tiny_training(dev)
    by_path = run_11b_paths(dev)
    torch.cuda.empty_cache()
    by_path["lora_11b"] = run_lora_11b(dev)
    torch.cuda.empty_cache()
    by_path["full_ft_3b"] = run_full_ft_3b(dev)

    out = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "also_replaces": ALSO_REPLACES.get(name, []),
                    "launches": sum(counts[name] for counts in by_path.values()),
                    "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
                    "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                    "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                    "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
