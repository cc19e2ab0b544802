"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``llama32mm_tpu_torch/csrc`` (nvcc,
   sm_90a);
3. compares every kernel with its plain PyTorch version at the shapes the
   bf16, the quantized and the training paths give it, and at ragged
   edges, in bf16 (and the fp32 flash kernels in fp32 too), and times both
   (and the effective weight GB/s of the gemvs);
4. checks, on a tiny fp32 model, that the kernel path and the plain path
   generate the same tokens: in float, and quantized to int8 and to the
   int4-mixed recipe with an int8 KV cache;
5. checks, on the tiny fp32 model, that 3 LoRA steps (default targets,
   head and projector adapters) and 3 full fine-tuning steps (the vision
   tower training) agree between the kernel and the plain path, and that
   the kernel path launched every training kernel and no plain version;
   and, on the tiny model in bf16, that 3 LoRA steps give the plain path's
   losses through the tensor-core flash backward; then ``vit_h_fp32``: the
   11B's ViT-H/14 tower, all 32 layers, in fp32 on one 560x560 image, the
   kernel path within 1e-4 of the plain path with the 3xTF32 forward
   launched once a layer; and ``fp32_autograd``: ``gqa_attention`` under
   autograd in fp32 at the decoder and ViT-H shapes, out, dq, dk and dv
   within 1e-5 of ``impl="torch"``;
6. builds Llama-3.2-11B-Vision shapes in bf16 from a seed, preprocesses a
   560x560 uint8 image on the card and runs ``InferenceEngine.generate``
   greedily for 64 tokens after a 1600-image-token + 32-text-token prompt,
   checking the output and that every kernel of the path, and no plain
   version, ran; prints, as information, the prefill logits' distance to
   the plain path;
7. does the same with an untied head, quantized to int8 and (from the same
   bf16 weights) to ``INT4_MIXED_RECIPE`` at g=128, each served with
   ``kv_dtype="int8"``; each prefill must run its 280 quantized linears (7
   a layer) through the wgmma dequantizing GEMM on x as it is and none
   through its general route (a pre-pass, then the same kernel), and the int4-mixed run must launch the W4A16 gemv 81 times a decode
   step (``w_gate`` and ``w_up`` of 40 layers, the head); the tensor-core
   int8 gemv must serve every int8 decode linear (281 a step and the
   prefill's head in int8, 200 a step in int4-mixed), its general route
   (fp32 x, ragged K, misaligned pointers) none;
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
   one step, checking budgets, ids and the path's kernels (the W4A8 gemv,
   on the tensor cores at every call, 81 times a decode step and once a
   prefill's head, the tensor-core int8 gemv 200 times a decode step, its
   general route never); printing
   aggregate decode tokens/s, ms per decode step with 8 slots busy, peak
   GiB and how many requests equal a solo engine run; and, as information,
   a B=1 generate A/B of the W4A8 and W4A16 int4 gemvs;
11. the ``swiglu_down`` op over the 40 layers' FFN weights of the bf16
   model at R=1, against and beside the unfused SwiGLU + gemv pair;
12. speculative decoding: on the tiny fp32 model, prompt lookup (K=3) and
   a seeded one-layer draft (K=3) give the plain engine's tokens on the
   kernel and the plain path, lookup accepts on a cyclic continuation, and
   the spec server (K=3, staggered submits) gives each request the solo
   engine's tokens; at 11B in bf16, ``bf16_spec_lookup`` (K=4) and
   ``bf16_spec_draft`` (K=4, a random draft at Llama-3.2-1B's published
   widths) generate 64 tokens after the smoke's image and 32 text ids that
   hold a 16-id phrase twice, each with its exact launches (the target's
   201 tensor-core gemvs, 40 SwiGLU rows calls and 40 flash decodes a
   verify step, the draft's R = 1 steps on top), 1-63 verify steps and no
   plain call; a self-draft (the 11B's own decoder, a text-only prompt)
   the same; ``server_bf16_spec`` serves the ``server_bf16`` traffic with
   K=3 (32 verify rows: the gemv and the TMA SwiGLU tile), with its exact
   launches. Each prints TTFT or ms a verify step, tokens/s, tokens a
   step and, as information, how many leading tokens equal the plain
   path's (random weights give near-tied logits, and a verify's bits may
   differ from a decode step's);
13. the rest of the server: on the tiny fp32 model, on the kernel path with
   no plain version called, prefix caching (a text prefix matched on its
   own under float and int8 KV, an image prefix pinned by id, one under
   ``prefill_chunk=4``, one with ``spec_lookup=2``) gives each request a
   solo engine's tokens on the full prompt; a 3-adapter bank (the identity
   and two seeded adapters) gives each request the tokens of a solo engine
   on its merged model, an adapter-specific prefix included; the HTTP front
   end on loopback (``/prefix``, ``/generate``, a concurrent pair,
   ``/generate_stream``) gives the direct server's tokens. At 11B in bf16
   (the tied model, 8 slots): ``server_bf16_prefix`` registers one image and
   16 system ids (P = 1616) and serves 10 requests of that prefix and 32
   question ids each (budgets 64 / 32, the ``server_bf16`` pattern),
   printing the registration's ms, the ms per prefixed admission against
   ``server_bf16``'s unprefixed one, the prefix's GiB, tokens/s and how many
   requests equal a solo engine on the full prompt; ``http_bf16`` sends that
   traffic through the front end (the prefix by ``POST /prefix``, then 9
   ``/generate`` and 1 ``/generate_stream`` at once) and counts the requests
   equal to the direct run's; ``server_bf16_lora`` serves the
   ``server_bf16`` traffic with a bank of the identity and two seeded
   rank-16 adapters (default targets and the head; request ``i`` adapter
   ``i % 3``), printing ms and kernel launches a decode step (a profiled
   chunk) and tokens/s against ``server_bf16``, peak GiB, and whether the
   identity adapter's requests equal the plain server's. Each checks its
   exact launches: 201 tensor-core gemvs a decode step on the prefix paths
   (a prefix's prefill and each 128-row suffix one TMA SwiGLU tile a layer),
   281 with the bank, whose gate/up adapters leave every SwiGLU kernel at 0;
14. checkpoint loading (``load_11b``): a seeded untied bf16 model at
   Llama-3.2-11B-Vision widths, its depth cut to 4 decoder and 2 ViT
   layers (printed), saved by ``save_checkpoint_params`` in 1 GiB shards
   with an index under ``build/`` (removed at the end), its config rebuilt
   from ``config.json``, loaded three ways through the native reader: host
   bf16, streaming int8 and streaming ``INT4_MIXED_RECIPE`` (quantize on
   load). Each load's report must be empty and every tensor bit-equal to
   the saved model (bf16) or to its quantization by ``quantize_weight`` /
   ``quantize_weight_int4`` with ``compiled=True`` at the recipe's bits;
   each loaded model then generates 32 greedy tokens after a seeded
   3024x4032 photo resized on the card (``preprocess_image_device``) and 32
   text ids, with the path's exact launches (int8 KV cache for the
   quantized loads) and the tokens of the same generate on the reference
   model. The resize on the card must be within 1e-3 of the CPU's (0-255
   scale). Prints each load's seconds and GB/s, its peak GiB beside the
   loaded model's, the preprocess ms and the phase's seconds;
15. QLoRA (``qlora_11b_int8``, ``qlora_11b_int4_mixed``): rank-16 adapters
   (the default targets and the head, Adam lr 1e-4, ``remat=True``,
   ``loss_chunk=512``, 2 accumulated microbatches of B=1) over the untied
   11B quantized to int8 and to ``INT4_MIXED_RECIPE`` at g=128, trained by
   the fine-tune command line's loop (``train/finetune.py::finetune_loop``)
   on S=1632 rows that ``PackedBatchIterator`` packs from seeded token
   documents of the 11B vocabulary and ``prefetch_to_device`` stages: a
   warm-up and 3 timed steps (ms a step, tokens/s, peak GiB), then a run of
   2 steps that saves its state and data position through
   ``TrainCheckpointManager`` and a run that restores them into a fresh
   state and iterator and goes on to step 4, whose adapters must equal the
   uninterrupted run's (rtol 1e-5; bit-equality printed); checks finite
   losses, the base's bytes unchanged, the adapters moved and the exact
   launches of the wgmma ``qmatmul``, the flash forward with the LSE and its
   backward and the RMSNorm training forward and backward;
16. evaluation (``eval_11b_*``, ``calibrate_11b``) on the tied bf16 11B:
   ``perplexity`` over 2 windows of 2048 seeded ids on the kernel path and
   on ``impl="torch"`` (NLL per token within 1% of each other), on its int8
   copy through an int8 KV cache, ``agreement`` of bf16 with int8 and with
   ``INT4_MIXED_RECIPE`` quantized plain (RTN) and after ``awq_equalize``
   (information: random weights give near-tied logits), and
   ``calibrate_stats`` at S=1632 with the image (its ms); exact launches;
17. ``finetune_cli_tiny``: the fine-tune command line's smoke mode on the
   card with ``--run-dir``, 3 steps, then rerun to 6 (resumed), whose
   adapters must equal an uninterrupted 6-step run's bit for bit; every
   training kernel launched, no plain version;
18. ``wrapper_profiling``: the object API's logits equal ``vlm_forward``'s,
   and ``utils/profiling.py::trace`` around a bf16 generate at the 11B
   widths names the three phases and the hand kernels;
19. ``tp_tiny``: the tiny model at tp=2 (fp32, int8 and int4-mixed
   weights): every rank's engine and server tokens (monolithic and chunked,
   float and int8 KV) equal the one-device kernel path's exactly; then, on
   the fp32 kernel path, the features once refused under tensor
   parallelism: ``tp_tiny_bank`` (the 3-adapter bank's traffic, each rank's
   tokens equal to the one-device bank server's), ``tp_tiny_draft`` (the
   one-layer draft whole and sharded, the one-device draft engine's
   tokens), ``tp_tiny_http`` (rank 0 serves the HTTP traffic on loopback,
   rank 1 follows its log: the direct one-device server's tokens, equal
   records on both ranks), ``tp_tiny_vit_dropout`` (a full fine-tuning step
   with ``vision_tp`` and ViT attention dropout: loss and the tower's
   gradients within ``TINY_VIT_TOL`` of the one-device step's) and
   ``tp_tiny_dp_server`` (a 4-slot pool, greedy, sampled and chunked over
   int8 KV, at dp=2 x tp=2 on four ranks, equal to tp=2's), each launching
   its kernels and no plain version;
20. ``tp_11b_bf16``, ``tp_11b_server_bf16`` and ``tp_11b_int4_mixed``: the
   11B at full depth and tp=2 (NCCL with a GPU a rank, else two ranks
   sharing the card over gloo): every rank launches each kernel of the path
   at its sharded shape and no plain version, the ranks' tokens are equal,
   and the prefill logits stay within twice the one-device kernel path's
   distance from ``impl="torch"`` of that path; on the bf16 model,
   ``tp_11b_server_bf16_lora`` (the 4 requests with ``server_bf16_lora``'s
   bank, adapters ``i % 3``, no SwiGLU kernel), ``tp_11b_bf16_spec_draft``
   (the random 1B-width draft whole on each rank, K=4, 32 tokens, the exact
   launches) and ``tp_11b_http_bf16`` (the 4 requests over loopback HTTP,
   rank 1 following: the direct tp=2 server's tokens); every rank's tokens
   equal; ``tp_dp_server_11b``: the 11B widths cut to ``TP_DP_DEPTH`` (8 of
   40 decoder, 8 of 32 ViT layers), 8 image requests (4 greedy, 4 sampled)
   through 8 slots at tp=2, then at dp=2 x tp=2 on four ranks: every rank's
   tokens equal tp=2's;
21. ``tp_lora_11b``: ``lora_11b`` at tp=2 (the tied bf16 11B at full
   depth, rank-16 adapters with the head's, B=1 S=1632, a warm-up and 3
   timed steps): both ranks' losses and adapters bit-equal after every
   step, the base unchanged, the first loss within twice the one-device
   kernel path's distance from ``impl="torch"`` of ``lora_11b``'s first
   loss, the flash LSE forward, dq and dk/dv at 16 query and 4 kv heads and
   the training RMSNorm at 4096 on every rank, no plain version;
22. ``zero1_full_ft_3b``: full fine-tuning of the 3B bench widths (cut to
   ``ZERO1_DEPTH``) at dp=2 × tp=2, four ranks (fp32 masters, bf16
   compute, AdamW, clip 1.0, B=2 S=1632), 3 steps without ZeRO-1 and 3
   with ZeRO-1 and dp-sharded masters: the losses within rtol 3e-4 of each
   other, each decoder matrix's Adam moments a quarter of the whole, the
   SwiGLU tile forward and backward at I=4096 and the flash training
   kernels at 12 / 4 heads on every rank; a ``ShardedCheckpointer`` save
   after step 2, step 3 from the restored state bit-equal to the straight
   run's, and the saved masters restored onto dp=4 × tp=1 equal to them;
23. ``sp_lora_11b``: ``lora_11b`` at sp=2 (two ranks, the tied bf16 11B at
   full width and depth, B=1 S=4096, 2048 tokens a rank, the image in the
   first chunk; ``remat``, ``loss_chunk=1024``; a warm-up and 3 timed
   steps): both ranks' losses and adapters bit-equal after every step, the
   base unchanged, the first loss within twice the distance between the
   one-device kernel path and ``impl="torch"`` on the same batch
   (``run_lora_11b`` keeps both), and on every rank exactly 2 ring steps of
   the flash LSE forward (twice: ``remat``), dq and dk/dv a layer at 32 / 8
   heads and Tq = Tk = 2048, the training RMSNorm at 4096, no plain
   version; ms a step, peak GiB and the bytes ``ppermute`` sent a step;
24. ``pp_full_ft_3b``: ``make_pipeline_train_step`` over the 3B bench
   widths, text only, at ``ZERO1_DEPTH``'s decoder depth split into 2
   stages, four ranks at pp=2 × dp=2 (bf16, Adam lr 1e-4, 2 microbatches,
   B=4 S=1632, ``loss_chunk=512``), 3 steps: each loss within twice the
   distance between the unpipelined kernel path and the unpipelined
   ``impl="torch"`` path at that step (both trained on one device first),
   the replicated leaves bit-equal on every rank after every step, and on
   every rank the SwiGLU tile forward and backward at I=8192 and the flash
   training kernels at 24 / 8 heads exactly (M + pp - 1) x the stage's 4
   layers a step; ms a step, the bubble share and peak GiB.

The ``ring`` kernel cases of step 3 run the flash LSE forward, dq and dk/dv
at the ring's shapes (32 / 8 heads, Tq = Tk = 2048) at a chunk wholly in the
future (``q_offset = -2048``: the output and every gradient exactly 0, the
LSE exactly ``NEG_BIG``), the diagonal and a chunk wholly in the past, and
a backward fed the LSE and delta of a two-chunk merge.

The flash forward runs as three kernels: the tensor-core forward for bf16
calls with many query rows (prefill, the ViT, training), the split-KV decode
kernel for calls with few rows per kv head (decode), and the 3xTF32 forward
for fp32 (the tiny exactness phases, ``vit_h_fp32``). The flash backward
runs as two pairs: the tensor-core dq and dk/dv kernels for bf16 (every
training path at 11B and 3B), and for fp32 the 3xTF32 dq and dk/dv. The
SwiGLU's fp32 calls above 8 rows and every fp32 SwiGLU backward run the
3xTF32 tile (``swiglu_tf32``, ``swiglu_bwd_tf32``); a bf16 SwiGLU backward
of at most 8 rows runs a rows kernel's backward (``swiglu_bwd_rows_tc``,
``swiglu_bwd_rows``), a bf16 call of more rows the TMA tile, on the
operands as they are or, where TMA cannot read them (H not a multiple of 8,
an operand off 16-byte alignment), after the general route's pre-pass has
copied those (``swiglu``, ``swiglu_bwd``). Step 3 also checks that every row
of a B=8 decode call equals, bit for bit, a B=1 call on that row, and that
two calls of a tensor-core backward kernel give the same bits; that each row
of the int4 W4A16 gemv's R=8, 16 and 32 calls equals its R=1 call bit for
bit and two calls of each int4 case give the same bits; that 50 calls of the
tensor-core forward at hd 8 (bf16 and int8 KV) give the same bits (the
zero-fill of its head-dim padding once raced its copies); that the model's
entry ``qmatmul_cuda`` routes each wgmma GEMM case to the wgmma kernel on x
as it is, and each case of its general route (fp32 x as three bf16 planes,
ragged K, other int4 groups, misaligned x or q; the bf16 shapes it would
read as they are forced there) to that route, two of its calls give the same
bits, and rows 0-96 of each R=1632 call equal an R=97 call bit for bit; that
the model's gemv entry routes each tensor-core gemv case there, two calls
give the same bits and each row of an R = 2-32 call equals its R = 1 call;
that the model's SwiGLU entries route each TMA-tile case (forward and
backward) there, two calls give the same bits and rows 0-96 of each R=1632
call equal an R=97 call; and prints the tensor-core forward's and backward's
times beside the fp32 kernels' and SDPA's at the same shapes. The 3xTF32
kernels (flash forward, LSE, int8 KV, dq and dk/dv; the SwiGLU tile forward
and backward) run fp32 cases held to 1e-5 of the plain version's largest
magnitude (the bf16 cases to ``TOL``), each twice with the same bits (50
times at hd 8), with their bound as three TF32 products at 494.7 TFLOP/s
beside the CUDA-core bound at 67; the model's SwiGLU entries route each fp32
tile case there, and rows 0-96 of each R=1632 call (all rows of a smaller
one) equal an R=97 call. The tensor-core SwiGLU rows kernel and W4A8 gemv
get the same three checks as the tensor-core gemv (routed by the model's
entry, two calls bit-equal, each row of an R > 1 call equal to its R = 1
call), and so do the CUDA-core SwiGLU rows kernel (fp32 at the 11B widths, R
= 1, 2, 5, 8; H=100; x one element into its buffer; bf16 ragged H), the
tensor-core int8 gemv, and the general routes of both gemvs (fp32 x at the
head and ``w_gate``, R = 1, 8, 32, as 3xTF32 products and as three bf16
planes, held to 1e-5 of max|plain|; ragged K=4100; x, w or q off 16-byte
alignment); the TMA SwiGLU backward one case whose cotangent starts at an
odd element; two calls of each RMSNorm backward case give the same bits (dt,
and dw when asked for); two calls of each SwiGLU + down case give the same
bits and each row of an R > 1 call equals its R = 1 call (bf16 and fp32 at
the 11B widths, the 3B's in bf16, ragged I and rows), and the bf16 and fp32
11B cases print their time beside the unfused SwiGLU + gemv pair's. The fp32
cases of the rows kernel and of SwiGLU + down are held to 1e-5 of
max|plain|. Every bf16 path at 11B and 3B must launch the new kernels and
never an fp32 flash forward or backward, nor the dequantizing GEMM's general
route, nor a gemv's general route; the bf16 generate and server launch the
tensor-core gemv 201 times a decode step (and once for each prefill's head),
the TMA SwiGLU tile 40 times a prefill and the tensor-core SwiGLU rows
kernel 40 times a decode step, never the CUDA-core rows kernel or the SwiGLU
general route; no 11B or 3B path ever launches the SwiGLU general route. The
new SwiGLU cases (the rows kernels' backward at R = 1 and 8 at the 11B and
3B widths, ragged H and I, x and the cotangent one element into their
buffers; the TMA tile at H=4104 and H=200, whose last 64-k box TMA
zero-fills; the general route on x, or on both weights, one element into its
buffer) get the same checks as the rest: the model's entry routes each there
with the same bits, two calls give the same bits, each row of a rows-kernel
call equals its R=1 call and rows 0-96 of a tile call of 97 rows or more
equal an R=97 call.

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

import dataclasses
import gc
import http.client
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import DeviceType, ProfilerActivity, profile

from llama32mm_tpu_torch.configs import (
    LLAMA32Config,
    MLLAMAConfig,
    VisionEncoderConfig,
    llama32_11b_vision_config,
    tiny_mllama_config,
)
from llama32mm_tpu_torch import evaluate
from llama32mm_tpu_torch.inference.engine import InferenceEngine, structured_prefill_mask
from llama32mm_tpu_torch.inference.http_server import ServingFrontend, follow, serve_forever
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.io.checkpoint import (
    build_config_from_hf,
    load_checkpoint_params,
    save_checkpoint_params,
)
from llama32mm_tpu_torch.io.native_st import native_available
from llama32mm_tpu_torch.models.common import QuantLinear
from llama32mm_tpu_torch.models import language as language_mod
from llama32mm_tpu_torch.models import wrapper
from llama32mm_tpu_torch.models.language import CausalLM
from llama32mm_tpu_torch.models.vision import init_vision_params, vision_encoder_forward
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops import attention as attention_mod
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.ops import gemv as gemv_mod
from llama32mm_tpu_torch.ops import rmsnorm as rmsnorm_mod
from llama32mm_tpu_torch.ops import swiglu as swiglu_mod
from llama32mm_tpu_torch.ops.gemv import linear
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu, swiglu_down
from llama32mm_tpu_torch.ops.cuda.attention import NEG_BIG, allowed_mask
from llama32mm_tpu_torch.ops.cuda.build import build_library
from llama32mm_tpu_torch.ops.cuda.qgemv import check_quant
from llama32mm_tpu_torch.ops.cuda.qmatmul import reads_as_is
from llama32mm_tpu_torch.ops.cuda.swiglu import ROWS_KERNEL_MAX as SWIGLU_ROWS_KERNEL_MAX
from llama32mm_tpu_torch.ops.cuda.swiglu import reads_as_is as swiglu_reads_as_is
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops.quant import (
    INT4_MIXED_RECIPE,
    quantize_weight,
    quantize_weight_int4,
    unpack_int4,
)
from llama32mm_tpu_torch.ops.awq import awq_equalize, calibrate_stats
from llama32mm_tpu_torch.preprocess.image import cubic_resize, preprocess_image_device
from llama32mm_tpu_torch.train import finetune
from llama32mm_tpu_torch.train.full import make_train_step
from llama32mm_tpu_torch.train.lora import (
    init_lora_params,
    lora_leaves,
    make_lora_train_step,
    merge_lora_into_params,
    stack_adapter_bank,
    zero_lora_params,
)
from llama32mm_tpu_torch.io.distributed import ShardedCheckpointer, abstract_state
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration
from llama32mm_tpu_torch.models.vlm import chunked_shifted_cross_entropy
from llama32mm_tpu_torch.parallel import (
    AXIS_DP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    create_mesh,
    data_sharding,
    init_distributed,
    placement_of,
    seq_data_sharding,
    shard_params,
    zero1_shardings,
)
from llama32mm_tpu_torch.parallel.pipeline import make_pipeline_train_step, pipeline_shard_params
from llama32mm_tpu_torch.train.optim import Adam
from llama32mm_tpu_torch.utils import st_file
from llama32mm_tpu_torch.utils.profiling import trace
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache, quantize_kv

# bf16 comparisons: |kernel - plain| <= TOL * max|plain|. 1.6e-2 is about two
# bf16 ulps (2^-7 each, relative) of the output rounding: the kernel and the
# plain version round intermediates at different places (fp32 vs bf16 gate
# and up in SwiGLU, bf16 vs fp32 probabilities in attention) and sum in
# different orders.
TOL = 1.6e-2
# fp32 cases of the fp32 flash kernels: |kernel - plain| <= FP32_TOL *
# max|plain| (out, LSE, dq, dk, dv). Both sides compute in fp32 (the 3xTF32
# products as exact as fp32's), in other orders.
FP32_TOL = 1e-5

KERNEL_INFO = {
    "rmsnorm": ("llama32mm_tpu_torch/csrc/rmsnorm.cu", "llama32mm_tpu/ops/pallas/rmsnorm.py:55"),
    "gemv": ("llama32mm_tpu_torch/csrc/gemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:655"),
    "swiglu": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "flash_attention": ("llama32mm_tpu_torch/csrc/flash_attention_tf32.cu",
                        "llama32mm_tpu/ops/pallas/attention.py:36"),
    "gemv_int8": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:162"),
    "gemv_int4": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:272"),
    "qmatmul": ("llama32mm_tpu_torch/csrc/qmatmul.cu",
                "llama32mm_tpu/ops/pallas/quant_matmul.py:29"),
    "flash_attention_int8kv": ("llama32mm_tpu_torch/csrc/flash_attention_tf32.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:36"),
    "rmsnorm_fwd_train": ("llama32mm_tpu_torch/csrc/rmsnorm.cu",
                          "llama32mm_tpu/ops/pallas/rmsnorm.py:44"),
    "rmsnorm_bwd": ("llama32mm_tpu_torch/csrc/rmsnorm.cu", "llama32mm_tpu/ops/pallas/rmsnorm.py:62"),
    "swiglu_bwd": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:136"),
    "flash_attention_lse": ("llama32mm_tpu_torch/csrc/flash_attention_tf32.cu",
                            "llama32mm_tpu/ops/pallas/attention.py:36"),
    "flash_attention_bwd_dq": ("llama32mm_tpu_torch/csrc/flash_attention_tf32.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:251"),
    "flash_attention_bwd_dkv": ("llama32mm_tpu_torch/csrc/flash_attention_tf32.cu",
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
    "flash_attention_bwd_dq_tc": ("llama32mm_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                  "llama32mm_tpu/ops/pallas/attention.py:251"),
    "flash_attention_bwd_dkv_tc": ("llama32mm_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                   "llama32mm_tpu/ops/pallas/attention.py:322"),
    "qmatmul_tc": ("llama32mm_tpu_torch/csrc/qmatmul.cu",
                   "llama32mm_tpu/ops/pallas/quant_matmul.py:29"),
    "gemv_tc": ("llama32mm_tpu_torch/csrc/gemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:655"),
    "swiglu_tc": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "swiglu_bwd_tc": ("llama32mm_tpu_torch/csrc/swiglu.cu",
                      "llama32mm_tpu/ops/pallas/swiglu.py:136"),
    "swiglu_rows_tc": ("llama32mm_tpu_torch/csrc/swiglu.cu",
                       "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "gemv_int8_tc": ("llama32mm_tpu_torch/csrc/qgemv.cu",
                     "llama32mm_tpu/ops/pallas/gemv.py:162"),
    "swiglu_tf32": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "swiglu_bwd_tf32": ("llama32mm_tpu_torch/csrc/swiglu.cu",
                        "llama32mm_tpu/ops/pallas/swiglu.py:136"),
    "swiglu_rows": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "swiglu_bwd_rows_tc": ("llama32mm_tpu_torch/csrc/swiglu.cu",
                           "llama32mm_tpu/ops/pallas/swiglu.py:136"),
    "swiglu_bwd_rows": ("llama32mm_tpu_torch/csrc/swiglu.cu",
                        "llama32mm_tpu/ops/pallas/swiglu.py:136"),
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
    "swiglu_tc": [_P + "swiglu.py:98"],
    "swiglu_bwd_tc": [_P + "swiglu.py:98"],
    "swiglu_rows_tc": [_P + "swiglu.py:98"],
    "swiglu_tf32": [_P + "swiglu.py:98"],
    "swiglu_bwd_tf32": [_P + "swiglu.py:98"],
    "swiglu_rows": [_P + "swiglu.py:98"],
    "swiglu_bwd_rows_tc": [_P + "swiglu.py:98"],
    "swiglu_bwd_rows": [_P + "swiglu.py:98"],
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
    "flash_attention_bwd_dq_tc": [_P + "attention.py:433"],
    "flash_attention_bwd_dkv_tc": [_P + "attention.py:472"],
    "gemv": [_P + "gemv.py:55", _P + "gemv.py:105", _P + "gemv.py:81", _P + "gemv.py:133",
             _P + "gemv.py:677"],
    "gemv_tc": [_P + "gemv.py:55", _P + "gemv.py:105", _P + "gemv.py:81", _P + "gemv.py:133",
                _P + "gemv.py:677"],
    "gemv_int8": [_P + "gemv.py:701", _P + "gemv.py:185", _P + "gemv.py:724"],
    "gemv_int8_tc": [_P + "gemv.py:701", _P + "gemv.py:185", _P + "gemv.py:724"],
    "gemv_int4": [_P + "gemv.py:216", _P + "gemv.py:592", _P + "gemv.py:618"],
    "gemv_int4_w4a8": [_P + "gemv.py:419", _P + "gemv.py:561"],
    "qmatmul": [_P + "quant_matmul.py:99", _P + "quant_matmul.py:75",
                _P + "quant_matmul.py:188"],
    "qmatmul_tc": [_P + "quant_matmul.py:99", _P + "quant_matmul.py:75",
                   _P + "quant_matmul.py:188"],
}
# The kernels each 11B and 3B path must launch: bf16 prefill and the ViT
# through the tensor-core flash forward, decode through the split-KV kernel,
# quantized prefill linears through the wgmma dequantizing GEMM, bf16 decode
# linears through the tensor-core gemv, the bf16 prefill's SwiGLU through
# the TMA tile and its decode SwiGLU (at most 8 rows) through the
# tensor-core rows kernel (run_11b and run_server hold both to their counts,
# and the CUDA-core rows kernel and the general route to 0), the int4
# server's W4A8 gemvs through the W4A8 kernel (tensor cores at every call), and every int8
# decode linear through the tensor-core int8 gemv (run_11b and run_server
# hold it to its count, path_faults the general route to 0).
BF16_ATTN = ("flash_attention_tc", "flash_decode")
INT8_KV_ATTN = ("flash_attention_tc", "flash_attention_tc_int8kv", "flash_decode_int8kv")
SERVER_INT4_KERNELS = ("rmsnorm", "gemv_int8_tc", "gemv_int4_w4a8", "qmatmul_tc") + INT8_KV_ATTN
PATH_KERNELS = {
    "bf16": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "int8": ("rmsnorm", "gemv_int8_tc", "qmatmul_tc") + INT8_KV_ATTN,
    "int4_mixed": ("rmsnorm", "gemv_int8_tc", "gemv_int4", "qmatmul_tc") + INT8_KV_ATTN,
    "server_bf16": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "server_int4_w4a8": SERVER_INT4_KERNELS,
    "swiglu_down_op": ("swiglu_down",),
    # speculative decoding: the (K+1)-row verifies (K+1 <= 8 rows on the SwiGLU
    # rows kernel; the 8-slot server's 32 rows on the TMA tile) and the draft's
    # R = 1 steps
    "bf16_spec_lookup": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "bf16_spec_draft": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "server_bf16_spec": ("rmsnorm", "gemv_tc", "swiglu_tc") + BF16_ATTN,
    "server_bf16_spec_rows": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "bf16_spec_self_draft": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    # the rest of the server: a prefix's prefill and each prefixed admission's
    # 128-row suffix chunk on the TMA SwiGLU tile and the tensor-core flash
    # forward; an adapter bank with gate/up adapters runs the FFN unfused
    # (run_server holds every SwiGLU kernel to 0 there)
    "server_bf16_prefix": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "http_bf16": ("rmsnorm", "gemv_tc", "swiglu_rows_tc", "swiglu_tc") + BF16_ATTN,
    "server_bf16_lora": ("rmsnorm", "gemv_tc") + BF16_ATTN,
}
# checkpoint loads (the load_11b phase): a loaded model runs its kind's kernels
PATH_KERNELS.update({f"load_11b_{kind}": PATH_KERNELS[kind]
                     for kind in ("bf16", "int8", "int4_mixed")})
# The kernels each training path must launch: the fp32 tiny model's flash
# forward with the LSE and backward are the fp32 kernels (3xTF32 forward, dq
# and dk/dv), the bf16 models' the bf16 tensor-core ones (the frozen ViT's
# no-grad forward too).
TRAIN_KERNELS = ("rmsnorm_fwd_train", "rmsnorm_bwd", "flash_attention_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
TRAIN_BF16_KERNELS = ("rmsnorm_fwd_train", "rmsnorm_bwd", "flash_attention_tc_lse",
                      "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc",
                      "flash_attention_tc")
PATH_KERNELS.update({
    "lora_11b": TRAIN_BF16_KERNELS,
    "full_ft_3b": TRAIN_BF16_KERNELS + ("swiglu_tc", "swiglu_bwd_tc"),
})
# QLoRA over a quantized base: every decoder linear and the head (in chunks
# of the loss) through the wgmma qmatmul, forward and remat recompute; the
# quantized FFN runs SiLU·up explicitly (no SwiGLU kernel); the text-only
# batches run no ViT. Evaluation: 2048-row windows (no gemv; the int8 copy's
# linears on the qmatmul, its cache on the int8-KV flash forward); the
# calibration forward's one-row head on the tensor-core gemv.
QLORA_KERNELS = ("rmsnorm", "rmsnorm_fwd_train", "rmsnorm_bwd", "flash_attention_tc_lse",
                 "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc", "qmatmul_tc")
PATH_KERNELS.update({
    "qlora_11b_int8": QLORA_KERNELS,
    "qlora_11b_int4_mixed": QLORA_KERNELS,
    "eval_11b_bf16": ("rmsnorm", "swiglu_tc", "flash_attention_tc"),
    "eval_11b_int8": ("rmsnorm", "qmatmul_tc", "flash_attention_tc_int8kv"),
    "eval_11b_agreement": ("rmsnorm", "swiglu_tc", "flash_attention_tc", "qmatmul_tc"),
    "calibrate_11b": ("rmsnorm", "swiglu_tc", "flash_attention_tc", "gemv_tc"),
})
# Tensor-parallel serving (each rank at its tp=2 shapes) runs its kind's kernels;
# so does training across ranks: LoRA at tp=2 (gate and up adapted: no SwiGLU
# kernel), full fine-tuning at dp=2 x tp=2 (the SwiGLU tile forward and backward).
# The features once refused under tensor parallelism at tp=2: the bank server, the
# draft engine, the HTTP front end; and the server at dp=2 x tp=2.
PATH_KERNELS.update({"tp_11b_server_bf16_lora": PATH_KERNELS["server_bf16_lora"],
                     "tp_11b_bf16_spec_draft": PATH_KERNELS["bf16_spec_draft"],
                     "tp_11b_http_bf16": PATH_KERNELS["http_bf16"],
                     "tp_dp_server_11b": PATH_KERNELS["server_bf16"]})
PATH_KERNELS.update({"tp_11b_bf16": PATH_KERNELS["bf16"],
                     "tp_11b_int4_mixed": PATH_KERNELS["int4_mixed"],
                     "tp_11b_server_bf16": PATH_KERNELS["server_bf16"],
                     "tp_lora_11b": TRAIN_BF16_KERNELS,
                     "zero1_full_ft_3b": PATH_KERNELS["full_ft_3b"]})
# Sequence parallelism: the ring's chunks through the flash training kernels
# (and the frozen ViT's no-grad forward); the pipeline: text only (no ViT),
# each stage's layers through the SwiGLU tile and the flash training kernels.
PATH_KERNELS.update({"sp_lora_11b": TRAIN_BF16_KERNELS,
                     "pp_full_ft_3b": TRAIN_BF16_KERNELS[:-1] + ("swiglu_tc", "swiglu_bwd_tc")})
# The fp32 kernels (the 3xTF32 flash forward, its int8-KV and LSE
# instantiations, dq and dk/dv; the 3xTF32 SwiGLU tile forward and
# backward): the bf16 paths above must never launch them; nor the
# dequantizing GEMM's general route ("qmatmul": the pre-pass), which every
# bf16 prefill shape leaves to the kernel on x as it is; nor the gemvs' general routes
# ("gemv", "gemv_int8": fp32 x, ragged K, misaligned pointers), which every
# decode linear at these widths leaves to the tensor-core kernels on x as it
# is (both int4 gemvs run on the tensor cores at every call).
FP32_FORWARD = ("flash_attention", "flash_attention_int8kv", "flash_attention_lse")
FP32_BACKWARD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
FP32_SWIGLU = ("swiglu_tf32", "swiglu_bwd_tf32")
# The tiny fp32 model's paths: float (a 12-token prefill's SwiGLU on the
# 3xTF32 tile, decode's on the CUDA-core rows kernel), and quantized: a
# 40-token prefill over the int8 cache (3xTF32), the 5-token ViT and decode
# (split-KV).
TINY_KERNELS = {
    "fp32": ("rmsnorm", "gemv", "swiglu_rows", "swiglu_tf32", "flash_decode"),
    "int8": ("rmsnorm", "gemv_int8", "qmatmul", "flash_attention_int8kv", "flash_decode",
             "flash_decode_int8kv"),
    "int4_mixed": ("rmsnorm", "gemv_int8", "gemv_int4", "qmatmul", "flash_attention_int8kv",
                   "flash_decode", "flash_decode_int8kv"),
}


def path_faults(path: str, launches: dict, plain_calls: dict) -> list:
    """What a path's run got wrong: kernels it should have launched and did
    not, fp32 kernels launched on a bf16 path, the SwiGLU general route
    (every SwiGLU operand of the 11B and 3B widths is read as it is), plain
    versions called."""
    faults = [f"skipped {k}" for k in PATH_KERNELS[path] if launches[k] == 0]
    faults += [f"launched the SwiGLU general route {k} {launches[k]} times"
               for k in ("swiglu", "swiglu_bwd") if launches[k]]
    if path != "swiglu_down_op":
        faults += [f"launched the fp32 {k} {launches[k]} times"
                   for k in FP32_FORWARD + FP32_BACKWARD + FP32_SWIGLU if launches[k]]
        if launches["qmatmul"]:
            faults.append(f"launched the qmatmul's general route {launches['qmatmul']} times")
        if launches["gemv"]:
            faults.append(f"launched the gemv's general route {launches['gemv']} times")
        if launches["gemv_int8"]:
            faults.append(f"launched the int8 gemv's general route {launches['gemv_int8']} "
                          f"times")
    return faults + [f"ran plain {k} {n} times" for k, n in plain_calls.items() if n]


def swiglu_faults(launches: dict, layers: int, prefills: int, decode_steps: int) -> list:
    """A bf16 generate's or server's SwiGLU launches: the TMA tile once a
    layer per prefill, the tensor-core rows kernel once a layer per decode
    step, and the CUDA-core rows kernel and the general route never."""
    want = {"swiglu_tc": layers * prefills, "swiglu_rows_tc": layers * decode_steps,
            "swiglu_rows": 0, "swiglu": 0}
    log(f"SwiGLU launches: TMA tile {launches['swiglu_tc']} (want {want['swiglu_tc']}), "
        f"tensor-core rows kernel {launches['swiglu_rows_tc']} (want {want['swiglu_rows_tc']}), "
        f"CUDA-core rows kernel {launches['swiglu_rows']} (want 0), general route "
        f"{launches['swiglu']} (want 0)")
    return [f"launched {k} {launches[k]} times, not {n}" for k, n in want.items()
            if launches[k] != n]


def int8_gemv_faults(path: str, launches: dict, layers: int, decode_steps: int, int8_head: bool,
                     prefills: int, kind: Optional[str] = None) -> list:
    """A quantized generate's or server's int8 gemvs: each decode step's int8
    linears (7 a layer in int8: W_query, W_key, W_value, out_proj, w_gate,
    w_up, w_down; 5 in the int4-mixed recipe, whose w_gate, w_up and head are
    int4) and an int8 head at each decode step and each prefill's last
    position, all on the tensor-core kernel (path_faults holds the general
    route to 0). ``kind`` ("int8" or "int4_mixed") defaults to ``path``."""
    per_step = (7 if (kind or path) == "int8" else 5) * layers + int8_head
    want = per_step * decode_steps + int8_head * prefills
    got = launches["gemv_int8_tc"]
    log(f"[{path}] tensor-core int8 gemv launches {got} = {per_step} x {decode_steps} decode steps"
        f" + {int8_head * prefills} prefill heads: {got == want}")
    return [] if got == want else [f"launched the tensor-core int8 gemv {got} times, not {want}"]


def generate_faults(path: str, kind: str, launches: dict, plain_calls: dict, layers: int,
                    decode_steps: int) -> list:
    """What one B=1 generate (a prefill, then ``decode_steps`` decode steps)
    of a ``kind`` ("bf16", "int8" or "int4_mixed") model launched wrong."""
    faults = path_faults(path, launches, plain_calls)
    if kind in ("int8", "int4_mixed"):  # the prefill's 7 quantized linears a layer
        want = 7 * layers
        log(f"[{path}] wgmma qmatmul launches {launches['qmatmul_tc']} = 7 x {layers} "
            f"layers: {launches['qmatmul_tc'] == want}")
        if launches["qmatmul_tc"] != want:
            faults.append(f"launched the wgmma qmatmul {launches['qmatmul_tc']} times, not {want}")
    if kind == "bf16":  # 5 linears a layer and the head each step, the tensor-core gemv
        per_step = 5 * layers + 1
        want = per_step * decode_steps + 1  # and the prefill's last-position head
        log(f"[{path}] tensor-core gemv launches {launches['gemv_tc']} = {per_step} per decode "
            f"step x {decode_steps} + 1: {launches['gemv_tc'] == want}")
        if launches["gemv_tc"] != want:
            faults.append(f"launched the tensor-core gemv {launches['gemv_tc']} times, not {want}")
        faults += swiglu_faults(launches, layers, prefills=1, decode_steps=decode_steps)
    if kind == "int4_mixed":  # w_gate and w_up of each layer and the head, each step
        per_step = 2 * layers + 1
        want = per_step * decode_steps + 1  # and the prefill's last-position head
        log(f"[{path}] W4A16 gemv launches {launches['gemv_int4']} = {per_step} per decode step "
            f"x {decode_steps} + 1: {launches['gemv_int4'] == want}")
        if launches["gemv_int4"] != want:
            faults.append(f"launched the W4A16 gemv {launches['gemv_int4']} times, not {want}")
    if kind in ("int8", "int4_mixed"):
        faults += int8_gemv_faults(path, launches, layers, decode_steps=decode_steps,
                                   int8_head=kind == "int8", prefills=1, kind=kind)
    return faults


def log(msg: str) -> None:
    sys.stdout.write(msg + "\n")  # one write a line: ranks sharing stdout do not interleave
    sys.stdout.flush()


def free_device_memory() -> None:
    """Collect reference cycles (a server whose ``_decode`` a timing wrapper
    replaced holds itself, and with it the model), then return the cached
    blocks."""
    gc.collect()
    torch.cuda.empty_cache()


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

    def rnd32(*shape):
        """fp32 x with all 24 bits of mantissa: each of its three bf16 planes
        carries bits."""
        return torch.randn(*shape, generator=gen, device=dev)

    def w32(*shape):
        """fp32 weights (the tiny fp32 models' linears)."""
        return torch.randn(*shape, generator=gen, device=dev) * 0.02

    def q8_off(n, k):
        """q whose data starts 1 byte past an aligned address."""
        q, sc = q8(n, k)
        buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)
        buf[1:].copy_(q.flatten())
        return buf[1:].view(q.shape), sc

    def q8_stepped(n, k):
        """Odd columns' weights (so their scales) 1e-3 of the even ones': a
        scale applied to a neighbouring column shows."""
        w = rnd(n, k, scale=0.02).float()
        w[1::2] *= 1e-3
        qw = quantize_weight(w.to(bf))
        return qw["q"], qw["scale"]

    def q4(n, k, g):
        qw = quantize_weight_int4(rnd(n, k, scale=0.02), g)
        return qw["q4"], qw["scale"]

    def q4_off(n, k, g):
        """q4 whose data starts 1 byte past an aligned address."""
        q, sc = q4(n, k, g)
        buf = torch.empty(q.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:].copy_(q.flatten())
        return buf[1:].view(q.shape), sc

    def q4_stepped(n, k, g):
        """Odd groups' weights (so their scales) 1000x the even groups': a
        scale applied to a neighbouring group shows."""
        w = rnd(n, k, scale=0.02).float().reshape(n, k // g, g)
        w[:, 1::2] *= 1000.0
        qw = quantize_weight_int4(w.reshape(n, k).to(bf), g)
        return qw["q4"], qw["scale"]

    def kv8(*shape):
        """int8 K, V and their scales, as the int8 cache holds them."""
        (kq, ks), (vq, vs) = quantize_kv(rnd(*shape)), quantize_kv(rnd(*shape))
        return kq, vq, ks, vs

    h, inter, vocab = 4096, 14336, 128256
    head4, w_gate4 = q4(vocab, h, 128), q4(inter, h, 128)
    head32, w_gate32 = w32(vocab, h), w32(inter, h)
    head8, w_gate8 = q8(vocab, h), q8(inter, h)
    cases = [
        ("rmsnorm", "prefill norm2 R=1632 C=4096 +residual",
         (rnd(1632, h), rnd(h), 1e-5, rnd(1632, h)), True),
        ("rmsnorm", "decode norm1 R=1 C=4096", (rnd(1, h), rnd(h), 1e-5, None), False),
        ("rmsnorm", "ragged R=3 C=100 +residual", (rnd(3, 100), rnd(100), 1e-5, rnd(3, 100)), False),
        # the general route: fp32 x and weights (3xTF32), ragged K, x or w
        # off 16-byte alignment (the pre-pass's padded copy, weight words)
        ("gemv", "fp32 lm_head R=1 N=128256 K=4096", (rnd32(1, h), head32), False),
        ("gemv", "fp32 lm_head R=8 N=128256 K=4096", (rnd32(8, h), head32), True),
        *[("gemv", f"fp32 w_gate R={r} N=14336 K=4096", (rnd32(r, h), w_gate32), False)
          for r in (1, 8, 32)],
        ("gemv", "fp32 ragged R=5 N=1000 K=4100", (rnd32(5, 4100), w32(1000, 4100)), False),
        ("gemv", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), rnd(1000, 4100, scale=0.02)), False),
        ("gemv", "fp32 x 4 bytes off alignment R=8 N=4096 K=4096",
         (rnd32(8 * h + 1)[1:].view(8, h), w32(h, h)), False),
        ("gemv", "fp32 w 4 bytes off alignment R=8 N=4096 K=4096",
         (rnd32(8, h), w32(h * h + 1)[1:].view(h, h)), False),
        ("gemv", f"{MISALIGNED_X} R=8 N=4096 K=4096",
         (rnd(8 * h + 1)[1:].view(8, h), rnd(h, h, scale=0.02)), False),
        ("gemv", "w 2 bytes off alignment R=8 N=4096 K=4096",
         (rnd(8, h), rnd(h * h + 1, scale=0.02)[1:].view(h, h)), False),
        ("gemv_tc", "lm_head R=1 N=128256 K=4096", (rnd(1, h), rnd(vocab, h)), False),
        ("gemv_tc", "W_query R=1 N=4096 K=4096", (rnd(1, h), rnd(h, h, scale=0.02)), False),
        ("gemv_tc", "W_key R=1 N=1024 K=4096", (rnd(1, h), rnd(1024, h, scale=0.02)), False),
        ("gemv_tc", "w_down R=1 N=4096 K=14336", (rnd(1, inter), rnd(h, inter, scale=0.01)),
         False),
        ("gemv_tc", "server lm_head R=8 N=128256 K=4096", (rnd(8, h), rnd(vocab, h)), True),
        ("gemv_tc", "server W_query R=8 N=4096 K=4096", (rnd(8, h), rnd(h, h, scale=0.02)), False),
        ("gemv_tc", "server W_key R=8 N=1024 K=4096", (rnd(8, h), rnd(1024, h, scale=0.02)),
         False),
        ("gemv_tc", "server w_down R=8 N=4096 K=14336",
         (rnd(8, inter), rnd(h, inter, scale=0.01)), False),
        ("gemv_tc", "W_query R=2 N=4096 K=4096", (rnd(2, h), rnd(h, h, scale=0.02)), False),
        ("gemv_tc", "W_query R=16 N=4096 K=4096", (rnd(16, h), rnd(h, h, scale=0.02)), False),
        ("gemv_tc", "w_down R=17 N=4096 K=14336", (rnd(17, inter), rnd(h, inter, scale=0.01)),
         False),
        ("gemv_tc", "lm_head R=32 N=128256 K=4096", (rnd(32, h), rnd(vocab, h)), False),
        ("gemv_tc", "W_key R=32 N=1024 K=4096", (rnd(32, h), rnd(1024, h, scale=0.02)), False),
        ("gemv_tc", "ragged N R=5 N=1000 K=4096", (rnd(5, h), rnd(1000, h, scale=0.02)), False),
        ("swiglu", "prefill R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), True),
        ("swiglu", "ragged R=33 H=100 I=200",
         (rnd(33, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("swiglu", "decode rows R=3 H=4096 I=14336",
         (rnd(3, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), False),
        # what the routed entry leaves to the general route: x, or both
        # weights, one element into their buffers (only those copied)
        ("swiglu", "x offset by one element R=1632 H=4096 I=14336",
         (rnd(1632 * h + 1)[1:].view(1632, h), rnd(inter, h, scale=0.02),
          rnd(inter, h, scale=0.02)), False),
        ("swiglu", "weights offset by one element R=130 H=256 I=300",
         (rnd(130, 256), rnd(300 * 256 + 1, scale=0.1)[1:].view(300, 256),
          rnd(300 * 256 + 1, scale=0.1)[1:].view(300, 256)), False),
        ("swiglu_rows", "ragged H R=3 H=100 I=200",
         (rnd(3, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("swiglu_rows", "ragged H R=8 H=4100 I=14336",
         (rnd(8, 4100), rnd(inter, 4100, scale=0.02), rnd(inter, 4100, scale=0.02)), False),
        ("swiglu_tc", "prefill R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), True),
        ("swiglu_tc", "3B prefill R=1632 H=3072 I=8192",
         (rnd(1632, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02)), False),
        ("swiglu_tc", "R=33 H=4096 I=14336",
         (rnd(33, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), False),
        ("swiglu_tc", "ragged I R=130 H=256 I=300",
         (rnd(130, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1)), False),
        # H a multiple of 8 but not of 64: TMA zero-fills the last 64-k box
        ("swiglu_tc", "R=1632 H=4104 I=14336",
         (rnd(1632, 4104), rnd(inter, 4104, scale=0.02), rnd(inter, 4104, scale=0.02)), False),
        ("swiglu_tc", "R=130 H=200 I=300",
         (rnd(130, 200), rnd(300, 200, scale=0.1), rnd(300, 200, scale=0.1)), False),
        *[("swiglu_rows_tc", f"{'server ' if r == 8 else ''}decode R={r} H=4096 I=14336",
           (rnd(r, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), r == 8)
          for r in (1, 2, 5, 8)],
        ("swiglu_rows_tc", "3B decode R=8 H=3072 I=8192",
         (rnd(8, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02)), False),
        ("swiglu_rows_tc", "ragged I R=3 H=96 I=200",
         (rnd(3, 96), rnd(200, 96, scale=0.1), rnd(200, 96, scale=0.1)), False),
        ("flash_attention", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1632), 0, True), False),
        ("flash_attention", "ViT-H nq=nkv=16 T=1600 hd=80 non-causal",
         (rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
          valid(1, 1600, 1600), 0, False), False),
        ("flash_attention", "decode Tq=1 Tk=2048 q_offset=1700 hd=128",
         (rnd(1, 32, 1, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1701), 1700, True), False),
        ("flash_attention", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), rnd(2, 2, 100, 16), rnd(2, 2, 100, 16),
          valid(2, 100, 90), 5, True), False),
        # the general route: fp32 x as three bf16 planes, ragged K, x or q
        # off 16-byte alignment
        ("gemv_int8", "fp32 x int8 lm_head R=1 N=128256 K=4096", (rnd32(1, h), *head8), False),
        ("gemv_int8", "fp32 x int8 lm_head R=8 N=128256 K=4096", (rnd32(8, h), *head8), True),
        *[("gemv_int8", f"fp32 x w_gate R={r} N=14336 K=4096", (rnd32(r, h), *w_gate8), False)
          for r in (1, 8, 32)],
        ("gemv_int8", "fp32 x channel scales 1000x apart R=8 N=1000 K=4096",
         (rnd32(8, h), *q8_stepped(1000, h)), False),
        ("gemv_int8", "fp32 x ragged R=5 N=1000 K=4100", (rnd32(5, 4100), *q8(1000, 4100)),
         False),
        ("gemv_int8", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), *q8(1000, 4100)), False),
        ("gemv_int8", "fp32 x 4 bytes off alignment R=8 N=4096 K=4096",
         (rnd32(8 * h + 1)[1:].view(8, h), *q8(h, h)), False),
        ("gemv_int8", "fp32 x q 1 byte off alignment R=8 N=4096 K=4096",
         (rnd32(8, h), *q8_off(h, h)), False),
        ("gemv_int4", "int4 lm_head R=1 N=128256 K=4096 g=128",
         (rnd(1, h), *head4), True),
        ("gemv_int4", "w_gate R=1 N=14336 K=4096 g=128", (rnd(1, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "ragged R=5 N=1000 K=4160 g=32", (rnd(5, 4160), *q4(1000, 4160, 32)), False),
        ("gemv_int4", "g=24 R=3 N=200 K=192", (rnd(3, 192), *q4(200, 192, 24)), False),
        ("gemv_int4", "w_gate R=8 N=14336 K=4096 g=128", (rnd(8, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "w_gate R=16 N=14336 K=4096 g=128", (rnd(16, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "w_gate R=32 N=14336 K=4096 g=128", (rnd(32, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "per-channel R=8 N=4096 K=4096 g=4096", (rnd(8, h), *q4(h, h, h)), False),
        ("gemv_int4", "g=64 R=20 N=1000 K=4096", (rnd(20, h), *q4(1000, h, 64)), False),
        ("gemv_int4", "group scales 1000x apart R=8 N=1000 K=4096 g=128",
         (rnd(8, h), *q4_stepped(1000, h, 128)), False),
        # fp32 x (three bf16 planes), other group sizes (spans that straddle
        # groups), rows of K/2 = 2050 bytes, misaligned x and q4
        *[("gemv_int4", f"fp32 x w_gate R={r} N=14336 K=4096 g=128", (rnd32(r, h), *w_gate4),
           False) for r in (1, 8, 32)],
        ("gemv_int4", "fp32 x int4 lm_head R=1 N=128256 K=4096 g=128", (rnd32(1, h), *head4),
         False),
        ("gemv_int4", "fp32 x per-channel R=8 N=4096 K=4096 g=4096", (rnd32(8, h), *q4(h, h, h)),
         False),
        ("gemv_int4", "fp32 x g=16 R=9 N=1000 K=4096", (rnd32(9, h), *q4(1000, h, 16)), False),
        ("gemv_int4", "fp32 x per-channel R=3 N=1000 K=4100 g=4100",
         (rnd32(3, 4100), *q4(1000, 4100, 4100)), False),
        ("gemv_int4", "g=16 w_gate R=8 N=14336 K=4096", (rnd(8, h), *q4(inter, h, 16)), False),
        ("gemv_int4", "g=16 group scales 1000x apart R=8 N=1000 K=4096",
         (rnd(8, h), *q4_stepped(1000, h, 16)), False),
        ("gemv_int4", "g=24 R=8 N=4096 K=4608", (rnd(8, 4608), *q4(h, 4608, 24)), False),
        ("gemv_int4", "g=56 w_down R=8 N=4096 K=14336", (rnd(8, inter), *q4(h, inter, 56)),
         False),
        ("gemv_int4", "per-channel R=8 N=4096 K=4100 g=4100", (rnd(8, 4100), *q4(h, 4100, 4100)),
         False),
        ("gemv_int4", "g=6 R=5 N=300 K=192", (rnd(5, 192), *q4(300, 192, 6)), False),
        ("gemv_int4", "g=2 R=17 N=100 K=64", (rnd(17, 64), *q4(100, 64, 2)), False),
        ("gemv_int4", f"{MISALIGNED_X} R=8 N=4096 K=4096 g=128",
         (rnd(8 * h + 1)[1:].view(8, h), *q4(h, h, 128)), False),
        ("gemv_int4", "fp32 x 4 bytes off alignment R=8 N=4096 K=4096 g=128",
         (rnd32(8 * h + 1)[1:].view(8, h), *q4(h, h, 128)), False),
        ("gemv_int4", "q4 1 byte off alignment R=8 N=4096 K=4096 g=128",
         (rnd(8, h), *q4_off(h, h, 128)), False),
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
        # the general route's fp32 x (three bf16 planes), other groups, ragged
        # K, misaligned x and q
        ("qmatmul", "fp32 x int8 w_gate R=1632 N=14336 K=4096", (rnd32(1632, h), *w_gate8), False),
        ("qmatmul", "fp32 x int4 w_gate R=1632 N=14336 K=4096 g=128", (rnd32(1632, h), *w_gate4),
         False),
        ("qmatmul", "fp32 x int4 g=32 R=130 N=1000 K=4096", (rnd32(130, h), *q4(1000, h, 32)),
         False),
        ("qmatmul", "fp32 x ragged int8 R=100 N=1000 K=4100", (rnd32(100, 4100), *q8(1000, 4100)),
         False),
        ("qmatmul", "fp32 x 4 bytes off alignment R=40 N=4096 K=4096",
         (rnd32(40 * h + 1)[1:].view(40, h), *q8(h, h)), False),
        ("qmatmul", "fp32 x int4 g=6 R=48 N=300 K=192", (rnd32(48, 192), *q4(300, 192, 6)), False),
        ("qmatmul", "int4 w_gate R=1632 N=14336 K=4096 g=32", (rnd(1632, h), *q4(inter, h, 32)),
         False),
        ("qmatmul", "q 1 byte off alignment R=64 N=4096 K=4096", (rnd(64, h), *q8_off(h, h)),
         False),
        ("qmatmul", "int4 g=6 R=48 N=300 K=192", (rnd(48, 192), *q4(300, 192, 6)), False),
        ("qmatmul", "g=32 group scales 1000x apart R=70 N=300 K=512",
         (rnd(70, 512), *q4_stepped(300, 512, 32)), False),
        ("qmatmul_tc", "int4 w_gate R=1632 N=14336 K=4096 g=128",
         (rnd(1632, h), *q4(inter, h, 128)), True),
        ("qmatmul_tc", "int8 w_gate R=1632 N=14336 K=4096", (rnd(1632, h), *q8(inter, h)), False),
        ("qmatmul_tc", "int8 w_down R=1632 N=4096 K=14336", (rnd(1632, inter), *q8(h, inter)),
         False),
        ("qmatmul_tc", "int8 W_query R=1632 N=4096 K=4096", (rnd(1632, h), *q8(h, h)), False),
        ("qmatmul_tc", "int8 W_key R=1632 N=1024 K=4096", (rnd(1632, h), *q8(1024, h)), False),
        ("qmatmul_tc", "int8 W_query R=33 N=4096 K=4096", (rnd(33, h), *q8(h, h)), False),
        ("qmatmul_tc", "int4 w_up R=33 N=14336 K=4096 g=128", (rnd(33, h), *q4(inter, h, 128)),
         False),
        ("qmatmul_tc", "ragged N int4 R=200 N=1000 K=4096 g=128",
         (rnd(200, h), *q4(1000, h, 128)), False),
        ("qmatmul_tc", "group scales 1000x apart R=70 N=300 K=512 g=64",
         (rnd(70, 512), *q4_stepped(300, 512, 64)), False),
        ("qmatmul_tc", "odd N int8 R=130 N=999 K=256", (rnd(130, 256), *q8(999, 256)), False),
        ("flash_attention_int8kv", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1632), 0, True), False),
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
        ("flash_attention_tc_int8kv", "hd=8 nq=4 nkv=2 Tq=70 Tk=90 q_offset=20 causal",
         (rnd(1, 4, 70, 8), *kv8(1, 2, 90, 8), valid(1, 90, 90), 20, True), False),
    ]
    return (cases + spec_kernel_cases(rnd, valid) + int8_gemv_cases(rnd, q8)
            + server_kernel_cases(rnd, q4, q4_stepped, q4_off, kv8)
            + training_kernel_cases(rnd, valid)
            + tp_kernel_cases(rnd, valid, q8, q4, kv8) + ring_kernel_cases(rnd, valid)
            + fp32_flash_cases(dev, gen) + fp32_swiglu_cases(dev, gen))


def tp_kernel_cases(rnd, valid, q8, q4, kv8):
    """The kernels of the tensor-parallel serving path (``tp_11b_*``) at the
    11B's tp=2 shapes: each rank's column-parallel linears (W_query N=2048,
    W_key and W_value N=512, w_gate and w_up N=7168, the vocab-parallel head
    N=64128), its row-parallel ones (out_proj K=2048, w_down K=7168; int4
    ones split on g=128 group boundaries), SwiGLU at I=7168 (the prefill's
    TMA tile, the decode rows kernel) and attention over 16 query and 4 kv
    heads, in bf16, int8 and int4, for one request and the 4-slot server; and
    the adapter bank's unfused gate and up (N=7168) at the 4-slot server."""
    h, vl, il, ol, kvl = 4096, 64128, 7168, 2048, 512
    dev = rnd(1).device
    offsets = torch.tensor([1664, 1700, 1727, 1690], dtype=torch.int32, device=dev)
    kvv = (torch.arange(2048, device=dev)[None, :] <= offsets[:, None].long()).to(torch.int32)
    kvv1 = (torch.arange(2048, device=dev) <= 1700).to(torch.int32)[None]
    head, w_gate = q4(vl, h, 128), q4(il, h, 128)
    cases = [
        ("gemv_tc", "tp=2 lm_head R=1 N=64128 K=4096", (rnd(1, h), rnd(vl, h)), False),
        ("gemv_tc", "tp=2 W_query R=1 N=2048 K=4096", (rnd(1, h), rnd(ol, h, scale=0.02)), False),
        ("gemv_tc", "tp=2 W_key R=1 N=512 K=4096", (rnd(1, h), rnd(kvl, h, scale=0.02)), False),
        ("gemv_tc", "tp=2 out_proj R=1 N=4096 K=2048", (rnd(1, ol), rnd(h, ol, scale=0.02)),
         False),
        ("gemv_tc", "tp=2 w_down R=1 N=4096 K=7168", (rnd(1, il), rnd(h, il, scale=0.01)), False),
        ("gemv_tc", "tp=2 server lm_head R=4 N=64128 K=4096", (rnd(4, h), rnd(vl, h)), False),
        ("gemv_tc", "tp=2 server w_down R=4 N=4096 K=7168", (rnd(4, il), rnd(h, il, scale=0.01)),
         False),
        ("gemv_tc", "tp=2 bank gate/up R=4 N=7168 K=4096", (rnd(4, h), rnd(il, h, scale=0.02)),
         False),
        ("swiglu_tc", "tp=2 prefill R=1632 H=4096 I=7168",
         (rnd(1632, h), rnd(il, h, scale=0.02), rnd(il, h, scale=0.02)), False),
        ("swiglu_rows_tc", "tp=2 decode R=1 H=4096 I=7168",
         (rnd(1, h), rnd(il, h, scale=0.02), rnd(il, h, scale=0.02)), False),
        ("swiglu_rows_tc", "tp=2 server decode R=4 H=4096 I=7168",
         (rnd(4, h), rnd(il, h, scale=0.02), rnd(il, h, scale=0.02)), False),
        ("flash_attention_tc", "tp=2 decoder prefill nq=16 nkv=4 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 16, 1632, 128), rnd(1, 4, 2048, 128), rnd(1, 4, 2048, 128),
          valid(1, 2048, 1632), 0, True), False),
        ("flash_attention_tc_int8kv", "tp=2 decoder prefill nq=16 nkv=4 Tq=1632 Tk=2048 hd=128",
         (rnd(1, 16, 1632, 128), *kv8(1, 4, 2048, 128), valid(1, 2048, 1632), 0, True), False),
        ("gemv_int8_tc", "tp=2 W_query R=1 N=2048 K=4096", (rnd(1, h), *q8(ol, h)), False),
        ("gemv_int8_tc", "tp=2 W_key R=1 N=512 K=4096", (rnd(1, h), *q8(kvl, h)), False),
        ("gemv_int8_tc", "tp=2 out_proj R=1 N=4096 K=2048", (rnd(1, ol), *q8(h, ol)), False),
        ("gemv_int8_tc", "tp=2 w_down R=1 N=4096 K=7168", (rnd(1, il), *q8(h, il)), False),
        ("gemv_int4", "tp=2 w_gate R=1 N=7168 K=4096 g=128", (rnd(1, h), *w_gate), False),
        ("gemv_int4", "tp=2 int4 lm_head R=1 N=64128 K=4096 g=128", (rnd(1, h), *head), False),
        ("gemv_int4", "tp=2 row-parallel w_down R=1 N=4096 K=7168 g=128",
         (rnd(1, il), *q4(h, il, 128)), False),
        ("gemv_int4", "tp=2 row-parallel out_proj R=1 N=4096 K=2048 g=128",
         (rnd(1, ol), *q4(h, ol, 128)), False),
        ("gemv_int4_w4a8", "tp=2 w_gate R=4 N=7168 K=4096 g=128", (rnd(4, h), *w_gate),
         False),
        ("qmatmul_tc", "tp=2 int4 w_gate R=1632 N=7168 K=4096 g=128", (rnd(1632, h), *w_gate),
         False),
        ("qmatmul_tc", "tp=2 int8 W_query R=1632 N=2048 K=4096", (rnd(1632, h), *q8(ol, h)),
         False),
        ("qmatmul_tc", "tp=2 int8 W_key R=1632 N=512 K=4096", (rnd(1632, h), *q8(kvl, h)), False),
        ("qmatmul_tc", "tp=2 int8 out_proj R=1632 N=4096 K=2048", (rnd(1632, ol), *q8(h, ol)),
         False),
        ("qmatmul_tc", "tp=2 int8 w_down R=1632 N=4096 K=7168", (rnd(1632, il), *q8(h, il)),
         False),
        ("qmatmul_tc", "tp=2 row-parallel int4 w_down R=1632 N=4096 K=7168 g=128",
         (rnd(1632, il), *q4(h, il, 128)), False),
    ]
    for name, kv in (("flash_decode", lambda *sh: (rnd(*sh), rnd(*sh))),
                     ("flash_decode_int8kv", kv8)):
        cases += [
            (name, "tp=2 decode B=1 nq=16 nkv=4 Tk=2048 q_offset=1700 hd=128",
             (rnd(1, 16, 1, 128), *kv(1, 4, 2048, 128), kvv1, 1700, True), False),
            (name, "tp=2 server decode B=4 nq=16 nkv=4 per-row q_offset Tk=2048 hd=128",
             (rnd(4, 16, 1, 128), *kv(4, 4, 2048, 128), kvv, offsets, True), False),
        ]
    return cases + tp_training_kernel_cases(rnd, valid)


def tp_training_kernel_cases(rnd, valid):
    """The kernels of the tensor-parallel training paths at a rank's shapes:
    ``tp_lora_11b`` (the 11B at tp=2: attention over 16 query and 4 kv
    heads, the replicated RMSNorm at 4096) and ``zero1_full_ft_3b`` (the 3B
    at tp=2: 12 and 4 heads, SwiGLU at I=4096, RMSNorm at 3072); the SwiGLU
    backward also at the 11B's tp=2 I=7168. B=1, S=1632."""
    def norm_bwd(r, c):
        t = rnd(r, c)
        rms = t.float().square().mean(-1).add(1e-5).sqrt()
        return (rnd(r, c), t, rnd(c), rms, True)

    cases = [
        ("rmsnorm_fwd_train", "tp=2 replicated R=1632 C=4096 +residual",
         (rnd(1632, 4096), rnd(4096), 1e-5, rnd(1632, 4096)), False),
        ("rmsnorm_fwd_train", "tp=2 3B replicated R=1632 C=3072 +residual",
         (rnd(1632, 3072), rnd(3072), 1e-5, rnd(1632, 3072)), False),
        ("rmsnorm_bwd", "tp=2 replicated R=1632 C=4096", norm_bwd(1632, 4096), False),
        ("rmsnorm_bwd", "tp=2 3B replicated R=1632 C=3072", norm_bwd(1632, 3072), False),
        ("swiglu_tc", "tp=2 3B R=1632 H=3072 I=4096",
         (rnd(1632, 3072), rnd(4096, 3072, scale=0.02), rnd(4096, 3072, scale=0.02)), False),
        ("swiglu_bwd_tc", "tp=2 3B R=1632 H=3072 I=4096",
         (rnd(1632, 3072), rnd(4096, 3072, scale=0.02), rnd(4096, 3072, scale=0.02),
          rnd(1632, 4096)), False),
        ("swiglu_bwd_tc", "tp=2 11B R=1632 H=4096 I=7168",
         (rnd(1632, 4096), rnd(7168, 4096, scale=0.02), rnd(7168, 4096, scale=0.02),
          rnd(1632, 7168)), False),
    ]
    for label, nq in (("tp=2 11B nq=16 nkv=4 T=1632 hd=128 causal", 16),
                      ("tp=2 3B nq=12 nkv=4 T=1632 hd=128 causal", 12)):
        fwd = (rnd(1, nq, 1632, 128), rnd(1, 4, 1632, 128), rnd(1, 4, 1632, 128),
               valid(1, 1632, 1632), 0, True)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        dout = rnd(*fwd[0].shape)
        bwd = (*fwd, lse, dout.float().mul(out.float()).sum(-1), dout)
        cases += [("flash_attention_tc_lse", label, fwd, False),
                  ("flash_attention_bwd_dq_tc", label, bwd, False),
                  ("flash_attention_bwd_dkv_tc", label, bwd, False)]
    return cases


RING_T = 2048  # sp_lora_11b: S=4096 over sp=2
FP32_MAIN_FWD = "fp32 decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal"
FP32_MAIN_TRAIN = "fp32 decoder nq=32 nkv=8 T=1632 hd=128 causal"


def ring_kernel_cases(rnd, valid):
    """The flash training kernels at the ring steps of ``sp_lora_11b`` (the
    11B's 32 query and 8 kv heads, hd 128, a rank's Tq = Tk = 2048 tokens,
    causal), at the chunk offsets a ring step gives: -2048 (a chunk wholly in
    the future: every row masked), 0 (the diagonal), 2048 (wholly in the
    past: every key seen); and the backward of the past chunk fed the LSE
    and ``rowsum(dO * O)`` of the merged output of both chunks, as the
    ring's backward feeds every chunk."""
    t = RING_T
    q = rnd(1, 32, t, 128)
    chunks = [(rnd(1, 8, t, 128), rnd(1, 8, t, 128)) for _ in range(2)]  # keys 0-2047, 2048-4095
    kvv = valid(1, t, t)
    dout = rnd(1, 32, t, 128)
    cases = []
    for q_offset, (k, v) in ((-t, chunks[1]), (0, chunks[1]), (t, chunks[0])):
        fwd = (q, k, v, kvv, q_offset, True)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        bwd = (*fwd, lse, dout.float().mul(out.float()).sum(-1), dout)
        label = f"ring nq=32 nkv=8 Tq=Tk={t} hd=128 q_offset={q_offset}"
        cases += [("flash_attention_tc_lse", label, fwd, False),
                  ("flash_attention_bwd_dq_tc", label, bwd, False),
                  ("flash_attention_bwd_dkv_tc", label, bwd, False)]
    # the query chunk at rows 2048-4095: the past chunk (offset 2048) and the
    # diagonal (offset 0) merged as attention._ring_merge does
    parts = [kernels.flash_attention_fwd_lse_plain(q, *chunks[i], kvv, off, True)
             for i, off in ((0, t), (1, 0))]
    merged, lse = attention_mod._ring_merge(
        torch.zeros(q.shape, dtype=torch.float32, device=q.device),
        torch.full(q.shape[:3], NEG_BIG, dtype=torch.float32, device=q.device), *parts[0])
    merged, lse = attention_mod._ring_merge(merged, lse, *parts[1])
    merged = merged.to(q.dtype)
    bwd = (q, *chunks[0], kvv, t, True, lse, dout.float().mul(merged.float()).sum(-1), dout)
    label = f"ring nq=32 nkv=8 Tq=Tk={t} hd=128 q_offset={t} merged LSE and delta"
    cases += [("flash_attention_bwd_dq_tc", label, bwd, False),
              ("flash_attention_bwd_dkv_tc", label, bwd, False)]
    return cases


def fp32_flash_cases(dev, gen):
    """The fp32 flash kernels on fp32 inputs, the dtype that the route sends
    them (the cases above are bf16): the 3xTF32 forward, its LSE and int8-KV
    instantiations (fp32 q, int8 K/V), dq and dk/dv, at the decoder prefill
    (the main case), ViT-H, the 3B, decode, a ragged hd 16 call with a fully
    masked row, per-row offsets at B=8 (the forwards: a gradient takes one
    offset), the ring's offsets and merged LSE, and hd 8, 32 and 96 with Tq
    and Tk off the 64-row tiles."""

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def valid(b, tk, n):
        kvv = torch.zeros(b, tk, dtype=torch.int32, device=dev)
        kvv[:, :n] = 1
        return kvv

    def kv8(*shape):
        (kq, ks), (vq, vs) = quantize_kv(rnd(*shape)), quantize_kv(rnd(*shape))
        return kq, vq, ks, vs

    masked = valid(2, 100, 90)
    masked[0, :6] = 0  # batch 0, query 0 (position 5) sees no key
    offsets = torch.tensor([0, 10, 57, 120, 160, 3, 99, 150], dtype=torch.int32, device=dev)
    # label: (q shape, k/v shape, kv_valid, q_offset, causal, main?)
    edges = {  # the forwards' and the training calls' alike
        "fp32 ViT-H nq=nkv=16 T=1600 hd=80 non-causal":
            ((1, 16, 1600, 80), (1, 16, 1600, 80), valid(1, 1600, 1600), 0, False, False),
        "fp32 decode Tq=1 Tk=2048 q_offset=1700 hd=128":
            ((1, 32, 1, 128), (1, 8, 2048, 128), valid(1, 2048, 1701), 1700, True, False),
        "fp32 ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys, a fully masked row":
            ((2, 4, 37, 16), (2, 2, 100, 16), masked, 5, True, False),
        "hd=32 fp32 B=2 nq=8 nkv=1 Tq=200 Tk=260 q_offset=60 causal":
            ((2, 8, 200, 32), (2, 1, 260, 32), valid(2, 260, 260), 60, True, False),
        "hd=96 fp32 nq=nkv=2 Tq=150 Tk=170 non-causal padded keys":
            ((1, 2, 150, 96), (1, 2, 170, 96), valid(1, 170, 160), 0, False, False),
    }
    fwd_shapes = {
        FP32_MAIN_FWD:
            ((1, 32, 1632, 128), (1, 8, 2048, 128), valid(1, 2048, 1632), 0, True, True),
        "fp32 3B prefill nq=24 nkv=8 Tq=1632 Tk=2048 hd=128 causal":
            ((1, 24, 1632, 128), (1, 8, 2048, 128), valid(1, 2048, 1632), 0, True, False),
        "fp32 per-row q_offset B=8 nq=8 nkv=2 Tq=40 Tk=200 hd=64":
            ((8, 8, 40, 64), (8, 2, 200, 64), valid(8, 200, 200), offsets, True, False),
        "hd=8 fp32 nq=4 nkv=2 Tq=70 Tk=90 q_offset=20 causal":
            ((1, 4, 70, 8), (1, 2, 90, 8), valid(1, 90, 90), 20, True, False),
        **edges,
    }
    cases = []
    for label, (qs, kvs, kvv, q_offset, causal, main) in fwd_shapes.items():
        q = rnd(*qs)
        cases.append(("flash_attention", label, (q, rnd(*kvs), rnd(*kvs), kvv, q_offset, causal),
                      main))
        if "ViT" not in label:  # the ViT has no KV cache
            cases.append(("flash_attention_int8kv", label,
                          (q, *kv8(*kvs), kvv, q_offset, causal), main))
    t = RING_T
    train_shapes = {  # the training calls: one offset
        FP32_MAIN_TRAIN:
            ((1, 32, 1632, 128), (1, 8, 1632, 128), valid(1, 1632, 1632), 0, True, True),
        "fp32 3B nq=24 nkv=8 T=1632 hd=128 causal":
            ((1, 24, 1632, 128), (1, 8, 1632, 128), valid(1, 1632, 1632), 0, True, False),
        "hd=8 fp32 nq=4 nkv=2 T=70 q_offset=0 causal":
            ((1, 4, 70, 8), (1, 2, 70, 8), valid(1, 70, 70), 0, True, False),
        **edges,
    }
    for label, (qs, kvs, kvv, q_offset, causal, main) in train_shapes.items():
        fwd = (rnd(*qs), rnd(*kvs), rnd(*kvs), kvv, q_offset, causal)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        dout = rnd(*qs)
        bwd = (*fwd, lse, (dout * out).sum(-1), dout)
        cases += [("flash_attention_lse", label, fwd, main),
                  ("flash_attention_bwd_dq", label, bwd, main),
                  ("flash_attention_bwd_dkv", label, bwd, main)]
    # the ring's steps (sp_lora_11b's shapes): a chunk wholly in the future,
    # the diagonal, a chunk wholly in the past, and the past chunk's backward
    # fed the merged LSE and delta
    q, dout, kvv = rnd(1, 32, t, 128), rnd(1, 32, t, 128), valid(1, t, t)
    chunks = [(rnd(1, 8, t, 128), rnd(1, 8, t, 128)) for _ in range(2)]
    for q_offset, (k, v) in ((-t, chunks[1]), (0, chunks[1]), (t, chunks[0])):
        fwd = (q, k, v, kvv, q_offset, True)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        label = f"ring fp32 nq=32 nkv=8 Tq=Tk={t} hd=128 q_offset={q_offset}"
        bwd = (*fwd, lse, (dout * out).sum(-1), dout)
        cases += [("flash_attention_lse", label, fwd, False),
                  ("flash_attention_bwd_dq", label, bwd, False),
                  ("flash_attention_bwd_dkv", label, bwd, False)]
    parts = [kernels.flash_attention_fwd_lse_plain(q, *chunks[i], kvv, off, True)
             for i, off in ((0, t), (1, 0))]
    merged, lse = attention_mod._ring_merge(
        torch.zeros(q.shape, dtype=torch.float32, device=dev),
        torch.full(q.shape[:3], NEG_BIG, dtype=torch.float32, device=dev), *parts[0])
    merged, lse = attention_mod._ring_merge(merged, lse, *parts[1])
    label = f"ring fp32 nq=32 nkv=8 Tq=Tk={t} hd=128 q_offset={t} merged LSE and delta"
    bwd = (q, *chunks[0], kvv, t, True, lse, (dout * merged).sum(-1), dout)
    cases += [("flash_attention_bwd_dq", label, bwd, False),
              ("flash_attention_bwd_dkv", label, bwd, False)]
    return cases


FP32_SWIGLU_MAIN = "fp32 11B R=1632 H=4096 I=14336"


def fp32_swiglu_cases(dev, gen):
    """The fp32 SwiGLU tile on fp32 inputs, forward and backward: the 11B
    prefill and training widths at R=1632 (the main cases), the 3B's, R=9
    (the forward's first row count above the rows kernel), a ragged R=33
    H=100 I=200 call (H not a multiple of the tile's 64-k stages nor of its
    16-byte copies), x and the cotangent one element into their buffers (the
    plain-load route), and a backward at R=3 (no rows kernel backward)."""

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def off(*shape):  # a contiguous view one element into its buffer
        return rnd(math.prod(shape) + 1)[1:].view(*shape)

    h, inter = 4096, 14336
    shapes = [  # (label, R, H, I, weight scale, x and g offset, main?)
        (FP32_SWIGLU_MAIN, 1632, h, inter, 0.02, False, True),
        ("fp32 3B R=1632 H=3072 I=8192", 1632, 3072, 8192, 0.02, False, False),
        ("fp32 R=9 H=4096 I=14336", 9, h, inter, 0.02, False, False),
        ("fp32 ragged R=33 H=100 I=200", 33, 100, 200, 0.1, False, False),
        ("fp32 x and g offset by one element R=130 H=256 I=300", 130, 256, 300, 0.1, True,
         False),
        ("fp32 R=3 H=4096 I=14336", 3, h, inter, 0.02, False, False),
    ]
    cases = []
    for label, r, hh, ii, scale, offset, main in shapes:
        x = off(r, hh) if offset else rnd(r, hh)
        g = off(r, ii) if offset else rnd(r, ii)
        wg, wu = rnd(ii, hh, scale=scale), rnd(ii, hh, scale=scale)
        if r > 8:  # the forward's rows kernel takes 8 rows or fewer
            cases.append(("swiglu_tf32", label, (x, wg, wu), main))
        cases.append(("swiglu_bwd_tf32", label, (x, wg, wu, g), main))
    return cases + fp32_rows_cases(rnd, off)


def fp32_rows_cases(rnd, off):
    """The kernels of at most 8 rows on fp32 inputs: the CUDA-core SwiGLU rows
    kernel at the 11B widths at R = 1, 2, 5 and 8 (the main case, the server's
    8 slots), H=100 (element loads) and x one element into its buffer; the
    SwiGLU + down fusion at the 11B widths at R = 1 and 8 and a ragged R=9
    call (two blocks of rows, I not a multiple of its tile)."""
    h, inter = 4096, 14336
    wg, wu = rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)
    wd = rnd(h, inter, scale=0.01)
    cases = [("swiglu_rows", f"fp32 {'server ' if r == 8 else ''}decode R={r} H=4096 I=14336",
              (rnd(r, h), wg, wu), r == 8) for r in (1, 2, 5, 8)]
    cases += [
        ("swiglu_rows", "fp32 ragged H R=3 H=100 I=200",
         (rnd(3, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("swiglu_rows", "fp32 x offset by one element R=4 H=256 I=300",
         (off(4, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1)), False),
    ]
    cases += [("swiglu_down", f"fp32 R={r} H=4096 I=14336", (rnd(r, h), wg, wu, wd), False)
              for r in (1, 8)]
    cases.append(("swiglu_down", "fp32 ragged I R=9 H=96 I=200",
                  (rnd(9, 96), rnd(200, 96, scale=0.1), rnd(200, 96, scale=0.1),
                   rnd(96, 200, scale=0.1)), False))
    return cases


def check_ring_masked(name, label, got) -> None:
    """A ring step whose key chunk lies wholly in the future: the output and
    every gradient exactly 0, the LSE exactly ``NEG_BIG``."""
    got = got if isinstance(got, tuple) else (got,)
    lse_fwd = name.endswith("_lse")
    zero = all(bool((g == 0).all()) for g in (got[:1] if lse_fwd else got))
    lse_ok = not lse_fwd or bool((got[1] == NEG_BIG).all())
    if not (zero and lse_ok):
        raise RuntimeError(f"{name} [{label}]: a wholly masked chunk gave a nonzero output or "
                           f"gradient, or an LSE other than NEG_BIG")
    log(f"kernel {name} [{label}]: every row masked: exactly 0"
        f"{', the LSE exactly NEG_BIG' if lse_fwd else ''}")


def spec_kernel_cases(rnd, valid):
    """The shapes speculative decoding adds: the 8-slot server's verify (K=3,
    32 rows) through the gemv and the TMA SwiGLU tile, and the Llama-3.2-1B-
    width draft (hidden 2048, FFN 8192, head dim 64): its R=1 linears and
    head, its decode SwiGLU rows, its prefill tile and prefill attention.
    (The B=1 verify's K+1 = 5 rows are the R=5 cases above; the verify's
    flash decode shapes are with the decode cases.)"""
    h, inter, vocab, dh, dinter = 4096, 14336, 128256, 2048, 8192
    return [
        ("gemv_tc", "server verify W_query R=32 N=4096 K=4096",
         (rnd(32, h), rnd(h, h, scale=0.02)), False),
        ("gemv_tc", "server verify w_down R=32 N=4096 K=14336",
         (rnd(32, inter), rnd(h, inter, scale=0.01)), False),
        ("gemv_tc", "1B draft lm_head R=1 N=128256 K=2048", (rnd(1, dh), rnd(vocab, dh)), False),
        ("gemv_tc", "1B draft w_down R=1 N=2048 K=8192",
         (rnd(1, dinter), rnd(dh, dinter, scale=0.01)), False),
        ("swiglu_tc", "server verify R=32 H=4096 I=14336",
         (rnd(32, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), False),
        ("swiglu_tc", "1B draft prefill R=1632 H=2048 I=8192",
         (rnd(1632, dh), rnd(dinter, dh, scale=0.02), rnd(dinter, dh, scale=0.02)), False),
        ("swiglu_rows_tc", "1B draft decode R=1 H=2048 I=8192",
         (rnd(1, dh), rnd(dinter, dh, scale=0.02), rnd(dinter, dh, scale=0.02)), False),
        ("flash_attention_tc", "1B draft prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=64 causal",
         (rnd(1, 32, 1632, 64), rnd(1, 8, 2048, 64), rnd(1, 8, 2048, 64),
          valid(1, 2048, 1632), 0, True), False),
    ]


# The cases whose bf16 x starts 2 bytes past a 16-byte boundary: the model's
# entries route them to the gemvs' general routes (check_routed).
MISALIGNED_X = "x 2 bytes off alignment"


def int8_gemv_cases(rnd, q8):
    """The tensor-core int8 gemv at the 11B decode linears (R = 1, 8, 16 and
    32: one request, the server's 8 slots, more rows), the int8 head at R = 1
    (main) and 8, the 3B widths, channel scales 1000x apart (a scale applied
    to a neighbouring column shows) with a ragged N; and a call whose x the
    tensor-core kernel does not take, which the model's entry routes to the
    general route."""
    h, inter, vocab = 4096, 14336, 128256

    def q8_stepped(n, k):
        w = rnd(n, k, scale=0.02).float()
        w[1::2] *= 1e-3
        qw = quantize_weight(w.to(torch.bfloat16))
        return qw["q"], qw["scale"]

    head = q8(vocab, h)
    linears = [("W_query", h, h, q8(h, h)), ("W_key", 1024, h, q8(1024, h)),
               ("w_gate", inter, h, q8(inter, h)), ("w_down", h, inter, q8(h, inter))]
    cases = [("gemv_int8_tc", f"{label} R={r} N={n} K={k}", (rnd(r, k), *w), False)
             for r in (1, 8, 16, 32) for label, n, k, w in linears]
    cases += [
        ("gemv_int8_tc", "int8 lm_head R=1 N=128256 K=4096", (rnd(1, h), *head), True),
        ("gemv_int8_tc", "int8 lm_head R=8 N=128256 K=4096", (rnd(8, h), *head), False),
        ("gemv_int8_tc", "3B W_query R=8 N=3072 K=3072", (rnd(8, 3072), *q8(3072, 3072)), False),
        ("gemv_int8_tc", "3B w_gate R=1 N=8192 K=3072", (rnd(1, 3072), *q8(8192, 3072)), False),
        ("gemv_int8_tc", "3B w_down R=8 N=3072 K=8192", (rnd(8, 8192), *q8(3072, 8192)), False),
        ("gemv_int8_tc", "channel scales 1000x apart R=8 N=1000 K=4096",
         (rnd(8, h), *q8_stepped(1000, h)), False),
        ("gemv_int8", f"{MISALIGNED_X} R=8 N=4096 K=4096",
         (rnd(8 * h + 1)[1:].view(8, h), *linears[0][3]), False),
    ]
    return cases


def server_kernel_cases(rnd, q4, q4_stepped, q4_off, kv8):
    """The server's kernels: the W4A8 int4 gemv at its decode shapes (8 slots;
    R=1 for one request) and at group sizes whose spans straddle groups, rows
    of K/2 = 2050 bytes and misaligned q4, the SwiGLU+down op, and
    decode attention over 8 slots at their own fill levels (per-row query
    offsets; the prompt's bucket padding 1632..1663 blocked, an idle slot at
    S-1)."""
    h, inter, vocab = 4096, 14336, 128256
    dev = rnd(1).device
    offsets = torch.tensor([1664, 1700, 1727, 1690, 1665, 1800, 2047, 1900], dtype=torch.int32,
                           device=dev)
    kvv = (torch.arange(2048, device=dev)[None, :] <= offsets[:, None].long()).to(torch.int32)
    kvv[:, 1632:1664] = 0
    zero_row = rnd(2, h)
    zero_row[0] = 0
    w_gate = q4(inter, h, 128)
    return [
        *[("gemv_int4_w4a8", f"w_gate R={r} N=14336 K=4096 g=128", (rnd(r, h), *w_gate), r == 8)
          for r in (1, 8, 16, 32)],
        ("gemv_int4_w4a8", "g=24 R=3 N=200 K=192", (rnd(3, 192), *q4(200, 192, 24)), False),
        ("gemv_int4_w4a8", "g=16 w_gate R=8 N=14336 K=4096", (rnd(8, h), *q4(inter, h, 16)),
         False),
        ("gemv_int4_w4a8", "g=16 group scales 1000x apart R=8 N=1000 K=4096",
         (rnd(8, h), *q4_stepped(1000, h, 16)), False),
        ("gemv_int4_w4a8", "g=56 w_down R=8 N=4096 K=14336", (rnd(8, inter), *q4(h, inter, 56)),
         False),
        ("gemv_int4_w4a8", "per-channel R=8 N=4096 K=4100 g=4100",
         (rnd(8, 4100), *q4(h, 4100, 4100)), False),
        ("gemv_int4_w4a8", "g=6 R=5 N=300 K=192", (rnd(5, 192), *q4(300, 192, 6)), False),
        ("gemv_int4_w4a8", "q4 1 byte off alignment R=8 N=4096 K=4096 g=128",
         (rnd(8, h), *q4_off(h, h, 128)), False),
        ("gemv_int4_w4a8", "int4 lm_head R=8 N=128256 K=4096 g=128",
         (rnd(8, h), *q4(vocab, h, 128)), False),
        ("gemv_int4_w4a8", "int4 lm_head R=1 N=128256 K=4096 g=128",
         (rnd(1, h), *q4(vocab, h, 128)), False),
        ("gemv_int4_w4a8", "per-channel R=8 N=4096 K=4096 g=4096", (rnd(8, h), *q4(h, h, h)),
         False),
        ("gemv_int4_w4a8", "an all-zero row R=2 N=1000 K=4096 g=128",
         (zero_row, *q4(1000, h, 128)), False),
        ("gemv_int4_w4a8", "g=64 R=20 N=1000 K=4096", (rnd(20, h), *q4(1000, h, 64)), False),
        ("gemv_int4_w4a8", "g=32 R=5 N=300 K=256", (rnd(5, 256), *q4(300, 256, 32)), False),
        ("gemv_int4_w4a8", "group scales 1000x apart R=8 N=1000 K=4096 g=128",
         (rnd(8, h), *q4_stepped(1000, h, 128)), False),
        ("gemv_int4_w4a8", "fp32 x R=3 N=1000 K=4096 g=128",
         (rnd(3, h).float(), *q4(1000, h, 128)), False),
        ("swiglu_down", "decode R=1 H=4096 I=14336",
         (rnd(1, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02),
          rnd(h, inter, scale=0.01)), True),
        ("swiglu_down", "R=8 H=4096 I=14336",
         (rnd(8, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02),
          rnd(h, inter, scale=0.01)), False),
        ("swiglu_down", "3B R=8 H=3072 I=8192",
         (rnd(8, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(3072, 8192, scale=0.01)), False),
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
    # speculative verifies: B=1 K=4 at q_offset 1700; the 8-slot server's K=3 at
    # wp = the slot's offset clamped to S-1-K, valid keys below wp and wp..wp+3
    kvv5 = (torch.arange(2048, device=dev) <= 1704).to(torch.int32)[None]
    wp = offsets.clamp(max=2048 - 4)
    karr = torch.arange(2048, device=dev)[None, :]
    kvv_v = (((kvv != 0) & (karr < wp[:, None].long()))
             | ((karr >= wp[:, None].long()) & (karr <= wp[:, None].long() + 3))).to(torch.int32)
    cases = []
    for name, kv in (("flash_decode", lambda *sh: (rnd(*sh), rnd(*sh))),
                     ("flash_decode_int8kv", kv8)):
        cases += [
            (name, "server decode B=8 per-row q_offset Tk=2048 hd=128",
             (rnd(8, 32, 1, 128), *kv(8, 8, 2048, 128), kvv, offsets, True), True),
            (name, "decode B=1 Tq=1 Tk=2048 q_offset=1700 hd=128",
             (rnd(1, 32, 1, 128), *kv(1, 8, 2048, 128), kvv1, 1700, True), False),
            (name, "verify B=1 Tq=5 Tk=2048 q_offset=1700 hd=128",
             (rnd(1, 32, 5, 128), *kv(1, 8, 2048, 128), kvv5, 1700, True), False),
            (name, "server verify B=8 Tq=4 per-row q_offset Tk=2048 hd=128",
             (rnd(8, 32, 4, 128), *kv(8, 8, 2048, 128), kvv_v, wp, True), False),
            (name, "1B draft decode B=1 nq=32 nkv=8 Tk=2048 q_offset=1700 hd=64",
             (rnd(1, 32, 1, 64), *kv(1, 8, 2048, 64), kvv1, 1700, True), False),
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
        ("rmsnorm_bwd", "3B R=1632 C=3072", norm_bwd(1632, 3072), False),
        ("rmsnorm_bwd", "3B R=1632 C=3072 frozen weight", norm_bwd(1632, 3072, need_dw=False),
         False),
        ("rmsnorm_bwd", "ragged R=3 C=100", norm_bwd(3, 100), False),
        ("rmsnorm_bwd", "ragged R=130 C=4100", norm_bwd(130, 4100), False),
        ("rmsnorm_bwd", "fp32 R=33 C=4096", tuple(a.float() if isinstance(a, torch.Tensor) else a
                                                  for a in norm_bwd(33, h)), False),
        ("swiglu_bwd", "3B R=1632 H=3072 I=8192",
         (rnd(1632, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(1632, 8192)), True),
        ("swiglu_bwd", "11B R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02), rnd(1632, inter)),
         False),
        ("swiglu_bwd", "ragged R=33 H=100 I=200",
         (rnd(33, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1), rnd(33, 200)), False),
        ("swiglu_bwd_tc", "3B R=1632 H=3072 I=8192",
         (rnd(1632, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(1632, 8192)), True),
        ("swiglu_bwd_tc", "11B R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02), rnd(1632, inter)),
         False),
        ("swiglu_bwd_tc", "R=33 H=3072 I=8192",
         (rnd(33, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(33, 8192)), False),
        ("swiglu_bwd_tc", "ragged I R=130 H=256 I=300",
         (rnd(130, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1), rnd(130, 300)),
         False),
        # a contiguous cotangent that starts at an odd element (2-byte aligned)
        ("swiglu_bwd_tc", "g offset by one element R=130 H=256 I=300",
         (rnd(130, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1),
          rnd(130 * 300 + 1)[1:].view(130, 300)), False),
        # H a multiple of 8 but not of 64: TMA zero-fills the last 64-k box
        ("swiglu_bwd_tc", "R=1632 H=4104 I=14336",
         (rnd(1632, 4104), rnd(inter, 4104, scale=0.02), rnd(inter, 4104, scale=0.02),
          rnd(1632, inter)), False),
        ("swiglu_bwd_tc", "R=130 H=200 I=300",
         (rnd(130, 200), rnd(300, 200, scale=0.1), rnd(300, 200, scale=0.1), rnd(130, 300)),
         False),
        # a bf16 training microbatch of at most 8 tokens: the rows kernels'
        # backward (tensor cores where H % 32 == 0 and x and the weights are
        # 16-byte aligned, else the CUDA cores)
        *[("swiglu_bwd_rows_tc", f"R={r} H=4096 I=14336",
           (rnd(r, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02), rnd(r, inter)),
           r == 8) for r in (1, 8)],
        ("swiglu_bwd_rows_tc", "3B R=8 H=3072 I=8192",
         (rnd(8, 3072), rnd(8192, 3072, scale=0.02), rnd(8192, 3072, scale=0.02),
          rnd(8, 8192)), False),
        ("swiglu_bwd_rows_tc", "ragged I R=3 H=96 I=200",
         (rnd(3, 96), rnd(200, 96, scale=0.1), rnd(200, 96, scale=0.1), rnd(3, 200)), False),
        ("swiglu_bwd_rows_tc", "g offset by one element R=5 H=256 I=300",
         (rnd(5, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1),
          rnd(5 * 300 + 1)[1:].view(5, 300)), False),
        ("swiglu_bwd_rows", "ragged H R=3 H=100 I=200",
         (rnd(3, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1), rnd(3, 200)), False),
        ("swiglu_bwd_rows", "ragged H R=8 H=4100 I=14336",
         (rnd(8, 4100), rnd(inter, 4100, scale=0.02), rnd(inter, 4100, scale=0.02),
          rnd(8, inter)), True),
        ("swiglu_bwd_rows", "x offset by one element R=4 H=256 I=300",
         (rnd(4 * 256 + 1)[1:].view(4, 256), rnd(300, 256, scale=0.1), rnd(300, 256, scale=0.1),
          rnd(4, 300)), False),
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
    holes = valid(1, 150, 150)
    holes[0, ::7] = 0
    tc_only = [  # the tensor-core backward's other head sizes and edges
        ("hd=8 nq=4 nkv=2 Tq=70 Tk=90 q_offset=20 causal", rnd(1, 4, 70, 8), rnd(1, 2, 90, 8),
         rnd(1, 2, 90, 8), valid(1, 90, 90), 20, True, False),
        ("hd=32 B=2 nq=8 nkv=1 Tq=200 Tk=260 q_offset=60 causal", rnd(2, 8, 200, 32),
         rnd(2, 1, 260, 32), rnd(2, 1, 260, 32), valid(2, 260, 260), 60, True, False),
        ("hd=64 nq=4 nkv=4 T=150 non-causal, every 7th key blocked", rnd(1, 4, 150, 64),
         rnd(1, 4, 150, 64), rnd(1, 4, 150, 64), holes, 0, False, False),
        ("hd=96 nq=nkv=2 T=150 non-causal padded keys", rnd(1, 2, 150, 96), rnd(1, 2, 150, 96),
         rnd(1, 2, 150, 96), valid(1, 150, 140), 0, False, False),
    ]
    for fp32_pair, (label, q, k, v, kvv, q_offset, causal, main) in (
            [(True, c) for c in attn] + [(False, c) for c in tc_only]):
        fwd = (q, k, v, kvv, q_offset, causal)
        out, lse = kernels.flash_attention_fwd_lse_plain(*fwd)
        dout = rnd(*q.shape)
        delta = (dout.float() * out.float()).sum(-1)
        bwd = (*fwd, lse, delta, dout)
        if fp32_pair:  # the fp32 kernels' main cases are fp32 (fp32_flash_cases)
            cases += [("flash_attention_lse", label, fwd, False),
                      ("flash_attention_tc_lse", label, fwd, main),
                      ("flash_attention_bwd_dq", label, bwd, False),
                      ("flash_attention_bwd_dkv", label, bwd, False)]
        cases += [("flash_attention_bwd_dq_tc", label, bwd, main),
                  ("flash_attention_bwd_dkv_tc", label, bwd, main)]
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
# The fp32 flash kernels run each fp32 product as three TF32 products on the
# tensor cores (494.7 TFLOP/s dense); their bound counts that, and the
# CUDA-core bound (67) is logged beside it.
TF32X3_OPS = 494.7e12 / 3
# The W4A16 gemv runs fp32 x as three bf16 planes, three bf16 products each.
BF16X3_OPS = 989e12 / 3


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def _allowed(kv_valid, q_offset, causal, tq):
    """``[B, Tq, Tk]`` bool: the (query, key) pairs a flash call computes."""
    b, tk = kv_valid.shape
    return allowed_mask(kv_valid, q_offset, causal, tq, tk, kv_valid.device).expand(
        b, 1, 1, tq, tk)[:, 0, 0]


def fp32_case(name, args) -> bool:
    """A 3xTF32 kernel's case on fp32 inputs."""
    return (name in FP32_FORWARD + FP32_BACKWARD + FP32_SWIGLU
            and args[0].dtype == torch.float32)


# The SwiGLU kernels of at most 8 rows a block whose fp32 cases run on the
# CUDA cores, and the gemvs on fp32 x (3xTF32, or three exact bf16 planes):
# held to FP32_TOL too (fp32 sums on both sides, in other orders).
FP32_SIMT_SWIGLU = ("swiglu_rows", "swiglu_down")
FP32_GEMVS = ("gemv", "gemv_int8", "gemv_int4", "qmatmul")


def held_to_fp32_tol(name, args) -> bool:
    """A case compared with its plain version at FP32_TOL, not TOL."""
    return fp32_case(name, args) or (name in FP32_SIMT_SWIGLU + FP32_GEMVS
                                     and args[0].dtype == torch.float32)


def bound(name, args, out, cuda_cores: bool = False):
    """``(bound_ms, bound_by)``: the larger of the bytes the function must
    move (each input read once, each output written once; for causal
    attention only the keys below each row's limit) over the HBM rate and
    its operations over the peak for its operand type: for a 3xTF32
    kernel's fp32 case three TF32 products each, or with ``cuda_cores`` the
    CUDA cores' fp32 rate."""
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
        per_pair = {"flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 8,
                    "flash_attention_bwd_dq_tc": 6, "flash_attention_bwd_dkv_tc": 8}.get(name, 4)
        ops = per_pair * q.shape[3] * pairs
    elif name.startswith(("gemv", "qmatmul")):
        rows, n = x.numel() // x.shape[-1], args[1].shape[0]
        ops = 2 * rows * n * x.shape[-1]
    elif name.startswith("swiglu"):
        rows, inter = x.numel() // x.shape[-1], args[1].shape[0]
        ops = {"swiglu_down": 6}.get(name, 4) * rows * x.shape[-1] * inter
    else:  # RMSNorm: a few operations per element
        ops = 4 * x.numel()
    peak = PEAK_OPS[torch.int8 if name.startswith("gemv_int4_w4a8") else x.dtype]
    if fp32_case(name, args) and not cuda_cores:
        peak = TF32X3_OPS
    if name in ("gemv_int4", "gemv_int8", "qmatmul") and x.dtype == torch.float32:  # 3 bf16 products
        peak = BF16X3_OPS
    if name == "gemv" and x.dtype == torch.float32:  # three TF32 products
        peak = TF32X3_OPS
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
    if name in ("gemv", "gemv_tc"):
        if x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("fp32 F.linear would run on TF32 (allow_tf32 is set)")
        return lambda: F.linear(x, args[1])
    if name == "rmsnorm" and args[3] is None:
        return lambda: F.rms_norm(x, (x.shape[-1],), args[1], args[2])
    if name in ("gemv_int4", "qmatmul", "qmatmul_tc") and args[1].dtype == torch.uint8:
        if x.data_ptr() % 16:  # its kernel faults on misaligned x (a sticky CUDA error)
            raise RuntimeError("_weight_int4pack_mm takes 16-byte-aligned x only")
        packed, g, sz = _int4pack(args[1], args[2], x)
        x2 = x.reshape(-1, x.shape[-1])
        return lambda: torch._weight_int4pack_mm(x2, packed, g, sz)
    if (name in ("gemv_int8", "gemv_int8_tc", "qmatmul", "qmatmul_tc")
            and args[1].dtype == torch.int8):
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


BWD_TC = ("flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")
# The int4 gemvs: one tensor-core kernel each, at every call; each case is
# called twice and, above one row, each row against its R=1 call.
INT4_GEMVS = ("gemv_int4", "gemv_int4_w4a8")
# The tensor-core forward zero-fills its hd 8 padding beside cp.async copies
# into the same tiles; 50 calls compared bit for bit guard that, and the
# 3xTF32 forward's ring of cp.async tiles at hd 8.
HD8_RACE = ("flash_attention_tc", "flash_attention_tc_int8kv", "flash_attention",
            "flash_attention_int8kv")


def check_same_bits(name, label, wrapper, args, got, calls: int = 1) -> None:
    """``calls`` more calls on the same inputs give the same bits (no
    atomics, a fixed summation order, no race); an output not asked for is
    None in every call."""
    got = got if isinstance(got, tuple) else (got,)
    for i in range(calls):
        again = wrapper(*args)
        again = again if isinstance(again, tuple) else (again,)
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name} [{label}]: call {i + 2} on the same inputs differs from "
                               f"the first")
    log(f"kernel {name} [{label}]: {calls + 1} calls equal bit for bit")


def check_gemv_rows_alone(name, label, wrapper, args, got) -> None:
    """Each row of a multi-row gemv call equals, bit for bit, the call on
    that row alone (a server's request against a solo engine run); a SwiGLU
    backward's cotangent is cut to that row with x, and each of its outputs
    compared."""
    x = args[0]
    cut = (0, 3) if name.startswith("swiglu_bwd") else (0,)
    got = got if isinstance(got, tuple) else (got,)
    for r in range(x.shape[0]):
        one = wrapper(*(a[r:r + 1].contiguous() if i in cut else a for i, a in enumerate(args)))
        one = one if isinstance(one, tuple) else (one,)
        if not all(torch.equal(o, g[r:r + 1]) for o, g in zip(one, got)):
            raise RuntimeError(f"{name} [{label}]: row {r} differs from the R=1 call on that row")
    log(f"kernel {name} [{label}]: each of the {x.shape[0]} rows equals its R=1 call bit for bit")


# The kernels (and the gemvs' general routes) that the model's entries
# choose by shape: kernel name -> that entry. Rows of a gemv-like call (at most 32) are each checked
# against an R = 1 call, those of an R = 1632 GEMM-like call against an
# R = 97 call.
ROUTED_BY = {
    "gemv_tc": kernels.gemv_cuda,
    "gemv_int8_tc": kernels.gemv_int8_cuda,
    "gemv": kernels.gemv_cuda,
    "gemv_int8": kernels.gemv_int8_cuda,
    "swiglu_rows_tc": kernels.fused_swiglu_cuda,
    "swiglu_tc": kernels.fused_swiglu_cuda,
    "swiglu_bwd_tc": kernels.fused_swiglu_bwd_cuda,
    "qmatmul_tc": kernels.qmatmul_cuda,
    "qmatmul": kernels.qmatmul_cuda,
    "swiglu_tf32": kernels.fused_swiglu_cuda,
    "swiglu_bwd_tf32": kernels.fused_swiglu_bwd_cuda,
    "swiglu_rows": kernels.fused_swiglu_cuda,
    "swiglu_bwd_rows_tc": kernels.fused_swiglu_bwd_cuda,
    "swiglu_bwd_rows": kernels.fused_swiglu_bwd_cuda,
    "swiglu": kernels.fused_swiglu_cuda,
    "swiglu_bwd": kernels.fused_swiglu_bwd_cuda,
}
# The bf16 SwiGLU kernels built on the TMA tile: the tile on the operands as
# they are, and the general route (the tile after the pre-pass).
SWIGLU_TMA = ("swiglu_tc", "swiglu_bwd_tc", "swiglu", "swiglu_bwd")


def swiglu_routed_general(args) -> bool:
    """Whether the model's SwiGLU entry takes the general route for these
    operands: bf16, more rows than a rows kernel takes, and an operand the
    TMA tile cannot read as it is."""
    return (args[0].dtype == torch.bfloat16 and args[0].shape[0] > SWIGLU_ROWS_KERNEL_MAX
            and not all(map(swiglu_reads_as_is, args[:3])))


def check_routed(name, label, args, got) -> None:
    """A routed kernel's case: the model's entry routes it to that kernel
    with the same bits, a second call gives the same bits, each row of a
    multi-row decode call equals its R = 1 call bit for bit (warps split K
    at spans fixed by the weights' shape and are summed in a fixed order),
    and the rows of an R = 1632 call, of a SwiGLU tile at R <= 32 and of a
    bf16 SwiGLU tile call above 97 rows equal those of an R = 97 call bit
    for bit (no split-K, a k order fixed by K, tiles fixed by N): rows 0-96
    of the one, all of the other."""
    wrapper = kernels.KERNELS[name][0]
    got = got if isinstance(got, tuple) else (got,)
    if name == "qmatmul" and reads_as_is(args[0], args[1], *check_quant(*args)[2:]):
        log(f"kernel {name} [{label}]: forced onto the general route (the model's entry reads "
            f"this x as it is)")
    elif name in ("swiglu", "swiglu_bwd") and not swiglu_routed_general(args):
        log(f"kernel {name} [{label}]: forced onto the general route (the model's entry takes "
            f"the TMA tile or a rows kernel here)")
    else:
        before = wrapper.launches
        routed = ROUTED_BY[name](*args)
        routed = routed if isinstance(routed, tuple) else (routed,)
        if wrapper.launches != before + 1 or not all(map(torch.equal, routed, got)):
            raise RuntimeError(f"{name} [{label}]: the model's entry did not route it to {name}, "
                               f"or gave other bits")
        log(f"kernel {name} [{label}]: the model's entry launched {name}, the same bits")
    check_same_bits(name, label, wrapper, args, got)
    rows = args[0].shape[0]
    tile = name in SWIGLU_TMA + FP32_SWIGLU
    if 1 < rows <= 32 and not tile:
        check_gemv_rows_alone(name, label, wrapper, args, got)
    if rows == 1632 or (tile and rows <= 32) or (name in SWIGLU_TMA and rows > 97):
        # x, and for the backward the cotangent, as 97 rows whose first
        # min(R, 97) are the case's (repeated where R < 97)
        n = min(rows, 97)
        part = wrapper(*(a.repeat(-(-97 // rows), 1)[:97].contiguous() if i in (0, 3) else a
                         for i, a in enumerate(args)))
        part = part if isinstance(part, tuple) else (part,)
        if not all(torch.equal(p[:n], g[:n]) for p, g in zip(part, got)):
            raise RuntimeError(f"{name} [{label}]: rows 0-{n - 1} differ from an R=97 call")
        log(f"kernel {name} [{label}]: rows 0-{n - 1} equal the R=97 call bit for bit")


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
        tol = FP32_TOL if held_to_fp32_tol(name, args) else TOL
        if not err <= tol * scale:
            failures.append(f"{name} [{label}] disagrees with its plain version: "
                            f"{err} > {tol} * {scale}")
            log(failures[-1])
            if only is None:
                break
            continue
        if main and name.startswith("flash_decode"):
            check_rows_alone(name, wrapper, args, got)
        if label.startswith("ring") and label.endswith(f"q_offset={-RING_T}"):
            check_ring_masked(name, label, got)
        if name in BWD_TC + FP32_FORWARD + FP32_BACKWARD + INT4_GEMVS + ("rmsnorm_bwd",):
            check_same_bits(name, label, wrapper, args, got)
        if name in INT4_GEMVS and args[0].shape[0] > 1:
            check_gemv_rows_alone(name, label, wrapper, args, got)
        if name == "swiglu_down":  # tiles from I alone, sums in a fixed order
            check_same_bits(name, label, wrapper, args, got)
            if args[0].shape[0] > 1:
                check_gemv_rows_alone(name, label, wrapper, args, got)
        if name in HD8_RACE and label.startswith("hd=8"):  # the zero-fill race, repaired
            check_same_bits(name, label, wrapper, args, got, calls=49)
        if name in ROUTED_BY:
            check_routed(name, label, args, got)
        ms, plain_ms = time_ms(lambda: wrapper(*args)), time_ms(lambda: plain(*args))
        lib_ms = library_ms(name, label, args)
        bound_ms, bound_by = bound(name, args, want)
        times[name, label] = (ms, lib_ms)
        if name == "swiglu_down" and args[0].shape[0] <= 8 and args[0].shape[-1] == 4096:
            # the yardstick: the unfused pair a decode step runs instead
            pair_ms = time_ms(lambda: kernels.gemv_cuda(kernels.fused_swiglu_cuda(*args[:3]),
                                                        args[3]))
            log(f"yardstick swiglu_down [{label}]: fused {ms:.6g} ms, SwiGLU + gemv {pair_ms:.6g}"
                f" ms ({'no slower' if ms <= pair_ms else 'SLOWER'} than the pair)")
        rate = ""
        if fp32_case(name, args):
            rate = f" cuda_core_bound_ms={bound(name, args, want, cuda_cores=True)[0]:.6g}"
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
            (ms, lib), (fp32, _) = times[new, label], times["flash_attention", label]
            log(f"yardstick [{label}]: {new} {ms:.6g} ms, 3xTF32 flash_attention on bf16 "
                f"{fp32:.6g} ms ({fp32 / ms:.3g}x), SDPA {lib} ms "
                f"({'no slower' if lib and ms <= lib else 'SLOWER'} than SDPA)")
    label = "decoder nq=32 nkv=8 T=1632 hd=128 causal"
    if all((n, label) in times for n in BWD_TC + FP32_BACKWARD):
        tc_ms = sum(times[n, label][0] for n in BWD_TC)
        fp32_ms = sum(times[n, label][0] for n in FP32_BACKWARD)
        lib = times[BWD_TC[0], label][1]
        log(f"yardstick [{label}] backward: tensor-core dq + dk/dv {tc_ms:.6g} ms, fp32 pair on "
            f"bf16 {fp32_ms:.6g} ms ({fp32_ms / tc_ms:.3g}x), SDPA backward (dq, dk, dv) {lib} ms "
            f"({'no slower' if lib and tc_ms <= lib else 'SLOWER'} than SDPA)")
    for name, label in (("flash_attention", FP32_MAIN_FWD),
                        ("flash_attention_lse", FP32_MAIN_TRAIN),
                        ("flash_attention_bwd_dq", FP32_MAIN_TRAIN),
                        ("flash_attention_bwd_dkv", FP32_MAIN_TRAIN)):
        if (name, label) in times:  # the targets: no slower than SDPA on the same fp32 inputs
            ms, lib = times[name, label]
            log(f"yardstick fp32 [{label}]: {name} {ms:.6g} ms, SDPA"
                f"{' (whole backward)' if 'bwd' in name else ''} on fp32 {lib} ms "
                f"({'no slower' if lib and ms <= lib else 'SLOWER'} than SDPA)")
    if all((n, FP32_MAIN_TRAIN) in times for n in FP32_BACKWARD):
        pair = sum(times[n, FP32_MAIN_TRAIN][0] for n in FP32_BACKWARD)
        lib = times[FP32_BACKWARD[0], FP32_MAIN_TRAIN][1]
        log(f"yardstick fp32 [{FP32_MAIN_TRAIN}] backward: dq + dk/dv {pair:.6g} ms, SDPA whole "
            f"backward {lib} ms ({'no slower' if lib and pair <= lib else 'SLOWER'} than SDPA)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return summary


def check_tiny_paths_agree(dev) -> dict:
    """On a tiny fp32 model, the kernel path and the plain path agree.
    Returns the generates' launches (``tiny_fp32``: the 12-token prefill's
    3xTF32 SwiGLU tile; ``tiny_int8``, ``tiny_int4_mixed``: the 40-token
    prefill's 3xTF32 int8-KV forward)."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, 240, (1, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    raw = torch.randint(0, 256, (1, 28, 28, 3), generator=gen, device=dev, dtype=torch.uint8)
    px = preprocess_image_device(raw, cfg.vision_config.image_size)
    res = {}
    for impl in ("cuda", "torch"):
        kernels.reset_counters()
        res[impl] = InferenceEngine(model, cfg, dev, impl=impl).generate(ids, px, max_new_tokens=8)
        if impl == "cuda":
            by_path = {"tiny_fp32": kernels.launch_counts()}
    dl = (res["cuda"].prefill_logits - res["torch"].prefill_logits).abs().max().item()
    log(f"tiny fp32: tokens cuda={res['cuda'].tokens.tolist()} torch={res['torch'].tokens.tolist()} "
        f"max_abs_dlogit={dl:.3g}; launches {by_path['tiny_fp32']}")
    missing = [k for k in TINY_KERNELS["fp32"] if by_path["tiny_fp32"][k] == 0]
    if dl > 1e-4 or not torch.equal(res["cuda"].tokens, res["torch"].tokens) or missing:
        raise RuntimeError(f"tiny model: kernel path and plain path disagree (or skipped "
                           f"{missing})")

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
        by_path[f"tiny_{mode}"] = launches
    return by_path


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


def tiny_draft(cfg, dev):
    """A seeded one-layer draft over the tiny vocabulary (head dim 16)."""
    tc = cfg.text_config
    dcfg = LLAMA32Config(vocab_size=tc.vocab_size, hidden_size=32, n_heads=2, n_layers=1,
                         hidden_dim=48, n_kv_groups=1, dtype=tc.dtype,
                         max_cache_length=tc.max_cache_length)
    draft = CausalLM(dcfg, dev, dcfg.torch_dtype)
    with torch.no_grad():
        draft.init_(torch.Generator(device=dev).manual_seed(7))
    return draft, dcfg


def check_tiny_spec(dev) -> None:
    """On the tiny fp32 model: prompt lookup (K=3) and a seeded one-layer
    draft (K=3) give the plain engine's tokens and ``num_generated``, on the
    kernel path (no plain version called) and on the plain path; on the
    first of a few text prompts whose continuation cycles, lookup accepts
    (fewer verify steps than tokens); the spec server (K=3, 2 slots, a third
    request submitted after one step) gives each request the solo engine's
    tokens. Any difference raises."""
    cfg = tiny_mllama_config(max_cache_length=96)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    draft, dcfg = tiny_draft(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, 240, (1, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    px = torch.randn(1, 3, 28, 28, generator=gen, device=dev)
    specs = {"lookup": dict(spec_lookup=3),
             "draft": dict(spec_draft=3, draft_params=draft, draft_config=dcfg)}
    for impl in ("cuda", "torch"):
        want = InferenceEngine(model, cfg, dev, impl=impl).generate(ids, px, max_new_tokens=24)
        for kind, spec in specs.items():
            kernels.reset_counters()
            got = InferenceEngine(model, cfg, dev, impl=impl, **spec).generate(
                ids, px, max_new_tokens=24)
            plain_calls = {k: n for k, n in kernels.plain_counts().items() if n}
            log(f"tiny fp32 spec {kind} impl={impl}: tokens {got.tokens.tolist()} "
                f"({int(got.steps)} verify steps), plain engine {want.tokens.tolist()}")
            if not (torch.equal(got.tokens, want.tokens)
                    and torch.equal(got.num_generated, want.num_generated)):
                raise RuntimeError(f"tiny spec {kind} (impl {impl}) differs from the plain engine")
            if impl == "cuda" and plain_calls:
                raise RuntimeError(f"tiny spec {kind}: the kernel path ran plain {plain_calls}")
    accepted = None
    for seed in range(6):
        text = torch.randint(0, 240, (1, 9), generator=torch.Generator(device=dev).manual_seed(
            10 + seed), device=dev)
        want = InferenceEngine(model, cfg, dev).generate(text, max_new_tokens=48)
        got = InferenceEngine(model, cfg, dev, spec_lookup=4).generate(text, max_new_tokens=48)
        if not torch.equal(got.tokens, want.tokens):
            raise RuntimeError(f"tiny spec lookup (prompt seed {10 + seed}) differs")
        if int(got.steps) < 47:
            accepted = (10 + seed, int(got.steps))
            break
    log(f"tiny fp32 spec lookup K=4, 48 tokens: (prompt seed, verify steps) {accepted}")
    if accepted is None:
        raise RuntimeError("tiny spec lookup accepted no draft on any of 6 prompts")
    reqs = []
    for s, max_new, image in ((9, 8, False), (12, 10, True), (14, 6, False)):
        toks = torch.randint(0, 240, (s,), generator=gen, device=dev)
        toks[s // 2:] = toks[:s - s // 2].clone()  # a repeated phrase, so drafts hit
        if image:
            toks[:4] = cfg.image_token_index
        reqs.append((toks, px if image else None, max_new))
    engine = InferenceEngine(model, cfg, dev)
    want = [engine.generate(r[None], p, max_new_tokens=n).tokens[0].tolist() for r, p, n in reqs]
    srv = ContinuousBatchingServer(model, cfg, dev, slots=2, prompt_buckets=None,
                                   steps_per_sync=2, spec_lookup=3)
    kernels.reset_counters()
    rids = [srv.submit(r, p, max_new_tokens=n) for r, p, n in reqs[:2]]
    srv.step()
    rids += [srv.submit(r, p, max_new_tokens=n) for r, p, n in reqs[2:]]
    results = srv.run()
    got = [results[r].tolist() for r in rids]
    plain_calls = {k: n for k, n in kernels.plain_counts().items() if n}
    log(f"tiny fp32 spec server K=3: tokens {got} solo engine {want}; {srv.stats()}")
    if got != want or plain_calls:
        raise RuntimeError(f"tiny spec server differs from the solo engine, or ran plain "
                           f"{plain_calls}")


def tiny_served(srv, submits) -> tuple:
    """Run ``submits`` (``(ids, pixel values, budget, submit kwargs)``)
    through ``srv`` on the kernel path from zeroed counters: ``(tokens of
    each, plain calls made)``."""
    kernels.reset_counters()
    rids = [srv.submit(ids, px, max_new_tokens=n, **kw) for ids, px, n, kw in submits]
    results = srv.run()
    return [results[r].tolist() for r in rids], {k: n for k, n in kernels.plain_counts().items()
                                                 if n}


def check_tiny_prefix(dev) -> None:
    """On the tiny fp32 model, on the kernel path: a text prefix matched on
    its own (float and int8 KV cache), an image prefix pinned by id, a prefix
    under ``prefill_chunk=4`` and one with ``spec_lookup=2``: two requests
    each (2 slots) give the tokens of a solo ``InferenceEngine`` run on the
    full prompt, both use the prefix, and no plain version runs."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(6)
    px = torch.randn(1, 3, 28, 28, generator=gen, device=dev)

    def ids(n):
        return torch.randint(0, 240, (n,), generator=gen, device=dev)

    image_head = ids(10)
    image_head[:4] = cfg.image_token_index
    phrase = ids(4)
    cases = {  # label: (prefix, its image, server options)
        "text, matched": (ids(8), None, {}),
        "text, matched, int8 KV": (ids(8), None, {"kv_dtype": "int8"}),
        "image, pinned": (image_head, px, {}),
        "text, prefill_chunk=4": (ids(10), None, {"prefill_chunk": 4}),
        "text, spec_lookup=2": (torch.cat([phrase, phrase]), None, {"spec_lookup": 2}),
    }
    for label, (prefix, image, kw) in cases.items():
        suffixes = [ids(5), ids(9)]
        if "spec_lookup" in kw:
            suffixes = [torch.cat([phrase, phrase[:1]]), torch.cat([phrase[:3], phrase, phrase])]
        prompts = [torch.cat([prefix, sfx]) for sfx in suffixes]
        engine = InferenceEngine(model, cfg, dev, kv_dtype=kw.get("kv_dtype"))
        want = [engine.generate(p[None], image, max_new_tokens=6).tokens[0].tolist()
                for p in prompts]
        srv = ContinuousBatchingServer(model, cfg, dev, slots=2, prompt_buckets=None,
                                       steps_per_sync=3, **kw)
        pid = srv.register_prefix(prefix, pixel_values=image)
        pin = {"prefix_id": pid} if image is not None else {}
        got, plain_calls = tiny_served(srv, [(p, None, 6, pin) for p in prompts])
        hits = srv.stats()["prefix_hits"]
        log(f"tiny fp32 prefix ({label}): tokens {got} solo engine {want}; prefix hits {hits}")
        if got != want or hits != 2 or plain_calls:
            raise RuntimeError(f"tiny prefix ({label}) differs from the solo engine, missed the "
                               f"prefix ({hits} hits), or ran plain {plain_calls}")


def tiny_adapter(tc, dev, seed: int) -> dict:
    """A seeded rank-4 adapter (default targets and the head) whose B is
    nonzero (0.05 * N(0, 1))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lora = init_lora_params(gen, tc, rank=4)
    for ad in [*lora["blocks"].values(), lora["lm_head"]]:
        ad["lora_b"].normal_(generator=gen).mul_(0.05)
    return lora


def tiny_bank_traffic(cfg, dev) -> tuple:
    """``(adapters, prompts, prefix, adapter ids)``: the identity and two
    seeded adapters with nonzero B; 4 prompts of adapters 0 / 1 / 2 / 1 and
    a fifth, of adapter 2, extending the prefix."""
    tc = cfg.text_config
    adapters = [zero_lora_params(tc, rank=4, device=dev), tiny_adapter(tc, dev, 101),
                tiny_adapter(tc, dev, 102)]
    gen = torch.Generator(device=dev).manual_seed(8)
    prompts = [torch.randint(0, 240, (s,), generator=gen, device=dev) for s in (9, 12, 10, 11)]
    prefix = torch.randint(0, 240, (8,), generator=gen, device=dev)
    prompts.append(torch.cat([prefix, prompts[0][:5]]))
    return adapters, prompts, prefix, [0, 1, 2, 1, 2]


def tiny_bank_served(model, cfg, dev, adapters, prompts, prefix, aids) -> tuple:
    """The bank server (3 slots) over ``model``: the prefix registered with
    adapter 2, the first 3 prompts submitted, a step, then the rest (the
    last matches the prefix on its own); ``(tokens of each, stats, plain
    calls)`` from counters zeroed after the registration."""
    srv = ContinuousBatchingServer(model, cfg, dev, slots=3, prompt_buckets=None,
                                   steps_per_sync=2, adapter_bank=stack_adapter_bank(adapters))
    srv.register_prefix(prefix, adapter_id=2)
    kernels.reset_counters()
    rids = [srv.submit(p, None, max_new_tokens=6, adapter_id=a)
            for p, a in zip(prompts[:3], aids[:3])]
    srv.step()
    rids += [srv.submit(p, None, max_new_tokens=6, adapter_id=a)
             for p, a in zip(prompts[3:], aids[3:])]
    results = srv.run()
    return ([results[r].tolist() for r in rids], srv.stats(),
            {k: n for k, n in kernels.plain_counts().items() if n})


def check_tiny_bank(dev) -> None:
    """On the tiny fp32 model, on the kernel path: a 3-adapter bank (the
    identity and two seeded adapters with nonzero B) serving 4 requests
    through 3 slots (adapters 0 / 1 / 2, then 1 after a step, into a freed
    slot) and one through a prefix of adapter 2 (matched on its own); each
    gives the tokens of a solo ``InferenceEngine`` on the model with its
    adapter merged (``merge_lora_into_params``), and no plain version runs."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    adapters, prompts, prefix, aids = tiny_bank_traffic(cfg, dev)
    engines = [InferenceEngine(merge_lora_into_params(model, a), cfg, dev) for a in adapters]
    want = [engines[a].generate(p[None], max_new_tokens=6).tokens[0].tolist()
            for p, a in zip(prompts, aids)]
    got, st, plain_calls = tiny_bank_served(model, cfg, dev, adapters, prompts, prefix, aids)
    log(f"tiny fp32 adapter bank (adapters {aids}, the last through a prefix of adapter 2): "
        f"tokens {got} merged solo engines {want}; {st}")
    if got != want or st["prefix_hits"] != 1 or plain_calls:
        raise RuntimeError(f"tiny adapter bank differs from the merged engines, missed the "
                           f"prefix, or ran plain {plain_calls}")


def http_call(port: int, method: str, path: str, body=None, timeout: float = 60.0) -> tuple:
    """``(status, JSON reply)`` of one HTTP request to the front end; a
    ``/generate_stream`` reply as ``(status, (streamed tokens, final event,
    events))``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if not path.endswith("_stream") or r.status != 200:
            return r.status, json.loads(r.read())
        streamed, final, events = [], None, 0
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                ev = json.loads(line[len("data: "):])
                events += 1
                if ev.get("finished"):
                    final = ev
                    break
                streamed.extend(ev["tokens"])
        return r.status, (streamed, final, events)
    finally:
        conn.close()


class LiveFrontend:
    """``ServingFrontend`` over ``srv`` and an HTTP server on a free loopback
    port, served from a thread; ``close()`` stops both."""

    def __init__(self, srv):
        self.frontend = ServingFrontend(srv)
        self.httpd = serve_forever(self.frontend, host="127.0.0.1", port=0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.frontend.shutdown()
        self.thread.join(timeout=30)


def http_traffic(port: int, bodies: list, timeout: float) -> list:
    """Send ``bodies`` at once, the last to ``/generate_stream`` and the
    others to ``/generate``, each from its own thread; the token list of
    each. A status other than 200, a stream whose tokens differ from its
    final event's, or a call still open after ``timeout`` raises."""
    out = [None] * len(bodies)

    def call(i):
        stream = i == len(bodies) - 1
        status, reply = http_call(port, "POST", "/generate_stream" if stream else "/generate",
                                  bodies[i], timeout=timeout)
        if stream and status == 200:
            streamed, final, events = reply
            if final is None or final["tokens"] != streamed or events < 2:
                raise RuntimeError(f"SSE stream: {events} events, streamed {streamed}, "
                                   f"final {final}")
            reply = final
        out[i] = (status, reply)

    errors = []

    def guarded(i):
        try:
            call(i)
        except Exception as e:  # re-raised below, from the main thread
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"HTTP traffic failed: {errors or 'a call did not return'}")
    bad = [(i, o) for i, o in enumerate(out) if o[0] != 200 or not o[1].get("finished")]
    if bad:
        raise RuntimeError(f"HTTP calls failed: {bad}")
    return [o[1]["tokens"] for o in out]


def tiny_http_traffic(cfg, dev) -> tuple:
    """``(prefix, requests)``: 3 text requests extending a seeded 8-id
    prefix and an image request, ``(ids, pixel values or None, budget)``."""
    gen = torch.Generator(device=dev).manual_seed(9)
    prefix = torch.randint(0, 240, (8,), generator=gen, device=dev)
    image = torch.randint(0, 240, (12,), generator=gen, device=dev)
    image[:4] = cfg.image_token_index
    px = torch.randn(3, 28, 28, generator=gen, device=dev)
    reqs = [(torch.cat([prefix, torch.randint(0, 240, (s,), generator=gen, device=dev)]), None, n)
            for s, n in ((5, 6), (7, 5), (4, 7))]
    reqs.insert(2, (image, px, 6))
    return prefix, reqs


def tiny_http_drive(port: int, prefix, reqs) -> tuple:
    """``POST /prefix``, then ``/generate`` alone, a concurrent pair and a
    ``/generate_stream``, then ``DELETE /prefix``: ``(tokens of each
    request, /stats, the DELETE's reply)``."""
    status, reply = http_call(port, "POST", "/prefix", {"input_ids": prefix.tolist()})
    if status != 200:
        raise RuntimeError(f"POST /prefix: {status} {reply}")
    bodies = [{"input_ids": ids.tolist(), "max_new_tokens": n,
               **({} if p is None else {"pixel_values": p.cpu().numpy().tolist()})}
              for ids, p, n in reqs]
    got = http_traffic(port, bodies[:1], timeout=60)
    got += http_traffic(port, bodies[1:3], timeout=60)
    got += http_traffic(port, bodies[3:], timeout=60)  # the stream
    stats = http_call(port, "GET", "/stats")[1]
    return got, stats, http_call(port, "DELETE", f"/prefix/{reply['prefix_id']}")


def check_tiny_http(dev) -> None:
    """On the tiny fp32 model, on the kernel path: the HTTP front end on
    127.0.0.1 (a free port), driven over ``http.client``: ``POST /prefix``
    (a text prefix), ``/generate``, a concurrent pair of ``/generate`` and a
    ``/generate_stream``, then ``DELETE /prefix``; each reply's tokens equal
    the direct server's on the same requests, and no plain version runs."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    prefix, reqs = tiny_http_traffic(cfg, dev)
    direct, srv = [ContinuousBatchingServer(model, cfg, dev, slots=2, prompt_buckets=None,
                                            steps_per_sync=3) for _ in range(2)]
    direct.register_prefix(prefix)
    want, _ = tiny_served(direct, [(ids, p, n, {}) for ids, p, n in reqs])
    live = LiveFrontend(srv)
    try:
        kernels.reset_counters()
        got, stats, dropped = tiny_http_drive(live.port, prefix, reqs)
        plain_calls = {k: n for k, n in kernels.plain_counts().items() if n}
    finally:
        live.close()
    log(f"tiny fp32 HTTP front end: tokens {got} direct server {want}; prefix hits "
        f"{stats.get('prefix_hits')}; DELETE /prefix {dropped}")
    if got != want or stats.get("prefix_hits") != 3 or dropped[0] != 200 or plain_calls:
        raise RuntimeError(f"tiny HTTP front end differs from the direct server, missed the "
                           f"prefix, or ran plain {plain_calls}")


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
                             ("full FT", full_run, TRAIN_KERNELS + FP32_SWIGLU)):
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


VIT_FP32_TOL = 1e-4  # the tower's output, 32 layers deep: of its largest magnitude


def run_vit_h_fp32(dev) -> dict:
    """The 11B's ViT-H/14 tower, whole (32 layers, 16 heads of 80, 1600
    patches), in fp32 on one 560x560 image: the kernel path within
    VIT_FP32_TOL of the plain path, the 3xTF32 forward launched once a layer
    and no plain version called on the kernel path. Returns its launches."""
    t = time.perf_counter()
    vc = llama32_11b_vision_config().vision_config
    tower = init_vision_params(vc, dev, torch.Generator(device=dev).manual_seed(11))
    gen = torch.Generator(device=dev).manual_seed(12)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    px = preprocess_image_device(raw, vc.image_size)
    with torch.no_grad():
        out, launches, plain_calls = counted(
            lambda: vision_encoder_forward(tower, vc, px, impl="cuda"))
        ref = vision_encoder_forward(tower, vc, px, impl="torch")
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    flash = {k: n for k, n in launches.items() if k.startswith("flash") and n}
    log(f"[vit_h_fp32] {vc.num_hidden_layers} layers, out {tuple(out.shape)} fp32: max|kernel - "
        f"plain| {err:.6g} of max|plain| {scale:.6g} ({err / scale:.3g}, bar {VIT_FP32_TOL}); "
        f"flash launches {flash}; {time.perf_counter() - t:.1f} s")
    faults = [] if flash == {"flash_attention": vc.num_hidden_layers} else [
        f"flash launches {flash}, not flash_attention once a layer"]
    faults += [f"ran plain {k} {n} times" for k, n in plain_calls.items() if n]
    if not bool(torch.isfinite(out).all()) or not err <= VIT_FP32_TOL * scale or faults:
        raise RuntimeError(f"[vit_h_fp32] kernel path vs plain: {err} > {VIT_FP32_TOL} * {scale}, "
                           f"or non-finite, or {faults}")
    del tower, out, ref
    return launches


def run_fp32_autograd(dev) -> dict:
    """``gqa_attention`` under autograd in fp32 at the decoder (32 / 8 heads,
    T=1632, causal) and ViT-H (16 heads of 80, T=1600) shapes: out, dq, dk
    and dv of the kernel path (the 3xTF32 LSE forward, dq and dk/dv) within
    FP32_TOL of ``impl="torch"``'s largest magnitude. Returns the
    kernel path's launches."""
    gen = torch.Generator(device=dev).manual_seed(13)
    total, faults = {}, []
    for label, (qs, kvs, causal) in {
            "decoder nq=32 nkv=8 T=1632 hd=128 causal": ((1, 32, 1632, 128), (1, 8, 1632, 128),
                                                        True),
            "ViT-H nq=nkv=16 T=1600 hd=80 non-causal": ((1, 16, 1600, 80), (1, 16, 1600, 80),
                                                       False)}.items():
        leaves = [torch.randn(*shape, generator=gen, device=dev) for shape in (qs, kvs, kvs)]
        g = torch.randn(*qs, generator=gen, device=dev)
        mask = AttnMask(torch.ones(1, qs[2], dtype=torch.int32, device=dev), 0)

        def run(impl):
            q, k, v = (t.detach().requires_grad_() for t in leaves)
            out = gqa_attention(q, k, v, mask, causal=causal, impl=impl)
            out.backward(g)
            return out.detach(), q.grad, k.grad, v.grad

        got, launches, plain_calls = counted(lambda: run("cuda"))
        want = run("torch")
        errs = [(a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want)]
        log(f"[fp32_autograd {label}] |kernel - plain| / max|plain|: out {errs[0]:.3g}, dq "
            f"{errs[1]:.3g}, dk {errs[2]:.3g}, dv {errs[3]:.3g} (bar {FP32_TOL})")
        if not all(e <= FP32_TOL for e in errs):
            faults.append(f"{label}: {errs}")
        faults += [f"{label}: skipped {k}" for k in FP32_FORWARD[2:] + FP32_BACKWARD
                   if launches[k] != 1]
        faults += [f"{label}: ran plain {k}" for k, n in plain_calls.items() if n]
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    if faults:
        raise RuntimeError(f"[fp32_autograd] {faults}")
    return total


def check_tiny_bf16_lora(dev) -> None:
    """On the tiny model in bf16, 3 LoRA steps on the kernel path give the
    plain path's losses within 1e-2 relative: bf16 rounds at other places on
    the two paths (each rounding 2^-9 relative; the tensor-core flash
    backward rounds p and ds as its plain version does, the other kernels
    not), which the loss, a mean over tokens, shows far less than one
    element does. The kernel path must launch the tensor-core flash backward
    pair, no fp32 flash kernel and no plain version."""
    cfg = tiny_mllama_config(dtype="bfloat16")
    batch = tiny_batch(cfg, dev, torch.Generator(device=dev).manual_seed(5))
    res = {}
    for impl in ("torch", "cuda"):
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        lora = init_lora_params(torch.Generator(device=dev).manual_seed(3), cfg, rank=4,
                                include_projector=True)
        init_state, step = make_lora_train_step(cfg, learning_rate=1e-4, impl=impl)
        state, losses = init_state(lora), []
        kernels.reset_counters()
        for _ in range(3):
            state, loss = step(model, state, batch)
            losses.append(loss.item())
        res[impl] = losses
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    dloss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(res["cuda"], res["torch"]))
    log(f"tiny bf16 LoRA, 3 steps: losses cuda={res['cuda']} torch={res['torch']} "
        f"max_rel_dloss={dloss:.3g}; launches {launches}")
    faults = [f"skipped {k}" for k in BWD_TC + ("flash_attention_tc_lse",) if launches[k] == 0]
    faults += [f"launched the fp32 {k}" for k in FP32_FORWARD + FP32_BACKWARD + FP32_SWIGLU
               if launches[k]]
    faults += [f"ran plain {k} {n} times" for k, n in plain_calls.items() if n]
    if not dloss <= 1e-2 or faults:
        raise RuntimeError(f"tiny bf16 LoRA: losses differ by {dloss} relative, or {faults}")


def checksums(tensors) -> torch.Tensor:
    """One int64 per tensor: the sum of its bytes read as int16, so any
    changed element shows."""
    return torch.stack([t.detach().contiguous().view(torch.int16).sum(dtype=torch.int64)
                        for t in tensors])


def train_batch(cfg, dev, b: int = 1, text_ids: int = 32):
    """B=b (1), S=1600+text_ids (1632): the 560x560 image's 1600 ``<image>``
    ids then the text ids, labels -100 on the image positions; a random
    uint8 image a row."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (b, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (b, text_ids), generator=gen, device=dev)
    image = torch.full((b, vc.num_patches), cfg.image_token_index, device=dev)
    ids = torch.cat([image, text], dim=1)
    labels = torch.cat([torch.full_like(image, cfg.ignore_index), text], dim=1)
    px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
    return {"input_ids": ids, "labels": labels, "pixel_values": px}


def run_steps(path: str, step, state, batch, opt_moments):
    """One warm-up step, then 3 timed steps with the counters set to 0 just
    before them; checks losses and moments, returns ``(state, launches, the
    warm-up step's loss)``."""
    tokens = batch["input_ids"].numel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    first = loss.item()
    log(f"[{path}] warm-up step {time.perf_counter() - t:.4f} s loss {first:.6g}")
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
    return state, launches, first


def run_lora_11b(dev, keep: dict) -> dict:
    """LoRA fine-tuning at Llama-3.2-11B-Vision, bf16 base (tied head), rank
    16, alpha 16, the default targets and a head adapter, Adam lr 1e-4.
    ``keep`` takes the first step's loss and its distance from the plain
    path's (``tp_lora_11b``'s reference)."""
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
    state, launches, first = run_steps("lora_11b", lambda st, b: step(model, st, b), state,
                                       batch, lambda st: st.opt_state.mu.values())
    keep["lora_11b"] = {"loss": first, "dl_plain": abs(first - plain)}
    log(f"[lora_11b] first loss {first:.8g}, plain path {plain:.8g}: |difference| "
        f"{abs(first - plain):.6g}")
    if not torch.equal(checksums(base), before) or any(p.requires_grad for p in base):
        raise RuntimeError("[lora_11b] the base weights changed or require gradients")
    del state
    free_device_memory()
    keep["sp_lora_11b"] = sp_references(dev, cfg, model)
    return launches


SP_SEQ = 2 * RING_T  # sp_lora_11b: B=1, S=4096 over sp=2
SP_LOSS_CHUNK = 1024


def sp_references(dev, cfg, model) -> dict:
    """``sp_lora_11b``'s one-device references on its S=4096 batch: the
    first step's loss on the kernel path (the training kernels: the fresh
    adapters require gradients) and on ``impl="torch"``."""
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), cfg, rank=16, alpha=16.0)
    batch = train_batch(cfg, dev, text_ids=SP_SEQ - cfg.vision_config.num_patches)
    kw = dict(input_ids=batch["input_ids"], pixel_values=batch["pixel_values"],
              labels=batch["labels"], lora=lora, remat=True, loss_chunk=SP_LOSS_CHUNK)
    for t in lora_leaves(lora).values():
        t.requires_grad_(True)
    with torch.enable_grad():
        kernel = vlm_forward(model, cfg, **kw).loss.item()
    with torch.inference_mode():
        plain = vlm_forward(model, cfg, impl="torch", **kw).loss.item()
    log(f"[sp_lora_11b] one-device references at S={SP_SEQ}: kernel path {kernel:.8g}, "
        f"impl='torch' {plain:.8g} (|difference| {abs(kernel - plain):.6g})")
    free_device_memory()
    return {"loss": kernel, "dl_plain": abs(kernel - plain)}


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
    state, launches, _ = run_steps("full_ft_3b", step, state, batch,
                                   lambda st: st.opt_state.mu.values())
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


def run_11b(dev, cfg, model, path: str, kv_dtype=None, keep: Optional[dict] = None) -> dict:
    """Generate 64 tokens on the 11B model, check the result and that the
    path's kernels, and no plain version, ran; return the launch counts.
    ``keep`` takes the prefill logits, the tokens and the kernel-vs-plain
    distance under ``path`` (the tensor-parallel phases' reference)."""
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
    faults = generate_faults(path, path, launches, plain_calls, tc.n_layers, decode_steps=63)
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
    if keep is not None:
        keep[path] = {"prefill_logits": res.prefill_logits.float().cpu(),
                      "tokens": res.tokens.cpu(), "dl_plain": dl}
    return launches


# The load_11b phase: a checkpoint at Llama-3.2-11B-Vision widths, its depth
# cut to fit a smoke run (a full-depth one is ~21 GB on disk), saved and loaded
# three ways, each load served 32 tokens after a phone-photo-sized image.
LOAD_DEPTH = {"decoder": 4, "vit": 2}
LOAD_PATHS = {
    "load_11b_bf16": ("bf16", {}),
    "load_11b_int8": ("int8", dict(streaming=True, quantize_int8=True)),
    "load_11b_int4_mixed": ("int4_mixed", dict(streaming=True, quantize_int4=True,
                                                int4_recipe=INT4_MIXED_RECIPE)),
}
LOAD_SHARD_BYTES = 2**30  # several shards and an index
PHOTO = (3024, 4032)  # a 12 MP phone photo, height x width
RESIZE_TOL = 1e-3  # card vs CPU, on the 0-255 scale (fp32 sums in other orders)


def load_11b_config(depth: dict = LOAD_DEPTH) -> MLLAMAConfig:
    """Llama-3.2-11B-Vision's widths at ``depth``'s decoder and ViT layers."""
    full = llama32_11b_vision_config()
    return MLLAMAConfig(
        vision_config=dataclasses.replace(full.vision_config, num_hidden_layers=depth["vit"]),
        text_config=dataclasses.replace(full.text_config, n_layers=depth["decoder"]),
        projection_dim=full.projection_dim, hidden_size=full.hidden_size,
    )


def shape_fields(cfg) -> tuple:
    """What ``config.json`` must carry over: the fields that shape the weights
    and the math (``build_config_from_hf`` reads ``max_position_embeddings``
    for both the context length and the position limit, as the JAX package
    does, so those two are left out)."""
    tc, vc = cfg.text_config, cfg.vision_config
    return (tc.vocab_size, tc.hidden_size, tc.n_heads, tc.n_layers, tc.hidden_dim,
            tc.n_kv_groups, tc.rope_base, tc.rms_norm_eps, tc.dtype, vc.hidden_size,
            vc.intermediate_size, vc.num_hidden_layers, vc.num_attention_heads,
            vc.num_channels, vc.image_size, vc.patch_size, vc.layer_norm_eps,
            cfg.image_token_index, cfg.projection_dim)


def oracle_quantized(model, kind: str):
    """The serving form quantize-on-load must produce, from the float model:
    every linear through ``quantize_weight`` / ``quantize_weight_int4`` with
    ``compiled=True`` at the recipe's bits (``quantize_llama_params``
    quantizes the head eagerly, so the head is redone here)."""
    if kind == "int8":
        q = quantize_llama_params(model, quantize_lm_head=False, bits=8)
        head = quantize_weight(model.language_model.lm_head.weight, compiled=True)
    else:
        q = quantize_llama_params(model, quantize_lm_head=False, bits=4, group_size=128,
                                  recipe=INT4_MIXED_RECIPE)
        head = quantize_weight_int4(model.language_model.lm_head.weight, 128, compiled=True)
    q.language_model.lm_head = QuantLinear(head)
    return q


def model_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def run_load_11b(dev) -> dict:
    """Save a seeded untied bf16 model at 11B widths in 1 GiB shards, rebuild
    its config from ``config.json``, and load it three ways (host bf16,
    streaming int8 and int4-mixed): each load through the native reader,
    with an empty report, bit-equal to the saved model or to its oracle
    quantization, then a greedy 32-token generate after the resized photo
    and 32 text ids with the path's exact launches and the reference
    model's tokens. Checks the card's resize against the CPU's."""
    t_phase = time.perf_counter()
    cfg = load_11b_config()
    tc, vc = cfg.text_config, cfg.vision_config
    full = llama32_11b_vision_config()
    log(f"[load_11b] Llama-3.2-11B-Vision widths (hidden {tc.hidden_size}, FFN {tc.hidden_dim}, "
        f"{tc.n_heads} / {tc.n_kv_groups} heads, vocab {tc.vocab_size}, ViT-H/14 at "
        f"{vc.image_size} px), depth cut to {tc.n_layers} of {full.text_config.n_layers} decoder "
        f"layers and {vc.num_hidden_layers} of {full.vision_config.num_hidden_layers} ViT layers")
    if not native_available():
        raise RuntimeError("[load_11b] the native safetensors reader did not build")
    saved = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=False)
    ckpt_bytes = model_bytes(saved)
    n_params = sum(p.numel() for p in saved.parameters())
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="load_11b_", dir=root)
    by_path = {}
    try:
        t = time.perf_counter()
        save_checkpoint_params(tmp, saved, cfg, max_shard_bytes=LOAD_SHARD_BYTES)
        save_s = time.perf_counter() - t
        shards = sorted(f for f in os.listdir(tmp) if f.endswith(".safetensors"))
        log(f"[load_11b] saved {n_params} parameters, {ckpt_bytes / 1e9:.3f} GB bf16, in "
            f"{len(shards)} shards: {save_s:.3f} s, {ckpt_bytes / save_s / 1e9:.3f} GB/s")
        if len(shards) < 2 or not os.path.exists(os.path.join(tmp, "model.safetensors.index.json")):
            raise RuntimeError(f"[load_11b] expected an index and several shards, got {shards}")
        with open(os.path.join(tmp, "config.json"), encoding="utf-8") as f:
            loaded_cfg = build_config_from_hf(json.load(f))
        if shape_fields(loaded_cfg) != shape_fields(cfg):
            raise RuntimeError(f"[load_11b] config.json rebuilds other shapes: "
                               f"{shape_fields(loaded_cfg)} against {shape_fields(cfg)}")

        gen = torch.Generator(device=dev).manual_seed(1)
        raw = torch.randint(0, 256, (1, *PHOTO, 3), generator=gen, device=dev, dtype=torch.uint8)
        text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
        ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev),
                         text], dim=1)
        check_resize(raw, vc.image_size)
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)

        for path, (kind, kw) in LOAD_PATHS.items():
            free_device_memory()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            model, report = load_checkpoint_params(tmp, loaded_cfg, dev, verbose=False,
                                                   return_report=True, **kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            peak = (torch.cuda.max_memory_allocated() - before) / 2**30
            log(f"[{path}] load {load_s:.3f} s, {ckpt_bytes / load_s / 1e9:.3f} GB/s of checkpoint; "
                f"peak {peak:.3f} GiB above the saved model while loading, loaded model "
                f"{model_bytes(model) / 2**30:.3f} GiB")
            if any(dataclasses.asdict(report).values()):
                raise RuntimeError(f"[{path}] load report not empty: {report}")
            want = saved if kind == "bf16" else oracle_quantized(saved, kind)
            got_sd, want_sd = model.state_dict(), want.state_dict()
            unequal = [k for k in want_sd if k not in got_sd or got_sd[k].dtype != want_sd[k].dtype
                       or not torch.equal(got_sd[k], want_sd[k])]
            n_quant = sum(isinstance(m, QuantLinear) for m in model.modules())
            log(f"[{path}] {len(got_sd)} tensors ({n_quant} QuantLinear) bit-equal to the "
                f"{'saved model' if kind == 'bf16' else 'oracle quantization'}: {not unequal}")
            if unequal or list(got_sd) != list(want_sd):
                raise RuntimeError(f"[{path}] tensors differ from the reference: {unequal[:8]}")
            by_path[path] = load_generate(dev, path, kind, model, want, loaded_cfg, ids, px)
            del model, want, got_sd, want_sd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del saved
        free_device_memory()
    log(f"[load_11b] phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


def check_resize(raw, size: int) -> None:
    """The photo's resize on the card against the same function on the CPU,
    on the 0-255 scale, and the card's preprocess time (CUDA events)."""
    on_card = cubic_resize(raw.float(), size, size)
    on_cpu = cubic_resize(raw.cpu().float(), size, size)
    err = (on_card.cpu() - on_cpu).abs().max().item()
    ms = time_ms(lambda: preprocess_image_device(raw, size, dtype=torch.bfloat16))
    log(f"[load_11b] preprocess {PHOTO[0]}x{PHOTO[1]} -> {size}x{size} on the card "
        f"{ms:.4f} ms; resize card vs CPU max_abs_err {err:.6g} (tolerance {RESIZE_TOL})")
    if not err <= RESIZE_TOL:
        raise RuntimeError(f"[load_11b] the card's resize is {err} from the CPU's")


def load_generate(dev, path: str, kind: str, model, reference, cfg, ids, px) -> dict:
    """32 greedy tokens on the loaded model (launches counted) and on the
    reference; the tokens must be equal."""
    kv_dtype = None if kind == "bf16" else "int8"
    results = []
    for m in (model, reference):
        engine = InferenceEngine(m, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype)
        kernels.reset_counters()
        res = engine.generate(ids, px, max_new_tokens=32, temperature=0.0)
        torch.cuda.synchronize()
        results.append((res, kernels.launch_counts(), kernels.plain_counts()))
    (res, launches, plain_calls), (ref, _, _) = results
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    log(f"[{path}] tokens {res.tokens[0].tolist()}")
    faults = generate_faults(path, kind, launches, plain_calls, cfg.text_config.n_layers,
                             decode_steps=31)
    if int(res.num_generated[0]) != 32 or not torch.equal(res.tokens, ref.tokens):
        faults.append(f"tokens differ from the reference model's: {ref.tokens[0].tolist()}")
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    return launches


def llama32_1b_draft(dev):
    """A random-init bf16 draft at Llama-3.2-1B's published widths
    (``meta-llama/Llama-3.2-1B`` ``config.json``: hidden 2048, 16 layers, 32
    heads, 8 KV heads, head dim 64, FFN 8192, vocab 128256, tied
    embeddings), from a seed; RoPE as the 11B config's."""
    dcfg = LLAMA32Config(vocab_size=128256, hidden_size=2048, n_heads=32, n_layers=16,
                         hidden_dim=8192, n_kv_groups=8, dtype="bfloat16")
    draft = CausalLM(dcfg, dev, dcfg.torch_dtype)
    with torch.no_grad():
        draft.init_(torch.Generator(device=dev).manual_seed(1))
    return draft, dcfg


def spec_prompt(cfg, dev, image: bool = True):
    """``(ids [1, S], raw image or None)``: the smoke's 560x560 image (1600
    ``<image>`` ids, S = 1632) or none (S = 32), then 32 text ids in which a
    seeded 16-id phrase appears twice, so the bigram lookup has matches."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    phrase = torch.randint(0, tc.vocab_size, (1, 16), generator=gen, device=dev)
    text = torch.cat([phrase, phrase], dim=1)
    if not image:
        return text, None
    return torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev),
                      text], dim=1), raw


def spec_launches(tc, k: int, steps: int, prompt_len: int, draft_cfg=None):
    """``(want, per verify step)``: the exact launches of a bf16 speculative
    generate. A verify step runs the target's K+1 rows once (5 gemvs a layer
    and the head, one SwiGLU rows call and one flash decode a layer) and,
    with a draft, the draft's K+1 R=1 steps (the same a layer, a head on all
    but the last). The prefills add the target's last-position head and a
    SwiGLU tile a layer (the draft's too, with no head); a prompt of at most
    32 rows also runs their 5 linears a layer on the gemv."""
    per_step = {"gemv_tc": 5 * tc.n_layers + 1, "swiglu_rows_tc": tc.n_layers,
                "flash_decode": tc.n_layers}
    prefill = {"gemv_tc": 1 + 5 * tc.n_layers * (prompt_len <= 32), "swiglu_tc": tc.n_layers}
    if draft_cfg is not None:
        dl = draft_cfg.n_layers
        per_step["gemv_tc"] += 5 * dl * (k + 1) + k
        per_step["swiglu_rows_tc"] += dl * (k + 1)
        per_step["flash_decode"] += dl * (k + 1)
        prefill["gemv_tc"] += 5 * dl * (prompt_len <= 32)
        prefill["swiglu_tc"] += dl
    want = {name: n * steps + prefill.get(name, 0) for name, n in per_step.items()}
    return {**want, "swiglu_tc": prefill["swiglu_tc"], "swiglu_rows": 0, "swiglu": 0}, per_step


def run_11b_spec(dev, cfg, model, path: str, spec: dict, image: bool = True,
                 want_tokens=None):
    """Generate 64 tokens greedily on the 11B model with speculative decoding
    (``spec``: the engine's spec arguments) from ``spec_prompt``; check 64
    tokens in the vocabulary, 1-63 verify steps, the exact launches of
    ``spec_launches`` and no plain call; print TTFT, tokens/s, the verify
    steps, tokens a step, ms a verify step and how many leading tokens equal
    the plain engine's on the same prompt (``want_tokens``, or a run of it,
    timed the same way and printed beside). Returns ``(launches, the plain
    engine's tokens)``."""
    tc, vc = cfg.text_config, cfg.vision_config
    k = spec.get("spec_lookup") or spec["spec_draft"]
    ids, raw = spec_prompt(cfg, dev, image)

    def generate(engine, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        px = None if raw is None else preprocess_image_device(raw, vc.image_size,
                                                              dtype=tc.torch_dtype)
        res = engine.generate(ids, px, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    if want_tokens is None:
        plain_engine = InferenceEngine(model, cfg, dev, max_cache_length=2048)
        _, ttft = generate(plain_engine, 1)
        res, t64 = generate(plain_engine, 64)
        want_tokens = res.tokens[0].tolist()
        log(f"[{path}] the plain engine on this prompt: TTFT {ttft * 1e3:.2f} ms; decode "
            f"{63 / (t64 - ttft):.2f} tok/s, {1e3 * (t64 - ttft) / 63:.4f} ms a step")
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, **spec)
    generate(engine, 2)  # warm-up: library handles, allocator
    _, ttft = generate(engine, 1)
    kernels.reset_counters()
    res, t64 = generate(engine, 64)
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    steps, toks = int(res.steps), res.tokens[0].tolist()
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    log(f"[{path}] tokens {toks}")
    if tuple(res.tokens.shape) != (1, 64) or int(res.num_generated[0]) != 64:
        raise RuntimeError(f"[{path}] expected 64 tokens, got {tuple(res.tokens.shape)} / "
                           f"{res.num_generated}")
    if not bool(((res.tokens >= 0) & (res.tokens < tc.vocab_size)).all()):
        raise RuntimeError(f"[{path}] generated ids outside the vocabulary")
    if not 1 <= steps <= 63:
        raise RuntimeError(f"[{path}] {steps} verify steps for 63 tokens")
    agree = next((i for i, (a, b) in enumerate(zip(toks, want_tokens)) if a != b), len(toks))
    decode_s = t64 - ttft
    log(f"[{path}] K={k} generate 64: {t64:.4f} s; TTFT (preprocess+prefill+first token) "
        f"{ttft * 1e3:.2f} ms; decode {63 / decode_s:.2f} tok/s (63 tokens after the first); "
        f"{steps} verify steps, {63 / steps:.4f} tokens a step, {1e3 * decode_s / steps:.4f} ms "
        f"a verify step; leading tokens equal to the plain engine's {agree}/64; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    want, per_step = spec_launches(tc, k, steps, ids.shape[1], spec.get("draft_config"))
    log(f"[{path}] exact launches: {per_step} a verify step x {steps} + prefill = {want}")
    faults = path_faults(path, launches, plain_calls)
    faults += [f"launched {name} {launches[name]} times, not {n}" for name, n in want.items()
               if launches[name] != n]
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    return launches, want_tokens


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


def prefix_requests(cfg, dev, n: int = 10):
    """``((prefix ids [P], pixel values [1, 3, H, W]), requests)``: the prefix
    is a seeded 560x560 image (1600 ``<image>`` ids) and 16 seeded system ids
    (P = 1616); request ``i`` is the prefix's ids and 32 seeded question ids
    (S = 1648), no pixel values, a budget of 64 tokens when ``i`` is even
    and 32 when it is odd."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(200)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    system = torch.randint(0, tc.vocab_size, (16,), generator=gen, device=dev)
    prefix = torch.cat([torch.full((vc.num_patches,), cfg.image_token_index, device=dev), system])
    px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
    reqs = []
    for i in range(n):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        question = torch.randint(0, tc.vocab_size, (32,), generator=gen, device=dev)
        reqs.append((torch.cat([prefix, question]), None, 64 if i % 2 == 0 else 32))
    return (prefix, px), reqs


def server_bank(cfg, dev) -> dict:
    """The 11B bank: the identity and two seeded rank-16 bf16 adapters (the
    default targets and the head) with B = 0.02 * N(0, 1)."""
    tc = cfg.text_config
    adapters = [zero_lora_params(tc, rank=16, dtype=torch.bfloat16, device=dev)]
    for seed in (1, 2):
        gen = torch.Generator(device=dev).manual_seed(seed)
        lora = init_lora_params(gen, tc, rank=16, dtype=torch.bfloat16)
        for ad in [*lora["blocks"].values(), lora["lm_head"]]:
            ad["lora_b"].copy_(torch.randn(ad["lora_b"].shape, generator=gen, device=dev) * 0.02)
        adapters.append(lora)
    bank = stack_adapter_bank(adapters)
    del adapters
    return bank


def profile_decode_chunk(path: str, srv, decode, reqs, adapter_ids) -> dict:
    """Information: one 8-step decode chunk (``decode``, the server's own)
    with 8 slots busy under ``torch.profiler``: kernel ms and kernel
    launches a step (every CUDA kernel, cuBLAS and elementwise ones too)."""
    for (ids, px, _), aid in zip(reqs[:8], adapter_ids[:8]):
        srv.submit(ids, px, max_new_tokens=2048 - ids.shape[0] - 8, adapter_id=aid)
    srv.step()  # admits all 8, then one decode chunk
    if srv.stats()["slots_busy"] != 8:
        raise RuntimeError(f"[{path}] expected 8 busy slots, got {srv.stats()}")
    decode(8)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(8)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {"kernel_ms": sum(e.self_device_time_total for e in rows) / 1e3 / 8,
           "launches": sum(e.count for e in rows) / 8}
    log(f"[{path}] profiled 8-step decode chunk, 8 slots busy: kernel time "
        f"{out['kernel_ms']:.4f} ms a step, {out['launches']:.1f} kernel launches a step; "
        f"the most device time, ms a step (launches a step):")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3 / 8:8.4f} ({e.count / 8:6.1f})  {e.key[:100]}")
    for r in list(srv._results):
        srv.cancel(r)
    return out


def profile_admission(path: str, srv, ids, px, **kw) -> None:
    """Information: one admission alone (a request with a budget of 1, which
    finishes at its first token) under ``torch.profiler``: kernel ms and
    kernel launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rid = srv.submit(ids, px, max_new_tokens=1, **kw)
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    srv.release(rid)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    log(f"[{path}] profiled admission: kernel time "
        f"{sum(e.self_device_time_total for e in rows) / 1e3:.4f} ms, "
        f"{sum(e.count for e in rows)} kernel launches, {wall * 1e3:.2f} ms wall (profiled)")


def run_server(dev, cfg, model, path: str, kv_dtype=None, spec_lookup: int = 0,
               tokens: Optional[dict] = None, metrics: Optional[dict] = None,
               prefix=None, reqs=None, adapter_bank=None, profile_step=False) -> dict:
    """The continuous-batching server at 8 slots, S_max 2048: 10 requests
    (``server_requests`` unless ``reqs``), 6 submitted, one step, then 4 more,
    so admissions land mid-decode and in freed slots. Checks budgets, ids and
    the path's kernels (and no plain version); prints decode tokens/s, ms per
    decode step with 8 slots busy, ms per admission, peak GiB, launches and
    how many requests equal a solo engine run. With ``spec_lookup`` a decode
    step is a verify step of 8 x (K+1) rows; it prints the tokens a step, and
    compares each request with the plain server's tokens
    (``tokens["server_bf16"]``) instead. ``prefix`` (ids, pixel values):
    registered (timed, its K/V's GiB printed) and pinned by every request.
    ``adapter_bank``: request ``i`` runs adapter ``i % 3``; the requests of
    the identity adapter are compared with the plain server's.
    ``profile_step``: one profiled decode chunk afterwards. ``tokens``
    collects each path's tokens, ``metrics`` its numbers."""
    tc = cfg.text_config
    free_device_memory()  # earlier servers' caches, so that the peak is this server's
    reqs = reqs or server_requests(cfg, dev)
    aids = [i % 3 if adapter_bank is not None else 0 for i in range(len(reqs))]
    srv = ContinuousBatchingServer(model, cfg, dev, slots=8, max_cache_length=2048,
                                   kv_dtype=kv_dtype, spec_lookup=spec_lookup,
                                   adapter_bank=adapter_bank)
    pin = {}
    if prefix is not None:  # warm-up registration and prefixed admission
        pin = {"prefix_id": srv.register_prefix(prefix[0], pixel_values=prefix[1])}
    warm = srv.submit(reqs[0][0], reqs[0][1], max_new_tokens=2, **pin)  # handles, allocator
    srv.run()
    srv.release(warm)
    if prefix is not None:
        srv.drop_prefix(pin["prefix_id"])
    chunks, admissions = [], []  # (steps, busy slots, seconds) per decode chunk; admission s
    decode, admit = srv._decode, srv._admit

    def timed_decode(n):
        busy = sum(r is not None for r in srv._by_slot)
        t = time.perf_counter()
        toks = decode(n)  # ends in the chunk's one device-to-host copy
        chunks.append((n, busy, time.perf_counter() - t))
        return toks

    def timed_admit(req, slot):
        t = time.perf_counter()
        admit(req, slot)  # ends in the first token's device-to-host copy
        admissions.append(time.perf_counter() - t)

    srv._decode, srv._admit = timed_decode, timed_admit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    if prefix is not None:
        t = time.perf_counter()
        pin = {"prefix_id": srv.register_prefix(prefix[0], pixel_values=prefix[1])}
        torch.cuda.synchronize()
        reg_ms = 1e3 * (time.perf_counter() - t)
        cache = srv._prefixes[pin["prefix_id"]].cache
        gib = sum(t.numel() * t.element_size() for t in (cache.k, cache.v)) / 2**30
        log(f"[{path}] register_prefix (P = {cache.k.shape[3]}: the image and 16 system ids) "
            f"{reg_ms:.4f} ms; its K/V hold {gib:.4f} GiB")
    t0 = time.perf_counter()
    rids = [srv.submit(ids, px, max_new_tokens=n, adapter_id=a, **pin)
            for (ids, px, n), a in zip(reqs[:6], aids[:6])]
    srv.step()
    rids += [srv.submit(ids, px, max_new_tokens=n, adapter_id=a, **pin)
             for (ids, px, n), a in zip(reqs[6:], aids[6:])]
    results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    decode_s = sum(c[2] for c in chunks)
    decode_tokens = sum(len(results[r]) for r in rids) - len(rids)
    full = [1e3 * sec / n for n, busy, sec in chunks if busy == 8]
    steps = sum(c[0] for c in chunks)
    numbers = {"tok_s": decode_tokens / decode_s,
               "step_ms": statistics.median(full) if full else float("nan"),
               "admit_ms": 1e3 * statistics.median(admissions),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if spec_lookup:
        log(f"[{path}] K={spec_lookup}: {srv.stats()['spec_tokens_per_step']} tokens a slot a "
            f"verify step (kept tokens only); the steps below are verify steps")
    log(f"[{path}] 10 requests in {wall:.4f} s; {len(chunks)} decode chunks, {steps} steps, "
        f"{decode_s:.4f} s: {decode_tokens} decode tokens, {numbers['tok_s']:.2f} tok/s "
        f"aggregate; ms per decode step with 8 slots busy: median {numbers['step_ms']:.4f} over "
        f"{len(full)} chunks; ms per admission: median {numbers['admit_ms']:.4f} over "
        f"{len(admissions)}; peak allocated {numbers['peak_gib']:.3f} GiB")
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    for i, r in enumerate(rids):
        toks = results[r]
        if len(toks) != reqs[i][2] or not ((toks >= 0) & (toks < tc.vocab_size)).all():
            raise RuntimeError(f"[{path}] request {i}: {len(toks)} tokens for a budget of "
                               f"{reqs[i][2]}, or ids outside the vocabulary")
    faults = path_faults(path, launches, plain_calls)
    if path in ("server_bf16", "server_bf16_prefix"):
        # every decode step's 201 linears and each admission's head; a
        # prefix's prefill (one more TMA SwiGLU tile a layer) has no head
        want = (5 * tc.n_layers + 1) * steps + len(rids)
        log(f"[{path}] tensor-core gemv launches {launches['gemv_tc']} = "
            f"{5 * tc.n_layers + 1} x {steps} steps + {len(rids)} prefill heads: "
            f"{launches['gemv_tc'] == want}")
        if launches["gemv_tc"] != want:
            faults.append(f"launched the tensor-core gemv {launches['gemv_tc']} times, not {want}")
        faults += swiglu_faults(launches, tc.n_layers, decode_steps=steps,
                                prefills=len(rids) + (prefix is not None))
        if prefix is not None and srv.stats()["prefix_hits"] != len(rids):
            faults.append(f"the prefix served {srv.stats()['prefix_hits']} requests")
    if path == "server_bf16_lora":  # 7 linears a layer and the head, the FFN unfused
        want = {"gemv_tc": (7 * tc.n_layers + 1) * steps + len(rids),
                "flash_decode": tc.n_layers * steps,
                "swiglu_tc": 0, "swiglu_rows_tc": 0, "swiglu_rows": 0, "swiglu": 0}
        log(f"[{path}] exact launches over {steps} decode steps and {len(rids)} prefills: {want}")
        faults += [f"launched {name} {launches[name]} times, not {n}"
                   for name, n in want.items() if launches[name] != n]
    if path == "server_bf16_spec":  # 8 x (K+1) = 32 rows a verify: the gemv, the TMA tile
        want = {"gemv_tc": (5 * tc.n_layers + 1) * steps + len(rids),
                "flash_decode": tc.n_layers * steps,
                "swiglu_tc": tc.n_layers * (steps + len(rids)), "swiglu_rows_tc": 0,
                "swiglu_rows": 0, "swiglu": 0}
        log(f"[{path}] exact launches over {steps} verify steps and {len(rids)} prefills: "
            f"{want}")
        faults += [f"launched {name} {launches[name]} times, not {n}"
                   for name, n in want.items() if launches[name] != n]
    if path == "server_int4_w4a8":  # w_gate, w_up and the int4 head each step, each prefill's head
        want = (2 * tc.n_layers + 1) * steps + len(rids)
        got = launches["gemv_int4_w4a8"]
        log(f"[{path}] W4A8 gemv launches {got} = {2 * tc.n_layers + 1} x {steps} "
            f"steps + {len(rids)} prefill heads: {got == want}")
        if got != want:
            faults.append(f"launched the W4A8 gemv {got} times, not {want}")
        faults += int8_gemv_faults(path, launches, tc.n_layers, decode_steps=steps,
                                   int8_head=False, prefills=len(rids))
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    if launches["gemv_int4"]:
        raise RuntimeError(f"[{path}] the W4A16 gemv launched {launches['gemv_int4']} times")
    got = [results[r].tolist() for r in rids]
    if tokens is not None:
        tokens[path] = got
    if path in ("server_bf16", "server_bf16_prefix"):
        profile_admission(path, srv, reqs[0][0], reqs[0][1], **pin)
    if profile_step:
        numbers.update(profile_decode_chunk(path, srv, decode, reqs, aids))
    if metrics is not None:
        metrics[path] = numbers
    if spec_lookup or adapter_bank is not None:  # information: bits that depend on the rows
        plain = tokens["server_bf16"]
        idx = [i for i in range(len(rids)) if aids[i] == 0]
        same = sum(got[i] == plain[i] for i in idx)
        lead = [next((j for j, (x, y) in enumerate(zip(got[i], plain[i])) if x != y),
                     len(got[i])) for i in idx]
        log(f"[{path}] requests {'of the identity adapter ' if adapter_bank is not None else ''}"
            f"whose tokens equal the plain server's: {same}/{len(idx)}; leading tokens equal "
            f"{lead}")
        return launches
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype,
                             prompt_buckets="auto")
    image = None if prefix is None else prefix[1]
    same = sum(engine.generate(ids[None], image if px is None else px, max_new_tokens=n)
               .tokens[0].tolist() == got[i] for i, (ids, px, n) in enumerate(reqs))
    log(f"[{path}] requests whose tokens equal a solo InferenceEngine run"
        f"{' on the full prompt' if prefix is not None else ''}: {same}/{len(rids)}")
    return launches


def run_http(dev, cfg, model, tokens: dict, metrics: dict) -> dict:
    """``http_bf16``: the ``server_bf16_prefix`` traffic through the HTTP
    front end on loopback: the prefix by ``POST /prefix`` with its pixel
    values (once), then the 10 requests at once, 9 to ``/generate`` and 1 to
    ``/generate_stream``, each pinning the prefix. Checks statuses, budgets
    and the path's exact launches; prints the wall time, decode tokens/s and
    how many requests equal the direct ``server_bf16_prefix`` run's."""
    tc = cfg.text_config
    free_device_memory()
    (prefix, px), reqs = prefix_requests(cfg, dev)
    srv = ContinuousBatchingServer(model, cfg, dev, slots=8, max_cache_length=2048)
    chunks = []
    decode = srv._decode

    def counted_decode(n):
        t = time.perf_counter()
        out = decode(n)
        chunks.append((n, time.perf_counter() - t))
        return out

    srv._decode = counted_decode
    live = LiveFrontend(srv)
    try:
        torch.cuda.synchronize()
        kernels.reset_counters()
        t0 = time.perf_counter()
        status, reply = http_call(live.port, "POST", "/prefix", {
            "input_ids": prefix.tolist(), "pixel_values": px[0].float().cpu().numpy().tolist()},
            timeout=300)
        if status != 200:
            raise RuntimeError(f"[http_bf16] POST /prefix: {status} {reply}")
        t_prefix = time.perf_counter() - t0
        bodies = [{"input_ids": ids.tolist(), "max_new_tokens": n,
                   "prefix_id": reply["prefix_id"]} for ids, _, n in reqs]
        got = http_traffic(live.port, bodies, timeout=600)
        wall = time.perf_counter() - t0
        launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
        stats = http_call(live.port, "GET", "/stats")[1]
    finally:
        live.close()
    steps = sum(c[0] for c in chunks)
    decode_s = sum(c[1] for c in chunks)
    decode_tokens = sum(len(g) for g in got) - len(got)
    same = sum(a == b for a, b in zip(got, tokens["server_bf16_prefix"]))
    metrics["http_bf16"] = {"tok_s": decode_tokens / decode_s, "wall_s": wall}
    log(f"[http_bf16] POST /prefix (JSON pixel values included) {t_prefix * 1e3:.2f} ms; 10 "
        f"requests (9 /generate, 1 /generate_stream) in {wall:.4f} s from the prefix's POST; "
        f"{steps} decode steps, {decode_tokens / decode_s:.2f} tok/s aggregate over the decode "
        f"chunks; prefix hits {stats.get('prefix_hits')}")
    log(f"[http_bf16] launches {launches} plain calls {plain_calls}")
    log(f"[http_bf16] requests whose tokens equal the direct server_bf16_prefix run's: "
        f"{same}/{len(got)}")
    faults = path_faults("http_bf16", launches, plain_calls)
    faults += [f"request {i}: {len(g)} tokens for a budget of {reqs[i][2]}"
               for i, g in enumerate(got) if len(g) != reqs[i][2]]
    want = (5 * tc.n_layers + 1) * steps + len(reqs)
    if launches["gemv_tc"] != want:
        faults.append(f"launched the tensor-core gemv {launches['gemv_tc']} times, not {want}")
    faults += swiglu_faults(launches, tc.n_layers, prefills=len(reqs) + 1, decode_steps=steps)
    if stats.get("prefix_hits") != len(reqs):
        faults.append(f"the prefix served {stats.get('prefix_hits')} requests")
    if faults:
        raise RuntimeError(f"[http_bf16] {faults}")
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


def spec_server_rows_witness(dev, cfg, model, tokens: dict) -> None:
    """Information: the ``server_bf16_spec`` traffic again with each
    verify's SwiGLU (32 rows) run as four 8-row calls of the tensor-core rows
    kernel, the kernel that every plain decode step's 8 rows take; the log
    says how many requests then equal the plain server's. The prefills keep
    the TMA tile."""
    tiled = language_mod.fused_swiglu

    def rows_swiglu(x, w_gate, w_up, *biases, impl="auto"):
        flat = x.reshape(-1, x.shape[-1])
        if flat.shape[0] > 32 or biases:
            return tiled(x, w_gate, w_up, *biases, impl=impl)
        out = [kernels.fused_swiglu_rows_tc_cuda(r, w_gate, w_up) for r in flat.split(8)]
        return torch.cat(out).reshape(*x.shape[:-1], w_gate.shape[0])

    language_mod.fused_swiglu = rows_swiglu
    try:
        run_server(dev, cfg, model, "server_bf16_spec_rows", spec_lookup=3, tokens=tokens)
    finally:
        language_mod.fused_swiglu = tiled


# QLoRA (phase 15): the fine-tune loop's packed-text path at the 11B's widths.
QLORA_SEQ = 1632
QLORA_CHUNK = 512
QLORA_ACCUM = 2
QLORA_EOS = 128001  # Llama 3's <|end_of_text|>


def qlora_docs(vocab: int) -> list:
    """Seeded token documents (150-2500 ids each, below the special ids at
    the top of the vocabulary), enough for 12 steps of 2 rows of 1632 an
    epoch."""
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab * 99 // 100, rs.randint(150, 2500)).tolist() for _ in range(28)]


def qlora_args(steps: int, run_dir=None):
    argv = ["--rank", "16", "--alpha", "16", "--lr", "1e-4", "--batch-size", "1",
            "--accum-steps", str(QLORA_ACCUM), "--max-seq-len", str(QLORA_SEQ),
            "--steps", str(steps), "--save-every", "2", "--log-every", "1000"]
    return finetune.parse_args(argv + (["--run-dir", str(run_dir)] if run_dir else []))


def qlora_launches(layers: int, steps: int) -> dict:
    """Each QLoRA step's launches: per microbatch, the decoder's 7 quantized
    linears a layer twice (the forward and its remat recompute) and the
    head's loss chunks twice (forward, recompute) on the wgmma qmatmul; the
    flash forward with the LSE twice a layer, its backward once; the RMSNorm
    training forward for every norm whose input carries a gradient (all but
    layer 0's norm1, which the inference RMSNorm runs) in the forward and the
    recompute plus the final norm once, its backward once each."""
    chunks = -(-(QLORA_SEQ - 1) // QLORA_CHUNK)
    per_mb = {"qmatmul_tc": 2 * 7 * layers + 2 * chunks,
              "flash_attention_tc_lse": 2 * layers,
              "flash_attention_bwd_dq_tc": layers, "flash_attention_bwd_dkv_tc": layers,
              "rmsnorm_fwd_train": 2 * (2 * layers - 1) + 1, "rmsnorm": 2,
              "rmsnorm_bwd": 2 * layers}
    return {k: v * QLORA_ACCUM * steps for k, v in per_mb.items()}


def quantized_checksums(model) -> torch.Tensor:
    """``checksums`` of every parameter and buffer of a (quantized) model."""
    return torch.stack([t.detach().contiguous().view(torch.uint8).sum(dtype=torch.int64)
                        for t in [*model.parameters(), *model.buffers()]])


def run_qlora_11b(dev, cfg, qmodel, path: str) -> dict:
    """QLoRA over a quantized 11B, driven by the fine-tune loop; returns the
    timed steps' launches."""
    tc = cfg.text_config
    t_phase = time.perf_counter()
    docs = qlora_docs(tc.vocab_size)
    before = quantized_checksums(qmodel)
    times, losses, counts = [], [], {}

    def on_step(i, state, loss):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        losses.append(loss.item())
        if i == 0:  # after the warm-up: count and measure the 3 timed steps
            kernels.reset_counters()
            torch.cuda.reset_peak_memory_stats()
        if i == 3:
            counts.update(launches=kernels.launch_counts(), plain=kernels.plain_counts())

    state = finetune.finetune_loop(qmodel, cfg, dev, qlora_args(4), docs=docs,
                                   eos_id=QLORA_EOS, on_step=on_step, remat=True,
                                   loss_chunk=QLORA_CHUNK)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [b - a for a, b in zip(times[:-1], times[1:])]
    ms = 1e3 * statistics.median(steps)
    tokens = QLORA_ACCUM * QLORA_SEQ
    log(f"[{path}] steps (s) {[round(x, 6) for x in steps]} (warm-up "
        f"{times[0] - t_phase:.3f} s incl. setup) losses {losses}; median {ms:.2f} ms/step, "
        f"{tokens / ms * 1e3:.1f} tokens/s; peak allocated {peak:.3f} GiB")
    launches, plain_calls = counts["launches"], counts["plain"]
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    faults = path_faults(path, launches, plain_calls)
    want = qlora_launches(tc.n_layers, steps=3)
    faults += [f"launched {k} {launches[k]} times, not {n}" for k, n in want.items()
               if launches[k] != n]
    faults += [f"launched {k} {launches[k]} times"
               for k in ("swiglu", "swiglu_rows", "swiglu_tc", "gemv_tc") if launches[k]]
    if not all(math.isfinite(x) for x in losses):
        faults.append(f"non-finite loss {losses}")
    if not torch.equal(quantized_checksums(qmodel), before):
        faults.append("the quantized base changed")
    if not all(bool(b.any()) for name, b in lora_leaves(state.lora).items()
               if name.endswith("lora_b")):
        faults.append("an adapter's B did not move from 0")

    # resume: 2 steps saved to a run dir, then a fresh state and iterator
    # restored from it and run to step 4, against the uninterrupted run
    run_dir = Path(tempfile.mkdtemp(prefix=f"{path}_run_"))
    try:
        finetune.finetune_loop(qmodel, cfg, dev, qlora_args(2, run_dir), docs=docs,
                               eos_id=QLORA_EOS, remat=True, loss_chunk=QLORA_CHUNK)
        resumed = finetune.finetune_loop(qmodel, cfg, dev, qlora_args(4, run_dir), docs=docs,
                                         eos_id=QLORA_EOS, remat=True, loss_chunk=QLORA_CHUNK)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    want_l, got_l = lora_leaves(state.lora), lora_leaves(resumed.lora)
    bit_equal = all(torch.equal(got_l[n], t) for n, t in want_l.items())
    rel = max(((got_l[n] - t).abs().max() / t.abs().max().clamp(min=1e-30)).item()
              for n, t in want_l.items())
    log(f"[{path}] resumed at step 2 and run to 4: adapters bit-equal to the uninterrupted "
        f"run's: {bit_equal}; max relative difference {rel:.3g}")
    if not rel <= 1e-5:
        faults.append(f"the resumed adapters differ from the uninterrupted run's by {rel}")
    log(f"[{path}] phase {time.perf_counter() - t_phase:.1f} s")
    if faults:
        raise RuntimeError(f"[{path}] {faults}")
    return launches


# Evaluation (phase 16): 2 windows of 2048 seeded ids through the text decoder.
EVAL_WINDOW = 2048
EVAL_NLL_TOL = 0.01  # kernel path against impl="torch": bf16 rounding orders differ


def eval_launch_faults(path: str, launches: dict, plain_calls: dict, want: dict) -> list:
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    faults = path_faults(path, launches, plain_calls)
    return faults + [f"launched {k} {launches[k]} times, not {n}" for k, n in want.items()
                     if launches[k] != n]


def counted(fn):
    """``(fn(), launches, plain calls)`` with the counters set to 0 just
    before ``fn`` and read just after."""
    torch.cuda.synchronize()
    kernels.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(), kernels.plain_counts()


def run_eval_11b(dev, cfg, model) -> dict:
    """``perplexity``, ``agreement`` and ``calibrate_stats`` on the tied bf16
    11B and its quantized copies; returns the launches by path."""
    tc, vc = cfg.text_config, cfg.vision_config
    layers, windows = tc.n_layers, 2
    t_phase = time.perf_counter()
    ids = np.random.RandomState(7).randint(0, tc.vocab_size * 99 // 100, windows * EVAL_WINDOW)
    by_path, faults = {}, []

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        log(f"[{label}] {res} in {time.perf_counter() - t:.3f} s")
        return res

    kernel, launches, plain_calls = counted(lambda: timed(
        "eval_11b_bf16", lambda: evaluate.perplexity(model, cfg, ids, window=EVAL_WINDOW)))
    by_path["eval_11b_bf16"] = launches
    faults += eval_launch_faults("eval_11b_bf16", launches, plain_calls, {
        "rmsnorm": (2 * layers + 1) * windows, "swiglu_tc": layers * windows,
        "flash_attention_tc": layers * windows})
    plain = timed("eval_11b_bf16 impl=torch", lambda: evaluate.perplexity(
        model, cfg, ids, window=EVAL_WINDOW, impl="torch"))
    d = abs(kernel["nll_per_token"] - plain["nll_per_token"]) / plain["nll_per_token"]
    log(f"[eval_11b_bf16] NLL per token: kernel path {kernel['nll_per_token']:.6f}, plain path "
        f"{plain['nll_per_token']:.6f}, relative difference {d:.3g} (limit {EVAL_NLL_TOL})")
    if not d <= EVAL_NLL_TOL:
        faults.append(f"kernel and plain NLL differ by {d} relative")

    int8 = quantize_llama_params(model, bits=8)
    res, launches, plain_calls = counted(lambda: timed(
        "eval_11b_int8 kv int8", lambda: evaluate.perplexity(
            int8, cfg, ids, window=EVAL_WINDOW, kv_dtype="int8")))
    by_path["eval_11b_int8"] = launches
    faults += eval_launch_faults("eval_11b_int8", launches, plain_calls, {
        "rmsnorm": (2 * layers + 1) * windows, "qmatmul_tc": 7 * layers * windows,
        "flash_attention_tc_int8kv": layers * windows})
    if not math.isfinite(res["nll_per_token"]):
        faults.append(f"int8 perplexity {res}")

    agree = {}
    agree_launches = {}

    def agreement(label, other):
        res, launches, plain_calls = counted(lambda: timed(
            f"eval_11b_agreement {label}",
            lambda: evaluate.agreement(model, other, cfg, ids, window=EVAL_WINDOW)))
        agree[label] = res
        for k, n in launches.items():
            agree_launches[k] = agree_launches.get(k, 0) + n
        return plain_calls

    plain_calls = agreement("bf16 vs int8", int8)
    del int8
    free_device_memory()
    rtn = quantize_llama_params(model, bits=4, group_size=128, recipe=INT4_MIXED_RECIPE)
    plain_calls = {k: n + plain_calls[k] for k, n in agreement("bf16 vs int4-mixed RTN",
                                                               rtn).items()}
    # information: the same agreement on the plain path, so that a low number
    # is the random model's and not the kernels'
    log(f"[eval_11b_agreement] bf16 vs int4-mixed RTN, both impl='torch': "
        f"{evaluate.agreement(model, rtn, cfg, ids, window=EVAL_WINDOW, impl='torch')}")
    del rtn
    free_device_memory()

    gen = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
    cal_ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev),
                         torch.from_numpy(ids[:32]).to(dev)[None]], dim=1)  # S = 1632
    calibrate_stats(model, cfg, cal_ids, pixel_values=px)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    stats, launches, cal_plain = counted(lambda: calibrate_stats(model, cfg, cal_ids,
                                                                 pixel_values=px))
    log(f"[calibrate_11b] calibrate_stats at S={cal_ids.shape[1]} with the image: "
        f"{1e3 * (time.perf_counter() - t):.2f} ms; stats "
        f"{ {k: tuple(v.shape) for k, v in stats.items()} }")
    by_path["calibrate_11b"] = launches
    faults += eval_launch_faults("calibrate_11b", launches, cal_plain, {
        "rmsnorm": 2 * layers + 1, "swiglu_tc": layers,
        "flash_attention_tc": layers + vc.num_hidden_layers, "gemv_tc": 1})
    if not all(bool(torch.isfinite(v).all() and (v > 0).all()) for v in stats.values()):
        faults.append("calibration stats not finite and positive")
    eq = awq_equalize(model, stats)  # shares out_proj and the embeddings with model
    awq = quantize_llama_params(eq, bits=4, group_size=128, recipe=INT4_MIXED_RECIPE)
    del eq
    free_device_memory()
    plain_calls = {k: n + plain_calls[k] for k, n in agreement("bf16 vs int4-mixed AWQ",
                                                               awq).items()}
    del awq
    free_device_memory()
    by_path["eval_11b_agreement"] = agree_launches
    windows_a = 3 * windows  # three agreements, each the bf16 side and a quantized side
    faults += eval_launch_faults("eval_11b_agreement", agree_launches, plain_calls, {
        "rmsnorm": 2 * (2 * layers + 1) * windows_a, "swiglu_tc": layers * windows_a,
        "flash_attention_tc": 2 * layers * windows_a, "qmatmul_tc": 7 * layers * windows_a})
    for label, res in agree.items():
        log(f"[eval_11b_agreement] {label}: top-1 agreement {res['top1_agreement']:.4f}, mean "
            f"|dlogit| {res['mean_abs_dlogit']:.6f} over {res['tokens']} positions")
    log(f"[eval_11b] phase {time.perf_counter() - t_phase:.1f} s")
    if faults:
        raise RuntimeError(f"[eval_11b] {faults}")
    return by_path


def run_finetune_cli_tiny(dev) -> dict:
    """The fine-tune command line's smoke mode on the card: 3 steps with a
    run dir, rerun to 6 (resumed), against an uninterrupted 6-step run."""
    t = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="finetune_cli_"))
    try:
        def cli(steps, save, run_dir=None):
            argv = ["--steps", str(steps), "--rank", "4", "--log-every", "1",
                    "--save", str(tmp / save)]
            finetune.main(argv + (["--run-dir", str(tmp / run_dir)] if run_dir else []))
            return st_file.load_file(str(tmp / save))

        def runs():
            cli(3, "b3.safetensors", "run")
            return cli(6, "b6.safetensors", "run"), cli(6, "a.safetensors")

        (resumed, straight), launches, plain_calls = counted(runs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bit_equal = set(resumed) == set(straight) and all(
        torch.equal(resumed[k], straight[k]) for k in straight)
    log(f"[finetune_cli_tiny] 3 steps, resumed to 6: adapters bit-equal to an uninterrupted "
        f"6-step run's: {bit_equal}; launches {launches} plain calls {plain_calls}; "
        f"{time.perf_counter() - t:.1f} s")
    faults = [f"skipped {k}" for k in TRAIN_KERNELS if launches[k] == 0]
    faults += [f"ran plain {k} {n} times" for k, n in plain_calls.items() if n]
    if not bit_equal or faults:
        raise RuntimeError(f"[finetune_cli_tiny] resumed adapters bit-equal: {bit_equal}; "
                           f"{faults}")
    return launches


# The object API and profiling (wrapper_profiling): the kernel symbols a trace
# of the bf16 generate must name, and the port's three phases.
TRACE_KERNELS = ("flash", "gemv", "swiglu", "rmsnorm")
TRACE_PHASES = ("vision_encode", "mm_projector", "image_splice")


def run_wrapper_profiling(dev) -> dict:
    """The wrapper's logits equal ``vlm_forward``'s on the tiny fp32 model;
    ``utils/profiling.py::trace`` around a 4-token bf16 generate at the 11B
    widths (4 decoder, 2 ViT layers) exports a Chrome trace naming the three
    phases and the hand kernels. Returns the traced generate's launches."""
    cfg = tiny_mllama_config()
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    wrapped = wrapper.MllamaForConditionalGeneration(cfg, params=model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, 240, (2, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    px = torch.randn(2, 3, 28, 28, generator=gen, device=dev)
    with torch.inference_mode():
        got = wrapped(input_ids=ids, pixel_values=px, labels=ids)
        want = vlm_forward(model, cfg, input_ids=ids, pixel_values=px, labels=ids)
    if not (torch.equal(got["logits"], want.logits) and torch.equal(got["loss"], want.loss)):
        raise RuntimeError("the wrapper's logits differ from vlm_forward's")
    log(f"[wrapper_profiling] tiny fp32 wrapper logits equal vlm_forward's: "
        f"{tuple(got['logits'].shape)}, loss {got['loss'].item():.6g}")

    cfg = load_11b_config()
    tc, vc = cfg.text_config, cfg.vision_config
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev), text],
                    dim=1)
    px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048)
    engine.generate(ids, px, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_counters()
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            res = engine.generate(ids, px, max_new_tokens=4)
            torch.cuda.synchronize()
        path = os.path.join(log_dir, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    names = {e.get("name", "") for e in events}
    kernel_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if device_ms == 0:
        log("[wrapper_profiling] torch.profiler's key_averages() show no device time on this "
            "machine (CUPTI recorded no kernel)")
    found = {k: sorted(n for n in kernel_names if k in n.lower())[:3] for k in TRACE_KERNELS}
    log(f"[wrapper_profiling] trace.json {size} bytes, {len(events)} events, {len(kernel_names)} "
        f"kernel names, kernel device time {device_ms:.4f} ms; phases "
        f"{[p for p in TRACE_PHASES if p in names]}; kernels {found}")
    faults = [f"no {p} in the trace" for p in TRACE_PHASES if p not in names]
    faults += [f"no {k} kernel in the trace" for k in TRACE_KERNELS if not found[k]]
    faults += path_faults("bf16", launches, plain_calls)
    if tuple(res.tokens.shape) != (1, 4):
        faults.append(f"generated {tuple(res.tokens.shape)}")
    if faults:
        raise RuntimeError(f"[wrapper_profiling] {faults}")
    return launches


# Tensor-parallel serving (tp_tiny, tp_11b_*) and training across ranks
# (tp_lora_11b, zero1_full_ft_3b): a world of ranks a phase (TP_WORLD, or 4 for
# dp=2 x tp=2), NCCL with a GPU each or gloo on one shared card. The entries
# each rank's model calls, whose argument shapes record_shapes notes.
TP_WORLD = 2
_SHAPE_ENTRIES = ((gemv_mod, ("gemv_cuda", "gemv_int8_cuda", "gemv_int4_cuda", "qmatmul_cuda",
                              "gemv_int4_w4a8_cuda")),
                  (swiglu_mod, ("fused_swiglu_cuda", "fused_swiglu_bwd_cuda")),
                  (rmsnorm_mod, ("fused_add_rmsnorm_cuda", "rmsnorm_fwd_train_cuda",
                                 "rmsnorm_bwd_cuda")))


class record_shapes:
    """Within the block, note each kernel entry's call as (entry, the shapes of
    its tensor arguments): the gemv, SwiGLU and RMSNorm entries the model
    calls and every flash kernel of ``ops/attention.py``'s table."""

    def __init__(self):
        self.seen, self._undo = set(), []

    def _wrap(self, name, fn):
        def call(*args, **kw):
            self.seen.add((name, tuple(tuple(a.shape) for a in args
                                       if isinstance(a, torch.Tensor))))
            return fn(*args, **kw)
        return call

    def __enter__(self):
        for mod, names in _SHAPE_ENTRIES:
            for name in names:
                fn = getattr(mod, name)
                self._undo.append((mod, name, fn))
                setattr(mod, name, self._wrap(name, fn))
        table = attention_mod.KERNELS
        for name in [n for n in table if n.startswith("flash")]:
            kernel, plain = table[name]
            self._undo.append((table, name, (kernel, plain)))
            table[name] = (self._wrap(name, kernel), plain)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            if isinstance(owner, dict):
                owner[name] = orig
            else:
                setattr(owner, name, orig)
        return False

    def weights(self, entry: str) -> set:
        """The second argument's shapes (a linear's weight, SwiGLU's w_gate)."""
        return {shapes[1] for name, shapes in self.seen if name == entry and len(shapes) > 1}

    def widths(self, entry: str) -> set:
        """The first argument's last axis (the normed activations' width)."""
        return {shapes[0][-1] for name, shapes in self.seen if name == entry and shapes}

    def heads(self, names=None) -> set:
        """(query heads, kv heads) of every flash call (of the kernels in
        ``names``, when given)."""
        return {(shapes[0][1], shapes[1][1]) for name, shapes in self.seen
                if name.startswith("flash") and (names is None or name in names)}


def tp_shape_faults(path: str, rec: record_shapes, kind: str) -> list:
    """The 11B's tp=2 shapes each kernel must have run at on this rank, and
    no unsharded one: column-parallel N = 2048 (W_query), 512 (W_key,
    W_value), 7168 (w_gate, w_up), the head's 64128; row-parallel K = 2048
    (out_proj) and 7168 (w_down); attention over 16 query and 4 kv heads
    (the decoder) and 16 and 16 (the ViT, whole); RMSNorm over all 4096."""
    h = 4096
    if kind == "bf16":
        want = {"gemv_cuda": {(2048, h), (512, h), (h, 2048), (h, 7168), (64128, h)},
                "fused_swiglu_cuda": {(7168, h)}}
    else:  # INT4_MIXED_RECIPE: int8 attention and w_down, int4 (q4 [N, K/2]) gate, up and head
        want = {"gemv_int8_cuda": {(2048, h), (512, h), (h, 2048), (h, 7168)},
                "gemv_int4_cuda": {(7168, h // 2), (64128, h // 2)},
                "qmatmul_cuda": {(2048, h), (512, h), (h, 2048), (h, 7168), (7168, h // 2)}}
    want["fused_add_rmsnorm_cuda"] = {(h,)}  # the decoder's norms stay whole
    faults = [f"{e} ran at {sorted(rec.weights(e))}, not {sorted(w)}"
              for e, w in want.items() if rec.weights(e) != w]
    if rec.widths("fused_add_rmsnorm_cuda") != {h}:
        faults.append(f"RMSNorm over widths {sorted(rec.widths('fused_add_rmsnorm_cuda'))}")
    if rec.heads() != {(16, 4), (16, 16)}:  # the decoder's heads and the whole ViT's
        faults.append(f"flash heads {sorted(rec.heads())}, not [(16, 4), (16, 16)]")
    log(f"[{path}] shapes: " + "; ".join(f"{e} {sorted(rec.weights(e))}" for e in want)
        + f"; RMSNorm widths {sorted(rec.widths('fused_add_rmsnorm_cuda'))}"
        + f"; flash (q heads, kv heads) {sorted(rec.heads())}")
    return faults


def tp_compute_mode() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def run_tp_world(phase: str, fn_name: str, args: dict, world: int = TP_WORLD) -> list:
    """Run ``TP_PHASES[fn_name](rank, device, args)`` on ``world`` spawned
    ranks; return each rank's result. As many GPUs: NCCL, a GPU each;
    fewer: the ranks share cuda:0 over gloo (not possible in the
    Exclusive_Process compute mode, which fails here)."""
    free_device_memory()  # the parent's cached blocks, before the ranks share the card
    n = torch.cuda.device_count()
    mode = tp_compute_mode()
    how = ("NCCL, one GPU a rank" if n >= world else
           f"gloo, {world} ranks sharing cuda:0 (times are not multi-GPU times)")
    log(f"[{phase}] {world} ranks over {how}; compute mode {mode}; the parent holds "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    if n < world and "Exclusive_Process" in mode:
        raise RuntimeError(f"[{phase}] {world} processes cannot share the one card in compute "
                           f"mode {mode}")
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = torch.multiprocessing.spawn(_tp_rank, args=(fn_name, port, args, queue, world),
                                        nprocs=world, join=False)
    results = {}
    while len(results) < world:
        if not queue.empty():
            rank, value = queue.get()
            results[rank] = value
        elif any(p.is_alive() for p in procs.processes):
            time.sleep(0.05)
        elif queue.empty():
            break
    procs.join()  # raises with the failed rank's traceback
    failed = {r: v[1] for r, v in results.items() if isinstance(v, tuple) and v[0] == "error"}
    if failed or len(results) < world:
        raise RuntimeError(f"[{phase}] ranks failed: {failed or 'no result'}")
    return [results[r] for r in range(world)]


def _host(obj):
    """``obj`` with every tensor a numpy array: a tensor sent through a
    queue lives in the sender's shared memory, which ends with the rank."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _tp_rank(rank: int, fn_name: str, port: int, args: dict, queue, world: int) -> None:
    import traceback

    dev = init_distributed(rank, world, f"tcp://localhost:{port}", device="cuda",
                           share_device=True)
    try:
        queue.put((rank, _host(TP_PHASES[fn_name](rank, dev, args))))
    except Exception:
        queue.put((rank, ("error", traceback.format_exc())))
        raise
    finally:
        torch.distributed.destroy_process_group()


def tiny_tp_traffic(cfg, dev):
    """check_tiny_server's model and three staggered prompts."""
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(4)
    px = torch.randn(1, 3, 28, 28, generator=gen, device=dev)
    prompts = []
    for s, max_new in ((9, 6), (12, 10), (14, 4)):
        ids = torch.randint(0, 240, (s,), generator=gen, device=dev)
        ids[:4] = cfg.image_token_index
        prompts.append((ids, max_new))
    return model, px, prompts


def tiny_tp_tokens(model, cfg, dev, px, prompts) -> dict:
    """Engine and server tokens (monolithic and chunked admission, float and
    int8 KV cache) on the kernel path."""
    out = {}
    for kv_dtype in (None, "int8"):
        engine = InferenceEngine(model, cfg, dev, kv_dtype=kv_dtype)
        out[f"engine kv={kv_dtype}"] = [engine.generate(ids[None], px, max_new_tokens=n)
                                        .tokens[0].tolist() for ids, n in prompts]
        for chunk in (None, 4):
            srv = ContinuousBatchingServer(model, cfg, dev, slots=2,
                                           prompt_buckets=(16, 24) if chunk is None else None,
                                           kv_dtype=kv_dtype, steps_per_sync=4,
                                           prefill_chunk=chunk)
            rids = [srv.submit(ids, px, max_new_tokens=n) for ids, n in prompts]
            results = srv.run()
            out[f"server kv={kv_dtype} chunk={chunk}"] = [results[r].tolist() for r in rids]
    return out


# tp_tiny's weights: fp32, and quantized as check_tiny_paths_agree quantizes
# (g=32 falls on the tp=2 row-parallel split, K/2 = 32 and 64), each with the
# kernels its path must launch (prompts of at most 24 rows: every quantized
# linear is a gemv; tp_11b_int4_mixed runs the prefill GEMM)
TINY_TP_WEIGHTS = {
    "fp32": (None, ("rmsnorm", "gemv", "swiglu_rows", "swiglu_tf32", "flash_decode",
                    "flash_decode_int8kv")),
    "int8": (dict(bits=8), ("rmsnorm", "gemv_int8", "flash_decode", "flash_decode_int8kv")),
    "int4_mixed": (dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE),
                   ("rmsnorm", "gemv_int8", "gemv_int4", "flash_decode", "flash_decode_int8kv")),
}


def tiny_tp_model(cfg, dev, weights: str):
    model, px, prompts = tiny_tp_traffic(cfg, dev)
    quant = TINY_TP_WEIGHTS[weights][0]
    if quant is not None:
        model = quantize_llama_params(model, **quant)
    return model, px, prompts


# tp_tiny's serving features once refused under tensor parallelism: each
# path's kernels on the fp32 kernel path (a bank's gate/up adapters run the
# FFN unfused: no SwiGLU kernel; prefills above 8 rows on the 3xTF32 SwiGLU
# tile, decode steps on the rows kernel; the ViT dropout step trains through
# the fp32 flash kernels and the 3xTF32 SwiGLU tile, forward and backward)
TINY_FEATURE_KERNELS = {
    "tp_tiny_bank": ("rmsnorm", "gemv", "flash_decode"),
    "tp_tiny_draft": ("rmsnorm", "gemv", "swiglu_rows", "swiglu_tf32", "flash_decode"),
    "tp_tiny_http": ("rmsnorm", "gemv", "swiglu_rows", "swiglu_tf32", "flash_decode"),
    "tp_tiny_vit_dropout": TRAIN_KERNELS + FP32_SWIGLU,
    "tp_tiny_dp_server": ("rmsnorm", "gemv", "swiglu_rows", "swiglu_tf32", "flash_decode",
                          "flash_decode_int8kv"),
}
TINY_VIT_DROPOUT = 0.25
TINY_VIT_TOL = 1e-4  # fp32 |Δ| over the tower's largest gradient: partial sums in other orders


def tiny_spec_prompt(cfg, dev) -> tuple:
    """check_tiny_spec's prompt: 12 ids, the first 4 ``<image>``, and its
    pixel values."""
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, 240, (1, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    return ids, torch.randn(1, 3, 28, 28, generator=gen, device=dev)


def tiny_pool_tokens(model, cfg, dev) -> dict:
    """tp_tiny's three prompts through 4 slots: greedy, sampled under a
    seeded generator, and chunked over an int8 KV cache."""
    _, px, prompts = tiny_tp_traffic(cfg, dev)
    out = {}
    for name, kw in (("greedy", dict(prompt_buckets=(16, 24))),
                     ("sampled", dict(temperature=0.9, top_k=20,
                                      rng=torch.Generator(device=dev).manual_seed(7))),
                     ("chunked", dict(prefill_chunk=4, kv_dtype="int8"))):
        srv = ContinuousBatchingServer(model, cfg, dev, slots=4, steps_per_sync=4,
                                       **{"prompt_buckets": None, **kw})
        rids = [srv.submit(ids, px, max_new_tokens=n) for ids, n in prompts]
        results = srv.run()
        out[name] = [results[r].tolist() for r in rids]
    return out


def tiny_vit_dropout_step(cfg, dev, model) -> dict:
    """One full fine-tuning step's loss and the tower's gradients (this
    rank's slices) with the ViT's attention dropout, from a seeded batch
    and generator."""
    batch = tiny_batch(cfg, dev, torch.Generator(device=dev).manual_seed(12))
    params = dict(model.vision_model.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    loss = vlm_forward(model, cfg, **batch,
                       dropout_rng=torch.Generator(device=dev).manual_seed(13)).loss
    grads = {n: (placement_of(t), g)
             for (n, t), g in zip(params.items(), torch.autograd.grad(loss, list(params.values())))}
    for t in params.values():
        t.requires_grad_(False)
    init, step = make_train_step(cfg, learning_rate=1e-3)
    _, step_loss = step(init(model), batch, torch.Generator(device=dev).manual_seed(13))
    return {"loss": loss.item(), "step_loss": float(step_loss), "grads": grads}


def tiny_tp_features(rank, dev, mesh) -> dict:
    """The tiny fp32 model sharded at tp=2, on the kernel path: the bank
    server (check_tiny_bank's traffic), draft speculation (check_tiny_spec's
    prompt; the draft whole on every rank and sharded), the HTTP front end
    (check_tiny_http's traffic; rank 0 serves on loopback, rank 1 follows),
    full fine-tuning with ``vision_tp`` and ViT attention dropout (against
    the one-device step on this rank), and the 4-slot pool that
    ``tp_tiny_dp`` repeats at dp=2 x tp=2. Each with its launches."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    sharded = shard_params(model, cfg, mesh)
    out = {}

    def counted(path, fn):
        kernels.reset_counters()
        out[path] = {"value": fn()}
        out[path].update(launches=kernels.launch_counts(), plain=kernels.plain_counts())

    counted("tp_tiny_bank", lambda: tiny_bank_served(sharded, cfg, dev,
                                                     *tiny_bank_traffic(cfg, dev))[:2])
    draft, dcfg = tiny_draft(cfg, dev)
    ids, px = tiny_spec_prompt(cfg, dev)
    counted("tp_tiny_draft", lambda: [
        InferenceEngine(sharded, cfg, dev, spec_draft=3, draft_params=d, draft_config=dcfg)
        .generate(ids, px, max_new_tokens=24).tokens[0].tolist()
        for d in (draft, shard_params(draft, dcfg, mesh))])

    def http():
        prefix, reqs = tiny_http_traffic(cfg, dev)
        srv = ContinuousBatchingServer(sharded, cfg, dev, slots=2, prompt_buckets=None,
                                       steps_per_sync=3)
        got = None
        if rank == 0:
            live = LiveFrontend(srv)
            try:
                got, stats, dropped = tiny_http_drive(live.port, prefix, reqs)
            finally:
                live.close()
            got = {"tokens": got, "prefix_hits": stats.get("prefix_hits"),
                   "dropped": dropped[0]}
        else:
            follow(srv)
        return {"http": got, "records": {rid: r.tokens for rid, r in srv._results.items()}}

    counted("tp_tiny_http", http)
    vcfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, attention_dropout=TINY_VIT_DROPOUT))
    whole = tiny_vit_dropout_step(vcfg, dev, init_vlm(vcfg, dev, torch.Generator(
        device=dev).manual_seed(3)))
    counted("tp_tiny_vit_dropout", lambda: tiny_vit_dropout_step(vcfg, dev, shard_params(
        init_vlm(vcfg, dev, torch.Generator(device=dev).manual_seed(3)), vcfg, mesh,
        vision_tp=True)))
    got = out["tp_tiny_vit_dropout"]["value"]
    scale = max(g.abs().max().item() for _, g in whole["grads"].values())
    err = max((g - (whole["grads"][n][1] if pl is None else pl.local(whole["grads"][n][1])))
              .abs().max().item() for n, (pl, g) in got["grads"].items())
    out["tp_tiny_vit_dropout"]["value"] = {
        "loss": (got["loss"], whole["loss"]), "step_loss": (got["step_loss"], whole["step_loss"]),
        "grad_err": err, "grad_scale": scale}
    counted("tp_tiny_pool", lambda: tiny_pool_tokens(sharded, cfg, dev))
    return out


def tp_tiny_rank(rank, dev, args) -> dict:
    cfg = tiny_mllama_config(max_cache_length=64)
    mesh = create_mesh(tp=TP_WORLD)
    out = {}
    for weights in TINY_TP_WEIGHTS:
        model, px, prompts = tiny_tp_model(cfg, dev, weights)
        sharded = shard_params(model, cfg, mesh)
        kernels.reset_counters()
        out[weights] = {"tokens": tiny_tp_tokens(sharded, cfg, dev, px, prompts),
                        "launches": kernels.launch_counts(), "plain": kernels.plain_counts()}
    out["features"] = tiny_tp_features(rank, dev, mesh)
    return out


def tp_tiny_dp_rank(rank, dev, args) -> dict:
    """tp_tiny's 4-slot pool at dp=2 x tp=2, four ranks."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    sharded = shard_params(model, cfg, create_mesh(dp=2, tp=2))
    kernels.reset_counters()
    tokens = tiny_pool_tokens(sharded, cfg, dev)
    return {"tokens": tokens, "launches": kernels.launch_counts(),
            "plain": kernels.plain_counts()}


def tiny_feature_faults(path: str, results: list) -> list:
    """Every rank launched ``path``'s kernels and no plain version."""
    faults = []
    for r, res in enumerate(results):
        faults += [f"{path} rank {r} skipped {k}" for k in TINY_FEATURE_KERNELS[path]
                   if res["launches"][k] == 0]
        if any(res["plain"].values()):
            faults.append(f"{path} rank {r} ran plain versions {res['plain']}")
    if path == "tp_tiny_bank":  # gate/up adapters: the FFN unfused
        faults += [f"{path} rank {r} launched {k} {res['launches'][k]} times"
                   for r, res in enumerate(results) for k in ("swiglu_rows", "swiglu_tf32")
                   if res["launches"][k]]
    return faults


def run_tp_tiny_features(dev, ranks) -> tuple:
    """``tp_tiny``'s features against the one-device kernel path, and the
    pool at dp=2 x tp=2 (four ranks) against tp=2: ``(faults, launches by
    path)``."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(2), tie_weights=False)
    feats = [rank["features"] for rank in ranks]
    faults, by_path = [], {}
    bank_want = tiny_bank_served(model, cfg, dev, *tiny_bank_traffic(cfg, dev))[0]
    draft, dcfg = tiny_draft(cfg, dev)
    ids, px = tiny_spec_prompt(cfg, dev)
    draft_want = InferenceEngine(model, cfg, dev, spec_draft=3, draft_params=draft,
                                 draft_config=dcfg).generate(ids, px, max_new_tokens=24)
    prefix, reqs = tiny_http_traffic(cfg, dev)
    direct = ContinuousBatchingServer(model, cfg, dev, slots=2, prompt_buckets=None,
                                      steps_per_sync=3)
    direct.register_prefix(prefix)
    http_want, _ = tiny_served(direct, [(i, p, n, {}) for i, p, n in reqs])
    for r, f in enumerate(feats):
        bank, st = f["tp_tiny_bank"]["value"]
        if bank != bank_want or st["prefix_hits"] != 1:
            faults.append(f"bank rank {r}: {bank} != one device {bank_want} or prefix missed")
        if any(t != draft_want.tokens[0].tolist() for t in f["tp_tiny_draft"]["value"]):
            faults.append(f"draft rank {r}: {f['tp_tiny_draft']['value']} != one device "
                          f"{draft_want.tokens[0].tolist()}")
        if f["tp_tiny_http"]["value"]["records"] != feats[0]["tp_tiny_http"]["value"]["records"]:
            faults.append(f"http rank {r}'s records differ from rank 0's")
        v = f["tp_tiny_vit_dropout"]["value"]
        rel = max(abs(a - b) / abs(b) for a, b in (v["loss"], v["step_loss"]))
        if not (rel <= TINY_VIT_TOL and v["grad_err"] <= TINY_VIT_TOL * v["grad_scale"]):
            faults.append(f"vit dropout rank {r}: losses {v['loss']} {v['step_loss']}, "
                          f"gradient |Δ| {v['grad_err']} over {v['grad_scale']}")
        log(f"[tp_tiny_vit_dropout rank {r}] vision_tp step with attention dropout "
            f"{TINY_VIT_DROPOUT}: loss {v['loss'][0]:.8g} against one device {v['loss'][1]:.8g},"
            f" step loss {v['step_loss'][0]:.8g} / {v['step_loss'][1]:.8g}, largest gradient "
            f"|Δ| {v['grad_err']:.3g} of {v['grad_scale']:.3g}")
    http = feats[0]["tp_tiny_http"]["value"]["http"]
    if http["tokens"] != http_want or http["prefix_hits"] != 3 or http["dropped"] != 200:
        faults.append(f"http over tp=2: {http} != the direct one-device server's {http_want}")
    log(f"[tp_tiny features] bank {feats[0]['tp_tiny_bank']['value'][0]} (one device "
        f"{bank_want}); draft whole / sharded {feats[0]['tp_tiny_draft']['value']} (one device "
        f"{draft_want.tokens[0].tolist()}); HTTP {http['tokens']} (direct {http_want})")
    dp = run_tp_world("tp_tiny_dp", "tp_tiny_dp", {}, world=4)
    pool = feats[0]["tp_tiny_pool"]["value"]
    faults += [f"dp=2 x tp=2 rank {r}: {res['tokens']} != tp=2 {pool}"
               for r, res in enumerate(dp) if res["tokens"] != pool]
    log(f"[tp_tiny_dp_server] dp=2 x tp=2 tokens equal tp=2's on all four ranks: "
        f"{all(res['tokens'] == pool for res in dp)} ({pool})")
    for path in TINY_FEATURE_KERNELS:
        results = dp if path == "tp_tiny_dp_server" else [f[path] for f in feats]
        faults += tiny_feature_faults(path, results)
        by_path[path] = results[0]["launches"]
    return faults, by_path


def run_tp_tiny(dev) -> dict:
    """The tiny model at tp=2, fp32, int8 and int4-mixed: each rank's engine
    and server tokens equal the one-device kernel path's exactly; each rank
    launches its path's kernels and no plain version. Then the features once
    refused under tensor parallelism (``run_tp_tiny_features``). Returns the
    launches by path."""
    cfg = tiny_mllama_config(max_cache_length=64)
    want = {}
    for weights in TINY_TP_WEIGHTS:
        model, px, prompts = tiny_tp_model(cfg, dev, weights)
        want[weights] = tiny_tp_tokens(model, cfg, dev, px, prompts)
        del model
    ranks = run_tp_world("tp_tiny", "tp_tiny", {})
    faults, launches = run_tp_tiny_features(dev, ranks)
    by_path, launches = launches, {}
    for weights, (_, path_kernels) in TINY_TP_WEIGHTS.items():
        equal = all(rank[weights]["tokens"] == want[weights] for rank in ranks)
        for r, res in enumerate(rank[weights] for rank in ranks):
            if res["tokens"] != want[weights]:
                faults.append(f"{weights} rank {r}: {res['tokens']} != one device "
                              f"{want[weights]}")
            if any(res["plain"].values()):
                faults.append(f"{weights} rank {r} ran plain versions {res['plain']}")
            faults += [f"{weights} rank {r} skipped {k}" for k in path_kernels
                       if res["launches"][k] == 0]
        for k, n in ranks[0][weights]["launches"].items():
            launches[k] = launches.get(k, 0) + n
        log(f"[tp_tiny {weights}] tokens on every rank equal the one-device kernel path's: "
            f"{equal} ({len(want[weights])} runs, "
            f"{sum(len(v) for v in want[weights].values())} requests); rank 0 launches "
            f"{ {k: n for k, n in ranks[0][weights]['launches'].items() if n} }")
    if faults:
        raise RuntimeError(f"[tp_tiny] {faults}")
    return {"tp_tiny": launches, **by_path}


TP_11B_KINDS = ("bf16", "int4_mixed")


def one_rank_at_a_time(rank, dev, build):
    """``build()`` on every rank, one rank after the other when they share a
    card (each builds a whole model, keeps its shard and frees the rest)."""
    world = torch.distributed.get_world_size()
    shared = torch.cuda.device_count() < world
    out = None
    for turn in range(world):
        if turn == (rank if shared else 0):
            out = build()
            free_device_memory()
        torch.distributed.barrier()
    return out


def tp_11b_model(rank, dev, mesh, kind: str):
    """This rank's shard of the seeded 11B (bf16 with a tied head, or the
    untied one quantized to INT4_MIXED_RECIPE at g=128): the whole model is
    built, sharded and freed one rank at a time on a shared card."""
    cfg = llama32_11b_vision_config()

    def build():
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                         tie_weights=kind == "bf16")
        if kind == "int4_mixed":
            model = quantize_llama_params(model, bits=4, group_size=128,
                                          recipe=INT4_MIXED_RECIPE, free_originals=True)
        return shard_params(model, cfg, mesh)

    return cfg, one_rank_at_a_time(rank, dev, build)


def tp_11b_rank(rank, dev, args) -> dict:
    """Each kind: a 32-token greedy generate after the smoke's 1632-token
    image prompt (the bf16 path's prompt), then, in bf16, 4 image requests of
    the server_bf16 pattern through 4 slots; launches, shapes and tokens."""
    mesh = create_mesh(tp=TP_WORLD)
    out = {}
    for kind in args["kinds"]:
        cfg, model = tp_11b_model(rank, dev, mesh, kind)
        tc, vc = cfg.text_config, cfg.vision_config
        path = f"tp_11b_{kind}"
        kv_dtype = None if kind == "bf16" else "int8"
        gen = torch.Generator(device=dev).manual_seed(0)
        raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
        text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
        ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev),
                         text], dim=1)
        engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype)

        def generate(n):
            px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
            return engine.generate(ids, px, max_new_tokens=n, temperature=0.0)

        generate(2)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t
        kernels.reset_counters()
        with record_shapes() as rec:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = generate(32)
            torch.cuda.synchronize()
            t32 = time.perf_counter() - t
        launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
        faults = generate_faults(path, kind, launches, plain_calls, tc.n_layers, decode_steps=31)
        faults += tp_shape_faults(f"{path} rank {rank}", rec, kind)
        one = {"tokens": res.tokens.cpu(), "num": res.num_generated.cpu(),
               "prefill_logits": res.prefill_logits.float().cpu(), "launches": launches,
               "faults": faults, "ttft_s": ttft, "t32_s": t32,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if kind == "bf16":
            srv = ContinuousBatchingServer(model, cfg, dev, slots=4, max_cache_length=2048)
            reqs = server_requests(cfg, dev, n=4)
            kernels.reset_counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rids = [srv.submit(ids_r, px_r, max_new_tokens=budget) for ids_r, px_r, budget in reqs]
            results = srv.run()
            torch.cuda.synchronize()
            one["server_s"] = time.perf_counter() - t
            one["server_tokens"] = [results[r].tolist() for r in rids]
            one["server_budgets"] = [budget for _, _, budget in reqs]
            one["server_launches"] = kernels.launch_counts()
            one["faults"] += path_faults("server_bf16", one["server_launches"],
                                         kernels.plain_counts())
            del srv
            one.update(tp_11b_features(rank, dev, cfg, model, reqs))
            del reqs
        out[kind] = one
        del engine, model
        free_device_memory()
    return out


def time_decode_chunks(srv) -> list:
    """Wrap ``srv._decode`` to note each decode chunk's ``(steps,
    seconds)``, synchronized; returns the list it fills."""
    chunks, decode = [], srv._decode

    def counted(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(n)
        torch.cuda.synchronize()
        chunks.append((n, time.perf_counter() - t))
        return out

    srv._decode = counted
    return chunks


def chunk_numbers(chunks, tokens) -> dict:
    """``{"steps", "step_ms", "tok_s"}`` of a server run's decode chunks and
    its requests' tokens (the first of each from its admission)."""
    steps, secs = sum(n for n, _ in chunks), sum(t for _, t in chunks)
    return {"steps": steps, "step_ms": 1e3 * secs / max(steps, 1),
            "tok_s": (sum(len(t) for t in tokens) - len(tokens)) / secs if secs else 0.0}


def timed(fn):
    """``(fn(), seconds, launches, plain calls)``, from zeroed counters to a
    synchronized end."""
    kernels.reset_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, kernels.launch_counts(), kernels.plain_counts()


def tp_11b_features(rank, dev, cfg, model, reqs) -> dict:
    """The bf16 11B at tp=2 (``model``, this rank's shard): the 4 requests
    of ``tp_11b_server_bf16`` (``reqs``) served with ``server_bf16_lora``'s
    bank (request ``i`` adapter ``i % 3``), then over the HTTP front end on
    loopback (rank 0 serves, rank 1 follows); and ``bf16_spec_draft``'s
    random 1B-width draft, whole on each rank, K=4, 32 tokens after
    ``spec_prompt``. Tokens, seconds, launches, peak GiB."""
    tc, vc = cfg.text_config, cfg.vision_config
    out = {}
    bank = server_bank(cfg, dev)
    srv = ContinuousBatchingServer(model, cfg, dev, slots=4, max_cache_length=2048,
                                   adapter_bank=bank)
    torch.cuda.reset_peak_memory_stats(dev)
    chunks = time_decode_chunks(srv)

    def serve():
        rids = [srv.submit(ids, px, max_new_tokens=n, adapter_id=i % 3)
                for i, (ids, px, n) in enumerate(reqs)]
        results = srv.run()
        return [results[r].tolist() for r in rids]

    toks, secs, launches, plain = timed(serve)
    out["tp_11b_server_bf16_lora"] = {
        "tokens": toks, "s": secs, "launches": launches, **chunk_numbers(chunks, toks),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "faults": path_faults("server_bf16_lora", launches, plain)
        + [f"launched {k} {launches[k]} times with a gate/up bank"
           for k in ("swiglu", "swiglu_rows", "swiglu_tc", "swiglu_rows_tc") if launches[k]]}
    del srv, bank
    free_device_memory()

    draft, dcfg = llama32_1b_draft(dev)
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, spec_draft=4,
                             draft_params=draft, draft_config=dcfg)
    ids, raw = spec_prompt(cfg, dev)

    def generate(n):
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        return engine.generate(ids, px, max_new_tokens=n, temperature=0.0)

    generate(2)  # warm-up
    _, ttft, _, _ = timed(lambda: generate(1))
    torch.cuda.reset_peak_memory_stats(dev)
    res, secs, launches, plain = timed(lambda: generate(32))
    steps = int(res.steps)
    want, _ = spec_launches(tc, 4, steps, ids.shape[1], dcfg)
    out["tp_11b_bf16_spec_draft"] = {
        "tokens": res.tokens[0].tolist(), "steps": steps, "s": secs, "ttft_s": ttft,
        "step_ms": 1e3 * (secs - ttft) / steps, "tok_s": 31 / (secs - ttft),
        "launches": launches, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "faults": path_faults("bf16_spec_draft", launches, plain)
        + [f"launched {k} {launches[k]} times, not {n}" for k, n in want.items()
           if launches[k] != n]}
    del engine, draft
    free_device_memory()

    srv = ContinuousBatchingServer(model, cfg, dev, slots=4, max_cache_length=2048)
    chunks = time_decode_chunks(srv)
    torch.cuda.reset_peak_memory_stats(dev)
    bodies = [{"input_ids": ids_r.tolist(), "max_new_tokens": n,
               "pixel_values": px_r[0].float().cpu().numpy().tolist()} for ids_r, px_r, n in reqs]
    if rank == 0:
        def over_http():
            live = LiveFrontend(srv)
            try:
                return http_traffic(live.port, bodies, timeout=600)
            finally:
                live.close()

        toks, secs, launches, plain = timed(over_http)
    else:
        _, secs, launches, plain = timed(lambda: follow(srv))
        toks = None
    records = {rid: r.tokens for rid, r in srv._results.items()}
    out["tp_11b_http_bf16"] = {
        "tokens": toks, "records": records, "s": secs, "launches": launches,
        **chunk_numbers(chunks, list(records.values())),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "faults": path_faults("http_bf16", launches, plain)}
    del srv
    free_device_memory()
    return out


TP_11B_FEATURES = ("tp_11b_server_bf16_lora", "tp_11b_bf16_spec_draft", "tp_11b_http_bf16")


def check_tp_11b_features(res: list, by_path: dict) -> list:
    """``tp_11b_features``'s results on both ranks: the same tokens (and, over
    HTTP, the records and the direct tp=2 server's tokens), every rank's
    launches. Prints each path's numbers."""
    faults = []
    direct = res[0]["server_tokens"]
    for path in TP_11B_FEATURES:
        ranks = [r[path] for r in res]
        faults += [f"{path} rank {r}: {f}" for r, one in enumerate(ranks) for f in one["faults"]]
        key = "records" if path == "tp_11b_http_bf16" else "tokens"
        if any(one[key] != ranks[0][key] for one in ranks):
            faults.append(f"{path}: the ranks' {key} differ")
        by_path[path] = ranks[0]["launches"]
        for r, one in enumerate(ranks):
            log(f"[{path} rank {r}] {one['s']:.3f} s; {one['step_ms']:.2f} ms a "
                f"{'verify' if 'spec' in path else 'decode'} step, {one['tok_s']:.2f} tok/s, peak "
                f"{one['peak_gib']:.3f} GiB; launches "
                f"{ {k: n for k, n in one['launches'].items() if n} }")
    bank = res[0]["tp_11b_server_bf16_lora"]
    same = sum(a == b for a, b in zip(bank["tokens"][::3], direct[::3]))
    log(f"[tp_11b_server_bf16_lora] 4 image requests (adapters 0 / 1 / 2 / 0) through 4 slots, "
        f"tokens equal on every rank; the identity adapter's requests equal the plain tp=2 "
        f"server's (information: the unfused FFN rounds otherwise): {same}/2")
    spec = res[0]["tp_11b_bf16_spec_draft"]
    log(f"[tp_11b_bf16_spec_draft] K=4, 32 tokens: TTFT {spec['ttft_s'] * 1e3:.2f} ms, "
        f"{spec['steps']} verify steps, {31 / spec['steps']:.4f} tokens a step; tokens equal on "
        f"every rank: {spec['tokens']}")
    http = res[0]["tp_11b_http_bf16"]
    if http["tokens"] != direct:
        faults.append(f"tp_11b_http_bf16: {http['tokens']} != the direct tp=2 server's {direct}")
    log(f"[tp_11b_http_bf16] 4 requests (3 /generate, 1 /generate_stream) over loopback, "
        f"tokens equal to the direct tp=2 server's: {http['tokens'] == direct}; every rank's "
        f"records equal")
    return faults


def run_tp_11b(keep: dict, kinds=TP_11B_KINDS) -> dict:
    """The 11B at full width and depth, tp=2 (tp_11b_bf16, tp_11b_int4_mixed):
    every rank launches the path's kernels at its sharded shapes and no plain
    version, and every rank gives the same tokens; the prefill logits' max
    |Δ| against the one-device kernel path (``keep``) stays within twice that
    path's kernel-vs-plain distance."""
    ranks = run_tp_world("tp_11b", "tp_11b", {"kinds": kinds})
    by_path = {}
    for kind in kinds:
        path = f"tp_11b_{kind}"
        res = [r[kind] for r in ranks]
        faults = [f"rank {r}: {f}" for r, one in enumerate(res) for f in one["faults"]]
        for one in res:
            for key in ("tokens", "num", "prefill_logits"):
                one[key] = torch.as_tensor(one[key])
        toks = res[0]["tokens"]
        if not all(torch.equal(one["tokens"], toks) for one in res):
            faults.append(f"ranks' tokens differ: {[one['tokens'][0].tolist() for one in res]}")
        if tuple(toks.shape) != (1, 32) or int(res[0]["num"][0]) != 32:
            faults.append(f"generated {tuple(toks.shape)} / {res[0]['num'].tolist()}")
        ref = keep[kind]
        dl = (res[0]["prefill_logits"] - ref["prefill_logits"]).abs().max().item()
        if not dl <= 2 * ref["dl_plain"]:  # bf16 partial sums rounded on each rank
            faults.append(f"prefill logits {dl} from the one-device kernel path, over twice "
                          f"that path's distance from impl='torch' ({ref['dl_plain']})")
        same = int((toks[0] == ref["tokens"][0, :32]).long().cumprod(0).sum())
        log(f"[{path}] rank 0: TTFT {res[0]['ttft_s'] * 1e3:.2f} ms, 32 tokens "
            f"{res[0]['t32_s']:.4f} s ({31 / (res[0]['t32_s'] - res[0]['ttft_s']):.2f} tok/s "
            f"after the first), peak {res[0]['peak_gib']:.3f} GiB; rank 1 peak "
            f"{res[1]['peak_gib']:.3f} GiB")
        log(f"[{path}] prefill logits, tp=2 vs the one-device kernel path: max_abs_dlogit={dl:.6g}"
            f" (the one-device kernel path vs impl='torch' at these shapes: {ref['dl_plain']:.6g});"
            f" leading tokens equal to the one-device run's: {same} of 32")
        log(f"[{path}] tokens {toks[0].tolist()}")
        if kind == "bf16":
            srv = [one["server_tokens"] for one in res]
            if any(s != srv[0] for s in srv):
                faults.append("the ranks' server tokens differ")
            lens = [len(t) for t in srv[0]]
            if lens != res[0]["server_budgets"]:
                faults.append(f"server budgets {lens} != {res[0]['server_budgets']}")
            log(f"[{path}] server: 4 image requests through 4 slots in {res[0]['server_s']:.3f} s"
                f" ({sum(lens) / res[0]['server_s']:.2f} tok/s), tokens equal on every rank")
            by_path["tp_11b_server_bf16"] = res[0]["server_launches"]
            faults += check_tp_11b_features(res, by_path)
        if faults:
            raise RuntimeError(f"[{path}] {faults}")
        by_path[path] = res[0]["launches"]
    return by_path


# tp_dp_server_11b: four ranks' shards of the 11B widths share the card; 8 of
# 40 decoder and 8 of 32 ViT layers keep the phase short
TP_DP_DEPTH = {"decoder": 8, "vit": 8}
TP_DP_SAMPLED = dict(temperature=20.0, top_k=50)  # requests 4-7: random weights give sharp logits


def serve_8(model, cfg, dev, reqs) -> dict:
    """``reqs`` through 8 slots, the last four sampled from a seeded
    generator: tokens, seconds, decode steps and their seconds, launches,
    plain calls."""
    srv = ContinuousBatchingServer(model, cfg, dev, slots=8, max_cache_length=2048,
                                   rng=torch.Generator(device=dev).manual_seed(5))
    chunks = time_decode_chunks(srv)

    def serve():
        rids = [srv.submit(ids, px, max_new_tokens=n, **(TP_DP_SAMPLED if i >= 4 else {}))
                for i, (ids, px, n) in enumerate(reqs)]
        results = srv.run()
        return [results[r].tolist() for r in rids]

    toks, secs, launches, plain = timed(serve)
    return {"tokens": toks, "s": secs, "launches": launches, "plain": plain,
            **chunk_numbers(chunks, toks)}


def tp_dp_server_11b_rank(rank, dev, args) -> dict:
    """The 11B widths at ``TP_DP_DEPTH``, bf16, tied: 8 image requests
    (``server_requests``) through 8 slots at tp=2 (ranks 0-1, the others
    waiting), then at dp=2 x tp=2 on the same weights (four slots a
    group)."""
    cfg = load_11b_config(TP_DP_DEPTH)
    dp_mesh, tp_mesh = create_mesh(dp=2, tp=2), create_mesh(tp=2)

    def build():
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        return (shard_params(model, cfg, dp_mesh),
                shard_params(model, cfg, tp_mesh) if tp_mesh.member else None)

    dp_model, tp_model = one_rank_at_a_time(rank, dev, build)
    reqs = server_requests(cfg, dev, n=8)
    out = {}
    if tp_model is not None:
        out["tp2"] = serve_8(tp_model, cfg, dev, reqs)
        del tp_model
    free_device_memory()
    torch.distributed.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    out["dp2"] = serve_8(dp_model, cfg, dev, reqs)
    out["dp2"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["dp2"]["faults"] = path_faults("tp_dp_server_11b", out["dp2"]["launches"],
                                       out["dp2"]["plain"])
    return out


def run_tp_dp_server_11b() -> dict:
    """``tp_dp_server_11b``: every rank's dp=2 x tp=2 tokens equal the tp=2
    server's on the same weights, sampled requests included; every rank
    launches the server's kernels and no plain version. Prints each rank's
    ms a decode step, tokens/s and peak GiB."""
    ranks = run_tp_world("tp_dp_server_11b", "tp_dp_server_11b", {}, world=4)
    want = ranks[0]["tp2"]["tokens"]
    faults = [f"rank {r}: {f}" for r, res in enumerate(ranks) for f in res["dp2"]["faults"]]
    faults += [f"rank {r}: tp=2 tokens {res['tp2']['tokens']} differ from rank 0's"
               for r, res in enumerate(ranks[:2]) if res["tp2"]["tokens"] != want]
    faults += [f"rank {r}: dp=2 x tp=2 tokens {res['dp2']['tokens']} != tp=2 {want}"
               for r, res in enumerate(ranks) if res["dp2"]["tokens"] != want]
    for name in ("tp2", "dp2"):
        for r, res in enumerate(ranks):
            if name not in res:
                continue
            one = res[name]
            log(f"[tp_dp_server_11b {name} rank {r}] 8 requests in {one['s']:.3f} s; "
                f"{one['steps']} decode steps, {one['step_ms']:.4f} ms a step, "
                f"{one['tok_s']:.2f} decode tok/s; "
                + (f"peak {one['peak_gib']:.3f} GiB; " if "peak_gib" in one else "")
                + f"launches { {k: n for k, n in one['launches'].items() if n} }")
    log(f"[tp_dp_server_11b] {TP_DP_DEPTH['decoder']} of 40 decoder and {TP_DP_DEPTH['vit']} of "
        f"32 ViT layers; dp=2 x tp=2 tokens equal the tp=2 server's on every rank (4 greedy, 4 "
        f"sampled): {not faults}; tokens {want}")
    if faults:
        raise RuntimeError(f"[tp_dp_server_11b] {faults}")
    return ranks[0]["dp2"]["launches"]


def adapters_flat(state) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in lora_leaves(state.lora).values()])


def same_on_every_rank(mesh, x: torch.Tensor, axis: str) -> bool:
    """Whether ``x`` is bit-equal on every rank of this rank's ``axis``
    group (each rank compares the gathered copies)."""
    parts = mesh.all_gather(x.reshape(1, -1), axis, dim=0)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def tp_lora_11b_rank(rank, dev, args) -> dict:
    """lora_11b at tp=2: the tied bf16 11B's shard, rank-16 adapters (the
    default targets and the head), Adam lr 1e-4, B=1 S=1632; a warm-up and
    3 timed steps, each followed by a check that both ranks hold the same
    loss and adapters."""
    mesh = create_mesh(tp=2)
    cfg, model = tp_11b_model(rank, dev, mesh, "bf16")
    base = list(model.parameters())
    before = checksums(base)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), cfg, rank=16, alpha=16.0)
    init_state, step = make_lora_train_step(cfg, learning_rate=1e-4)
    state = init_state(lora)
    batch = train_batch(cfg, dev)
    out = {"losses": [], "equal": [], "times": []}

    def one_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = step(model, state, batch)
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t)
        out["losses"].append(loss.item())
        out["equal"].append(same_on_every_rank(mesh, loss, AXIS_TP)
                            and same_on_every_rank(mesh, adapters_flat(state), AXIS_TP))

    one_step()  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counters()
    with record_shapes() as rec:
        for _ in range(3):
            one_step()
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    faults = path_faults("tp_lora_11b", launches, plain_calls)
    train_heads = rec.heads(("flash_attention_tc_lse", "flash_attention_bwd_dq_tc",
                             "flash_attention_bwd_dkv_tc"))
    if train_heads != {(16, 4)}:
        faults.append(f"flash LSE forward and backward at heads {sorted(train_heads)}, not "
                      f"[(16, 4)]")
    for entry in ("rmsnorm_fwd_train_cuda", "rmsnorm_bwd_cuda"):
        if rec.widths(entry) != {4096}:
            faults.append(f"{entry} at widths {sorted(rec.widths(entry))}, not [4096]")
    log(f"[tp_lora_11b rank {rank}] flash (q heads, kv heads): training {sorted(train_heads)}, "
        f"all {sorted(rec.heads())}; RMSNorm training widths "
        f"{sorted(rec.widths('rmsnorm_fwd_train_cuda') | rec.widths('rmsnorm_bwd_cuda'))}")
    out.update(launches=launches, faults=faults,
               base_unchanged=bool(torch.equal(checksums(base), before))
               and not any(p.requires_grad for p in base),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def run_tp_lora_11b(keep: dict) -> dict:
    """tp_lora_11b: both ranks' losses and adapters bit-equal after every
    step, the base unchanged, the first loss within twice the one-device
    kernel path's distance from the plain path of the one-device lora_11b
    first loss (``keep``), the path's kernels at the rank's shapes (flash
    LSE, dq and dk/dv over 16 query and 4 kv heads, the training RMSNorm at
    4096) and no plain version."""
    res = run_tp_world("tp_lora_11b", "tp_lora_11b", {})
    faults = [f"rank {r}: {f}" for r, one in enumerate(res) for f in one["faults"]]
    if not all(all(one["equal"]) for one in res) or res[0]["losses"] != res[1]["losses"]:
        faults.append(f"the ranks' losses or adapters differ: {[one['equal'] for one in res]}, "
                      f"{[one['losses'] for one in res]}")
    if not all(one["base_unchanged"] for one in res):
        faults.append("the base weights changed or require gradients")
    ref = keep["lora_11b"]
    dl = abs(res[0]["losses"][0] - ref["loss"])
    if not dl <= 2 * ref["dl_plain"]:
        faults.append(f"first loss {res[0]['losses'][0]} is {dl} from the one-device kernel "
                      f"path's {ref['loss']}, over twice that path's distance from impl='torch' "
                      f"({ref['dl_plain']})")
    ms = 1e3 * statistics.median(res[0]["times"][1:])
    log(f"[tp_lora_11b] losses {res[0]['losses']} (warm-up first), equal on both ranks after "
        f"every step; first loss {dl:.6g} from the one-device kernel path's (its distance from "
        f"the plain path {ref['dl_plain']:.6g})")
    log(f"[tp_lora_11b] rank 0: steps (s) {[round(x, 4) for x in res[0]['times']]}, median "
        f"{ms:.2f} ms/step ({1632 / ms * 1e3:.1f} tokens/s; two ranks sharing one card over gloo, "
        f"not multi-GPU times); peak {res[0]['peak_gib']:.3f} / {res[1]['peak_gib']:.3f} GiB a "
        f"rank; launches {({k: n for k, n in res[0]['launches'].items() if n})}")
    if faults:
        raise RuntimeError(f"[tp_lora_11b] {faults}")
    return res[0]["launches"]


# zero1_full_ft_3b: the 3B bench widths at a depth four ranks on one card fit
# (with the checkpoint's round trips in the time and disk of the smoke)
ZERO1_DEPTH = {"decoder": 8, "vit": 8}


def zero1_3b_config(dtype: str) -> MLLAMAConfig:
    cfg = bench_3b_config(dtype)
    return dataclasses.replace(
        cfg, text_config=dataclasses.replace(cfg.text_config, n_layers=ZERO1_DEPTH["decoder"]),
        vision_config=dataclasses.replace(cfg.vision_config,
                                          num_hidden_layers=ZERO1_DEPTH["vit"]))


def gather_whole(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of a rank's slice ``t`` (its placement's splits
    all-gathered)."""
    pl = placement_of(t)
    for dim, parts, axis in ([] if pl is None else pl.splits):
        if parts > 1:
            t = mesh.all_gather(t.contiguous(), axis, dim)
    return t


def zero1_3b_rank(rank, dev, args) -> dict:
    """Full fine-tuning at dp=2 x tp=2, fp32 masters, bf16 compute, frozen
    ViT, AdamW lr 1e-5, clip 1.0, B=2 (a row a dp rank), S=1632: 3 steps
    without ZeRO-1, then 3 with ZeRO-1 and dp-sharded masters, a
    ShardedCheckpointer save after step 2, step 3 again from the restored
    state, and a restore onto dp=4 x tp=1."""
    mesh = create_mesh(dp=2, tp=2)
    cfg = zero1_3b_config("float32")
    batch = {k: data_sharding(mesh).local(v).contiguous()
             for k, v in train_batch(zero1_3b_config("bfloat16"), dev, b=2).items()}

    def build():
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        return shard_params(model, cfg, mesh)

    def steps(step, state, n, save_after=None):
        losses, times = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
            if save_after == i + 1:
                t = time.perf_counter()
                ck.save(path, state)
                out["save_s"] = time.perf_counter() - t
        return state, losses, times

    out, ck, path = {}, ShardedCheckpointer(), os.path.join(args["dir"], "zero1_3b")
    kw = dict(learning_rate=1e-5, max_grad_norm=1.0, freeze_vision=True,
              compute_dtype="bfloat16")
    model = one_rank_at_a_time(rank, dev, build)
    init_state, step = make_train_step(cfg, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    state, out["plain_losses"], out["plain_times"] = steps(step, init_state(model), 3)
    out["plain_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del model, init_state, step, state
    free_device_memory()

    model = one_rank_at_a_time(rank, dev, build)
    init_state, step = make_train_step(cfg, zero1_params=model, zero1_masters=True, **kw)
    state = init_state(model)
    del model  # the masters are the state's dp slices now; the forward runs its bf16 twin
    free_device_memory()
    moments = {}  # name: (elements on this rank, whole elements, dims)
    for name, m in state.opt_state.mu.items():
        moments[name] = (m.numel(), math.prod(placement_of(m).full_shape(m.shape)), m.dim())
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counters()
    with record_shapes() as rec:
        state, out["losses"], out["times"] = steps(step, state, 3, save_after=2)
    out["launches"], plain_calls = kernels.launch_counts(), kernels.plain_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    faults = path_faults("zero1_full_ft_3b", out["launches"], plain_calls)
    for entry in ("fused_swiglu_cuda", "fused_swiglu_bwd_cuda"):
        if rec.weights(entry) != {(4096, 3072)}:
            faults.append(f"{entry} at {sorted(rec.weights(entry))}, not [(4096, 3072)]")
    heads = rec.heads(("flash_attention_tc_lse", "flash_attention_bwd_dq_tc",
                       "flash_attention_bwd_dkv_tc"))
    if heads != {(12, 4)}:
        faults.append(f"flash LSE forward and backward at heads {sorted(heads)}, not [(12, 4)]")
    quarter = [n for n, (local, whole, dims) in moments.items()
               if ".blocks." in n and dims == 2 and local * 4 != whole]
    if quarter:
        faults.append(f"decoder matrices' moments not a quarter of their whole: {quarter}")
    out["moment_elems"] = (sum(v[0] for v in moments.values()),
                           sum(v[1] for v in moments.values()))
    log(f"[zero1_full_ft_3b rank {rank}] SwiGLU tile at {sorted(rec.weights('fused_swiglu_cuda'))},"
        f" backward at {sorted(rec.weights('fused_swiglu_bwd_cuda'))}; flash training heads "
        f"{sorted(heads)}; Adam moments {out['moment_elems'][0]} of {out['moment_elems'][1]} "
        f"elements on this rank")

    # step 3 again, from the state saved after step 2, on the same mesh
    last = {n: t.clone() for n, t in state.params.items()}
    restored = ck.restore(path, abstract_state(state))
    t = time.perf_counter()
    restored, loss = step(restored, batch)
    out["restore_s"] = time.perf_counter() - t
    out["resume_equal"] = (loss.item() == out["losses"][2]
                           and all(torch.equal(restored.params[n], v) for n, v in last.items())
                           and all(torch.equal(restored.opt_state.mu[n], v)
                                   for n, v in state.opt_state.mu.items()))
    del restored, last
    free_device_memory()

    # the step-2 state onto dp=4 x tp=1: each rank's quarter of the whole masters
    mesh_b = create_mesh(dp=4, tp=1)
    whole = dict(MllamaForConditionalGeneration(cfg, "meta").named_parameters())
    z1_b = zero1_shardings(shard_params(MllamaForConditionalGeneration(cfg, "meta"), cfg,
                                        mesh_b))
    names = list(state.params)
    template = {"params": {n: whole[n] for n in names}}
    got = ck.restore(path, abstract_state(template, {"params": {n: z1_b[n] for n in names}}))
    saved = ck.restore(path, abstract_state({"params": state.params}))  # the step-2 masters
    mismatched = []
    for n in names:
        w = gather_whole(saved["params"][n], mesh)
        if not torch.equal(z1_b[n].local(w), got["params"][n]):
            mismatched.append(n)
        del w
    out["other_mesh_mismatched"] = mismatched
    out["faults"] = faults
    ck.close()
    return out


def run_zero1_full_ft_3b(tmp_dir: str) -> dict:
    """zero1_full_ft_3b: the SwiGLU tile forward and backward at I=4096 and
    the flash training kernels at 12 / 4 heads on every rank, each Adam
    moment of a decoder matrix a quarter of its whole, the losses within
    rtol 3e-4 of the run without ZeRO-1, the step after a restore bit-equal
    to the straight run's, and the restore onto dp=4 x tp=1 equal to the
    saved masters."""
    res = run_tp_world("zero1_full_ft_3b", "zero1_3b", {"dir": tmp_dir}, world=4)
    faults = [f"rank {r}: {f}" for r, one in enumerate(res) for f in one["faults"]]
    for key in ("losses", "plain_losses"):
        if any(one[key] != res[0][key] for one in res):
            faults.append(f"the ranks' {key} differ: {[one[key] for one in res]}")
    got, want = np.asarray(res[0]["losses"]), np.asarray(res[0]["plain_losses"])
    if not np.allclose(got, want, rtol=3e-4, atol=0):
        faults.append(f"ZeRO-1 losses {got.tolist()} not within rtol 3e-4 of {want.tolist()}")
    if not all(one["resume_equal"] for one in res):
        faults.append("step 3 from the restored state differs from the straight run's")
    bad = {r: one["other_mesh_mismatched"] for r, one in enumerate(res)
           if one["other_mesh_mismatched"]}
    if bad:
        faults.append(f"the dp=4 x tp=1 restore differs from the saved masters: {bad}")
    ms, plain_ms = (1e3 * statistics.median(res[0][k]) for k in ("times", "plain_times"))
    log(f"[zero1_full_ft_3b] ({ZERO1_DEPTH['decoder']} decoder and {ZERO1_DEPTH['vit']} ViT "
        f"layers of the 3B bench config) losses ZeRO-1 {got.tolist()}, without "
        f"{want.tolist()} (max relative {float(np.max(np.abs(got - want) / np.abs(want))):.3g})")
    log(f"[zero1_full_ft_3b] rank 0: ms/step ZeRO-1 {ms:.2f}, without {plain_ms:.2f} (four ranks "
        f"sharing one card over gloo, not multi-GPU times); save {res[0]['save_s']:.3f} s, "
        f"restore + step {res[0]['restore_s']:.3f} s; peak a rank "
        f"{[round(one['peak_gib'], 3) for one in res]} GiB (without ZeRO-1 "
        f"{[round(one['plain_peak_gib'], 3) for one in res]}); Adam moments "
        f"{res[0]['moment_elems'][0]} of {res[0]['moment_elems'][1]} elements a rank; step 3 "
        f"after the restore bit-equal; the dp=4 x tp=1 restore equal to the saved masters")
    log(f"[zero1_full_ft_3b] rank 0 launches "
        f"{({k: n for k, n in res[0]['launches'].items() if n})}")
    if faults:
        raise RuntimeError(f"[zero1_full_ft_3b] {faults}")
    return res[0]["launches"]


class count_ppermute_bytes:
    """Within the block, the bytes ``Mesh.ppermute`` sends from this rank."""

    def __enter__(self):
        self.bytes, self._orig = 0, Mesh.ppermute

        def counted(mesh, x, axis, shift=1):
            if mesh.shape[axis] > 1:
                self.bytes += x.numel() * x.element_size()
            return self._orig(mesh, x, axis, shift)

        Mesh.ppermute = counted
        return self

    def __exit__(self, *exc):
        Mesh.ppermute = self._orig
        return False


RING_KERNELS = ("flash_attention_tc_lse", "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")


def flash_shapes(rec: record_shapes, names) -> set:
    """(q heads, kv heads, Tq, Tk) of every call of the flash kernels ``names``."""
    return {(shapes[0][1], shapes[1][1], shapes[0][2], shapes[1][2])
            for name, shapes in rec.seen if name in names}


def sp_lora_11b_rank(rank, dev, args) -> dict:
    """lora_11b at sp=2: the tied bf16 11B (whole on both ranks), rank-16
    adapters with the head's, Adam lr 1e-4, ``remat``, ``loss_chunk``; B=1
    S=4096, this rank's 2048 tokens; a warm-up and 3 timed steps, each
    followed by a check that both ranks hold the same loss and adapters."""
    mesh = create_mesh(sp=2)
    cfg = llama32_11b_vision_config()

    def build():
        model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=True)
        return shard_params(model, cfg, mesh)

    model = one_rank_at_a_time(rank, dev, build)
    base = list(model.parameters())
    before = checksums(base)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), cfg, rank=16, alpha=16.0)
    init_state, step = make_lora_train_step(cfg, learning_rate=1e-4, remat=True,
                                            loss_chunk=SP_LOSS_CHUNK)
    state = init_state(lora)
    whole = train_batch(cfg, dev, text_ids=SP_SEQ - cfg.vision_config.num_patches)
    batch = {k: (seq_data_sharding(mesh) if k != "pixel_values" else data_sharding(mesh))
             .local(v).contiguous() for k, v in whole.items()}
    out = {"losses": [], "equal": [], "times": []}

    def one_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = step(model, state, batch)
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t)
        out["losses"].append(loss.item())
        out["equal"].append(same_on_every_rank(mesh, loss, AXIS_SP)
                            and same_on_every_rank(mesh, adapters_flat(state), AXIS_SP))

    one_step()  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counters()
    with record_shapes() as rec, count_ppermute_bytes() as sent:
        for _ in range(3):
            one_step()
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    faults = path_faults("sp_lora_11b", launches, plain_calls)
    layers, ring = cfg.text_config.n_layers, mesh.shape[AXIS_SP]
    # a ring step per rank of the axis, a layer; the forward twice (remat)
    want = {"flash_attention_tc_lse": 3 * 2 * ring * layers,
            "flash_attention_bwd_dq_tc": 3 * ring * layers,
            "flash_attention_bwd_dkv_tc": 3 * ring * layers}
    faults += [f"{k} launched {launches[k]} times, not {n}" for k, n in want.items()
               if launches[k] != n]
    shapes = flash_shapes(rec, RING_KERNELS)
    if shapes != {(32, 8, RING_T, RING_T)}:
        faults.append(f"ring kernels at (heads, kv heads, Tq, Tk) {sorted(shapes)}, not "
                      f"[(32, 8, {RING_T}, {RING_T})]")
    for entry in ("rmsnorm_fwd_train_cuda", "rmsnorm_bwd_cuda"):
        if rec.widths(entry) != {4096}:
            faults.append(f"{entry} at widths {sorted(rec.widths(entry))}, not [4096]")
    log(f"[sp_lora_11b rank {rank}] ring kernels at {sorted(shapes)}; launches "
        f"{({k: launches[k] for k in want})} (want {want}); RMSNorm training widths "
        f"{sorted(rec.widths('rmsnorm_fwd_train_cuda') | rec.widths('rmsnorm_bwd_cuda'))}")
    out.update(launches=launches, faults=faults, ppermute_bytes=sent.bytes / 3,
               base_unchanged=bool(torch.equal(checksums(base), before))
               and not any(p.requires_grad for p in base),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def run_sp_lora_11b(keep: dict) -> dict:
    """sp_lora_11b: both ranks' losses and adapters bit-equal after every
    step, the base unchanged, the first loss within twice the one-device
    kernel path's distance from the plain path on the same S=4096 batch
    (``keep``), the ring's launches exact at the rank's shapes and no plain
    version."""
    res = run_tp_world("sp_lora_11b", "sp_lora_11b", {})
    faults = [f"rank {r}: {f}" for r, one in enumerate(res) for f in one["faults"]]
    if not all(all(one["equal"]) for one in res) or res[0]["losses"] != res[1]["losses"]:
        faults.append(f"the ranks' losses or adapters differ: {[one['equal'] for one in res]}, "
                      f"{[one['losses'] for one in res]}")
    if not all(one["base_unchanged"] for one in res):
        faults.append("the base weights changed or require gradients")
    ref = keep["sp_lora_11b"]
    dl = abs(res[0]["losses"][0] - ref["loss"])
    if not dl <= 2 * ref["dl_plain"]:
        faults.append(f"first loss {res[0]['losses'][0]} is {dl} from the one-device kernel "
                      f"path's {ref['loss']}, over twice that path's distance from impl='torch' "
                      f"({ref['dl_plain']})")
    ms = 1e3 * statistics.median(res[0]["times"][1:])
    log(f"[sp_lora_11b] losses {res[0]['losses']} (warm-up first), equal on both ranks after "
        f"every step; first loss {dl:.6g} from the one-device kernel path's (its distance from "
        f"the plain path {ref['dl_plain']:.6g})")
    log(f"[sp_lora_11b] rank 0: steps (s) {[round(x, 4) for x in res[0]['times']]}, median "
        f"{ms:.2f} ms/step ({SP_SEQ / ms * 1e3:.1f} tokens/s; two ranks sharing one card over "
        f"gloo, not multi-GPU times); peak {res[0]['peak_gib']:.3f} / {res[1]['peak_gib']:.3f} "
        f"GiB a rank; ppermute {res[0]['ppermute_bytes'] / 2**20:.2f} MiB sent a step a rank; "
        f"launches {({k: n for k, n in res[0]['launches'].items() if n})}")
    if faults:
        raise RuntimeError(f"[sp_lora_11b] {faults}")
    return res[0]["launches"]


PP_STAGES, PP_MICRO, PP_BATCH, PP_CHUNK, PP_LR = 2, 2, 4, 512, 1e-4


def pp_3b_config() -> LLAMA32Config:
    """The 3B bench's text widths at ``ZERO1_DEPTH``'s decoder depth, bf16."""
    return dataclasses.replace(bench_3b_config("bfloat16").text_config,
                               n_layers=ZERO1_DEPTH["decoder"])


def pp_model(dev) -> CausalLM:
    lm = CausalLM(pp_3b_config(), dev, torch.bfloat16)
    with torch.no_grad():
        lm.init_(torch.Generator(device=dev).manual_seed(0))
    return lm


def pp_batch(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, pp_3b_config().vocab_size, (PP_BATCH, 1632), generator=gen, device=dev)
    return {"input_ids": ids, "labels": ids}


def pp_unpipelined(dev, impl: str) -> list:
    """3 Adam steps (no decay, no clip) of the unpipelined 3B text model on
    one device: its losses."""
    lm, tc, batch = pp_model(dev), pp_3b_config(), pp_batch(dev)
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tx, losses = Adam(PP_LR), []
    state = tx.init(params)
    for _ in range(3):
        with torch.enable_grad():
            h = language_mod.llama_forward(lm.model, tc, input_ids=batch["input_ids"],
                                           impl=impl).hidden_states
            loss = chunked_shifted_cross_entropy(lm, tc, h, batch["labels"], -100,
                                                 chunk=PP_CHUNK, impl=impl)
            grads = torch.autograd.grad(loss, list(params.values()))
        state = tx.step(params, dict(zip(params, grads)), state)
        losses.append(loss.item())
        del h, grads, loss  # the last step's graph too, before the cache is returned
    del lm, params, state
    free_device_memory()
    return losses


def replicated_checksums(model) -> torch.Tensor:
    """Two int64 sums a replicated leaf (the embedding, the final norm, an
    untied head): its bytes as int16, plain and position-weighted."""
    sums = []
    for name, p in model.named_parameters():
        if ".blocks." in name:
            continue
        w = p.detach().contiguous().view(torch.int16).reshape(-1)
        plain = weighted = 0
        # 2^24 elements at a time: four ranks widening the whole embedding to
        # int64 at once would not fit beside their training state
        for start in range(0, w.numel(), 2**24):
            c = w[start:start + 2**24].to(torch.int64)
            pos = torch.arange(start, start + c.numel(), device=w.device) % 65521
            plain, weighted = plain + c.sum(), weighted + (c * pos).sum()
        sums += [plain, weighted]
    return torch.stack(sums)


def pp_3b_rank(rank, dev, args) -> dict:
    """make_pipeline_train_step at pp=2 x dp=2 on the 3B text widths (4 + 4
    layers): 3 steps, the replicated leaves compared over pp and dp after
    each."""
    mesh = create_mesh(dp=2, pp=PP_STAGES)
    tc = pp_3b_config()
    model = one_rank_at_a_time(rank, dev, lambda: pipeline_shard_params(pp_model(dev), mesh))
    batch = {k: data_sharding(mesh).local(v).contiguous() for k, v in pp_batch(dev).items()}
    init_state, step = make_pipeline_train_step(tc, mesh, PP_MICRO, learning_rate=PP_LR,
                                                loss_chunk=PP_CHUNK)
    state = init_state(model)
    out = {"losses": [], "equal": [], "times": []}
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counters()
    with record_shapes() as rec:
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            out["times"].append(time.perf_counter() - t)
            out["losses"].append(loss.item())
            sums = replicated_checksums(state.model)
            out["equal"].append(same_on_every_rank(mesh, sums, AXIS_PP)
                                and same_on_every_rank(mesh, sums, AXIS_DP))
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    faults = path_faults("pp_full_ft_3b", launches, plain_calls)
    per_step = (PP_MICRO + PP_STAGES - 1) * len(state.model.model.blocks)
    want = {k: 3 * per_step for k in ("swiglu_tc", "swiglu_bwd_tc") + RING_KERNELS}
    faults += [f"{k} launched {launches[k]} times, not {n}" for k, n in want.items()
               if launches[k] != n]
    for entry in ("fused_swiglu_cuda", "fused_swiglu_bwd_cuda"):
        if rec.weights(entry) != {(8192, 3072)}:
            faults.append(f"{entry} at {sorted(rec.weights(entry))}, not [(8192, 3072)]")
    heads = rec.heads(RING_KERNELS)
    if heads != {(24, 8)}:
        faults.append(f"flash LSE forward and backward at heads {sorted(heads)}, not [(24, 8)]")
    log(f"[pp_full_ft_3b rank {rank}] stage {mesh.rank(AXIS_PP)} layers "
        f"{state.model.model.stage.first_layer}-"
        f"{state.model.model.stage.first_layer + len(state.model.model.blocks) - 1}; SwiGLU at "
        f"{sorted(rec.weights('fused_swiglu_cuda'))}; flash heads {sorted(heads)}; launches "
        f"{({k: launches[k] for k in want})} (want {want})")
    out.update(launches=launches, faults=faults,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def run_pp_full_ft_3b() -> dict:
    """pp_full_ft_3b: the unpipelined kernel and ``impl="torch"`` runs on one
    device first, then the four ranks; each pipelined loss within twice the
    two unpipelined runs' distance at its step, the replicated leaves
    bit-equal on every rank after every step, the kernels' exact launches at
    the stage's shapes."""
    dev = torch.device("cuda", 0)
    kernel, plain = pp_unpipelined(dev, "auto"), pp_unpipelined(dev, "torch")
    log(f"[pp_full_ft_3b] unpipelined one-device losses: kernel path {kernel}, impl='torch' "
        f"{plain}")
    res = run_tp_world("pp_full_ft_3b", "pp_3b", {}, world=2 * PP_STAGES)
    faults = [f"rank {r}: {f}" for r, one in enumerate(res) for f in one["faults"]]
    if any(one["losses"] != res[0]["losses"] for one in res):
        faults.append(f"the ranks' losses differ: {[one['losses'] for one in res]}")
    if not all(all(one["equal"]) for one in res):
        faults.append(f"replicated leaves differ across ranks: {[one['equal'] for one in res]}")
    dist_ = [abs(a - b) for a, b in zip(res[0]["losses"], kernel)]
    bound_ = [2 * abs(a - b) for a, b in zip(kernel, plain)]
    if not all(d <= b for d, b in zip(dist_, bound_)):
        faults.append(f"pipelined losses {res[0]['losses']} are {dist_} from the unpipelined "
                      f"kernel path's {kernel}: over twice its distance from impl='torch' "
                      f"({bound_})")
    ms = 1e3 * statistics.median(res[0]["times"])
    log(f"[pp_full_ft_3b] ({ZERO1_DEPTH['decoder']} decoder layers of the 3B bench config, "
        f"{PP_STAGES} stages) pipelined losses {res[0]['losses']}: {[f'{d:.6g}' for d in dist_]} "
        f"from the unpipelined kernel path (limits {[f'{b:.6g}' for b in bound_]}); replicated "
        f"leaves equal on every rank after every step")
    log(f"[pp_full_ft_3b] rank 0: steps (s) {[round(x, 4) for x in res[0]['times']]}, median "
        f"{ms:.2f} ms/step ({PP_BATCH * 1632 / ms * 1e3:.1f} tokens/s; four ranks sharing one "
        f"card over gloo, not multi-GPU times); bubble share (pp-1)/(M+pp-1) = "
        f"{(PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1):.4f}; peak a rank "
        f"{[round(one['peak_gib'], 3) for one in res]} GiB; rank 0 launches "
        f"{({k: n for k, n in res[0]['launches'].items() if n})}")
    if faults:
        raise RuntimeError(f"[pp_full_ft_3b] {faults}")
    return res[0]["launches"]


TP_PHASES = {"tp_tiny": tp_tiny_rank, "tp_tiny_dp": tp_tiny_dp_rank, "tp_11b": tp_11b_rank,
             "tp_dp_server_11b": tp_dp_server_11b_rank,
             "tp_lora_11b": tp_lora_11b_rank, "zero1_3b": zero1_3b_rank,
             "sp_lora_11b": sp_lora_11b_rank, "pp_3b": pp_3b_rank}


def run_11b_paths(dev, keep: dict) -> dict:
    """The bf16 path (tied head) and its server, then int8 and int4-mixed
    quantized copies of one untied bf16 model, each served from an int8 KV
    cache; the int4-mixed copy also through the server with the W4A8 gemv.
    ``keep`` takes the bf16 and int4-mixed generates' prefill logits and
    tokens (``run_11b``)."""
    by_path, tokens, metrics = {}, {}, {}
    cfg, model = build_11b(dev, tie_weights=True)
    by_path["bf16"] = run_11b(dev, cfg, model, "bf16", keep=keep)
    by_path["server_bf16"] = run_server(dev, cfg, model, "server_bf16", tokens=tokens,
                                        metrics=metrics, profile_step=True)
    prefix, reqs = prefix_requests(cfg, dev)
    by_path["server_bf16_prefix"] = run_server(dev, cfg, model, "server_bf16_prefix",
                                               tokens=tokens, metrics=metrics, prefix=prefix,
                                               reqs=reqs)
    by_path["http_bf16"] = run_http(dev, cfg, model, tokens, metrics)
    bank = server_bank(cfg, dev)
    by_path["server_bf16_lora"] = run_server(dev, cfg, model, "server_bf16_lora", tokens=tokens,
                                             metrics=metrics, adapter_bank=bank,
                                             profile_step=True)
    del bank
    free_device_memory()
    plain, pre, lora = (metrics[k] for k in ("server_bf16", "server_bf16_prefix",
                                             "server_bf16_lora"))
    log(f"[server_bf16_prefix] ms per admission {pre['admit_ms']:.4f} against server_bf16's "
        f"unprefixed {plain['admit_ms']:.4f} ({plain['admit_ms'] / pre['admit_ms']:.2f}x); "
        f"decode {pre['tok_s']:.2f} tok/s against {plain['tok_s']:.2f}")
    log(f"[server_bf16_lora] against server_bf16: ms per decode step (8 busy) "
        f"{lora['step_ms']:.4f} / {plain['step_ms']:.4f}; kernel ms a step "
        f"{lora['kernel_ms']:.4f} / {plain['kernel_ms']:.4f}; kernel launches a step "
        f"{lora['launches']:.1f} / {plain['launches']:.1f}; decode {lora['tok_s']:.2f} / "
        f"{plain['tok_s']:.2f} tok/s; peak {lora['peak_gib']:.3f} / {plain['peak_gib']:.3f} GiB")
    by_path["swiglu_down_op"] = run_swiglu_down_op(dev, model)
    by_path["bf16_spec_lookup"], plain = run_11b_spec(dev, cfg, model, "bf16_spec_lookup",
                                                      dict(spec_lookup=4))
    draft, dcfg = llama32_1b_draft(dev)
    by_path["bf16_spec_draft"], _ = run_11b_spec(
        dev, cfg, model, "bf16_spec_draft", dict(spec_draft=4, draft_params=draft,
                                                  draft_config=dcfg), want_tokens=plain)
    del draft
    free_device_memory()
    # information: the 11B's own decoder as the draft; a low acceptance points
    # at bits that depend on the rows of a call (the verify's K+1 against 1)
    run_11b_spec(dev, cfg, model, "bf16_spec_self_draft",
                 dict(spec_draft=4, draft_params=model.language_model,
                      draft_config=cfg.text_config), image=False)
    by_path["server_bf16_spec"] = run_server(dev, cfg, model, "server_bf16_spec",
                                             spec_lookup=3, tokens=tokens)
    spec_server_rows_witness(dev, cfg, model, tokens)
    free_device_memory()
    by_path.update(run_eval_11b(dev, cfg, model))
    del model
    free_device_memory()
    cfg, model = build_11b(dev, tie_weights=False)
    for path, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=128, recipe=INT4_MIXED_RECIPE))):
        t = time.perf_counter()
        qmodel = quantize_llama_params(model, **kw)
        torch.cuda.synchronize()
        log(f"[{path}] quantize {time.perf_counter() - t:.3f} s, "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats()
        by_path[path] = run_11b(dev, cfg, qmodel, path, kv_dtype="int8", keep=keep)
        if path == "int4_mixed":
            prev, gemv_mod._INT4_VARIANT = gemv_mod._INT4_VARIANT, "w4a8"
            try:
                by_path["server_int4_w4a8"] = run_server(dev, cfg, qmodel, "server_int4_w4a8",
                                                         kv_dtype="int8")
            finally:
                gemv_mod._INT4_VARIANT = prev
            int4_variant_ab(dev, cfg, qmodel)
        free_device_memory()
        by_path[f"qlora_11b_{path}"] = run_qlora_11b(dev, cfg, qmodel, f"qlora_11b_{path}")
        del qmodel
        free_device_memory()
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    free_device_memory()
    tiny_quantized = check_tiny_paths_agree(dev)
    check_tiny_server(dev)
    check_tiny_spec(dev)
    check_tiny_prefix(dev)
    check_tiny_bank(dev)
    check_tiny_http(dev)
    check_tiny_training(dev)
    check_tiny_bf16_lora(dev)
    finetune_cli = run_finetune_cli_tiny(dev)
    wrapper_profiling = run_wrapper_profiling(dev)
    free_device_memory()
    vit_h_fp32 = run_vit_h_fp32(dev)
    fp32_autograd = run_fp32_autograd(dev)
    free_device_memory()
    tp_reference = {}
    by_path = run_11b_paths(dev, tp_reference)
    by_path["finetune_cli_tiny"] = finetune_cli
    by_path["wrapper_profiling"] = wrapper_profiling
    by_path.update(tiny_quantized)
    by_path["vit_h_fp32"] = vit_h_fp32
    by_path["fp32_autograd"] = fp32_autograd
    free_device_memory()
    by_path.update(run_load_11b(dev))
    free_device_memory()
    by_path["lora_11b"] = run_lora_11b(dev, tp_reference)
    free_device_memory()
    by_path["full_ft_3b"] = run_full_ft_3b(dev)
    free_device_memory()
    by_path.update(run_tp_tiny(dev))
    free_device_memory()
    by_path.update(run_tp_11b(tp_reference))
    by_path["tp_dp_server_11b"] = run_tp_dp_server_11b()
    by_path["tp_lora_11b"] = run_tp_lora_11b(tp_reference)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="zero1_3b_", dir=root) as tmp_dir:
        by_path["zero1_full_ft_3b"] = run_zero1_full_ft_3b(tmp_dir)
    by_path["sp_lora_11b"] = run_sp_lora_11b(tp_reference)
    by_path["pp_full_ft_3b"] = run_pp_full_ft_3b()
    log(f"all phases {time.perf_counter() - t_start:.1f} s")

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
