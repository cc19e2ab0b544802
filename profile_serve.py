"""Profile one decode chunk of the continuous-batching server on one NVIDIA
GPU with every slot busy: the ``server_bf16`` and ``server_int4_w4a8``
configurations of ``chip_smoke.py`` (11B shapes, S_max 2048, 8 image
requests of S = 1632 admitted together), and with one slot and one request
(a B=1 decode step) the bf16 model and its copy quantized to int8 with the
int8 KV cache (the int8 generate of ``chip_smoke.py``).

    python3 profile_serve.py              # all four, the bf16 ones also with spec_lookup
    python3 profile_serve.py --quantized  # the int8 one-slot step and server_int4_w4a8

For each it admits the requests (one ``step()``), then, as
``profile_train.py`` does for a training step, times one 8-step decode chunk
without the profiler and one under ``torch.profiler``, and prints the
kernels' device time by category, the busy share, the launches and the
kernels' device time per decode step. Run it on two commits in one call to
compare them. ``server_bf16`` and the bf16 slot run twice, plain and then
with prompt lookup (``spec_lookup`` 3 with 8 slots, 4 with one), where a
decode step is a verify step of K+1 rows a slot; that run also prints the
tokens each chunk committed (its tokens/s line counts one a slot a step).
"""

from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke as cs
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops import gemv as gemv_mod
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE
from profile_train import profile_step

STEPS = 8


def profile_chunk(dev, cfg, model, label: str, kv_dtype=None, slots: int = 8,
                  spec_lookup: int = 0) -> None:
    srv = ContinuousBatchingServer(model, cfg, dev, slots=slots, max_cache_length=2048,
                                   kv_dtype=kv_dtype, spec_lookup=spec_lookup)
    for ids, px, _ in cs.server_requests(cfg, dev, slots):
        srv.submit(ids, px, max_new_tokens=2048 - 1664)  # budgets that outlast the profile
    srv.step()  # admits every request, then one decode chunk
    if srv.stats()["slots_busy"] != slots:
        raise RuntimeError(f"expected {slots} busy slots, got {srv.stats()}")
    committed = []

    def chunk():
        out = srv._decode(STEPS)
        if spec_lookup:
            committed.append(int(out[1].sum()))

    total = profile_step(label, chunk, slots * STEPS)
    print(f"== {label}: kernel time per decode step {total / STEPS:.4f} ms")
    if spec_lookup:
        print(f"== {label}: committed tokens per chunk {committed} "
              f"({committed[-1] / (slots * STEPS):.4f} a slot a verify step in the profiled one)")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cs.build_library()
    if "--quantized" not in sys.argv[1:]:
        cfg, model = cs.build_11b(dev, tie_weights=True)
        for slots, k in ((8, 3), (1, 4)):
            name = "server_bf16" if slots == 8 else "bf16, one slot (B=1)"
            profile_chunk(dev, cfg, model, f"{name}, one {STEPS}-step decode chunk", slots=slots)
            profile_chunk(dev, cfg, model, f"{name} spec_lookup={k}, one {STEPS}-step verify chunk",
                          slots=slots, spec_lookup=k)
        del model
        torch.cuda.empty_cache()
    cfg, model = cs.build_11b(dev, tie_weights=False)
    qmodel = quantize_llama_params(model, bits=8)
    profile_chunk(dev, cfg, qmodel, f"int8, one slot (B=1), one {STEPS}-step decode chunk",
                  kv_dtype="int8", slots=1)
    del qmodel
    torch.cuda.empty_cache()
    qmodel = quantize_llama_params(model, bits=4, group_size=128, recipe=INT4_MIXED_RECIPE,
                                   free_originals=True)
    gemv_mod._INT4_VARIANT = "w4a8"
    profile_chunk(dev, cfg, qmodel, f"server_int4_w4a8, one {STEPS}-step decode chunk",
                  kv_dtype="int8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
