"""Profile one decode chunk of the continuous-batching server on one NVIDIA
GPU with every slot busy: the ``server_bf16`` and ``server_int4_w4a8``
configurations of ``chip_smoke.py`` (11B shapes, S_max 2048, 8 image
requests of S = 1632 admitted together), and the bf16 model with one slot
and one request (a B=1 decode step).

    python3 profile_serve.py

For each it admits the requests (one ``step()``), then, as
``profile_train.py`` does for a training step, times one 8-step decode chunk
without the profiler and one under ``torch.profiler``, and prints the
kernels' device time by category, the busy share and the launches.
"""

from __future__ import annotations

import subprocess

import torch

import chip_smoke as cs
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops import gemv as gemv_mod
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE
from profile_train import profile_step

STEPS = 8


def profile_chunk(dev, cfg, model, label: str, kv_dtype=None, slots: int = 8) -> None:
    srv = ContinuousBatchingServer(model, cfg, dev, slots=slots, max_cache_length=2048,
                                   kv_dtype=kv_dtype)
    for ids, px, _ in cs.server_requests(cfg, dev, slots):
        srv.submit(ids, px, max_new_tokens=2048 - 1664)  # budgets that outlast the profile
    srv.step()  # admits every request, then one decode chunk
    if srv.stats()["slots_busy"] != slots:
        raise RuntimeError(f"expected {slots} busy slots, got {srv.stats()}")
    profile_step(label, lambda: srv._decode(STEPS), slots * STEPS)


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cs.build_library()
    cfg, model = cs.build_11b(dev, tie_weights=True)
    profile_chunk(dev, cfg, model, f"server_bf16, one {STEPS}-step decode chunk")
    profile_chunk(dev, cfg, model, f"bf16, one slot (B=1), one {STEPS}-step decode chunk", slots=1)
    del model
    torch.cuda.empty_cache()
    cfg, model = cs.build_11b(dev, tie_weights=False)
    qmodel = quantize_llama_params(model, bits=4, group_size=128, recipe=INT4_MIXED_RECIPE,
                                   free_originals=True)
    gemv_mod._INT4_VARIANT = "w4a8"
    profile_chunk(dev, cfg, qmodel, f"server_int4_w4a8, one {STEPS}-step decode chunk",
                  kv_dtype="int8")


if __name__ == "__main__":
    main()
