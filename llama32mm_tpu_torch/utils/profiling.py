"""Tracing and timing (counterpart of ``llama32mm_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where the card is present) that writes a
  Chrome trace into ``log_dir`` on exit; the profiler object is yielded, so
  its ``key_averages()`` can be read after the block;
- ``annotate(name)``: while a profiler runs, a named region in its trace
  (``torch.profiler.record_function``) and, on the card, an NVTX range of
  the same name; no work at all otherwise. The model names three phases, as the JAX package does:
  ``"vision_encode"`` and ``"mm_projector"`` (``models/vlm.py::
  encode_image``) and ``"image_splice"`` (``vlm_forward``);
- ``Timer``: repeat timing whose sync point is a device-to-host fetch of the
  first output tensor (the JAX package's reliable sync), with the median of
  each name's samples.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str = "cuda"):
    """Profile the block and write ``log_dir/trace.json`` (Chrome trace
    format, open it in Perfetto or ``chrome://tracing``). ``device="cpu"``
    records the host only; ``"cuda"`` (needs a card) the kernels too."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda') needs a CUDA device; pass device='cpu'")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Name a region in profiler traces: ``with annotate("prefill"): ...``.
    Outside a profiler it does nothing, as ``jax.named_scope`` costs nothing
    at run time: the model's phases stay free while tracing is off."""
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for leaf in out:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def _fetch(out):
    """Copy the first output tensor to the host (blocks until it exists)."""
    t = _first_tensor(out)
    if t is not None:
        t.detach().to("cpu")


class Timer:
    """Repeat-timing harness with a device→host fetch as the sync point."""

    def __init__(self, sync: Optional[Callable] = None):
        self._sync = sync or _fetch
        self.records: Dict[str, List[float]] = {}

    def measure(self, name: str, fn: Callable, *args, warmup: int = 2, iters: int = 5):
        for _ in range(warmup):
            self._sync(fn(*args))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self._sync(fn(*args))
            times.append(time.perf_counter() - t0)
        self.records.setdefault(name, []).extend(times)
        return float(np.percentile(times, 50))

    def report(self) -> Dict[str, float]:
        return {k: float(np.percentile(v, 50)) for k, v in self.records.items()}
