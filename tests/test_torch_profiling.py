"""The port's tracing and timing (``utils/profiling.py``) on the CPU: a trace
of a tiny VLM forward names the JAX package's three phases, ``annotate``
names a region, ``Timer`` syncs on a device-to-host fetch of the first
output and reports medians."""

import json
import os

import numpy as np
import pytest
import torch

from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.utils import profiling
from llama32mm_tpu_torch.utils.profiling import Timer, annotate, trace

PHASES = ("vision_encode", "mm_projector", "image_splice")


def _event_names(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    cfg = tiny_mllama_config()
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))
    ids = torch.randint(0, 240, (1, 10), generator=torch.Generator().manual_seed(1))
    ids[:, :4] = cfg.image_token_index
    px = torch.randn(1, 3, 28, 28, generator=torch.Generator().manual_seed(2))
    log_dir = str(tmp_path_factory.mktemp("trace"))
    with torch.inference_mode(), trace(log_dir, device="cpu") as prof:
        with annotate("my_region"):
            out = vlm_forward(model, cfg, input_ids=ids, pixel_values=px)
    return log_dir, prof, out


@pytest.mark.parametrize("phase", PHASES)
def test_trace_names_the_phases(traced, phase):
    log_dir, prof, out = traced
    assert phase in _event_names(log_dir)
    assert phase in {e.key for e in prof.key_averages()}
    assert torch.isfinite(out.logits).all()


def test_annotate_names_a_region(traced):
    assert "my_region" in _event_names(traced[0])


def test_annotate_outside_a_profiler_does_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("annotate opened a region while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    with annotate("idle"):
        pass


def test_text_only_forward_has_no_image_phases(tmp_path):
    cfg = tiny_mllama_config()
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.inference_mode(), trace(str(tmp_path), device="cpu"):
        vlm_forward(model, cfg, input_ids=torch.zeros(1, 4, dtype=torch.long))
    assert not set(PHASES) & _event_names(str(tmp_path))


def test_trace_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path)):
            pass
    with pytest.raises(ValueError, match="device"):
        with trace(str(tmp_path), device="tpu"):
            pass


def test_timer_syncs_on_the_first_output_and_reports_medians(monkeypatch):
    fetched = []
    real = profiling._fetch

    def spy(out):
        fetched.append(profiling._first_tensor(out))
        real(out)

    monkeypatch.setattr(profiling, "_fetch", spy)
    timer = Timer()
    a, b = torch.ones(3), torch.zeros(2)
    med = timer.measure("pair", lambda x: ({"first": x, "second": b}, None), a, warmup=1,
                        iters=3)
    assert len(fetched) == 4 and all(t is a for t in fetched)
    assert med > 0 and len(timer.records["pair"]) == 3
    timer.measure("pair", lambda: a, warmup=0, iters=2)
    rep = timer.report()
    assert set(rep) == {"pair"} and rep["pair"] == float(np.percentile(timer.records["pair"], 50))


def test_timer_takes_a_custom_sync():
    calls = []
    timer = Timer(sync=calls.append)
    timer.measure("f", lambda: 7, warmup=2, iters=2)
    assert calls == [7, 7, 7, 7]
