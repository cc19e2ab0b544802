"""Serving: the engine, the continuous-batching server and (imported on
first use, as in the JAX package) the HTTP front end."""

from llama32mm_tpu_torch.inference.engine import (
    InferenceEngine,
    build_decode_mask,
    build_prefill_mask,
    structured_decode_mask,
    structured_prefill_mask,
)
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer


def __getattr__(name):
    # the HTTP front end pulls in http.server and threading only when serving
    if name == "ServingFrontend":
        from llama32mm_tpu_torch.inference.http_server import ServingFrontend

        return ServingFrontend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "InferenceEngine",
    "ContinuousBatchingServer",
    "ServingFrontend",
    "build_decode_mask",
    "build_prefill_mask",
    "structured_decode_mask",
    "structured_prefill_mask",
]
