"""Weight download CLI (counterpart of ``llama32mm_tpu/io/download.py``).

A thin CLI over ``huggingface_hub.snapshot_download`` with an access
pre-check and a gated-model hint, as the reference's
``Model/download_weights.py``. Flags: ``--model-id`` (default
Llama-3.2-11B-Vision-Instruct), ``--output-dir``, ``--token``, ``--revision``,
``--ignore-patterns`` (default excludes ``*.pt``, ``*.bin``, ``original/*`` so
only safetensors download).

Usage: ``python -m llama32mm_tpu_torch.io.download --output-dir weights/11b``.
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_MODEL_ID = "meta-llama/Llama-3.2-11B-Vision-Instruct"
DEFAULT_IGNORE = ["*.pt", "*.bin", "original/*"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Download HF safetensors weights.")
    parser.add_argument("--model-id", default=DEFAULT_MODEL_ID)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--token", default=None, help="HF access token (gated models).")
    parser.add_argument("--revision", default=None)
    parser.add_argument(
        "--ignore-patterns",
        nargs="*",
        default=DEFAULT_IGNORE,
        help="Glob patterns to skip (default: everything but safetensors).",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        from huggingface_hub import HfApi, snapshot_download
    except ImportError:
        sys.exit("huggingface_hub is required for downloading weights.")

    api = HfApi(token=args.token)
    try:
        info = api.model_info(args.model_id, revision=args.revision)
    except Exception as e:  # gated / missing / offline
        sys.exit(
            f"Cannot access '{args.model_id}': {e}\n"
            "If this is a gated model, request access on huggingface.co and pass --token."
        )
    size_gb = sum(
        (f.size or 0) for f in (info.siblings or []) if f.rfilename.endswith(".safetensors")
    ) / 1e9
    if size_gb:
        print(f"Downloading ~{size_gb:.0f} GB of safetensors from {args.model_id} …")

    path = snapshot_download(
        args.model_id,
        local_dir=args.output_dir,
        token=args.token,
        revision=args.revision,
        ignore_patterns=args.ignore_patterns,
    )
    print(f"Done: {path}")


if __name__ == "__main__":
    main()
