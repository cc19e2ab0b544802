"""The port's command lines against the JAX package's, on one tiny
checkpoint that the JAX package wrote beside the trained
``tests/assets/tiny_tokenizer`` and a seeded PNG image: ``load_hf_model``,
the inference CLI (the same printed text as the JAX CLI, fp32, ``--cpu``,
greedy; plain, prompt-lookup and int8 quantize-on-load), the draft-model
path, the CLI's errors, and the HTTP server's ``main()`` on port 0 serving
one request and draining."""

import base64
import dataclasses
import json
import os
import shutil
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llama32mm_tpu.configs import LLAMA32Config, MLLAMAConfig, VisionEncoderConfig
from llama32mm_tpu.inference import cli as jax_cli
from llama32mm_tpu.io import download as jax_download
from llama32mm_tpu.io import checkpoint as jck
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu_torch.convert import from_jax_params
from llama32mm_tpu_torch.inference import cli, http_server
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.io import download
from llama32mm_tpu_torch.io.checkpoint import load_hf_model
from llama32mm_tpu_torch.preprocess.processor import MllamaImageProcessor

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny_tokenizer")


def _jax_config():
    return MLLAMAConfig(
        vision_config=VisionEncoderConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=28, patch_size=14,
        ),
        text_config=LLAMA32Config(
            vocab_size=1280, hidden_size=64, n_heads=4, n_layers=2,
            hidden_dim=96, n_kv_groups=2, dtype="float32", max_cache_length=128,
        ),
        projection_dim=64, hidden_size=64, image_token_index=1024, vocab_size=1280,
    )


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(checkpoint dir with the tokenizer files, PNG path)."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = _jax_config()
    params = init_vlm_params(jax.random.PRNGKey(0), cfg, tie_weights=False)
    jck.save_checkpoint_params(str(tmp / "model"), params, cfg)
    for f in os.listdir(ASSET):
        shutil.copy(os.path.join(ASSET, f), tmp / "model" / f)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8)).save(tmp / "img.png")
    return str(tmp / "model"), str(tmp / "img.png")


def _argv(checkpoint, *extra):
    model_dir, img = checkpoint
    return ["--image", img, "--prompt", "what is in this image?", "--hf-weights", model_dir,
            "--cpu", "--dtype", "float32", "--max-new-tokens", "8", *extra]


def test_parse_args_match_jax(checkpoint):
    """The inference CLI's flags and defaults, and the download CLI's (never
    run here: it needs the network)."""
    for argv in (_argv(checkpoint), ["--image", "x", "--prompt", "y"],
                 _argv(checkpoint, "--quantize", "int4", "--spec-draft", "3",
                       "--draft-weights", "d", "--top-k", "5", "--seed", "3")):
        assert vars(cli.parse_args(argv)) == vars(jax_cli.parse_args(argv))
    for argv in (["--output-dir", "w"], ["--output-dir", "w", "--model-id", "m", "--token", "t",
                                         "--revision", "r", "--ignore-patterns", "*.bin"]):
        assert vars(download.parse_args(argv)) == vars(jax_download.parse_args(argv))


def test_load_hf_model_matches_jax(checkpoint):
    """The head is tied (the untied checkpoint head is dropped, as in the
    JAX package); the report, tokenizer and every weight equal JAX's."""
    model_dir, _ = checkpoint
    model, tok, report = load_hf_model(model_dir, "cpu", dtype="float32", return_report=True)
    jmodel, jtok, jreport = jck.load_hf_model(model_dir, dtype="float32", return_report=True)
    assert dataclasses.asdict(report) == dataclasses.asdict(jreport)
    assert model.language_model.lm_head is None
    assert tok.vocab_size == jtok.vocab_size == 1024 and tok.pad_token_id == jtok.pad_token_id
    assert model.config.text_config.pad_token_index == tok.pad_token_id
    want = from_jax_params(jax.tree.map(np.asarray, jmodel.params), model.config, "cpu")
    a, b = model.state_dict(), want.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("extra", [(), ("--spec-lookup", "2"), ("--quantize", "int8")])
def test_cli_prints_the_jax_cli_text(extra, checkpoint, capsys):
    """``main`` prints what the JAX CLI prints: the loading line and the
    generated text (greedy)."""
    argv = _argv(checkpoint, *extra)
    jax_cli.main(argv)
    want = capsys.readouterr().out
    cli.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("Loading model from: ")


def test_cli_draft_model_equals_plain(checkpoint):
    """``--spec-draft`` with ``--draft-weights`` (the checkpoint itself as
    the draft): greedy text equal to the plain run's."""
    plain = cli.run_custom_inference(cli.parse_args(_argv(checkpoint)))
    spec = cli.run_custom_inference(cli.parse_args(
        _argv(checkpoint, "--spec-draft", "2", "--draft-weights", checkpoint[0])))
    assert spec == plain and isinstance(plain, str)


def test_cli_errors(checkpoint, tmp_path):
    with pytest.raises(SystemExit, match="--hf-weights directory not found"):
        cli.run_custom_inference(cli.parse_args(
            _argv((str(tmp_path / "none"), checkpoint[1]))))
    with pytest.raises(SystemExit, match="Image not found"):
        cli.load_image(str(tmp_path / "none.png"))
    with pytest.raises(SystemExit, match="--spec-draft needs --draft-weights"):
        cli.run_custom_inference(cli.parse_args(_argv(checkpoint, "--spec-draft", "2")))


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_main_serves_then_drains(checkpoint, monkeypatch, capsys):
    """``main()`` loads the checkpoint, serves on port 0 until a stubbed
    ``serve_forever`` raises ``KeyboardInterrupt`` after one answered
    request, then drains; the answer equals a solo engine's tokens on the
    processor's inputs."""
    from PIL import Image

    model_dir, img = checkpoint
    bound, answered, replies = threading.Event(), threading.Event(), []
    real_serve_forever = http_server.serve_forever

    def stub(frontend, host, port):
        httpd = real_serve_forever(frontend, host, port)
        httpd.timeout = 0.05

        def serve():
            bound.port = httpd.server_address[1]
            bound.set()
            while not answered.is_set():
                httpd.handle_request()
            raise KeyboardInterrupt

        httpd.serve_forever = serve
        return httpd

    with open(img, "rb") as f:
        body = {"prompt": "what is in this image?", "image": base64.b64encode(f.read()).decode(),
                "max_new_tokens": 4}

    def client():
        bound.wait(timeout=120)
        try:
            if hasattr(bound, "port"):  # main() bound the server
                replies.append(_post(bound.port, body))
        finally:
            answered.set()

    monkeypatch.setattr(http_server, "serve_forever", stub)
    thread = threading.Thread(target=client)
    thread.start()
    try:
        http_server.main(["--hf-weights", model_dir, "--cpu", "--dtype", "float32", "--port",
                          "0", "--host", "127.0.0.1", "--slots", "2", "--max-cache-length",
                          "128"])
    finally:
        bound.set()  # releases the client if main() failed before serving
    thread.join(timeout=120)
    assert not thread.is_alive()
    out = capsys.readouterr().out
    assert "serving on 127.0.0.1:" in out and out.rstrip().endswith("draining...")
    (status, reply), = replies
    assert status == 200 and reply["finished"]

    model, tok = load_hf_model(model_dir, "cpu", dtype="float32")
    proc = MllamaImageProcessor(tok, model.config.text_config.num_image_tokens,
                                model.config.vision_config.image_size)
    inputs = proc(["what is in this image?"], [Image.open(img).convert("RGB")], padding=True)
    res = InferenceEngine(model, model.config, "cpu", max_cache_length=128).generate(
        inputs["input_ids"], inputs["pixel_values"], max_new_tokens=4,
        eos_token_id=tok.eos_token_id)
    assert reply["tokens"] == res.tokens[0, : int(res.num_generated[0])].tolist()
