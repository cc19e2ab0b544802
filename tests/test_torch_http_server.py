"""The port's HTTP front end over its continuous-batching server, on the
tiny fp32 config on the CPU (the cases of the JAX package's
``test_http_server.py`` and ``test_serving_robustness.py`` but its text and
image surface, which needs the prompt processor): ``/generate`` gives a
solo engine's tokens, concurrent calls and ``/submit`` + ``/result``,
``/stats``, ``/prefix`` and ``DELETE /prefix``, SSE streaming and
cancel-on-disconnect, ``DELETE /request``, ``adapter_id`` and
``timeout_s`` in the body, 429 on a full queue and while draining, 400 and
404 answers, and the drain. Every connection, wait and join has a time
limit, and each fixture shuts its HTTP server and front end down."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from llama32mm_tpu import tiny_mllama_config as jax_tiny_config
from llama32mm_tpu.models.vlm import init_vlm_params
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax
from llama32mm_tpu_torch.inference import http_server
from llama32mm_tpu_torch.inference.engine import InferenceEngine
from llama32mm_tpu_torch.inference.http_server import ServingFrontend, serve_forever
from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer, QueueFullError
from llama32mm_tpu_torch.train import init_lora_params, stack_adapter_bank, zero_lora_params
from llama32mm_tpu_torch.train.lora import merge_lora_into_params

MAX_LEN = 64
TIMEOUT = 30  # seconds, for every connection, wait and join
PX = np.random.RandomState(0).randn(3, 28, 28).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_config()
    params = init_vlm_params(jax.random.PRNGKey(2), jcfg, tie_weights=False)
    cfg = tiny_mllama_config()
    return cfg, from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")


class _Live:
    """A server, its front end and an HTTP server on a free loopback port,
    served from a thread."""

    def __init__(self, tiny, **kw):
        cfg, model = tiny
        kw = {"slots": 2, "max_cache_length": MAX_LEN, "prompt_buckets": None,
              "eos_token_id": -1, "steps_per_sync": 3, **kw}
        self.srv = ContinuousBatchingServer(model, cfg, "cpu", **kw)
        self.frontend = ServingFrontend(self.srv)
        self.httpd = serve_forever(self.frontend, host="127.0.0.1", port=0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.frontend.shutdown()
        self.thread.join(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def live(tiny):
    lv = _Live(tiny)
    yield lv
    lv.close()


def _request(port, method, path, obj=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        if obj is None:
            conn.request(method, path)
        else:
            conn.request(method, path, json.dumps(obj), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _ids(s, seed, image=False):
    ids = np.random.RandomState(seed).randint(0, 240, s)
    if image:
        ids[:4] = 250
    return ids


def _solo(tiny, ids, px, n, model=None):
    cfg, base = tiny
    eng = InferenceEngine(model or base, cfg, "cpu", max_cache_length=MAX_LEN)
    px = None if px is None else torch.as_tensor(px)[None]
    out = eng.generate(torch.as_tensor(ids)[None], px, max_new_tokens=n)
    return out.tokens[0, :int(out.num_generated[0])].tolist()


def _wait_idle(port):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        st = _request(port, "GET", "/stats")[1]
        if st["slots_busy"] == 0 and st["queued"] == 0:
            return st
        time.sleep(0.02)
    pytest.fail(f"the server stayed busy: {st}")


def _read_events(resp):
    """``(streamed tokens, final event, number of events)`` of an SSE reply."""
    streamed, final, events = [], None, 0
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        ev = json.loads(line[len("data: "):])
        events += 1
        if ev.get("finished"):
            final = ev
            break
        streamed.extend(ev["tokens"])
    return streamed, final, events


def test_generate_matches_solo_engine(tiny, live):
    ids = _ids(11, 1, image=True)
    status, out = _request(live.port, "POST", "/generate", {
        "input_ids": ids.tolist(), "pixel_values": PX.tolist(), "max_new_tokens": 6})
    assert status == 200 and out["finished"] and "timed_out" not in out
    assert out["tokens"] == _solo(tiny, ids, PX, 6)


def test_concurrent_requests_and_stats(tiny, live):
    ids = _ids(9, 3)
    results = {}

    def call(tag, n):
        results[tag] = _request(live.port, "POST", "/generate",
                                {"input_ids": ids.tolist(), "max_new_tokens": n})

    threads = [threading.Thread(target=call, args=(i, 4 + i)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    want = _solo(tiny, ids, None, 6)
    for tag in range(3):
        status, out = results[tag]
        assert status == 200 and out["finished"], (tag, out)
        assert out["tokens"] == want[:4 + tag]
    status, st = _request(live.port, "GET", "/stats")
    assert status == 200 and st["finished"] >= 3 and st["slots"] == 2


def test_async_submit_and_result(live):
    status, out = _request(live.port, "POST", "/submit",
                           {"input_ids": _ids(10, 5).tolist(), "max_new_tokens": 5})
    assert status == 200
    rid = out["request_id"]
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        status, res = _request(live.port, "GET", f"/result/{rid}")
        assert status == 200 and res["request_id"] == rid
        if res["finished"]:
            break
        time.sleep(0.01)
    assert res["finished"] and len(res["tokens"]) == 5


@pytest.mark.parametrize("method,path,body,code,text", [
    ("POST", "/generate", {"max_new_tokens": 4}, 400, "prompt"),
    ("POST", "/generate", {"prompt": "hi", "max_new_tokens": 3}, 400, "tokenizer"),
    ("POST", "/generate", {"prompt": "hi", "image": "AAAA"}, 400, "image processor"),
    ("POST", "/generate", {"input_ids": list(range(60)), "max_new_tokens": 8}, 400,
     "exceeds cache capacity"),
    ("POST", "/generate", {"input_ids": [1, 2, 3], "max_new_tokens": 4, "prefix_id": 99}, 400,
     "KeyError"),
    ("POST", "/nowhere", {"input_ids": [1, 2, 3]}, 404, "unknown path"),
    ("GET", "/result/12345", None, 404, "unknown request id"),
    ("GET", "/nowhere", None, 404, "unknown path"),
    ("DELETE", "/prefix/12345", None, 404, "unknown prefix id"),
    ("DELETE", "/request/12345", None, 404, "unknown request id"),
    ("DELETE", "/nowhere", None, 404, "unknown path"),
])
def test_bad_requests(live, method, path, body, code, text):
    status, out = _request(live.port, method, path, body)
    assert status == code and text in out["error"]


def test_prefix_caching_over_http(tiny, live):
    prefix = _ids(8, 7)
    prompt = np.concatenate([prefix, _ids(5, 8)])
    want = _solo(tiny, prompt, None, 5)
    status, out = _request(live.port, "POST", "/prefix", {"input_ids": prefix.tolist()})
    assert status == 200
    pid = out["prefix_id"]
    # matched on its own, and pinned: both use the prefix
    for extra in ({}, {"prefix_id": pid}):
        status, res = _request(live.port, "POST", "/generate",
                               {"input_ids": prompt.tolist(), "max_new_tokens": 5, **extra})
        assert status == 200 and res["finished"] and res["tokens"] == want
    st = _request(live.port, "GET", "/stats")[1]
    assert st["prefix_hits"] == 2 and st["prefixes"] == 1
    assert _request(live.port, "DELETE", f"/prefix/{pid}") == (200, {"ok": True})
    assert "prefix_hits" not in _request(live.port, "GET", "/stats")[1]


def test_image_prefix_over_http(tiny, live):
    head = _ids(10, 9, image=True)
    full = np.concatenate([head, _ids(4, 10)])
    status, out = _request(live.port, "POST", "/prefix",
                           {"input_ids": head.tolist(), "pixel_values": PX.tolist()})
    assert status == 200
    pid = out["prefix_id"]
    status, res = _request(live.port, "POST", "/generate", {
        "input_ids": full.tolist(), "max_new_tokens": 4, "prefix_id": pid})
    assert status == 200 and res["tokens"] == _solo(tiny, full, PX, 4)
    status, res = _request(live.port, "POST", "/generate", {
        "input_ids": full.tolist(), "pixel_values": PX.tolist(), "max_new_tokens": 4,
        "prefix_id": pid})
    assert status == 400 and "already carries the image" in res["error"]
    _request(live.port, "DELETE", f"/prefix/{pid}")


def test_sse_streaming_generate(tiny, live):
    ids = _ids(9, 6, image=True)
    conn = http.client.HTTPConnection("127.0.0.1", live.port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/generate_stream",
                     json.dumps({"input_ids": ids.tolist(), "pixel_values": PX.tolist(),
                                 "max_new_tokens": 7}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
        streamed, final, events = _read_events(r)
    finally:
        conn.close()
    want = _solo(tiny, ids, PX, 7)
    assert final is not None and final["finished"] and final["tokens"] == want
    assert streamed == want
    assert events >= 2  # tokens streamed before the final event


def test_sampler_fields_and_timeout_in_the_body(live):
    status, out = _request(live.port, "POST", "/generate", {
        "input_ids": _ids(5, 12).tolist(), "max_new_tokens": 4, "temperature": 0.8,
        "top_k": 5, "top_p": 0.9, "min_p": 0.05, "repetition_penalty": 1.2, "timeout_s": 20})
    assert status == 200 and out["finished"] and len(out["tokens"]) == 4
    status, out = _request(live.port, "POST", "/generate",
                           {"input_ids": _ids(5, 12).tolist(), "max_new_tokens": 4,
                            "min_p": 2.0})
    assert status == 400 and "min_p" in out["error"]


@pytest.fixture()
def slow_live(tiny):
    """One slot, one step per decode chunk, a queue of 2, a long cache: a
    request decodes long enough to fill the queue behind it."""
    lv = _Live(tiny, slots=1, max_cache_length=512, steps_per_sync=1, max_queue=2)
    yield lv
    lv.close()


def test_timeout_s_finishes_early(slow_live):
    status, out = _request(slow_live.port, "POST", "/generate", {
        "input_ids": _ids(5, 13).tolist(), "max_new_tokens": 500, "timeout_s": 0.5})
    assert status == 200 and out["finished"] and out.get("timed_out") is True
    assert 0 < len(out["tokens"]) < 500
    assert _request(slow_live.port, "GET", "/stats")[1]["timeouts"] == 1


def test_http_429_on_a_full_queue(slow_live):
    """With the scheduler thread stopped nothing leaves the queue: two
    submissions fill it, the third is refused."""
    lv = slow_live
    lv.frontend.shutdown()
    body = {"input_ids": _ids(5, 14).tolist(), "max_new_tokens": 2}
    assert [_request(lv.port, "POST", "/submit", body)[0] for _ in range(2)] == [200, 200]
    status, out = _request(lv.port, "POST", "/submit", body)
    assert status == 429 and "queue full (2/2)" in out["error"]
    assert _request(lv.port, "GET", "/stats")[1]["queued"] == 2


def test_cancel_over_http(slow_live):
    port = slow_live.port
    status, out = _request(port, "POST", "/submit",
                           {"input_ids": _ids(6, 11).tolist(), "max_new_tokens": 400})
    rid = out["request_id"]
    assert _request(port, "DELETE", f"/request/{rid}") == (200, {"cancelled": True})
    status, res = _request(port, "GET", f"/result/{rid}")
    assert status == 200 and res["finished"] and len(res["tokens"]) < 400
    # a second DELETE of the finished request drops its record
    assert _request(port, "DELETE", f"/request/{rid}") == (200, {"cancelled": False})
    assert _request(port, "GET", f"/result/{rid}")[0] == 404
    _wait_idle(port)


def test_http_429_while_draining(slow_live):
    slow_live.frontend._draining = True
    status, out = _request(slow_live.port, "POST", "/generate",
                           {"input_ids": _ids(5, 15).tolist(), "max_new_tokens": 2})
    assert status == 429 and "draining" in out["error"]


def test_sse_client_disconnect_cancels_request(slow_live):
    conn = http.client.HTTPConnection("127.0.0.1", slow_live.port, timeout=TIMEOUT)
    conn.request("POST", "/generate_stream",
                 json.dumps({"input_ids": _ids(5, 16).tolist(), "max_new_tokens": 500}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    assert r.readline()  # one streamed event, then the client vanishes
    r.close()  # the response holds the socket open past conn.close()
    conn.close()
    st = _wait_idle(slow_live.port)
    assert st["finished"] == 1 and st["tokens_generated"] < 500


def test_graceful_drain(tiny):
    cfg, model = tiny
    srv = ContinuousBatchingServer(model, cfg, "cpu", slots=1, max_cache_length=MAX_LEN,
                                   prompt_buckets=None, eos_token_id=-1, steps_per_sync=1)
    frontend = ServingFrontend(srv)
    try:
        rid = frontend.submit(_ids(5, 17), None, 8)
        assert frontend.drain(timeout=TIMEOUT)
        toks, fin = frontend.tokens_so_far(rid)
        assert fin and len(toks) == 8
        assert frontend.wait(rid, timeout=TIMEOUT)
        with pytest.raises(QueueFullError, match="draining"):
            frontend.submit(_ids(5, 17), None, 2)
    finally:
        frontend.shutdown()
    assert not frontend._thread.is_alive()


def test_shutdown_with_drain_finishes_inflight_work(tiny):
    cfg, model = tiny
    srv = ContinuousBatchingServer(model, cfg, "cpu", slots=1, max_cache_length=MAX_LEN,
                                   prompt_buckets=None, eos_token_id=-1, steps_per_sync=1)
    frontend = ServingFrontend(srv)
    rid = frontend.submit(_ids(6, 18), None, 5)
    frontend.shutdown(drain=True, drain_timeout=TIMEOUT)
    assert srv.is_finished(rid) and len(srv.tokens_so_far(rid)) == 5
    assert not frontend._thread.is_alive()


def test_adapter_id_over_http(tiny):
    """``adapter_id`` in the body picks the request's adapter from the
    server's bank; an id out of range is a 400."""
    cfg, model = tiny
    gen = torch.Generator().manual_seed(3)
    adapter = init_lora_params(gen, cfg.text_config, rank=4)
    for ad in [*adapter["blocks"].values(), adapter["lm_head"]]:
        ad["lora_b"].normal_(generator=gen).mul_(0.05)
    bank = stack_adapter_bank([zero_lora_params(cfg.text_config, rank=4, device="cpu"), adapter])
    lv = _Live(tiny, adapter_bank=bank)
    try:
        ids = _ids(9, 19)
        status, out = _request(lv.port, "POST", "/generate",
                               {"input_ids": ids.tolist(), "max_new_tokens": 5, "adapter_id": 1})
        assert status == 200
        assert out["tokens"] == _solo(tiny, ids, None, 5, merge_lora_into_params(model, adapter))
        status, out = _request(lv.port, "POST", "/prefix",
                               {"input_ids": ids[:6].tolist(), "adapter_id": 1})
        assert status == 200
        status, out = _request(lv.port, "POST", "/generate",
                               {"input_ids": ids.tolist(), "max_new_tokens": 5, "adapter_id": 2})
        assert status == 400 and "out of range" in out["error"]
        assert _request(lv.port, "GET", "/stats")[1]["adapters"] == 2
    finally:
        lv.close()


def test_adapter_bank_from_jax_serves_over_http(tiny):
    """A bank converted from JAX adapters (``convert.lora_from_jax``)."""
    from llama32mm_tpu.train import lora as jax_lora

    cfg, model = tiny
    jtc = jax_tiny_config().text_config
    jax_bank = jax_lora.stack_adapter_bank([jax_lora.zero_lora_params(jtc, rank=2)] * 2)
    bank = lora_from_jax(jax.tree.map(np.asarray, jax_bank), "cpu")
    lv = _Live(tiny, adapter_bank=bank)
    try:
        ids = _ids(7, 20)
        status, out = _request(lv.port, "POST", "/generate",
                               {"input_ids": ids.tolist(), "max_new_tokens": 4, "adapter_id": 1})
        assert status == 200 and out["tokens"] == _solo(tiny, ids, None, 4)
    finally:
        lv.close()


def test_main_needs_the_checkpoint_loader(tmp_path):
    """``main()`` loads through ``io/checkpoint.py::load_hf_model``: a
    directory without a checkpoint fails there, before a server starts
    (``tests/test_torch_cli.py`` serves a real one)."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        http_server.main(["--hf-weights", str(tmp_path), "--cpu"])
