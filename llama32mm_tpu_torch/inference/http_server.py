"""HTTP serving front end over the continuous-batching server (counterpart
of ``llama32mm_tpu/inference/http_server.py``).

Standard library only (``http.server`` and a scheduler thread):

- a background thread drives ``ContinuousBatchingServer.step()`` while work
  is pending (admissions interleave with decode as the scheduler decides);
- ``POST /generate``: submit and wait; body ``{"input_ids": [...],
  "pixel_values"?: [3, H, W] nested lists, "max_new_tokens": N,
  "adapter_id"?: i, "prefix_id"?: p, "timeout_s"?: t}`` and the sampler
  fields (``temperature``, ``top_p``, ``top_k``, ``min_p``,
  ``repetition_penalty``); or the text surface ``{"prompt": "...",
  "image"?: <base64 image file>}``, which needs a tokenizer (and, with an
  image, a processor) on the front end; returns ``{"request_id", "finished",
  "tokens", "timed_out"?, "text"?}``;
- ``POST /submit``: the same body, returns ``{"request_id"}`` at once;
- ``GET /result/<rid>``: ``{"finished", "tokens"}`` so far;
- ``GET /stats``: the scheduler's ``stats()``;
- ``POST /prefix``: register a prompt prefix (``{"input_ids",
  "pixel_values"?, "adapter_id"?}`` → ``{"prefix_id"}``); later text
  requests match it on their own, or pin it with ``"prefix_id"``;
  ``DELETE /prefix/<pid>`` frees it;
- ``POST /generate_stream``: server-sent events, ``data: {"request_id",
  "tokens": [...new...]}`` as tokens arrive, then the final result with
  ``"finished": true``; a client that disconnects has its request cancelled;
- ``DELETE /request/<rid>``: cancel a queued or running request (on a
  finished one: drop its record);
- backpressure: a full admission queue (``max_queue``) and a draining front
  end answer 429; bad bodies 400; unknown ids 404.

One lock serializes every call into the scheduler.

Over a sharded server (a model from ``parallel/sharding.py::shard_params``
on a mesh of several ranks, tensor- and data-parallel alike) every rank must
make the same scheduler calls in the same order, since each call may run
collectives. So each call (``submit``, ``cancel`` with ``release``,
``register_prefix``, ``drop_prefix``) becomes an entry of one ordered log:
world rank 0 runs this front end and the HTTP listener, and before each
``step()`` its scheduler thread broadcasts the entries queued since the last
one to the world (ids and sampler fields as Python objects, pixel values as
tensors) and applies them; every other rank runs ``follow(server)``, which
applies the same entries in the same order, steps when rank 0 does and
returns when rank 0 shuts down. Request and prefix ids then agree on every
rank by construction, and each round checks that they do. A disconnecting
client's cancel reaches every rank as an entry; drain and shutdown reach
every rank through the rounds.

Run: ``python -m llama32mm_tpu_torch.inference.http_server --hf-weights DIR
[--quantize int8|int4] [--slots N] [--port P]`` (the GPU; ``--cpu`` for the
CPU): loads the checkpoint (``io/checkpoint.py::load_hf_model``), builds the
server and the processor, warms the decode chunks up and serves until
interrupted, then drains. In Python, build a ``ServingFrontend`` over a
server and pass it to ``serve_forever``; over a sharded server, spawn the
ranks, build the server on each, serve from rank 0 and call
``follow(server)`` on the others (README.md).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from llama32mm_tpu_torch.inference.server import QueueFullError

# the errors a scheduler call answers a client with (400, 404, 429); a rank
# that follows rank 0 meets the same one, which rank 0 has answered
_CALL_ERRORS = (KeyError, ValueError, TypeError, QueueFullError)


def _world(server) -> int:
    """The ranks that serve ``server`` together: the world of a sharded
    server (its mesh must span it), else 1."""
    if server.tp is None or not dist.is_initialized():
        return 1
    world, mesh = dist.get_world_size(), server.tp.mesh
    if world > 1 and np.prod(list(mesh.shape.values())) != world:
        raise ValueError(f"the server's mesh {mesh.shape} must span the world of {world} ranks")
    return world


def _pending(server) -> bool:
    return bool(server._queue or server._inflight is not None
                or any(r is not None for r in server._by_slot))


def _apply(server, op: str, args: tuple):
    """One scheduler call (an entry of the log) on ``server``."""
    if op == "submit":
        ids, px, max_new_tokens, kw = args
        return server.submit(ids, px, max_new_tokens, **kw)
    if op == "cancel":  # cancel a live request; on a finished one, drop its record
        ok = server.cancel(args[0])
        if not ok:
            server.release(args[0])
        return ok
    if op == "register_prefix":
        ids, px, adapter_id = args
        return server.register_prefix(ids, px, adapter_id=adapter_id)
    if op == "drop_prefix":
        return server.drop_prefix(args[0])
    raise ValueError(f"unknown scheduler call {op!r}")


_PIXELS = ("submit", "register_prefix")  # the calls whose args[1] is pixel values or None


def _ids_of(server) -> tuple:
    return server._next_id, server._next_prefix_id


def _sync_round(server, entries: Optional[list], stop: bool = False) -> tuple:
    """One round of the log over the world: world rank 0 passes its entries
    (``(op, args)``, the pixel values of ``submit`` and ``register_prefix``
    in ``args[1]``) and whether it stops; every other rank passes None and
    receives them. Returns ``(entries, stop)`` on every rank, the pixel
    values as float32 tensors. Python objects go through
    ``broadcast_object_list`` and the pixel values as tensors (on the
    server's device under NCCL; gloo takes them from the host). Each round
    carries rank 0's next request and prefix ids, which every rank must
    share before it applies the round."""
    nccl = dist.get_backend() == "nccl"
    dev = server.device if nccl else torch.device("cpu")
    obj_dev = dev if nccl else None
    if entries is not None:  # rank 0
        tensors = [None if op not in _PIXELS or args[1] is None else
                   torch.as_tensor(np.asarray(args[1], np.float32), device=dev)
                   for op, args in entries]
        header = [([(op, (args[0], None, *args[2:]) if op in _PIXELS else args)
                    for op, args in entries],
                   [None if t is None else tuple(t.shape) for t in tensors],
                   stop, _ids_of(server))]
        dist.broadcast_object_list(header, src=0, device=obj_dev)
    else:
        header = [None]
        dist.broadcast_object_list(header, src=0, device=obj_dev)
        entries, shapes, stop, ids = header[0]
        if _ids_of(server) != ids:
            raise RuntimeError(f"this rank's next (request, prefix) ids {_ids_of(server)} "
                               f"differ from rank 0's {ids}")
        tensors = [None if shape is None else torch.empty(shape, dtype=torch.float32, device=dev)
                   for shape in shapes]
    for t in tensors:
        if t is not None:
            dist.broadcast(t, src=0)
    return [(op, (args[0], t, *args[2:]) if op in _PIXELS else args)
            for (op, args), t in zip(entries, tensors)], stop


class ServingFrontend:
    """Owns a ``ContinuousBatchingServer`` and the thread that steps it (on a
    sharded server: world rank 0's, the other ranks in ``follow``)."""

    def __init__(self, server, tokenizer=None, processor=None):
        self.srv = server
        self._world = _world(server)
        if self._world > 1 and dist.get_rank() != 0:
            raise ValueError("world rank 0 serves a sharded server; the other ranks call "
                             "follow(server)")
        self.tokenizer = tokenizer
        self.processor = processor  # prompt + image bodies (MllamaImageProcessor's surface)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._done_events: dict[int, threading.Event] = {}
        self._log: list = []  # a sharded server's entries queued since the last round
        self._stop = False
        self._draining = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _pending(self) -> bool:
        return _pending(self.srv)

    def _apply_here(self, op: str, args: tuple):
        """Apply one call on this rank's server (the lock held)."""
        out = _apply(self.srv, op, args)
        if op == "submit":
            self._done_events[out] = threading.Event()
        return out

    def _call(self, op: str, *args):
        """One scheduler call: at once on a one-device server; on a sharded
        server an entry of the log, which the scheduler thread applies on
        every rank at its next round, handing back the result or error."""
        entry = {"op": op, "args": args, "done": threading.Event()}
        with self._lock:
            if op == "submit" and self._draining:
                raise QueueFullError("server is draining — not accepting requests")
            if self._world == 1:
                return self._apply_here(op, args)
            if self._stop:
                raise QueueFullError("the front end is shut down")
            self._log.append(entry)
        self._work.set()
        entry["done"].wait()
        if "error" in entry:
            raise entry["error"]
        return entry["result"]

    def _round(self, stop: bool) -> None:
        """Rank 0's round of the log (the lock held): broadcast the queued
        entries, then apply them in order."""
        queued, self._log = self._log, []
        entries, _ = _sync_round(self.srv, [(e["op"], e["args"]) for e in queued], stop)
        for entry, (op, args) in zip(queued, entries):
            try:
                entry["result"] = self._apply_here(op, args)
            except Exception as e:  # handed to the caller; a fault also stops the thread
                entry["error"] = e
                if not isinstance(e, _CALL_ERRORS):
                    raise
            finally:
                entry["done"].set()

    def _loop(self):
        while True:
            with self._lock:
                stop = self._stop
                if self._world > 1:
                    self._round(stop)
                if stop:
                    break
                pending = self._pending()
                finished = self.srv.step() if pending else []
            for rid in finished:
                ev = self._done_events.pop(rid, None)
                if ev is not None:
                    ev.set()
            # let a handler waiting for the lock take it before the next step
            # (a released lock is otherwise taken back at once)
            time.sleep(0)
            if not pending:
                self._work.wait(timeout=0.05)
                self._work.clear()

    def submit(self, input_ids, pixel_values, max_new_tokens: int,
               prefix_id: Optional[int] = None, adapter_id: int = 0,
               temperature=None, top_p=None, top_k=None, min_p=None, repetition_penalty=None,
               timeout_s: Optional[float] = None) -> int:
        kw = dict(prefix_id=prefix_id, adapter_id=adapter_id, temperature=temperature,
                  top_p=top_p, top_k=top_k, min_p=min_p,
                  repetition_penalty=repetition_penalty, timeout_s=timeout_s)
        rid = self._call("submit", input_ids, pixel_values, max_new_tokens, kw)
        self._work.set()
        return rid

    def encode_request(self, req: dict):
        """A request body as ``(input_ids, pixel_values or None)``: raw
        ``input_ids`` (and ``pixel_values``), or ``prompt`` (and ``image``,
        a base64 image file) through the front end's tokenizer or processor
        (duck-typed: ``tokenizer([text], return_tensors="np", ...)``,
        ``processor([prompt], [image], padding=True)``)."""
        if "input_ids" in req:
            ids = np.asarray(req["input_ids"], np.int64)
            px = req.get("pixel_values")
            return ids, None if px is None else np.asarray(px, np.float32)
        prompt = req["prompt"]  # KeyError → 400 (input_ids or prompt needed)
        img_b64 = req.get("image")
        if img_b64 is None:
            if self.tokenizer is None:
                raise ValueError("server has no tokenizer — send input_ids")
            text = (getattr(self.tokenizer, "bos_token", None) or "") + prompt
            # BOS is prepended above: keep the tokenizer from adding its own
            if hasattr(self.tokenizer, "add_bos_token"):
                self.tokenizer.add_bos_token = False
            if hasattr(self.tokenizer, "add_eos_token"):
                self.tokenizer.add_eos_token = False
            ids = self.tokenizer([text], return_tensors="np", padding=True,
                                 truncation=False)["input_ids"][0]
            return np.asarray(ids, np.int64), None
        if self.processor is None:
            raise ValueError("server has no image processor — send input_ids")
        import base64
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(img_b64))).convert("RGB")
        out = self.processor([prompt], [img], padding=True)
        return (np.asarray(out["input_ids"][0], np.int64),
                np.asarray(out["pixel_values"][0], np.float32))

    def register_prefix(self, input_ids, pixel_values=None, adapter_id: int = 0) -> int:
        return self._call("register_prefix", input_ids, pixel_values, adapter_id)

    def drop_prefix(self, prefix_id: int) -> None:
        self._call("drop_prefix", prefix_id)

    def tokens_so_far(self, rid: int) -> tuple:
        with self._lock:
            return [int(t) for t in self.srv.tokens_so_far(rid)], self.srv.is_finished(rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request; on a finished one, drop its record instead
        (``DELETE /request/<id>`` doubles as cleanup)."""
        ok = self._call("cancel", rid)
        ev = self._done_events.pop(rid, None)
        if ev is not None:
            ev.set()  # release a /generate waiter
        return ok

    def wait(self, rid: int, timeout: Optional[float] = None) -> bool:
        ev = self._done_events.get(rid)
        if ev is None:  # already finished (the loop popped its event)
            return True
        return ev.wait(timeout)

    def result(self, rid: int) -> dict:
        with self._lock:
            toks = [int(t) for t in self.srv.tokens_so_far(rid)]
            fin = self.srv.is_finished(rid)
            req = self.srv._results.get(rid)
            timed_out = bool(req is not None and req.timed_out)
        out = {"request_id": rid, "finished": fin, "tokens": toks}
        if timed_out:
            out["timed_out"] = True
        if fin and self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(toks, skip_special_tokens=True).strip()
        return out

    def stats(self) -> dict:
        with self._lock:
            return self.srv.stats()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Refuse new submissions (``submit`` raises ``QueueFullError``) and
        wait for everything queued or decoding to finish; True if it did
        within ``timeout`` seconds (None: no limit)."""
        with self._lock:
            self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._pending():
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._work.set()
            time.sleep(0.02)

    def shutdown(self, drain: bool = False, drain_timeout: Optional[float] = 30.0):
        """Stop the scheduler thread; ``drain=True`` first lets in-flight
        requests finish (within ``drain_timeout``)."""
        if drain:
            self.drain(drain_timeout)
        self._stop = True
        self._work.set()
        self._thread.join(timeout=5)


def follow(server) -> None:
    """The loop of every rank of a sharded server's world but rank 0, which
    serves HTTP through ``ServingFrontend``: each round, apply rank 0's
    entries in its order, then step when there is work, as rank 0 does;
    return when rank 0 shuts down. An entry that fails here fails alike on
    rank 0, which answers its client."""
    if _world(server) == 1 or dist.get_rank() == 0:
        raise ValueError("follow() runs on the ranks other than 0 of a sharded server's world")
    while True:
        entries, stop = _sync_round(server, None)
        for op, args in entries:
            try:
                _apply(server, op, args)
            except _CALL_ERRORS:
                pass
        if stop:
            return
        if _pending(server):
            server.step()


def make_handler(frontend: ServingFrontend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _sse(self, rid: int):
            """Stream a request's tokens as server-sent events, one event
            per scheduler step that produced tokens, then the final result.
            A client that disconnects has its request cancelled, so that it
            does not keep a slot busy to its budget."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            sent = 0
            try:
                while True:
                    done = frontend.wait(rid, timeout=0.02)
                    toks, fin = frontend.tokens_so_far(rid)
                    if len(toks) > sent:
                        ev = {"request_id": rid, "tokens": toks[sent:]}
                        self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                        self.wfile.flush()
                        sent = len(toks)
                    if fin or done:
                        self.wfile.write(f"data: {json.dumps(frontend.result(rid))}\n\n".encode())
                        self.wfile.flush()
                        return
            except (BrokenPipeError, ConnectionResetError, OSError):
                frontend.cancel(rid)  # free the slot or dequeue

        def do_GET(self):
            try:
                if self.path == "/stats":
                    return self._json(200, frontend.stats())
                if self.path.startswith("/result/"):
                    return self._json(200, frontend.result(int(self.path.rsplit("/", 1)[1])))
                return self._json(404, {"error": f"unknown path {self.path}"})
            except KeyError:
                return self._json(404, {"error": "unknown request id"})
            except Exception as e:  # pragma: no cover - defensive
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            try:
                req = self._read_body()
                ids, px = frontend.encode_request(req)
                if self.path == "/prefix":
                    pid = frontend.register_prefix(ids, px,
                                                   adapter_id=int(req.get("adapter_id", 0)))
                    return self._json(200, {"prefix_id": pid})
                mnt = int(req.get("max_new_tokens", 64))
                pfx = req.get("prefix_id")
                tmo = req.get("timeout_s")
                kw = dict(
                    prefix_id=None if pfx is None else int(pfx),
                    adapter_id=int(req.get("adapter_id", 0)),
                    temperature=req.get("temperature"), top_p=req.get("top_p"),
                    top_k=req.get("top_k"), min_p=req.get("min_p"),
                    repetition_penalty=req.get("repetition_penalty"),
                    timeout_s=None if tmo is None else float(tmo),
                )
                if self.path == "/submit":
                    return self._json(200, {"request_id": frontend.submit(ids, px, mnt, **kw)})
                if self.path == "/generate":
                    rid = frontend.submit(ids, px, mnt, **kw)
                    frontend.wait(rid)
                    return self._json(200, frontend.result(rid))
                if self.path == "/generate_stream":
                    return self._sse(frontend.submit(ids, px, mnt, **kw))
                return self._json(404, {"error": f"unknown path {self.path}"})
            except QueueFullError as e:
                return self._json(429, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # pragma: no cover - defensive
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            try:
                if self.path.startswith("/prefix/"):
                    try:
                        frontend.drop_prefix(int(self.path.rsplit("/", 1)[1]))
                    except KeyError:
                        return self._json(404, {"error": "unknown prefix id"})
                    return self._json(200, {"ok": True})
                if self.path.startswith("/request/"):
                    try:
                        ok = frontend.cancel(int(self.path.rsplit("/", 1)[1]))
                    except KeyError:
                        return self._json(404, {"error": "unknown request id"})
                    return self._json(200, {"cancelled": ok})
                return self._json(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # pragma: no cover - defensive
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_forever(frontend: ServingFrontend, host: str = "0.0.0.0", port: int = 8000):
    """The HTTP server over ``frontend`` (bound, not yet serving: call its
    ``serve_forever()``, e.g. in a thread; ``port=0`` picks a free port,
    read back from ``server_address``)."""
    return ThreadingHTTPServer((host, port), make_handler(frontend))


def main(argv=None):
    parser = argparse.ArgumentParser(description="llama32mm PyTorch/CUDA HTTP serving")
    parser.add_argument("--hf-weights", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-queue", type=int, default=64,
                        help="admission queue bound; a full queue returns HTTP 429 "
                             "(0 = unbounded)")
    parser.add_argument("--max-cache-length", type=int, default=2048)
    parser.add_argument("--quantize", choices=["none", "int8", "int4"], default="none")
    parser.add_argument("--prefill-chunk", type=int, default=None)
    parser.add_argument("--spec-lookup", type=int, default=0,
                        help="K>0: batched prompt-lookup speculative decoding")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--cpu", action="store_true", help="Serve on the CPU instead of the GPU.")
    args = parser.parse_args(argv)

    import torch

    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
    from llama32mm_tpu_torch.io.checkpoint import load_hf_model
    from llama32mm_tpu_torch.preprocess.processor import MllamaImageProcessor

    device = torch.device("cpu" if args.cpu else "cuda")
    model, tokenizer = load_hf_model(
        args.hf_weights, device, dtype=args.dtype,
        max_cache_length=args.max_cache_length,
        streaming=args.quantize != "none",
        quantize_int8=args.quantize == "int8",
        quantize_int4=args.quantize == "int4",
    )
    srv = ContinuousBatchingServer(
        model, model.config, device, slots=args.slots,
        max_cache_length=args.max_cache_length,
        kv_dtype="int8" if args.quantize != "none" else None,
        eos_token_id=tokenizer.eos_token_id if tokenizer.eos_token_id is not None else -1,
        prefill_chunk=args.prefill_chunk,
        spec_lookup=args.spec_lookup,
        max_queue=args.max_queue if args.max_queue > 0 else None,
    )
    processor = MllamaImageProcessor(
        tokenizer,
        model.config.text_config.num_image_tokens,
        model.config.vision_config.image_size,
    )
    print("warming up the decode chunks...", flush=True)
    srv.warmup()  # every decode chunk length once, before traffic
    frontend = ServingFrontend(srv, tokenizer, processor)
    httpd = serve_forever(frontend, args.host, args.port)
    print(f"serving on {args.host}:{httpd.server_address[1]} "
          f"(slots={args.slots}, quantize={args.quantize})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: refuse new work, let in-flight requests finish
        print("draining...", flush=True)
        frontend.shutdown(drain=True, drain_timeout=60.0)
        httpd.server_close()


if __name__ == "__main__":
    main()
