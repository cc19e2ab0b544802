"""The rank side of ``tests/test_torch_tp_serving.py``: the serving features
once refused under tensor parallelism (an adapter bank, a speculation
draft, the HTTP front end, the server at ``dp > 1``) and the ViT's attention
dropout under ``vision_tp``, in ranks spawned over gloo on the CPU by
``torch_tp_ranks.run_world(world, inputs, module=__name__)``. Like
``tests/torch_tp_ranks.py`` this module imports torch and the port only,
never jax; the test module computes the JAX oracles in the parent.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time

import numpy as np
import torch

from torch_tp_ranks import MAX_LEN, PX, SERVER_SPECS, engine_prompt, prompt

TIMEOUT = 60  # seconds, for every HTTP call and join
DRAFT = dict(hidden_size=32, n_heads=2, n_layers=1, hidden_dim=48, n_kv_groups=1)
SPEC_K = 3
# the bank traffic: (prompt length, seed, adapter id, budget); the last one
# through a prefix registered with its adapter
BANK_SPECS = [(9, 31, 1, 6), (12, 32, 0, 5), (10, 33, 2, 7), (11, 34, 1, 4)]
BANK_PREFIX = (8, 35)  # (length, seed) of the prefix the last request extends
# the pool at dp=2 x tp=2 against tp=2 (4 slots either way): server keywords
POOL_RUNS = {
    "greedy": {"prompt_buckets": (16, 24)},
    "sampled": {"temperature": 0.9, "top_p": 0.9, "top_k": 20},
    "chunked": {"prefill_chunk": 4, "kv_dtype": "int8"},
    "spec_sampled": {"spec_lookup": 2, "temperature": 0.8, "top_k": 30},
    "bank": {"adapter_bank": True},
}
POOL_SPECS = SERVER_SPECS + [(10, 9, 7), (13, 10, 5)]  # 5 requests through 4 slots
SAMPLER_SEED = 11
# HTTP bodies: text requests after the prefix, an image request, a stream
HTTP_PREFIX = (8, 41)
HTTP_SPECS = [(5, 42, 6, False), (7, 43, 5, False), (12, 44, 6, True), (4, 45, 7, False)]
CANCEL_BUDGET = 40
VIT_DROPOUT = 0.25
VIT_SEED = 13


def bank_prompts():
    """The bank traffic's prompts (text only) and the prefix of the last."""
    pfx = np.random.RandomState(BANK_PREFIX[1]).randint(0, 240, BANK_PREFIX[0])
    ids = [np.random.RandomState(seed).randint(0, 240, s) for s, seed, _, _ in BANK_SPECS]
    ids[-1] = np.concatenate([pfx, ids[-1][:5]])
    return ids, pfx


def http_bodies():
    """``(prefix ids, [request body])``: each text request extends the
    prefix; the image request carries its pixel values."""
    pfx = np.random.RandomState(HTTP_PREFIX[1]).randint(0, 240, HTTP_PREFIX[0])
    bodies = []
    for s, seed, budget, image in HTTP_SPECS:
        ids = np.random.RandomState(seed).randint(0, 240, s)
        if image:
            ids[:4] = 250
            bodies.append({"input_ids": ids.tolist(), "max_new_tokens": budget,
                           "pixel_values": PX[0].tolist()})
        else:
            bodies.append({"input_ids": np.concatenate([pfx, ids]).tolist(),
                           "max_new_tokens": budget})
    return pfx, bodies


class Ctx:
    """A rank's fixtures: the config, the parent's trees and adapters, and
    the mesh of its world (tp=2, or dp=2 x tp=2)."""

    def __init__(self, rank, world, inputs):
        from llama32mm_tpu_torch.configs import tiny_mllama_config
        from llama32mm_tpu_torch.parallel import create_mesh

        self.rank, self.world, self.inputs = rank, world, inputs
        self.cfg = tiny_mllama_config()
        self.mesh = create_mesh(tp=2) if world == 2 else create_mesh(dp=2, tp=2)

    def whole(self, key="untied"):
        from llama32mm_tpu_torch.convert import from_jax_params

        return from_jax_params(self.inputs["trees"][key], self.cfg, "cpu")

    def sharded(self, key="untied", cfg=None, vision_tp=False):
        from llama32mm_tpu_torch.parallel import shard_params

        return shard_params(self.whole(key), cfg or self.cfg, self.mesh, vision_tp=vision_tp)

    def bank(self):
        from llama32mm_tpu_torch.convert import lora_from_jax
        from llama32mm_tpu_torch.train import stack_adapter_bank

        return stack_adapter_bank([lora_from_jax(a, "cpu") for a in self.inputs["adapters"]])

    def server(self, model, **kw):
        from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

        kw = {"slots": 2, "max_cache_length": MAX_LEN, "prompt_buckets": None,
              "eos_token_id": -1, "steps_per_sync": 2, **kw}
        return ContinuousBatchingServer(model, self.cfg, "cpu", **kw)


# -- the pool: the same traffic at tp=2 (world 2) and dp=2 x tp=2 (world 4) --------


def serve_pool(c: Ctx) -> dict:
    """Each of ``POOL_RUNS`` through 4 slots: the requests' tokens, and the
    device rows this rank's group holds."""
    model = c.sharded()
    out = {}
    for name, kw in POOL_RUNS.items():
        kw = dict(kw)
        aids = [0] * len(POOL_SPECS)
        if kw.pop("adapter_bank", False):
            kw["adapter_bank"] = c.bank()
            aids = [i % 3 for i in range(len(POOL_SPECS))]
        srv = c.server(model, slots=4, rng=torch.Generator().manual_seed(SAMPLER_SEED), **kw)
        rids = [srv.submit(prompt(s, seed)[0], PX[0], max_new_tokens=mn, adapter_id=a)
                for (s, seed, mn), a in zip(POOL_SPECS, aids)]
        res = srv.run()
        out[name] = [res[r] for r in rids]
    out["rows"] = srv.state.pos.shape[0]
    return out


def case_pool(c: Ctx):
    return serve_pool(c)


# -- world 2 (tp = 2) --------------------------------------------------------------


def case_bank(c: Ctx):
    """A 3-adapter bank over the tp=2 model: requests of adapters 1, 0, 2,
    then 1 into a freed slot through a prefix computed with adapter 1."""
    srv = c.server(c.sharded(), adapter_bank=c.bank())
    ids, pfx = bank_prompts()
    srv.register_prefix(pfx, adapter_id=BANK_SPECS[-1][2])
    rids = [srv.submit(i, None, max_new_tokens=mn, adapter_id=a)
            for i, (_, _, a, mn) in zip(ids[:3], BANK_SPECS[:3])]
    srv.step()
    rids.append(srv.submit(ids[3], None, max_new_tokens=BANK_SPECS[3][3],
                           adapter_id=BANK_SPECS[3][2]))
    res = srv.run()
    return {"tokens": [res[r] for r in rids], "prefix_hits": srv.stats()["prefix_hits"]}


def draft_config(c: Ctx):
    from llama32mm_tpu_torch.configs import LLAMA32Config

    tc = c.cfg.text_config
    return LLAMA32Config(vocab_size=tc.vocab_size, dtype=tc.dtype,
                         max_cache_length=tc.max_cache_length, **DRAFT)


def case_draft(c: Ctx):
    """Draft-model speculation over the tp=2 target, the draft whole on
    every rank and sharded on the same mesh."""
    from llama32mm_tpu_torch.convert import causal_lm_from_jax
    from llama32mm_tpu_torch.inference.engine import InferenceEngine
    from llama32mm_tpu_torch.parallel import shard_params

    dcfg = draft_config(c)
    whole = causal_lm_from_jax(c.inputs["draft"], dcfg, "cpu")
    target = c.sharded("tied")
    ids, px = engine_prompt()
    out = {}
    for kind, draft in (("whole", whole), ("sharded", shard_params(whole, dcfg, c.mesh))):
        eng = InferenceEngine(target, c.cfg, "cpu", max_cache_length=MAX_LEN, spec_draft=SPEC_K,
                              draft_params=draft, draft_config=dcfg)
        res = eng.generate(ids, px, max_new_tokens=12, eos_token_id=-1)
        out[kind] = {"tokens": res.tokens.numpy(), "steps": int(res.steps),
                     "kv_heads": None if draft.model.tp is None else draft.model.tp.kv_heads}
    return out


def http_call(port: int, method: str, path: str, body=None) -> tuple:
    """``(status, reply)``; a stream's reply is ``(streamed tokens, final
    event)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if not path.endswith("_stream"):
            return r.status, json.loads(r.read())
        streamed, final = [], None
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                ev = json.loads(line[len("data: "):])
                if ev.get("finished"):
                    final = ev
                    break
                streamed.extend(ev["tokens"])
        return r.status, (streamed, final)
    finally:
        conn.close()


def drive_http(port: int) -> dict:
    """World rank 0's client: a prefix, the bodies at once (the last as a
    stream), a cancelled long request, then the prefix dropped."""
    pfx, bodies = http_bodies()
    status, reply = http_call(port, "POST", "/prefix", {"input_ids": pfx.tolist()})
    assert status == 200, (status, reply)
    pid = reply["prefix_id"]
    out = [None] * len(bodies)

    def call(i):
        path = "/generate_stream" if i == len(bodies) - 1 else "/generate"
        out[i] = http_call(port, "POST", path, bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert all(o is not None and o[0] == 200 for o in out), out
    streamed, final = out[-1][1]
    assert final is not None and final["tokens"] == streamed, out[-1]
    tokens = [o[1]["tokens"] for o in out[:-1]] + [final["tokens"]]
    rids = [o[1]["request_id"] for o in out[:-1]] + [final["request_id"]]
    status, sub = http_call(port, "POST", "/submit", {"input_ids": bodies[0]["input_ids"][:6],
                                                      "max_new_tokens": CANCEL_BUDGET})
    cancel = http_call(port, "DELETE", f"/request/{sub['request_id']}")
    result = http_call(port, "GET", f"/result/{sub['request_id']}")[1]
    stats = http_call(port, "GET", "/stats")[1]
    dropped = http_call(port, "DELETE", f"/prefix/{pid}")
    return {"tokens": tokens, "rids": rids, "cancel_rid": sub["request_id"],
            "cancelled": cancel, "cancel_result": result, "stats": stats, "dropped": dropped}


def serve_http(c: Ctx, srv) -> dict:
    """World rank 0 serves ``srv`` over loopback HTTP and drives it; the
    other ranks follow. Every rank returns its server's record of every
    request (tokens, finished) and its prefixes."""
    from llama32mm_tpu_torch.inference.http_server import ServingFrontend, follow, serve_forever

    out = {}
    if c.rank == 0:
        frontend = ServingFrontend(srv)
        httpd = serve_forever(frontend, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            out = drive_http(httpd.server_address[1])
        finally:
            httpd.shutdown()
            httpd.server_close()
            frontend.shutdown(drain=True, drain_timeout=TIMEOUT)
            thread.join(timeout=TIMEOUT)
        out["thread_alive"] = frontend._thread.is_alive()
    else:
        follow(srv)
    out["records"] = {rid: (list(map(int, r.tokens)), r.finished)
                      for rid, r in srv._results.items()}
    out["prefixes"] = sorted(srv._prefixes)
    return out


def case_http(c: Ctx):
    return serve_http(c, c.server(c.sharded(), steps_per_sync=3))


def case_vit_dropout(c: Ctx):
    """Full fine-tuning with ``vision_tp`` and the ViT's attention dropout:
    two steps' losses, and one step's gradients (this rank's slices),
    against the one-device step under the same generator."""
    from torch_tp_train_ranks import tiny_batch

    from llama32mm_tpu_torch.models.vlm import vlm_forward
    from llama32mm_tpu_torch.parallel import placement_of
    from llama32mm_tpu_torch.train.full import make_train_step

    cfg = dataclasses.replace(c.cfg, vision_config=dataclasses.replace(
        c.cfg.vision_config, attention_dropout=VIT_DROPOUT))
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch().items()}
    out = {}
    for kind in ("whole", "sharded"):
        model = c.whole("tied") if kind == "whole" else c.sharded("tied", cfg, vision_tp=True)
        params = dict(model.vision_model.named_parameters())
        for t in params.values():
            t.requires_grad_(True)
        loss = vlm_forward(model, cfg, **batch, dropout_rng=torch.Generator().manual_seed(
            VIT_SEED)).loss
        grads = torch.autograd.grad(loss, list(params.values()))
        out[kind] = {"loss": float(loss), "grads": {
            n: (placement_of(t), g.numpy()) for (n, t), g in zip(params.items(), grads)}}
        for t in params.values():
            t.requires_grad_(False)
        init, step = make_train_step(cfg, learning_rate=1e-3)
        state = init(model)
        gen = torch.Generator().manual_seed(VIT_SEED)
        losses = []
        for _ in range(2):
            state, step_loss = step(state, batch, gen)
            losses.append(float(step_loss))
        out[kind]["losses"] = losses
    # the one-device gradients narrowed to this rank's slices
    pairs = {}
    for n, (pl, g) in out["sharded"]["grads"].items():
        want = out["whole"]["grads"][n][1]
        if pl is not None:
            want = pl.local(torch.from_numpy(want)).numpy()
        pairs[n] = (g, want)
    return {"loss": (out["sharded"]["loss"], out["whole"]["loss"]),
            "losses": (out["sharded"]["losses"], out["whole"]["losses"]), "grads": pairs,
            "split": sum(pl is not None for pl, _ in out["sharded"]["grads"].values())}


# -- world 4 (dp = 2 x tp = 2) ------------------------------------------------------


def case_deadline_dp2(c: Ctx):
    """Rank 3's clock jumps past every deadline after two steps: every rank
    of both data-parallel groups expires the same requests at one step."""
    from unittest import mock

    srv = c.server(c.sharded(), slots=4, steps_per_sync=1)
    rids = [srv.submit(prompt(s, seed)[0], PX[0], max_new_tokens=mn, timeout_s=1e4)
            for s, seed, mn in POOL_SPECS]
    srv.step()
    srv.step()
    ahead = time.monotonic() + (1e6 if c.rank == 3 else 0.0)
    with mock.patch("time.monotonic", lambda: ahead):
        res = srv.run()
    return {"tokens": [res[r] for r in rids],
            "timed_out": [srv._results[r].timed_out for r in rids]}


def case_http_dp2(c: Ctx):
    return serve_http(c, c.server(c.sharded(), slots=4, steps_per_sync=3))


CASES = {
    2: [case_pool, case_bank, case_draft, case_http, case_vit_dropout],
    4: [case_pool, case_deadline_dp2, case_http_dp2],
}
