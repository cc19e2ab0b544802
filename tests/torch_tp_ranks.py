"""The rank side of ``tests/test_torch_tp.py``: tensor-parallel cases run in
spawned processes over gloo on the CPU. This module imports torch and the
port only, never jax, so the spawned children never load it; the test
module computes the JAX oracles in the parent.

``run_world(world, inputs)`` starts ``world`` ranks, each of which runs every
case of its world size in the same order (meshes and collectives are
collective calls) and sends back, per case, a picklable result (numpy arrays,
numbers, strings) or the error it raised. ``run_world(..., module=)`` runs
another rank module's ``Ctx`` and ``CASES`` the same way
(``tests/torch_tp_serving_ranks.py``).
"""

from __future__ import annotations

import importlib
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

MAX_LEN = 64
IMAGE_ID = 250
SERVER_SPECS = [(9, 1, 6), (12, 5, 8), (14, 7, 4)]  # (prompt length, seed, budget)


def prompt(s: int, seed: int, image: bool = True) -> np.ndarray:
    ids = np.random.RandomState(seed).randint(0, 240, (1, s))
    if image:
        ids[:, :4] = IMAGE_ID
    return ids


def batch(b: int = 4, s: int = 12, seed: int = 1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 240, (b, s))
    ids[:, :4] = IMAGE_ID
    return ids, rs.randn(b, 3, 28, 28).astype(np.float32)


PX = np.random.RandomState(0).randn(1, 3, 28, 28).astype(np.float32)


def engine_prompt():
    """tests/test_torch_engine.py's prompt: on the tied seed-2 model its
    greedy tokens vary from step to step."""
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 240, (1, 10))
    ids[:, 1:5] = IMAGE_ID
    return ids, rs.randn(1, 3, 28, 28).astype(np.float32)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ctx:
    """A rank's fixtures: the config, the port models from the parent's
    trees, the checkpoint directory and the tp = world mesh."""

    def __init__(self, rank, world, inputs):
        from llama32mm_tpu_torch.configs import tiny_mllama_config
        from llama32mm_tpu_torch.convert import from_jax_params
        from llama32mm_tpu_torch.parallel import create_mesh

        self.rank, self.world = rank, world
        self.cfg = tiny_mllama_config()
        self.models = {k: from_jax_params(tree, self.cfg, "cpu")
                       for k, tree in inputs["trees"].items()}
        self.ckpt = inputs.get("ckpt")
        self.mesh = create_mesh(tp=world)

    def sharded(self, key="tied", mesh=None, vision_tp=False, quant=None):
        from llama32mm_tpu_torch.models.quantize import quantize_llama_params
        from llama32mm_tpu_torch.parallel import shard_params

        model = self.models[key]
        if quant is not None:
            model = quantize_llama_params(model, **quant)
        return shard_params(model, self.cfg, mesh or self.mesh, vision_tp=vision_tp)


INT4 = dict(bits=4, group_size=32)


def _int4_mixed():
    from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE

    return dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE)


def _logits(model, cfg):
    from llama32mm_tpu_torch.models.vlm import vlm_forward

    ids, px = batch()
    with torch.inference_mode():
        return vlm_forward(model, cfg, input_ids=torch.as_tensor(ids),
                           pixel_values=torch.as_tensor(px)).logits.numpy()


def _generate(c: Ctx, model, ids, px, **kw):
    from llama32mm_tpu_torch.inference.engine import InferenceEngine

    eng_kw = {k: kw.pop(k) for k in ("kv_dtype", "spec_lookup", "prompt_buckets") if k in kw}
    eng = InferenceEngine(model, c.cfg, "cpu", max_cache_length=MAX_LEN, **eng_kw)
    res = eng.generate(ids, px, eos_token_id=-1, **kw)
    return {"tokens": res.tokens.numpy(), "num": res.num_generated.numpy(),
            "prefill_logits": res.prefill_logits.numpy()}


def _serve(c: Ctx, model, **kw):
    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

    srv = ContinuousBatchingServer(model, c.cfg, "cpu", slots=2, max_cache_length=MAX_LEN,
                                   eos_token_id=-1, steps_per_sync=3, **kw)
    rids = [srv.submit(prompt(s, seed)[0], PX[0], max_new_tokens=mn)
            for s, seed, mn in SERVER_SPECS]
    out = srv.run()
    return [out[r] for r in rids]


# -- the cases of world 2 (tp = 2) ----------------------------------------------


def case_mesh(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    errors = []
    for kw in (dict(dp=2, tp=2), dict(tp=4), dict(dp=2, tp=2, sp=2)):
        try:
            create_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    return {"shape": c.mesh.shape, "coords": c.mesh.coords, "errors": errors}


def case_placement(c: Ctx):
    m = c.sharded("untied")
    blk = m.language_model.model.blocks[0]
    vm = c.sharded("tied", vision_tp=True).vision_model
    return {
        "W_query": tuple(blk.att.W_query.weight.shape),
        "W_key": tuple(blk.att.W_key.weight.shape),
        "out_proj": tuple(blk.att.out_proj.weight.shape),
        "w_down": tuple(blk.ff.w_down.weight.shape),
        "tok_emb": tuple(m.language_model.model.tok_emb.shape),
        "lm_head": tuple(m.language_model.lm_head.weight.shape),
        "patch_embedding": tuple(m.vision_model.patch_embedding.weight.shape),
        "vit_q_proj": tuple(vm.layers[0].q_proj.weight.shape),
        "vit_fc1_bias": tuple(vm.layers[0].fc1.bias.shape),
        "vit_fc2_bias": tuple(vm.layers[0].fc2.bias.shape),
        "tp": (m.language_model.model.tp.heads, m.language_model.model.tp.kv_heads,
               m.language_model.model.tp.vocab_start, m.language_model.model.tp.vocab_rows),
        "rows_of_W_query": blk.att.W_query.weight.numpy(),
    }


def case_forward_tied(c: Ctx):
    return _logits(c.sharded("tied"), c.cfg)


def case_forward_untied(c: Ctx):
    return _logits(c.sharded("untied"), c.cfg)


def case_vision_tp(c: Ctx):
    return _logits(c.sharded("tied", vision_tp=True), c.cfg)


def case_int8_forward(c: Ctx):
    return _logits(c.sharded("untied", quant=dict(bits=8)), c.cfg)


def case_int4_forward(c: Ctx):
    return _logits(c.sharded("untied", quant=INT4), c.cfg)


def case_engine_greedy(c: Ctx):
    return _generate(c, c.sharded("tied"), *engine_prompt(), max_new_tokens=10)


def case_engine_sampled(c: Ctx):
    return _generate(c, c.sharded("tied"), *engine_prompt(), max_new_tokens=10,
                     temperature=0.8, top_p=0.9, top_k=20, rng=torch.Generator().manual_seed(5))


def case_engine_int4_mixed(c: Ctx):
    return _generate(c, c.sharded("untied", quant=_int4_mixed()), *engine_prompt(),
                     max_new_tokens=10, kv_dtype="int8")


def case_server_monolithic(c: Ctx):
    return _serve(c, c.sharded("untied"), prompt_buckets=(16, 24))


def case_server_chunked_int8kv(c: Ctx):
    return _serve(c, c.sharded("untied"), prompt_buckets=None, prefill_chunk=4,
                  kv_dtype="int8")


def case_deadline_skew(c: Ctx):
    """Rank 1's clock jumps past every deadline after two steps; rank 0's
    never does. The ranks must still expire the same requests at the same
    step and finish with the same tokens."""
    from unittest import mock

    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

    srv = ContinuousBatchingServer(c.sharded("untied"), c.cfg, "cpu", slots=2,
                                   max_cache_length=MAX_LEN, eos_token_id=-1, steps_per_sync=1,
                                   prompt_buckets=None)
    rids = [srv.submit(prompt(s, seed)[0], PX[0], max_new_tokens=mn, timeout_s=1e4)
            for s, seed, mn in SERVER_SPECS]
    srv.step()
    srv.step()
    ahead = time.monotonic() + (1e6 if c.rank == 1 else 0.0)
    with mock.patch("time.monotonic", lambda: ahead):
        out = srv.run()
    return {"tokens": [out[r] for r in rids],
            "timed_out": [srv._results[r].timed_out for r in rids],
            "timeouts": srv.stats()["timeouts"]}


def case_prefix(c: Ctx):
    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer

    srv = ContinuousBatchingServer(c.sharded("tied"), c.cfg, "cpu", slots=2,
                                   max_cache_length=MAX_LEN, eos_token_id=-1, steps_per_sync=3,
                                   prompt_buckets=None)
    ids = prompt(14, 11, image=False)[0]
    pid = srv.register_prefix(ids[:8])
    rids = [srv.submit(ids, max_new_tokens=6), srv.submit(ids[:11], max_new_tokens=5,
                                                          prefix_id=pid)]
    out = srv.run()
    return {"tokens": [out[r] for r in rids], "hits": srv.stats()["prefix_hits"]}


def case_spec_lookup(c: Ctx):
    model = c.sharded("tied")
    ids = np.tile(prompt(6, 13, image=False), (1, 3))  # repeats give the lookup matches
    eng = _generate(c, model, ids, None, max_new_tokens=10, spec_lookup=2)
    srv = _serve(c, model, prompt_buckets=None, spec_lookup=2)
    return {"engine": eng["tokens"], "server": srv}


def case_load_sharded(c: Ctx):
    from llama32mm_tpu_torch.io.checkpoint import load_checkpoint_params
    from llama32mm_tpu_torch.parallel import param_shardings

    sh = param_shardings(c.cfg, c.mesh)
    out = {}
    for kind, kw in (("float", dict(streaming=True)),
                     ("int8", dict(streaming=True, quantize_int8=True)),
                     ("int4", dict(streaming=True, quantize_int4=True, int4_group_size=32))):
        whole = load_checkpoint_params(c.ckpt, c.cfg, "cpu", verbose=False, **kw)
        local = load_checkpoint_params(c.ckpt, c.cfg, "cpu", verbose=False, shardings=sh, **kw)
        plan = param_shardings(c.cfg, c.mesh, whole)
        named = dict(whole.named_parameters()) | dict(whole.named_buffers())
        mine = dict(local.named_parameters()) | dict(local.named_buffers())
        assert set(named) == set(mine), sorted(set(named) ^ set(mine))
        out[kind] = {
            "equal": all(torch.equal(plan[n].local(t), mine[n]) for n, t in named.items()),
            "split": sum(plan[n].dim is not None for n in named),
            "logits": _logits(local, c.cfg),
        }
    return out


def case_abstract_state(c: Ctx):
    from llama32mm_tpu_torch.io.distributed import abstract_state
    from llama32mm_tpu_torch.parallel import param_shardings

    model = c.models["untied"]
    spec = abstract_state(dict(model.state_dict()), param_shardings(c.cfg, c.mesh, model))
    return {n: tuple(s.shape) for n, s in spec.items()}


def case_refusals(c: Ctx):
    """Each feature once refused under TP runs (sequence parallelism: a
    forward at sp=2 whose token chunks' logits equal the one-device
    forward's; the bank server, the draft engine and the HTTP front end
    serve a request; tests/test_torch_tp_serving.py holds their tokens to
    the JAX package)."""
    from llama32mm_tpu_torch.inference.engine import InferenceEngine
    from llama32mm_tpu_torch.inference.http_server import ServingFrontend, follow
    from llama32mm_tpu_torch.inference.server import ContinuousBatchingServer
    from llama32mm_tpu_torch.models.vlm import vlm_forward
    from llama32mm_tpu_torch.parallel import AXIS_SP, create_mesh, shard_params
    from llama32mm_tpu_torch.train.lora import (
        init_lora_params,
        stack_adapter_bank,
        zero_lora_params,
    )

    model = c.sharded("tied")
    tc = c.cfg.text_config
    ids = torch.as_tensor(prompt(6, 3, image=False))
    lora = init_lora_params(torch.Generator().manual_seed(1), tc, rank=2)
    bank_tree = stack_adapter_bank([zero_lora_params(tc, rank=2, device="cpu"), lora])

    def server(**kw):
        return ContinuousBatchingServer(model, c.cfg, "cpu", slots=2, max_cache_length=MAX_LEN,
                                        **kw)

    def bank():
        srv = server(adapter_bank=bank_tree, eos_token_id=-1)
        srv.submit(ids[0], max_new_tokens=3, adapter_id=1)
        srv.run()

    def draft():
        eng = InferenceEngine(model, c.cfg, "cpu", max_cache_length=MAX_LEN, spec_draft=2,
                              draft_params=c.models["tied"].language_model, draft_config=tc)
        eng.generate(ids, max_new_tokens=3, eos_token_id=-1)

    def http():
        srv = server(eos_token_id=-1)
        if c.rank > 0:
            return follow(srv)
        frontend = ServingFrontend(srv)
        try:
            frontend.wait(frontend.submit(ids[0].numpy(), None, 3), timeout=60)
        finally:
            frontend.shutdown()

    def training():
        norm = model.language_model.model.final_norm.weight  # shared with the whole model
        norm.requires_grad_(True)
        try:
            vlm_forward(model, c.cfg, input_ids=ids)
        finally:
            norm.requires_grad_(False)

    def sp_mesh():
        mesh = create_mesh(sp=2)
        chunk = slice(3 * mesh.rank(AXIS_SP), 3 * mesh.rank(AXIS_SP) + 3)
        with torch.no_grad():
            want = vlm_forward(c.models["tied"], c.cfg, input_ids=ids).logits[:, chunk]
            got = vlm_forward(shard_params(c.models["tied"], c.cfg, mesh), c.cfg,
                              input_ids=ids[:, chunk].contiguous()).logits
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    attempts = {
        "lora": lambda: vlm_forward(model, c.cfg, input_ids=ids, lora=lora),
        "adapter_bank": bank,
        "draft": draft,
        "http": http,
        "training": training,
        "sequence_parallel": sp_mesh,
    }
    out = {}
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = "not_in_slice" if "ROADMAP.md" in str(e) else repr(e)
        except Exception as e:  # noqa: BLE001 - reported to the parent
            out[name] = repr(e)
    return out


# -- the cases of world 4 --------------------------------------------------------


def case_mesh4(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    mesh = create_mesh(dp=2, tp=2)
    errors = []
    for kw in (dict(dp=4, tp=4), dict(dp=2, tp=4, sp=2)):
        try:
            create_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    return {"shape": mesh.shape, "coords": mesh.coords, "errors": errors}


def case_forward_tp4(c: Ctx):
    m = c.sharded("tied")
    return {"logits": _logits(m, c.cfg), "kv_heads": m.language_model.model.tp.kv_heads,
            "W_key": m.language_model.model.blocks[0].att.W_key.weight.numpy()}


def case_engine_dp2_tp2_int8(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    mesh = create_mesh(dp=2, tp=2)
    ids, px = batch(2, 10, seed=21)
    return _generate(c, c.sharded("untied", mesh=mesh, quant=dict(bits=8)), ids, px,
                     max_new_tokens=6, kv_dtype="int8")


def case_server_dp2(c: Ctx):
    """The server at dp=2 x tp=2, a slot per data-parallel group."""
    from llama32mm_tpu_torch.parallel import create_mesh

    mesh = create_mesh(dp=2, tp=2)
    return _serve(c, c.sharded("untied", mesh=mesh), prompt_buckets=(16, 24))


CASES = {
    2: [case_mesh, case_placement, case_forward_tied, case_forward_untied, case_vision_tp,
        case_int8_forward, case_int4_forward, case_engine_greedy, case_engine_sampled,
        case_engine_int4_mixed, case_server_monolithic, case_server_chunked_int8kv,
        case_deadline_skew, case_prefix, case_spec_lookup, case_load_sharded, case_abstract_state, case_refusals],
    4: [case_mesh4, case_forward_tp4, case_engine_dp2_tp2_int8, case_server_dp2],
}


def _rank_main(rank: int, world: int, port: int, inputs: dict, queue, module: str) -> None:
    from llama32mm_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, f"tcp://localhost:{port}", device="cpu", timeout_s=120)
    try:
        mod = importlib.import_module(module)
        ctx = mod.Ctx(rank, world, inputs)
        for fn in mod.CASES[world]:
            name = fn.__name__[len("case_"):]
            try:
                queue.put((name, rank, fn(ctx)))
            except Exception:  # noqa: BLE001 - reported to the parent, which fails the case
                queue.put((name, rank, ("error", traceback.format_exc())))
                raise
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(world: int, inputs: dict, module: str = __name__) -> dict:
    """``{case: [result of rank 0, ..., rank world-1]}`` of ``module``'s
    cases; a case that raised on a rank holds ``("error", traceback)``
    there. Cases after a failed one are missing (the ranks' collectives
    would no longer line up)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.spawn(_rank_main, args=(world, free_port(), inputs, queue, module),
                     nprocs=world, join=False)
    results: dict = {}
    expected = world * len(importlib.import_module(module).CASES[world])
    while sum(len(v) for v in results.values()) < expected:
        if not queue.empty():
            name, rank, value = queue.get()
            results.setdefault(name, {})[rank] = value
        elif any(p.is_alive() for p in procs.processes):
            time.sleep(0.02)
        elif queue.empty():
            break
    try:
        procs.join()
    except ProcessException:
        pass  # the failed case is in the results
    return {name: [by_rank.get(r) for r in range(world)] for name, by_rank in results.items()}
