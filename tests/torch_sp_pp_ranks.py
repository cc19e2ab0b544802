"""The rank side of ``tests/test_torch_seq_parallel.py`` (suite ``"sp"``) and
``tests/test_torch_pipeline.py`` (suite ``"pp"``): sequence- and
pipeline-parallel cases in spawned processes over gloo on the CPU. Like
``tests/torch_tp_train_ranks.py`` this module imports torch and the port
only, never jax; the test modules compute the JAX oracles in the parent.

``start_world(suite, world, inputs)`` starts ``world`` ranks, each of which
runs every case of its suite and world size in order (meshes and
collectives are collective calls; a rank outside a case's mesh skips it)
and sends back, per case, a picklable result or the error it raised.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from torch_tp_ranks import free_port

LR = 1e-3
STEPS = 3
IMAGE_ID = 250
# the LoRA variants at dp=2 x tp=2 x sp=2: make_lora_train_step's keywords and
# the adapter tree they train ("text": the decoder's; "head": with the head's
# and the projector's)
LORA_VARIANTS = {
    "plain": ({}, "text"),
    "head": ({}, "head"),
    "remat": ({"remat": True}, "head"),
    "loss_chunk": ({"loss_chunk": 5}, "head"),
    "dropout": ({"lora_dropout": 0.25}, "head"),
}
DROPOUT_SEED = 7
# ring attention inputs (tests/test_ring_attention.py's shapes): per case the
# key-validity row's valid length and the query offset
ATTN_T = 512
ATTN_CASES = {"full": (ATTN_T, 0), "ragged": (300, 0), "offset": (ATTN_T, 17)}
PP_CONFIG = dict(vocab_size=256, hidden_size=64, n_heads=4, n_layers=4, hidden_dim=128,
                 n_kv_groups=2, dtype="float32")


def sp_batch():
    """B=4, S=16 with 4 ``<image>`` ids at 0, 6 (across the sp=2 chunk
    boundary at 8), 8 (the second chunk's start) and none; labels -100 on
    the image, so row 2's shift across the boundary lands on -100 and row
    0's on a valid label."""
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 246, (4, 16))
    for row, start in enumerate((0, 6, 8)):
        ids[row, start:start + 4] = IMAGE_ID
    labels = np.where(ids == IMAGE_ID, -100, ids)
    return {"input_ids": ids, "pixel_values": rs.randn(4, 3, 28, 28).astype(np.float32),
            "labels": labels}


def attn_inputs():
    rs = np.random.RandomState(0)
    q = rs.randn(1, 4, ATTN_T, 16).astype(np.float32)
    k, v = (rs.randn(1, 2, ATTN_T, 16).astype(np.float32) for _ in range(2))
    return q, k, v


def int8_kv():
    """int8 K and V with fp32 per-position scales ``[B, nkv, T]``."""
    rs = np.random.RandomState(4)
    k8, v8 = (rs.randint(-127, 128, (1, 2, ATTN_T, 16)).astype(np.int8) for _ in range(2))
    ks, vs = ((np.abs(rs.randn(1, 2, ATTN_T)) * 0.02 + 0.01).astype(np.float32)
              for _ in range(2))
    return k8, v8, ks, vs


def kv_valid(n_valid: int) -> np.ndarray:
    return (np.arange(ATTN_T)[None, :] < n_valid).astype(np.int32)


def pp_ids():
    return np.random.RandomState(1).randint(0, 255, (4, 16))


class Ctx:
    def __init__(self, rank, world, inputs):
        self.rank, self.world, self.inputs = rank, world, inputs


def _np(t):
    return t.detach().float().numpy().copy()


def _lora_flat(lora):
    from llama32mm_tpu_torch.train.lora import lora_leaves

    return {k: _np(t) for k, t in lora_leaves(lora).items()}


def _local_batch(mesh, batch):
    """This rank's rows and token chunk: ids and labels on (dp, sp), pixels
    on dp."""
    from llama32mm_tpu_torch.parallel import data_sharding, seq_data_sharding

    out = {}
    for k, v in batch.items():
        pl = data_sharding(mesh) if v.ndim == 4 else seq_data_sharding(mesh)
        out[k] = pl.local(torch.from_numpy(v)).contiguous()
    return out


# -- suite "sp", world 4 -----------------------------------------------------------


def case_ppermute(c: Ctx):
    """Rank r holds ``x + r``: the rotation by +1 and -1 at 2 and 4 ranks,
    and the gradient of ``sum(y * w_r)`` (the reverse rotation)."""
    from llama32mm_tpu_torch.parallel import AXIS_SP, create_mesh, ppermute

    out = {}
    for n in (2, 4):
        mesh = create_mesh(sp=n)
        if not mesh.member:
            continue
        r = mesh.rank(AXIS_SP)
        for shift in (1, -1):
            x = (torch.arange(6.0).reshape(2, 3) + r).requires_grad_(True)
            y = ppermute(x, mesh, AXIS_SP, shift)
            w = torch.arange(6.0).reshape(2, 3) * (1 + r)
            (y * w).sum().backward()
            out[n, shift] = {"y": _np(y), "grad": _np(x.grad),
                             "plain": _np(mesh.ppermute(x.detach(), AXIS_SP, shift))}
    return out


def case_attention(c: Ctx):
    """The ring and the all-gather layouts at sp=4: each rank's chunk of
    the output and of dq, dk, dv for ``sum(out ** 2)``."""
    from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
    from llama32mm_tpu_torch.parallel import AXIS_SP, create_mesh

    mesh = create_mesh(sp=4)
    r, n = mesh.rank(AXIS_SP), ATTN_T // 4
    q, k, v = (torch.from_numpy(a[:, :, r * n:(r + 1) * n].copy()) for a in attn_inputs())
    out = {}
    for case, (n_valid, q_offset) in ATTN_CASES.items():
        kvv = torch.from_numpy(kv_valid(n_valid)[:, r * n:(r + 1) * n].copy())
        for layout in ("ring", "gather"):
            qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
            o = gqa_attention(qq, kk, vv, AttnMask(kvv, r * n + q_offset), causal=True,
                              sp_mesh=mesh, sp_layout=layout)
            (o ** 2).sum().backward()
            out[case, layout] = [_np(t) for t in (o, qq.grad, kk.grad, vv.grad)]
    # int8 K/V with per-position scales: the all-gather layout, inference only
    k8, v8, ks, vs = (torch.from_numpy(a[:, :, r * n:(r + 1) * n].copy()) for a in int8_kv())
    kvv = torch.from_numpy(kv_valid(ATTN_T)[:, r * n:(r + 1) * n].copy())
    with torch.no_grad():
        out["int8"] = _np(gqa_attention(q, k8, v8, AttnMask(kvv, r * n), causal=True,
                                        k_scale=ks, v_scale=vs, sp_mesh=mesh))
    return out


def case_full_ft(c: Ctx):
    """Three AdamW steps (clip 1.0) at dp=2 x sp=2: the losses and every
    parameter (whole on every rank)."""
    from llama32mm_tpu_torch.configs import tiny_mllama_config
    from llama32mm_tpu_torch.convert import from_jax_params
    from llama32mm_tpu_torch.parallel import create_mesh, shard_params
    from llama32mm_tpu_torch.train.full import make_train_step

    cfg = tiny_mllama_config()
    mesh = create_mesh(dp=2, sp=2)
    model = shard_params(from_jax_params(c.inputs["tied"], cfg, "cpu"), cfg, mesh)
    init, step = make_train_step(cfg, learning_rate=LR)
    state = init(model)
    batch = _local_batch(mesh, sp_batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return {"losses": losses, "params": {n: _np(p) for n, p in state.params.items()}}


def case_collect_stats(c: Ctx):
    """The per-layer activation statistics at dp=2 x sp=2 (averaged over
    both axes)."""
    from llama32mm_tpu_torch.configs import tiny_mllama_config
    from llama32mm_tpu_torch.convert import from_jax_params
    from llama32mm_tpu_torch.models.vlm import vlm_forward
    from llama32mm_tpu_torch.parallel import create_mesh, shard_params

    cfg = tiny_mllama_config()
    mesh = create_mesh(dp=2, sp=2)
    model = shard_params(from_jax_params(c.inputs["tied"], cfg, "cpu"), cfg, mesh)
    b = _local_batch(mesh, sp_batch())
    with torch.no_grad():
        out = vlm_forward(model, cfg, input_ids=b["input_ids"], pixel_values=b["pixel_values"],
                          collect_stats=True)
    return {k: v.numpy() for k, v in out.stats.items()}


# -- suite "sp", world 8 -----------------------------------------------------------


def case_lora(c: Ctx):
    """One LoRA step of each variant at dp=2 x tp=2 x sp=2: the loss and
    every adapter leaf."""
    from llama32mm_tpu_torch.configs import tiny_mllama_config
    from llama32mm_tpu_torch.convert import from_jax_params, lora_from_jax
    from llama32mm_tpu_torch.parallel import create_mesh, shard_params
    from llama32mm_tpu_torch.train.lora import make_lora_train_step

    cfg = tiny_mllama_config()
    mesh = create_mesh(dp=2, tp=2, sp=2)
    batch = _local_batch(mesh, sp_batch())
    out = {}
    for name, (kw, kind) in LORA_VARIANTS.items():
        model = shard_params(from_jax_params(c.inputs["tied"], cfg, "cpu"), cfg, mesh)
        init, step = make_lora_train_step(cfg, learning_rate=LR, **kw)
        state = init(lora_from_jax(c.inputs["lora"][kind], "cpu"))
        rng = torch.Generator().manual_seed(DROPOUT_SEED) if kw.get("lora_dropout") else None
        state, loss = step(model, state, batch, rng)
        out[name] = {"loss": float(loss), "lora": _lora_flat(state.lora)}
    return out


# -- suite "pp" --------------------------------------------------------------------


def _pp_config():
    from llama32mm_tpu_torch.configs import LLAMA32Config

    return LLAMA32Config(**PP_CONFIG)


def _stage(c: Ctx, mesh, key="float", tp=False):
    from llama32mm_tpu_torch.convert import causal_lm_from_jax
    from llama32mm_tpu_torch.parallel import pipeline_shard_params

    lm = causal_lm_from_jax(c.inputs["pp_trees"][key], _pp_config(), "cpu")
    return pipeline_shard_params(lm, mesh, tp=tp)


def _pp_batch(mesh):
    from llama32mm_tpu_torch.parallel import data_sharding

    ids = data_sharding(mesh).local(torch.from_numpy(pp_ids())).contiguous()
    return {"input_ids": ids, "labels": ids}


def global_name(name: str, stage) -> str:
    """A stage's parameter name with its layer index made global."""
    parts = name.split(".")
    if "blocks" in parts:
        i = parts.index("blocks") + 1
        parts[i] = str(int(parts[i]) + stage.first_layer)
    return ".".join(parts)


def _boxes(named: dict, stage) -> dict:
    """``{global name: (box in the whole tensor, array)}``."""
    from llama32mm_tpu_torch.parallel import placement_of

    out = {}
    for name, t in named.items():
        pl = placement_of(t)
        box = [(0, n) for n in t.shape] if pl is None else pl.box(pl.full_shape(t.shape))
        out[global_name(name, stage)] = (box, _np(t))
    return out


def _pp_grads(c: Ctx, mesh, n_micro=2, tp=False, **kw):
    """The loss and each parameter's gradient (summed over dp) of the
    pipelined loss on this rank's stage."""
    from llama32mm_tpu_torch.parallel import AXIS_DP, pipeline_causal_lm_loss
    from llama32mm_tpu_torch.train.accum import all_reduce_flat

    model = _stage(c, mesh, tp=tp)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    b = _pp_batch(mesh)
    loss = pipeline_causal_lm_loss(model, _pp_config(), b["input_ids"], b["labels"], mesh,
                                   n_micro, **kw)
    grads = torch.autograd.grad(loss, list(params.values()))
    all_reduce_flat(list(grads), mesh, AXIS_DP)
    for p, g in zip(params.values(), grads):  # the gradients in the parameters' place
        p.data = g
    return float(loss), _boxes(params, model.model.stage)


def _replicated(model) -> dict:
    return {n: _np(p) for n, p in model.named_parameters() if ".blocks." not in n}


def case_pp_losses(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh, pipeline_causal_lm_loss

    out = {}
    for label, (dp, pp, m) in {"dp2_pp2": (2, 2, 2), "pp4": (1, 4, 4)}.items():
        mesh = create_mesh(dp=dp, pp=pp)
        model = _stage(c, mesh)
        b = _pp_batch(mesh)
        with torch.no_grad():
            loss = pipeline_causal_lm_loss(model, _pp_config(), b["input_ids"], b["labels"],
                                           mesh, m)
        out[label] = {"loss": float(loss), "layers": len(model.model.blocks)}
    return out


def case_pp_grads(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    loss, grads = _pp_grads(c, create_mesh(dp=2, pp=2))
    return {"loss": loss, "grads": grads}


def case_pp_remat(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    mesh = create_mesh(dp=1, pp=2)
    if not mesh.member:
        return None
    return {"plain": _pp_grads(c, mesh)[1], "remat": _pp_grads(c, mesh, remat=True)[1]}


def case_pp_chunked(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh, pipeline_causal_lm_loss

    mesh = create_mesh(dp=1, pp=2)
    if not mesh.member:
        return None
    model, b = _stage(c, mesh), _pp_batch(mesh)
    with torch.no_grad():
        return [float(pipeline_causal_lm_loss(model, _pp_config(), b["input_ids"], b["labels"],
                                              mesh, 2, loss_chunk=chunk)) for chunk in (None, 4)]


def case_pp_train(c: Ctx):
    """Three Adam steps (lr 1e-3) at dp=2 x pp=2: the losses, the replicated
    leaves after every step, the moments' names, the final parameters."""
    from llama32mm_tpu_torch.parallel import create_mesh, make_pipeline_train_step

    mesh = create_mesh(dp=2, pp=2)
    init, step = make_pipeline_train_step(_pp_config(), mesh, 2, learning_rate=1e-3)
    state = init(_stage(c, mesh))
    batch = _pp_batch(mesh)
    losses, replicated = [], []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
        replicated.append(_replicated(state.model))
    stage = state.model.model.stage
    return {"losses": losses, "replicated": replicated,
            "moments": sorted(global_name(n, stage) for n in state.opt_state.mu),
            "params": _boxes(dict(state.model.named_parameters()), stage)}


def case_pp_quantized(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh, pipeline_causal_lm_loss

    mesh = create_mesh(dp=2, pp=2)
    model, b = _stage(c, mesh, "int8"), _pp_batch(mesh)
    with torch.no_grad():
        loss = pipeline_causal_lm_loss(model, _pp_config(), b["input_ids"], b["labels"], mesh, 2)
    return {"loss": float(loss),
            "int8_blocks": sorted({str(t.dtype) for n, t in model.named_buffers()})}


def case_pp_qlora(c: Ctx):
    """Two QLoRA steps (lr 1e-2) over the int8 base at dp=2 x pp=2."""
    from llama32mm_tpu_torch.convert import lora_from_jax
    from llama32mm_tpu_torch.parallel import (
        create_mesh,
        make_pipeline_lora_train_step,
        pipeline_shard_lora,
    )

    mesh = create_mesh(dp=2, pp=2)
    model = _stage(c, mesh, "int8")
    base = {n: t.clone() for n, t in model.named_buffers()}
    init, step = make_pipeline_lora_train_step(_pp_config(), mesh, 2, learning_rate=1e-2)
    state = init(pipeline_shard_lora(lora_from_jax(c.inputs["pp_lora"], "cpu"), mesh))
    batch = _pp_batch(mesh)
    losses, heads = [], []
    for _ in range(2):
        state, loss = step(model, state, batch)
        losses.append(float(loss))
        heads.append({k: _np(t) for k, t in state.lora["lm_head"].items()})
    first = model.model.stage.first_layer
    return {"losses": losses, "heads": heads, "first": first,
            "W_query_b": _np(state.lora["blocks"]["W_query"]["lora_b"]),
            "mu_shape": tuple(state.opt_state.mu["blocks.W_query.lora_b"].shape),
            "base_unchanged": all(torch.equal(t, base[n]) for n, t in model.named_buffers())}


def case_pp_validation(c: Ctx):
    """What the pipeline refuses, each as its message."""
    from llama32mm_tpu_torch.configs import LLAMA32Config
    from llama32mm_tpu_torch.convert import causal_lm_from_jax
    from llama32mm_tpu_torch.parallel import (
        create_mesh,
        pipeline_causal_lm_loss,
        pipeline_shard_params,
        shard_params,
    )

    out = {}
    pp2, pp4, sp_pp = create_mesh(dp=1, pp=2), create_mesh(dp=1, pp=4), create_mesh(pp=2, sp=2)
    tc3 = LLAMA32Config(vocab_size=64, hidden_size=32, n_heads=2, n_layers=3, hidden_dim=64,
                        n_kv_groups=1, dtype="float32")
    attempts = {
        "layers": lambda: pipeline_shard_params(
            causal_lm_from_jax(c.inputs["pp_trees"]["three"], tc3, "cpu"), pp2),
        "batch": lambda: pipeline_causal_lm_loss(
            _stage(c, pp4), _pp_config(), torch.from_numpy(pp_ids()[:3]),
            torch.from_numpy(pp_ids()[:3]), pp4, 2),
        "sp_and_pp": lambda: shard_params(
            causal_lm_from_jax(c.inputs["pp_trees"]["float"], _pp_config(), "cpu"),
            _pp_config(), sp_pp),
    }
    for name, fn in attempts.items():
        if name == "layers" and not pp2.member:
            continue
        try:
            fn()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)
    return out


def case_pp_3d(c: Ctx):
    """dp=2 x pp=2 x tp=2: the loss and the gradients (each rank's TP slice
    of its stage's layers)."""
    from llama32mm_tpu_torch.parallel import create_mesh

    loss, grads = _pp_grads(c, create_mesh(dp=2, pp=2, tp=2), tp=True)
    return {"loss": loss, "grads": grads}


CASES = {
    ("sp", 4): [case_ppermute, case_attention, case_full_ft, case_collect_stats],
    ("sp", 8): [case_lora],
    ("pp", 4): [case_pp_losses, case_pp_grads, case_pp_remat, case_pp_chunked, case_pp_train,
                case_pp_quantized, case_pp_qlora, case_pp_validation],
    ("pp", 8): [case_pp_3d],
}


def _rank_main(rank: int, world: int, suite: str, port: int, inputs: dict, queue) -> None:
    from llama32mm_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, f"tcp://localhost:{port}", device="cpu", timeout_s=120)
    try:
        ctx = Ctx(rank, world, inputs)
        for fn in CASES[suite, world]:
            name = fn.__name__[len("case_"):]
            try:
                queue.put((name, rank, fn(ctx)))
            except Exception:  # noqa: BLE001 - reported to the parent, which fails the case
                queue.put((name, rank, ("error", traceback.format_exc())))
                raise
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Run:
    """A world of ranks started by ``start_world``."""

    def __init__(self, suite: str, world: int, inputs: dict):
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        self.suite, self.world = suite, world
        self.queue = mp.get_context("spawn").SimpleQueue()
        self.procs = mp.spawn(_rank_main, args=(world, suite, free_port(), inputs, self.queue),
                              nprocs=world, join=False)
        self._results = None

    def results(self) -> dict:
        """``{case: [result of rank 0, ..., rank world-1]}``; a case that
        raised on a rank holds ``("error", traceback)`` there; cases after a
        failed one are missing."""
        if self._results is not None:
            return self._results
        results: dict = {}
        expected = self.world * len(CASES[self.suite, self.world])
        while sum(len(v) for v in results.values()) < expected:
            if not self.queue.empty():
                name, rank, value = self.queue.get()
                results.setdefault(name, {})[rank] = value
            elif any(p.is_alive() for p in self.procs.processes):
                time.sleep(0.02)
            elif self.queue.empty():
                break
        try:
            self.procs.join()
        except ProcessException:
            pass  # the failed case is in the results
        self._results = {name: [by_rank.get(r) for r in range(self.world)]
                         for name, by_rank in results.items()}
        return self._results


def start_world(suite: str, world: int, inputs: dict) -> Run:
    return Run(suite, world, inputs)
