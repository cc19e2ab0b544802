"""The rank side of ``tests/test_torch_tp_train.py``: training over a mesh
(LoRA, QLoRA, full fine-tuning, ZeRO-1, the sharded checkpointer) in
spawned processes over gloo on the CPU. Like ``tests/torch_tp_ranks.py``
this module imports torch and the port only, never jax; the test module
computes the JAX oracles in the parent while the ranks run.

``start_world(world, inputs)`` starts ``world`` ranks, each of which runs
every case of its world size in order and sends back, per case, a
picklable result (numpy arrays, numbers, strings) or the error it raised;
``Run.results()`` collects them.
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
# the LoRA variants of world 4 (dp=2 x tp=2): keyword arguments of
# make_lora_train_step, and the adapter tree they train
LORA_VARIANTS = {
    "plain": ({}, "text"),
    "head": ({}, "head"),
    "remat": ({"remat": True}, "head"),
    "loss_chunk": ({"loss_chunk": 5}, "head"),
    "accum": ({"accum_steps": 2}, "head"),
    "dropout": ({"lora_dropout": 0.25}, "head"),
}
DROPOUT_SEED = 7
FULL_RUNS = {"plain": {}, "zero1": {"zero1": True},
             "zero1_masters": {"zero1": True, "zero1_masters": True},
             "tp4": {"tp4": True}}


def tiny_batch():
    """tests/test_sharding.py's (4, 12) batch, made with numpy: four
    ``<image>`` ids, then text; labels -100 on the image."""
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 246, (4, 12))
    ids[:, :4] = 250
    px = rs.randn(4, 3, 28, 28).astype(np.float32)
    labels = ids.copy()
    labels[:, :4] = -100
    return {"input_ids": ids, "pixel_values": px, "labels": labels}


def accum_batch(batch):
    """Two microbatches of two rows (``[2, 2, ...]``); the second row of the
    first microbatch, which dp rank 1 holds, is all padding."""
    out = {k: v.reshape(2, 2, *v.shape[1:]).copy() for k, v in batch.items()}
    out["labels"][0, 1] = -100
    return out


class Ctx:
    def __init__(self, rank, world, inputs):
        from llama32mm_tpu_torch.configs import tiny_mllama_config
        from llama32mm_tpu_torch.parallel import create_mesh

        self.rank, self.world, self.inputs = rank, world, inputs
        self.cfg = tiny_mllama_config()
        self.mesh = create_mesh(dp=2, tp=2) if world == 4 else create_mesh(tp=2)
        self.dir = inputs["dir"]

    def model(self, key="tied", mesh=None, vision_tp=False):
        """A fresh local model of the parent's tree ``key``."""
        from llama32mm_tpu_torch.convert import from_jax_params
        from llama32mm_tpu_torch.parallel import shard_params

        whole = from_jax_params(self.inputs["trees"][key], self.cfg, "cpu")
        return shard_params(whole, self.cfg, mesh or self.mesh, vision_tp=vision_tp)

    def batch(self, batch=None, dim=0, mesh=None):
        """This rank's rows (``dim``) of the batch, as tensors."""
        from llama32mm_tpu_torch.parallel import AXIS_DP, Placement

        mesh = mesh or self.mesh
        pl = Placement(mesh, dim, mesh.shape[AXIS_DP], AXIS_DP)
        batch = tiny_batch() if batch is None else batch
        return {k: pl.local(torch.from_numpy(v)).contiguous() for k, v in batch.items()}

    def lora(self, kind):
        from llama32mm_tpu_torch.convert import lora_from_jax

        return lora_from_jax(self.inputs["lora"][kind], "cpu")


def _lora_flat(lora):
    from llama32mm_tpu_torch.train.lora import lora_leaves

    return {k: t.detach().numpy().copy() for k, t in lora_leaves(lora).items()}


def _slices(named: dict) -> dict:
    """``{name: (box, array)}`` of local tensors (the box of the whole
    tensor each holds; the whole tensor when it has no placement)."""
    from llama32mm_tpu_torch.parallel import placement_of

    out = {}
    for name, t in named.items():
        pl = placement_of(t)
        box = ([(0, n) for n in t.shape] if pl is None else pl.box(pl.full_shape(t.shape)))
        out[name] = (box, t.detach().float().numpy().copy())
    return out


def lora_step(c: Ctx, model, kind, kw, batch):
    from llama32mm_tpu_torch.train.lora import make_lora_train_step

    init, step = make_lora_train_step(c.cfg, learning_rate=LR, **kw)
    state = init(c.lora(kind))
    rng = torch.Generator().manual_seed(DROPOUT_SEED) if kw.get("lora_dropout") else None
    state, loss = step(model, state, batch, rng)
    return {"loss": float(loss), "lora": _lora_flat(state.lora)}


# -- world 4: dp=2 x tp=2 ------------------------------------------------------


def case_lora(c: Ctx):
    from llama32mm_tpu_torch.parallel import create_mesh

    out = {}
    for name, (kw, kind) in LORA_VARIANTS.items():
        batch = (c.batch(accum_batch(tiny_batch()), dim=1) if kw.get("accum_steps")
                 else c.batch())
        out[name] = lora_step(c, c.model(), kind, kw, batch)
    # tp=4: each of the two kv heads held by two ranks
    tp4 = create_mesh(tp=4)
    out["tp4"] = lora_step(c, c.model(mesh=tp4), "head", {}, c.batch(mesh=tp4))
    return out


def full_run(c: Ctx, steps=STEPS, zero1=False, zero1_masters=False, optimizer="adamw",
             max_grad_norm=1.0, vision_tp=False, mesh=None, tp4=False):
    from llama32mm_tpu_torch.parallel import create_mesh
    from llama32mm_tpu_torch.train.full import make_train_step

    if tp4:  # each of the two kv heads held by two ranks: their gradients summed
        mesh = create_mesh(tp=4)
    model = c.model(mesh=mesh, vision_tp=vision_tp)
    init, step = make_train_step(c.cfg, learning_rate=LR, max_grad_norm=max_grad_norm,
                                 optimizer=optimizer, zero1_params=model if zero1 else None,
                                 zero1_masters=zero1_masters)
    state = init(model)
    batch = c.batch(mesh=mesh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return model, state, step, batch, losses


def case_full(c: Ctx):
    from llama32mm_tpu_torch.parallel import Placement, placement_of, zero1_shardings

    out = {}
    for name, kw in FULL_RUNS.items():
        model, state, _, _, losses = full_run(c, **kw)
        z1 = zero1_shardings(model)
        whole = {n: (placement_of(t) or Placement(z1[n].mesh)).full_shape(t.shape)
                 for n, t in model.named_parameters()}
        out[name] = {
            "losses": losses, "params": _slices(state.params),
            "mu_shapes": {n: tuple(m.shape) for n, m in state.opt_state.mu.items()},
            "z1_shapes": {n: z1[n].local_shape(shape) for n, shape in whole.items()},
            "tp_shapes": {n: tuple(t.shape) for n, t in model.named_parameters()},
            "whole_shapes": whole,
        }
    return out


def case_ckpt_resume(c: Ctx):
    """ZeRO-1 with dp-sharded masters: 2 steps, a save, 2 more; the restored
    state's 2 steps must give the same bits."""
    from llama32mm_tpu_torch.io import ShardedCheckpointer, abstract_state

    _, state, step, batch, _ = full_run(c, steps=2, zero1=True, zero1_masters=True)
    ck = ShardedCheckpointer()
    path = os.path.join(c.dir, "resume")
    ck.save(path, state)
    template = abstract_state(state)
    ref_losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        ref_losses.append(loss.item())
    restored = ck.restore(path, template)
    got_losses = []
    for _ in range(2):
        restored, loss = step(restored, batch)
        got_losses.append(loss.item())
    same = all(torch.equal(restored.params[n], t) for n, t in state.params.items())
    same_mu = all(torch.equal(restored.opt_state.mu[n], t) for n, t in state.opt_state.mu.items())
    ck.close()
    return {"ref": ref_losses, "got": got_losses, "params_equal": same, "mu_equal": same_mu,
            "step": restored.step, "count": restored.opt_state.count}


def case_ckpt_other_mesh(c: Ctx):
    """A ZeRO-1 state saved at dp=2 x tp=2 restored onto dp=4 x tp=1 and
    onto tp=4: both sides' slices, which the parent assembles."""
    from llama32mm_tpu_torch.io import ShardedCheckpointer, abstract_state
    from llama32mm_tpu_torch.parallel import create_mesh, shard_params, zero1_shardings

    model, state, _, _, _ = full_run(c, steps=1, zero1=True, zero1_masters=True)
    tree = {"params": state.params, "mu": state.opt_state.mu}
    ck = ShardedCheckpointer()
    path = os.path.join(c.dir, "other_mesh")
    ck.save(path, tree)
    out = {"saved": {k: _slices(v) for k, v in tree.items()}}
    from llama32mm_tpu_torch.convert import from_jax_params

    whole = from_jax_params(c.inputs["trees"]["tied"], c.cfg, "cpu")
    whole_named = dict(whole.named_parameters())
    for label, kw in (("dp4", dict(dp=4, tp=1)), ("tp4", dict(tp=4))):
        mesh = create_mesh(**kw)
        z1 = zero1_shardings(shard_params(whole, c.cfg, mesh))
        template = abstract_state({"params": whole_named, "mu": whole_named},
                                  {"params": z1, "mu": z1})
        got = ck.restore(path, template)
        out[label] = {k: _slices(v) for k, v in got.items()}
    ck.close()
    return out


def case_ckpt_async(c: Ctx):
    from llama32mm_tpu_torch.io import ShardedCheckpointer, abstract_state

    _, state, step, batch, _ = full_run(c, steps=1, zero1=True)
    snapshot = {n: t.detach().clone() for n, t in state.params.items()}
    ck = ShardedCheckpointer()
    path = os.path.join(c.dir, "async")
    ck.save(path, state, wait=False)
    for _ in range(2):  # train on while the write is in flight
        state, _ = step(state, batch)
    ck.wait()
    restored = ck.restore(path, abstract_state(state))
    ck.close()
    return {"restored_equal": all(torch.equal(restored.params[n], t)
                                  for n, t in snapshot.items()),
            "moved": any(not torch.equal(state.params[n], t) for n, t in snapshot.items()),
            "step": restored.step}


def case_ckpt_quantized(c: Ctx):
    from llama32mm_tpu_torch.io import ShardedCheckpointer, abstract_state
    from llama32mm_tpu_torch.convert import from_jax_params
    from llama32mm_tpu_torch.models.quantize import quantize_llama_params
    from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE
    from llama32mm_tpu_torch.parallel import shard_params

    out = {}
    for kind, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE))):
        whole = from_jax_params(c.inputs["trees"]["untied"], c.cfg, "cpu")
        local = shard_params(quantize_llama_params(whole, **kw), c.cfg, c.mesh)
        tree = dict(local.named_parameters()) | dict(local.named_buffers())
        ck = ShardedCheckpointer()
        path = os.path.join(c.dir, f"quant_{kind}")
        ck.save(path, tree)
        got = ck.restore(path, abstract_state(tree))
        ck.close()
        out[kind] = {"equal": all(torch.equal(got[n], t) and got[n].dtype == t.dtype
                                  for n, t in tree.items()),
                     "dtypes": sorted({str(t.dtype) for t in got.values()})}
    return out


def case_ckpt_manager(c: Ctx):
    """Rotation, the latest step, and a run resumed from step 3 that equals
    the straight run's step 4."""
    from llama32mm_tpu_torch.io import TrainCheckpointManager, abstract_state

    model, state, step, batch, _ = full_run(c, steps=0, zero1=True)
    mgr = TrainCheckpointManager(os.path.join(c.dir, "run"), max_to_keep=2)
    saved = {}
    for i in range(4):
        state, _ = step(state, batch)
        assert mgr.save(state.step, state, force=True)
        saved[state.step] = {n: t.detach().clone() for n, t in state.params.items()}
    mgr.wait()
    template = abstract_state(state)
    latest = mgr.restore(template)
    three = mgr.restore(template, step=3)
    out = {"steps": mgr.all_steps(), "latest": mgr.latest_step(),
           "latest_equal": all(torch.equal(latest.params[n], t) for n, t in saved[4].items()),
           "three_equal": all(torch.equal(three.params[n], saved[3][n]) for n in saved[3])}
    resumed, _ = step(three, batch)  # updates three's masters in place
    mgr.close()
    out["resumed_equal"] = all(torch.equal(resumed.params[n], t) for n, t in saved[4].items())
    return out


# -- world 2: tp=2 ---------------------------------------------------------------


def case_optimizers(c: Ctx):
    out = {}
    for name, kw in (("adafactor", dict(optimizer="adafactor", max_grad_norm=1e-2)),
                     ("clip", dict(max_grad_norm=1e-2)),
                     ("vision_tp", dict(vision_tp=True))):
        _, state, _, _, losses = full_run(c, **kw)
        out[name] = {"losses": losses, "params": _slices(state.params)}
    return out


def case_adafactor_factored(c: Ctx):
    """Adafactor's factored statistics over a split matrix: the sharded step
    (tp on each dim in turn) against the whole step, on this rank."""
    from llama32mm_tpu_torch.parallel import AXIS_TP, Placement
    from llama32mm_tpu_torch.train.optim import Adafactor

    rs = np.random.RandomState(5)
    whole = {"blocks.0.w": torch.from_numpy(rs.randn(256, 192).astype(np.float32)),
             "blocks.1.w": torch.from_numpy(rs.randn(256, 192).astype(np.float32)),
             "b": torch.from_numpy(rs.randn(192).astype(np.float32))}
    grads = {k: torch.from_numpy(rs.randn(*t.shape).astype(np.float32)) for k, t in whole.items()}
    tx = Adafactor(1e-2, max_grad_norm=1.0)
    want = {k: t.clone() for k, t in whole.items()}
    st = tx.init(want)
    for _ in range(2):
        st = tx.step(want, grads, st)
    errs = {}
    for dim in (0, 1):
        pls = {"blocks.0.w": Placement(c.mesh, dim, 2, AXIS_TP),
               "blocks.1.w": Placement(c.mesh, dim, 2, AXIS_TP), "b": Placement(c.mesh)}
        got = {k: pls[k].local(t).clone() for k, t in whole.items()}
        g = {k: pls[k].local(t).clone() for k, t in grads.items()}
        st = tx.init(got, layouts=pls)
        for _ in range(2):
            st = tx.step(got, g, st, layouts=pls)
        errs[dim] = max(float((got[k] - pls[k].local(want[k])).abs().max()) for k in got)
        errs[f"{dim}_stats"] = len(st.v_row)
    return errs


def case_collect_stats(c: Ctx):
    from llama32mm_tpu_torch.models.vlm import vlm_forward

    b = tiny_batch()
    with torch.no_grad():
        out = vlm_forward(c.model(), c.cfg, input_ids=torch.from_numpy(b["input_ids"]),
                          pixel_values=torch.from_numpy(b["pixel_values"]), collect_stats=True)
    return {k: v.numpy() for k, v in out.stats.items()}


def case_qlora(c: Ctx):
    from llama32mm_tpu_torch.convert import from_jax_params
    from llama32mm_tpu_torch.parallel import shard_params

    out = {}
    for kind in ("int8", "int4_mixed"):
        model = shard_params(from_jax_params(c.inputs["trees"][kind], c.cfg, "cpu"), c.cfg,
                             c.mesh)
        base = {n: t.clone() for n, t in model.named_buffers()}
        out[kind] = lora_step(c, model, "head", {}, c.batch())
        out[kind]["base_unchanged"] = all(torch.equal(t, base[n])
                                          for n, t in model.named_buffers())
    return out


def case_collectives(c: Ctx):
    """Each differentiable collective's forward and gradient at tp=2 (rank r
    holds ``x + r``): ``f`` sums the gradient, ``g`` the value, the gather
    slices the gradient, ``all_gather`` and ``reduce_scatter`` are each
    other's transpose; outside autograd ``g`` sums in place."""
    from llama32mm_tpu_torch.parallel import (
        AXIS_TP,
        all_gather,
        copy_to_tp,
        gather_from_tp,
        reduce_from_tp,
        reduce_scatter,
    )

    out = {}
    base = torch.arange(6.0).reshape(2, 3)
    for name, fn in (("f", copy_to_tp), ("g", reduce_from_tp), ("gather", gather_from_tp),
                     ("all_gather", lambda x, m: all_gather(x, m, AXIS_TP, 0)),
                     ("reduce_scatter", lambda x, m: reduce_scatter(x, m, AXIS_TP, 0))):
        x = (base + c.rank).requires_grad_(True)
        y = fn(x, c.mesh)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * (1 + c.rank)
        (y * w).sum().backward()
        out[name] = {"y": y.detach().numpy().copy(), "grad": x.grad.numpy().copy(),
                     "is_x": y is x}
    plain = base + c.rank
    out["g_in_place"] = reduce_from_tp(plain, c.mesh) is plain and plain.numpy().copy()
    return out


CASES = {
    4: [case_lora, case_full, case_ckpt_resume, case_ckpt_other_mesh, case_ckpt_async,
        case_ckpt_quantized, case_ckpt_manager],
    2: [case_collectives, case_optimizers, case_adafactor_factored, case_collect_stats,
        case_qlora],
}


def _rank_main(rank: int, world: int, port: int, inputs: dict, queue) -> None:
    from llama32mm_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, f"tcp://localhost:{port}", device="cpu", timeout_s=120)
    try:
        ctx = Ctx(rank, world, inputs)
        for fn in CASES[world]:
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

    def __init__(self, world: int, inputs: dict):
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        self.world = world
        self.queue = mp.get_context("spawn").SimpleQueue()
        self.procs = mp.spawn(_rank_main, args=(world, free_port(), inputs, self.queue),
                              nprocs=world, join=False)
        self._results = None

    def results(self) -> dict:
        """``{case: [result of rank 0, ..., rank world-1]}``; a case that
        raised on a rank holds ``("error", traceback)`` there; cases after a
        failed one are missing."""
        if self._results is not None:
            return self._results
        results: dict = {}
        expected = self.world * len(CASES[self.world])
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


def start_world(world: int, inputs: dict) -> Run:
    return Run(world, inputs)
