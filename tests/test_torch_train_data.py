"""The port's training data pipeline (``train/data.py``) and its run-dir
checkpoints (``io/distributed.py``).

Packing, the seeded per-epoch order and resume are the JAX package's numpy
code, so every batch must equal JAX's bit for bit. The prefetch stages
batches on the asked device, keeps their order, relays the inner
iterator's error at the matching ``next()`` and never falls back to the CPU
when the GPU was asked for. The checkpoint manager round-trips a LoRA train
state (adapters, Adam moments, counts) and a ``DataState`` exactly, keeps
the newest ``max_to_keep`` steps and refuses a template that does not fit.
"""

import os

import numpy as np
import pytest
import torch

from llama32mm_tpu.train import data as jax_data
from llama32mm_tpu_torch.configs import tiny_mllama_config
from llama32mm_tpu_torch.io import ShardedCheckpointer, TrainCheckpointManager, abstract_state
from llama32mm_tpu_torch.train.data import (
    DataState,
    PackedBatchIterator,
    pack_documents,
    prefetch_to_device,
)
from llama32mm_tpu_torch.train.lora import init_lora_params, lora_leaves, make_lora_train_step


def _docs(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(3, 500, rs.randint(0, 40))) for _ in range(n)]


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_pack_documents_equals_jax():
    docs = _docs()
    _equal(pack_documents(docs, 16, eos_id=2, pad_id=1), jax_data.pack_documents(docs, 16, 2, 1))
    with pytest.raises(ValueError, match="seq_len"):
        pack_documents(docs, 1, 2)
    with pytest.raises(ValueError, match="no non-empty"):
        pack_documents([[], []], 8, 2)


@pytest.mark.parametrize("shuffle", [True, False])
def test_iterator_and_resume_equal_jax(shuffle):
    """Twenty batches (several epochs, the partial tail dropped each time), a
    resume from the state after batch 4 in both packages, and the state's
    values."""
    docs = _docs()
    it = PackedBatchIterator(docs, 3, 16, eos_id=2, seed=5, shuffle=shuffle)
    jit = jax_data.PackedBatchIterator(docs, 3, 16, eos_id=2, seed=5, shuffle=shuffle)
    states = []
    for _ in range(20):
        _equal(next(it), next(jit))
        states.append(it.state)
        assert tuple(int(x) for x in it.state) == tuple(int(x) for x in jit.state)
    assert int(it.state.epoch) >= 2
    resumed = PackedBatchIterator.from_state(docs, 3, 16, 2, states[4], shuffle=shuffle)
    jresumed = jax_data.PackedBatchIterator.from_state(docs, 3, 16, 2, states[4],
                                                       shuffle=shuffle)
    again = PackedBatchIterator(docs, 3, 16, eos_id=2, seed=5, shuffle=shuffle)
    for _ in range(5):
        next(again)
    for _ in range(5):
        b = next(resumed)
        _equal(b, next(jresumed))
        _equal(b, next(again))
    assert isinstance(it.state, DataState) and isinstance(it.state.row, np.int64)


def test_prefetch_places_orders_and_passes_leaves():
    docs = _docs()
    inner = PackedBatchIterator(docs, 2, 16, eos_id=2)

    def with_state(it):
        while True:
            b = next(it)
            yield b, it.state

    stream = prefetch_to_device(with_state(inner), size=2, device="cpu")
    ref = PackedBatchIterator(docs, 2, 16, eos_id=2)
    for i in range(6):
        batch, state = next(stream)
        expect = next(ref)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in batch.values())
        for k in expect:
            np.testing.assert_array_equal(batch[k].numpy(), expect[k])
        assert isinstance(state, DataState) and state == ref.state


def test_prefetch_relays_errors_and_ends():
    def inner():
        yield {"x": np.arange(3)}
        yield {"x": np.arange(3) + 1}
        raise RuntimeError("corpus went away")

    stream = prefetch_to_device(inner(), size=4, device="cpu")
    assert next(stream)["x"].tolist() == [0, 1, 2]
    assert next(stream)["x"].tolist() == [1, 2, 3]
    with pytest.raises(RuntimeError, match="corpus went away"):
        next(stream)
    assert list(prefetch_to_device(iter([{"x": np.zeros(1)}]), device="cpu"))[0]["x"].shape == (1,)


def test_prefetch_never_falls_back_to_the_cpu():
    """The default device is the GPU; without one the first ``next()``
    raises instead of staging on the CPU."""
    stream = prefetch_to_device(iter([{"x": np.zeros(2)}]))
    if torch.cuda.is_available():
        assert next(stream)["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(stream)


def _lora_state(seed=0):
    cfg = tiny_mllama_config()
    lora = init_lora_params(torch.Generator().manual_seed(seed), cfg.text_config, rank=2)
    init, _ = make_lora_train_step(cfg)
    state = init(lora)
    with torch.no_grad():
        for t in (*state.opt_state.mu.values(), *state.opt_state.nu.values()):
            t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return state._replace(step=7, opt_state=state.opt_state.__class__(
        count=7, mu=state.opt_state.mu, nu=state.opt_state.nu))


def test_checkpoint_manager_round_trip_and_rotation(tmp_path):
    state = _lora_state()
    tree = {"train": state, "data": DataState(np.int64(2), np.int64(9), np.int64(5)),
            "note": None}
    mgr = TrainCheckpointManager(str(tmp_path / "run"), max_to_keep=3)
    for step in (2, 4, 6, 8):
        assert mgr.save(step, tree, force=step == 8)
    mgr.wait()
    assert mgr.all_steps() == [4, 6, 8] and mgr.latest_step() == 8
    assert not [n for n in os.listdir(tmp_path / "run") if "tmp" in n]
    template = abstract_state({"train": _lora_state(seed=3), "data": DataState(
        np.int64(0), np.int64(0), np.int64(0)), "note": None})
    got = TrainCheckpointManager(str(tmp_path / "run")).restore(template)
    assert got["note"] is None and got["data"] == tree["data"]
    assert isinstance(got["data"].row, np.int64)
    assert got["train"].step == 7 and got["train"].opt_state.count == 7
    for name, t in lora_leaves(state.lora).items():
        r = lora_leaves(got["train"].lora)[name]
        assert torch.equal(r, t) and r.requires_grad  # trainable again
        assert torch.equal(got["train"].opt_state.mu[name], state.opt_state.mu[name])
        assert torch.equal(got["train"].opt_state.nu[name], state.opt_state.nu[name])
    assert mgr.restore(template, step=4)["train"].step == 7
    mgr.close()


def test_checkpoint_manager_refusals(tmp_path):
    mgr = TrainCheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        mgr.restore({"w": torch.zeros(3)})
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        mgr.restore({"w": torch.zeros(4)})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.zeros(3)})
    # a target layout is ported (tests/test_torch_tp.py): a placed leaf takes
    # this rank's local shape, an unplaced one stays whole
    from llama32mm_tpu_torch.parallel import Mesh, Placement

    spec = abstract_state({"w": torch.zeros(4, 3), "b": torch.zeros(3)},
                          shardings={"w": Placement(Mesh({"tp": 2}), 0, 2), "b": None})
    assert spec["w"].shape == (2, 3) and spec["b"].shape == (3,)
    # the sharded checkpointer, once refused, reads a placed leaf's slice
    ck = ShardedCheckpointer()
    tree = {"w": torch.arange(12.0).reshape(4, 3), "b": torch.ones(3)}
    ck.save(str(tmp_path / "ck"), tree)
    got = ck.restore(str(tmp_path / "ck"), spec)
    assert torch.equal(got["w"], tree["w"][:2]) and torch.equal(got["b"], tree["b"])
    ck.close()
    every2 = TrainCheckpointManager(str(tmp_path / "run2"), save_interval_steps=2,
                                    async_save=False)
    assert not every2.save(3, {"w": torch.zeros(3)})
    assert every2.save(3, {"w": torch.zeros(3)}, force=True) and every2.save(4, {"w": torch.ones(3)})
    every2.wait()
    assert every2.all_steps() == [3, 4]
