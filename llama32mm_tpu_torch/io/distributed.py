"""Rotating step checkpoints of a training run on one device (counterpart
of the one-device part of ``llama32mm_tpu/io/distributed.py``).

``TrainCheckpointManager(directory, max_to_keep)`` keeps the newest
``max_to_keep`` steps of a run directory, one directory per step:

- ``<directory>/<step>/tensors.safetensors`` holds every tensor of the saved
  tree (written by ``utils/st_file.py``), keyed by its path in the tree;
- ``<directory>/<step>/tree.json`` holds the tree's other leaves (the
  optimizer's update count, the step, a ``DataState``'s integers, ``None``)
  and the path, dtype and shape of each tensor.

A step is written under a temporary name and renamed when complete, so an
interrupted save never replaces a finished step; the oldest steps are then
removed. ``save`` copies the tensors to the host before it returns and
writes the files on a background thread (``wait`` joins it), so training
may continue meanwhile. ``restore(template)`` rebuilds a tree of the
template's structure: each tensor is created on the template's device with
its dtype and ``requires_grad``, after its shape and dtype are checked. The
template is a concrete tree or :func:`abstract_state` of one.

Trees are nested dicts, lists, tuples, named tuples (``LoraTrainState``,
``DataState``) and dataclasses (``AdamState``) of tensors and scalars.

``abstract_state(tree, shardings)`` gives each placed tensor its rank's local
shape (tensor parallelism, ``parallel/sharding.py``). Not here: the
multi-device ``ShardedCheckpointer`` (ROADMAP.md, queue 1, multi-GPU). The JAX package's orbax
directories are not read, nor written: the layouts differ.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.parallel.sharding import Placement
from llama32mm_tpu_torch.utils import st_file

__all__ = ["ShardedCheckpointer", "TensorSpec", "TrainCheckpointManager", "abstract_state"]

_TENSORS = "tensors.safetensors"
_TREE = "tree.json"


class TensorSpec(NamedTuple):
    """A tensor leaf of a template: what ``restore`` creates in its place."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool = False


def _map(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(path, leaf)``."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)

    if isinstance(tree, dict):
        return {k: _map(v, fn, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not isinstance(tree, TensorSpec):
        return type(tree)(*(_map(getattr(tree, f), fn, sub(f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return type(tree)(_map(v, fn, sub(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map(getattr(tree, f.name), fn, sub(f.name))
                             for f in dataclasses.fields(tree)})
    return fn(path, tree)


def abstract_state(tree: Any, shardings: Optional[Any] = None) -> Any:
    """The template ``restore`` needs, from a concrete state tree: every
    tensor leaf becomes a :class:`TensorSpec` (shape, dtype, device,
    ``requires_grad``); other leaves stay. ``shardings``, a tree of the same
    structure (or a flat ``{path: Placement}``, e.g. ``param_shardings`` for
    a ``state_dict``) whose leaves are ``parallel/sharding.py::Placement``
    or None, is the target layout: a placed leaf's spec takes this rank's
    local shape and the mesh's device."""
    placed = {}
    if isinstance(shardings, dict) and all(isinstance(v, Placement)
                                           for v in shardings.values()):
        placed = dict(shardings)
    elif shardings is not None:
        _map(shardings, lambda path, leaf: placed.__setitem__(path, leaf))

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl = placed.get(path)
        if isinstance(pl, Placement):
            return TensorSpec(pl.local_shape(leaf.shape), leaf.dtype, pl.mesh.device,
                              leaf.requires_grad)
        return TensorSpec(tuple(leaf.shape), leaf.dtype, leaf.device, leaf.requires_grad)

    return _map(tree, one)


def _scalar(leaf) -> dict:
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return {"value": leaf}
    if isinstance(leaf, np.generic):
        return {"value": leaf.item(), "numpy": leaf.dtype.name}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _snapshot(tree: Any) -> tuple:
    """``(host tensors by path, the JSON record)`` of a tree."""
    tensors, record = {}, {"tensors": {}, "scalars": {}}

    def one(path, leaf):
        if isinstance(leaf, torch.Tensor):
            tensors[path] = leaf.detach().to("cpu", copy=True).contiguous()
            record["tensors"][path] = {"dtype": str(leaf.dtype).replace("torch.", ""),
                                       "shape": list(leaf.shape)}
        else:
            record["scalars"][path] = _scalar(leaf)
        return leaf

    _map(tree, one)
    return tensors, record


def _restore_scalar(entry: dict):
    value = entry["value"]
    return getattr(np, entry["numpy"])(value) if "numpy" in entry else value


class TrainCheckpointManager:
    """Rotating step-indexed checkpoints over one run directory.

    >>> mgr = TrainCheckpointManager(run_dir, max_to_keep=3)
    >>> mgr.save(step, {"train": state, "data": it.state})
    >>> mgr.wait()
    >>> tree = mgr.restore(abstract_state({"train": state, "data": it.state}))
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, async_save: bool = True) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` at ``step``; returns False when the
        ``save_interval_steps`` policy skips this step (``force`` saves
        anyway). The tensors are on the host when this returns."""
        if not force and step % self.save_interval_steps:
            return False
        self.wait()
        tensors, record = _snapshot(state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, tensors, record),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, tensors, record)
            self._raise()
        return True

    def _write(self, step: int, tensors: dict, record: dict) -> None:
        try:
            final = self._step_dir(step)
            tmp = f"{final}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            st_file.save_file(tensors, os.path.join(tmp, _TENSORS))
            with open(os.path.join(tmp, _TREE), "w", encoding="utf-8") as f:
                json.dump(record, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        except BaseException as e:  # noqa: BLE001 — raised by wait() / the next save
            self._error = e

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (default: the latest), in the structure
        of ``template`` (a concrete tree or ``abstract_state`` of one)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint steps under {self.directory}")
        path = self._step_dir(step)
        with open(os.path.join(path, _TREE), encoding="utf-8") as f:
            record = json.load(f)
        data = st_file.load_file(os.path.join(path, _TENSORS))

        def one(key, leaf):
            if isinstance(leaf, torch.Tensor):
                leaf = abstract_state(leaf)
            if isinstance(leaf, TensorSpec):
                if key not in data:
                    raise KeyError(f"checkpoint step {step} has no tensor at {key!r}")
                src = data[key]
                if tuple(src.shape) != tuple(leaf.shape) or src.dtype != leaf.dtype:
                    raise ValueError(f"checkpoint mismatch at {key}: template "
                                     f"{tuple(leaf.shape)} {leaf.dtype}, file "
                                     f"{tuple(src.shape)} {src.dtype}")
                out = src.to(leaf.device)
                return out.requires_grad_(True) if leaf.requires_grad else out
            if key not in record["scalars"]:
                raise KeyError(f"checkpoint step {step} has no leaf at {key!r}")
            return _restore_scalar(record["scalars"][key])

        return _map(template, one)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def wait(self) -> None:
        """Block until an in-flight save is on disk; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def close(self) -> None:
        self.wait()


class ShardedCheckpointer:
    """Multi-device sharded save and restore: not ported yet (ROADMAP.md,
    queue 1, multi-GPU)."""

    def __init__(self) -> None:
        not_in_slice("ShardedCheckpointer (multi-device sharded checkpoints)")
