"""Checkpoints of sharded and one-device train states (counterpart of
``llama32mm_tpu/io/distributed.py``).

A checkpoint is a directory:

- ``tensors.safetensors`` (rank 0) and ``tensors.rank<r>.safetensors``
  (rank ``r > 0`` of the default process group): each rank writes only its
  own slices (``utils/st_file.py``), keyed by the tensor's path in the tree;
  a slice that several ranks hold (a replicated leaf, a tensor-parallel
  slice repeated over ``dp``) is written once, by the lowest of them;
- ``tree.json`` (rank 0): the tree's other leaves (the optimizer's update
  count, the step, a ``DataState``'s integers, ``None``) and, per tensor,
  its whole shape, its dtype and each written slice's file and box
  (``[start, length]`` per dim).

A tensor's slice is read from the ``parallel.Placement`` noted on it by
``shard_params``, the trainers and ``restore`` (``placement_of``; a
``state_dict()`` holds copies without one: save ``named_parameters()`` and
``named_buffers()``); a tensor without one is whole on every rank. ``restore(path, template)`` builds the template's structure:
each rank reads, from whichever files hold them, only the parts of the
slices that its template leaf's placement gives it (a checkpoint saved at
dp=2 × tp=2 restores onto dp=4 × tp=1, or onto one device), after the
whole shape and dtype are checked. The template is a concrete tree or
:func:`abstract_state` of one, which may name another mesh's placements.

Saving: the slices are copied to the host before ``save`` returns, then
written on a thread into ``<dir>.tmp``; ``wait()`` (or the next save)
joins the thread, and rank 0 then writes ``tree.json`` and renames the
directory into place, so an interrupted save never replaces a finished
one. With several ranks every rank calls ``save``, ``wait`` and
``restore`` (the commit is a barrier); all ranks share the file system.

``ShardedCheckpointer`` saves one tree to a directory;
``TrainCheckpointManager(directory, max_to_keep)`` keeps the newest
``max_to_keep`` steps of a run directory, one such directory a step.

Trees are nested dicts, lists, tuples, named tuples (``LoraTrainState``,
``FullTrainState``, ``DataState``) and dataclasses (``AdamState``) of
tensors and scalars. The JAX package's orbax directories are not read, nor
written: the layouts differ.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import shutil
import threading
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from llama32mm_tpu_torch.parallel.mesh import AXES, _grid
from llama32mm_tpu_torch.parallel.sharding import Placement, placement_of, set_placement
from llama32mm_tpu_torch.utils import st_file

__all__ = ["ShardedCheckpointer", "TensorSpec", "TrainCheckpointManager", "abstract_state"]

_TREE = "tree.json"


def _tensor_file(rank: int) -> str:
    return "tensors.safetensors" if rank == 0 else f"tensors.rank{rank}.safetensors"


class TensorSpec(NamedTuple):
    """A tensor leaf of a template: what ``restore`` creates in its place
    (``shape`` the local one; ``placement`` the slice of the whole tensor,
    None for all of it)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool = False
    placement: Optional[Placement] = None


def _map(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(path, leaf)``."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)

    if isinstance(tree, dict):
        return {k: _map(v, fn, sub(k)) for k, v in tree.items()}
    if isinstance(tree, nn.Module):  # a model's state (FullTrainState.module): not saved
        return tree
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
    ``requires_grad``, placement); other leaves stay. ``shardings``, a tree
    of the same structure (or a flat ``{path: Placement}``, e.g.
    ``param_shardings`` for a ``state_dict``) whose leaves are
    ``parallel.Placement`` or None, is the target layout: a placed leaf's
    spec takes the rank's local shape, the mesh's device and the placement.
    Without it a leaf keeps the placement noted for it (``placement_of``)."""
    placed = {}
    if isinstance(shardings, dict) and all(isinstance(v, Placement)
                                           for v in shardings.values()):
        placed = dict(shardings)
    elif shardings is not None:
        _map(shardings, lambda path, leaf: placed.__setitem__(path, leaf))

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if shardings is None:
            return TensorSpec(tuple(leaf.shape), leaf.dtype, leaf.device, leaf.requires_grad,
                              placement_of(leaf))
        pl = placed.get(path)
        if isinstance(pl, Placement):
            return TensorSpec(pl.local_shape(leaf.shape), leaf.dtype, pl.mesh.device,
                              leaf.requires_grad, pl)
        return TensorSpec(tuple(leaf.shape), leaf.dtype, leaf.device, leaf.requires_grad)

    return _map(tree, one)


def _scalar(leaf) -> dict:
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return {"value": leaf}
    if isinstance(leaf, np.generic):
        return {"value": leaf.item(), "numpy": leaf.dtype.name}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _restore_scalar(entry: dict):
    value = entry["value"]
    return getattr(np, entry["numpy"])(value) if "numpy" in entry else value


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _barrier() -> None:
    if _world()[0] > 1:
        dist.barrier()


def _holders(pl: Optional[Placement], whole: tuple, world: int) -> dict:
    """``{box: the lowest global rank holding it}`` of every slice of a
    tensor of shape ``whole`` (one box, rank 0's, without a placement)."""
    full = tuple((0, n) for n in whole)
    if pl is None or not pl.splits:
        return {full: 0}
    out: dict = {}
    for coords, rank in sorted(_grid(pl.mesh.shape).items(), key=lambda kv: kv[1]):
        if rank < world:
            box = tuple(pl.box(whole, dict(zip(AXES, coords))))
            out.setdefault(box, rank)
    return out


def _snapshot(tree: Any) -> tuple:
    """``(host copies of the slices this rank writes, the JSON record)``;
    every rank builds the same record."""
    world, me = _world()
    tensors, record = {}, {"tensors": {}, "scalars": {}}

    def one(path, leaf):
        if isinstance(leaf, torch.Tensor):
            pl = placement_of(leaf)
            whole = tuple(leaf.shape) if pl is None else pl.full_shape(leaf.shape)
            holders = _holders(pl, whole, world)
            mine = tuple((0, n) for n in whole) if pl is None else tuple(pl.box(whole))
            if holders.get(mine) == me:
                tensors[path] = leaf.detach().to("cpu", copy=True).contiguous()
            record["tensors"][path] = {
                "dtype": str(leaf.dtype).replace("torch.", ""), "shape": list(whole),
                "slices": [{"file": _tensor_file(r), "box": [list(b) for b in box]}
                           for box, r in holders.items()]}
        else:
            record["scalars"][path] = _scalar(leaf)
        return leaf

    _map(tree, one)
    return tensors, record


class _Files:
    """Private (copy-on-write) mappings of a checkpoint's tensor files,
    opened as needed; ``view(file, key)`` is a CPU tensor over the mapping,
    valid until ``close``."""

    def __init__(self, directory: str):
        self.directory, self.open = directory, {}

    def view(self, file: str, key: str) -> torch.Tensor:
        if file not in self.open:
            with open(os.path.join(self.directory, file), "rb") as fh:
                header, start = st_file.read_header(fh)
                mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
            self.open[file] = (header, start, mm)
        header, start, mm = self.open[file]
        if key not in header:
            raise KeyError(f"{file} has no tensor {key!r}")
        info = header[key]
        begin, end = info["data_offsets"]
        return st_file.tensor_view(mm, start + begin, end - begin, info["dtype"], info["shape"])

    def close(self) -> None:
        for _, _, mm in self.open.values():
            st_file.close_mapping(mm, "checkpoint mapping")
        self.open = {}


def _read(files: _Files, entry: dict, key: str, box: list, dtype: torch.dtype) -> torch.Tensor:
    """The ``box`` of the whole tensor ``key`` (a CPU tensor), assembled from
    the stored slices that overlap it."""
    out = torch.empty([n for _, n in box], dtype=dtype)
    slices = entry.get("slices") or [{"file": _tensor_file(0),
                                      "box": [[0, n] for n in entry["shape"]]}]
    covered = 0
    for sl in slices:
        inter = []
        for (want0, want_n), (have0, have_n) in zip(box, sl["box"]):
            lo, hi = max(want0, have0), min(want0 + want_n, have0 + have_n)
            if lo >= hi:
                break
            inter.append((lo, hi))
        else:
            src = files.view(sl["file"], key)
            dst = out
            for d, (lo, hi) in enumerate(inter):
                src = src.narrow(d, lo - sl["box"][d][0], hi - lo)
                dst = dst.narrow(d, lo - box[d][0], hi - lo)
            dst.copy_(src)
            del src
            covered += int(np.prod([hi - lo for lo, hi in inter]))
    if covered < out.numel():
        raise ValueError(f"checkpoint has no data for part of {key!r} (box {box})")
    return out


def _restore_tree(directory: str, template: Any, what: str) -> Any:
    with open(os.path.join(directory, _TREE), encoding="utf-8") as f:
        record = json.load(f)
    files = _Files(directory)

    def one(key, leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = abstract_state(leaf)
        if isinstance(leaf, TensorSpec):
            entry = record["tensors"].get(key)
            if entry is None:
                raise KeyError(f"{what} has no tensor at {key!r}")
            pl = leaf.placement
            whole = tuple(leaf.shape) if pl is None else pl.full_shape(leaf.shape)
            dtype = str(leaf.dtype).replace("torch.", "")
            if tuple(entry["shape"]) != whole or entry["dtype"] != dtype:
                raise ValueError(f"checkpoint mismatch at {key}: template {whole} {dtype}, "
                                 f"file {tuple(entry['shape'])} {entry['dtype']}")
            box = [(0, n) for n in whole] if pl is None else pl.box(whole)
            out = _read(files, entry, key, box, leaf.dtype).to(leaf.device)
            set_placement(out, pl)
            return out.requires_grad_(True) if leaf.requires_grad else out
        if key not in record["scalars"]:
            raise KeyError(f"{what} has no leaf at {key!r}")
        return _restore_scalar(record["scalars"][key])

    try:
        return _map(template, one)
    finally:
        files.close()


class _Writer:
    """One save in flight: this rank's slices written on a thread into
    ``<final>.tmp``, committed (``tree.json`` written, the directory renamed
    into place, ``on_commit`` run on rank 0) by ``finish``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[tuple] = None

    def start(self, final: str, tree: Any, asynchronous: bool,
              on_commit: Optional[Callable[[], None]] = None) -> None:
        self.finish()
        _, me = _world()
        tmp = f"{final}.tmp"
        if me == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        tensors, record = _snapshot(tree)
        path = os.path.join(tmp, _tensor_file(me))
        self._pending = (final, tmp, record, on_commit)
        if asynchronous:
            self._thread = threading.Thread(target=self._write, args=(path, tensors), daemon=True)
            self._thread.start()
        else:
            self._write(path, tensors)
            self.finish()

    def _write(self, path: str, tensors: dict) -> None:
        try:
            if tensors:
                st_file.save_file(tensors, path)
        except BaseException as e:  # noqa: BLE001 — raised by finish()
            self._error = e

    def finish(self) -> None:
        """Join the write, commit it on every rank; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error, self._pending = self._error, None, None
            raise err
        if self._pending is None:
            return
        final, tmp, record, on_commit = self._pending
        self._pending = None
        _barrier()
        if _world()[1] == 0:
            with open(os.path.join(tmp, _TREE), "w", encoding="utf-8") as f:
                json.dump(record, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            if on_commit is not None:
                on_commit()
        _barrier()


class ShardedCheckpointer:
    """Sharded save and restore of one tree per directory.

    >>> ck = ShardedCheckpointer()
    >>> ck.save("/ckpts/step_100", state)              # blocks until on disk
    >>> ck.save("/ckpts/step_200", state, wait=False)  # overlaps training
    >>> ck.wait()                                      # join and commit
    >>> state = ck.restore("/ckpts/step_200", abstract_state(state))
    """

    def __init__(self) -> None:
        self._writer = _Writer()

    def save(self, path: str, tree: Any, *, wait: bool = True, force: bool = True) -> None:
        """Write ``tree`` under ``path`` (a directory, replaced when
        ``force``). The tensors are on the host when this returns; with
        ``wait=False`` the files are written in the background and
        committed by ``wait``."""
        path = os.path.abspath(path)
        if not force and os.path.exists(path):
            raise FileExistsError(f"checkpoint {path} exists (force=False)")
        self._writer.start(path, tree, asynchronous=not wait)

    def restore(self, path: str, template: Any) -> Any:
        """The tree saved at ``path`` in ``template``'s structure: a concrete
        tree (its placements reused) or ``abstract_state`` of one, whose
        placements may be another mesh's."""
        self.wait()
        return _restore_tree(os.path.abspath(path), template, f"checkpoint {path}")

    def wait(self) -> None:
        """Block until an in-flight save is on disk and committed."""
        self._writer.finish()

    def close(self) -> None:
        self.wait()


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
        if _world()[1] == 0:
            os.makedirs(self.directory, exist_ok=True)
        self._writer = _Writer()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` at ``step``; returns False when the
        ``save_interval_steps`` policy skips this step (``force`` saves
        anyway). The tensors are on the host when this returns; the step
        is committed by the next ``save`` or ``wait``."""
        if not force and step % self.save_interval_steps:
            return False
        self._writer.start(self._step_dir(step), state, self.async_save,
                           on_commit=self._rotate)
        return True

    def _rotate(self) -> None:
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (default: the latest), in the structure
        of ``template`` (a concrete tree or ``abstract_state`` of one)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint steps under {self.directory}")
        return _restore_tree(self._step_dir(step), template, f"checkpoint step {step}")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def wait(self) -> None:
        """Block until an in-flight save is on disk and committed; raise its
        error, if any."""
        self._writer.finish()

    def close(self) -> None:
        self.wait()
