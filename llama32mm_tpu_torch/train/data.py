"""Training input pipeline: packing, deterministic shuffling, resumable
iteration and host-to-device prefetch (counterpart of
``llama32mm_tpu/train/data.py``).

- **Packing.** Every batch is exactly ``[batch, seq_len]``: documents are
  packed into one EOS-separated token stream and sliced into rows, padding
  only the stream's tail. The label at each document's first token is
  ``ignore_index``, so the shifted loss never scores "the EOS of document A
  predicts the first token of B". Attention does cross documents (plain
  causal), the usual GPT-style packing trade.
- **Determinism and resume.** Each epoch's order is a permutation seeded by
  ``(seed, epoch)``; the iterator's :class:`DataState` (three integers)
  fixes every later batch. Save it with the train state
  (``io.TrainCheckpointManager`` persists it), restore it, and the stream
  continues bit for bit. The packing and the permutation are the JAX
  package's numpy code, so both packages yield the same batches.
- **Prefetch.** :func:`prefetch_to_device` stages the next batches on the
  device from a background thread while the current step runs: each array
  is copied into pinned host memory and then to the device with a
  ``non_blocking`` copy on a side stream; the consumer's stream waits on an
  event recorded after the copy before the batch is used.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "DataState",
    "PackedBatchIterator",
    "pack_documents",
    "prefetch_to_device",
]

IGNORE_INDEX = -100


def pack_documents(
    docs: Sequence[Sequence[int]],
    seq_len: int,
    eos_id: int,
    pad_id: int = 0,
    ignore_index: int = IGNORE_INDEX,
) -> dict:
    """Pack tokenized documents into ``[n_rows, seq_len]`` causal-LM arrays.

    Each document is terminated with ``eos_id`` and the stream is sliced into
    fixed rows; the tail is padded. Returns ``{"input_ids", "labels"}`` where
    ``labels`` equals ``input_ids`` except ``ignore_index`` at every
    document-start position (no cross-document prediction) and at padding.
    """
    if seq_len < 2:
        raise ValueError("seq_len must be >= 2 for shifted-CE training")
    stream: List[int] = []
    starts: List[int] = []
    for doc in docs:
        if len(doc) == 0:
            continue
        starts.append(len(stream))
        stream.extend(int(t) for t in doc)
        stream.append(int(eos_id))
    if not stream:
        raise ValueError("no non-empty documents to pack")

    n_rows = (len(stream) + seq_len - 1) // seq_len
    total = n_rows * seq_len
    ids = np.full((total,), pad_id, dtype=np.int32)
    ids[: len(stream)] = np.asarray(stream, dtype=np.int32)
    labels = ids.copy()
    labels[len(stream):] = ignore_index  # padding tail
    labels[np.asarray(starts, dtype=np.int64)] = ignore_index  # doc starts
    return {
        "input_ids": ids.reshape(n_rows, seq_len),
        "labels": labels.reshape(n_rows, seq_len),
    }


class DataState(NamedTuple):
    """Everything needed to resume the stream: three integers, saved with
    the train state."""

    epoch: np.int64
    row: np.int64  # next unconsumed packed row within the epoch
    seed: np.int64


class PackedBatchIterator:
    """Deterministic, resumable iterator of packed ``[batch, seq_len]``
    causal-LM batches (numpy) over a document corpus.

    Per epoch: documents are shuffled by a permutation seeded with
    ``(seed, epoch)``, packed (:func:`pack_documents`), and yielded in
    ``batch_size``-row batches; a trailing partial batch is dropped (static
    shapes). Epochs repeat indefinitely. ``state`` and ``from_state``
    round-trip a resume."""

    def __init__(
        self,
        docs: Sequence[Sequence[int]],
        batch_size: int,
        seq_len: int,
        eos_id: int,
        seed: int = 0,
        pad_id: int = 0,
        ignore_index: int = IGNORE_INDEX,
        shuffle: bool = True,
        _epoch: int = 0,
        _row: int = 0,
    ) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._docs = docs
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.ignore_index = ignore_index
        self.shuffle = shuffle
        self._seed = int(seed)
        self._epoch = int(_epoch)
        self._row = int(_row)
        self._packed: Optional[dict] = None
        self._packed_epoch = -1

    @property
    def state(self) -> DataState:
        return DataState(epoch=np.int64(self._epoch), row=np.int64(self._row),
                         seed=np.int64(self._seed))

    @classmethod
    def from_state(
        cls,
        docs: Sequence[Sequence[int]],
        batch_size: int,
        seq_len: int,
        eos_id: int,
        state: DataState,
        **kw,
    ) -> "PackedBatchIterator":
        """Rebuild the iterator at an exact stream position. ``state``'s
        fields may be numpy scalars, ints or 0-dim tensors (as restored from
        a checkpoint)."""
        return cls(docs, batch_size, seq_len, eos_id, seed=int(state.seed),
                   _epoch=int(state.epoch), _row=int(state.row), **kw)

    def _epoch_rows(self) -> dict:
        if self._packed_epoch != self._epoch:
            order = np.arange(len(self._docs))
            if self.shuffle:
                rng = np.random.default_rng((self._seed, self._epoch))
                order = rng.permutation(len(self._docs))
            self._packed = pack_documents(
                [self._docs[i] for i in order], self.seq_len, self.eos_id,
                pad_id=self.pad_id, ignore_index=self.ignore_index,
            )
            self._packed_epoch = self._epoch
        return self._packed

    def __iter__(self) -> "PackedBatchIterator":
        return self

    def __next__(self) -> dict:
        while True:
            packed = self._epoch_rows()
            n_rows = packed["input_ids"].shape[0]
            if self._row + self.batch_size <= n_rows:
                sl = slice(self._row, self._row + self.batch_size)
                self._row += self.batch_size
                return {k: v[sl] for k, v in packed.items()}
            # partial tail dropped: next epoch
            self._epoch += 1
            self._row = 0


class _Staged(NamedTuple):
    item: object  # the batch with its arrays on the device
    ready: Optional[torch.cuda.Event]  # recorded on the side stream after the copies
    pinned: list  # the pinned host buffers, kept alive until the batch is taken


def _stage(tree, device: torch.device, pinned: list):
    """``tree`` with every numpy array and tensor moved to ``device``; dicts,
    lists and tuples (named ones too) are rebuilt, other leaves (the
    ``DataState``'s numpy scalars) kept as they are."""
    if isinstance(tree, dict):
        return {k: _stage(v, device, pinned) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_stage(v, device, pinned) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, device, pinned) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if device.type != "cuda":
        return tree.to(device)
    host = tree.pin_memory()
    pinned.append(host)
    return host.to(device, non_blocking=True)


def _record_streams(tree, stream) -> None:
    """Tell the caching allocator that the consumer's ``stream`` uses each
    device tensor of ``tree`` (they were allocated on the side stream)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _record_streams(v, stream)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        tree.record_stream(stream)


def prefetch_to_device(it: Iterator, size: int = 2, device=None) -> Iterator:
    """Wrap a host batch iterator so that the next ``size`` batches are staged
    on ``device`` (the GPU unless the caller passes another device) by a
    background thread while the train step runs. Batches may be dicts,
    lists or tuples of numpy arrays or tensors; other leaves pass through.
    On a CUDA device each array goes through pinned memory and a
    ``non_blocking`` copy on a side stream, and the consumer's stream waits
    for that copy before the batch is handed out. Exceptions from the inner
    iterator (or from staging) are raised at the matching ``next()``;
    iteration ends when the inner iterator does. A CUDA device that is not
    available raises at the first ``next()``: there is no fallback to the
    CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    end = object()

    def worker(side):
        try:
            for batch in it:
                pinned: list = []
                if side is None:
                    q.put(_Staged(_stage(batch, device, pinned), None, pinned))
                    continue
                with torch.cuda.stream(side):
                    staged = _stage(batch, device, pinned)
                    ready = torch.cuda.Event()
                    ready.record(side)
                q.put(_Staged(staged, ready, pinned))
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            q.put((end, e))
            return
        q.put((end, None))

    def consume():
        side = None
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"prefetch_to_device: {device} was asked for, but CUDA is "
                                   "not available (pass device='cpu' to stage on the CPU)")
            side = torch.cuda.Stream(device)
        consumer = torch.cuda.current_stream(device) if side is not None else None
        threading.Thread(target=worker, args=(side,), daemon=True).start()
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                if item[1] is not None:
                    raise item[1]
                return
            if item.ready is not None:
                consumer.wait_event(item.ready)
                _record_streams(item.item, consumer)
            yield item.item

    return consume()
