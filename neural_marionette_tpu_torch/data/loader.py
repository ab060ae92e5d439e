"""Batching and host-to-card prefetch.

Counterpart of ``neural_marionette_tpu/data/loader.py``:

* :class:`DataLoader` stacks dataset items into batches with a thread
  pool. Its batches do not depend on ``num_workers``: the items' random
  choices are drawn on the calling thread in index order
  (``PointSequenceDataset.draw``), and only the reading and transforming
  (``load``) runs in the threads. The JAX loader maps ``__getitem__`` over
  its threads, so which window and which points an item gets there depends
  on thread timing; at ``num_workers=0`` the two loaders give the same
  batches. The next batches' loads are queued while the current one is
  consumed, so the threads work while the card steps.
* :func:`prefetch_to_device` keeps ``buffer_size`` batches in flight to
  the card: pinned host copies, copied on a side stream, each batch with an
  event that the consuming stream waits on.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import random
from typing import Iterator

import numpy as np
import torch

from ..parallel.mesh import local_rows

# batches whose loads are queued on the threads beyond the one consumed
LOOKAHEAD = 2


def _stack(items):
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[i] for it in items])
                     for i in range(len(items[0])))
    return np.stack(items)


class DataLoader:
    """Epoch-based batch loader over a ``PointSequenceDataset``.

    ``drop_last`` defaults True (torch's loader keeps the partial final
    batch): the steps take static batch shapes. ``batch_size`` is the
    global batch; with ``process_count > 1`` every process draws the same
    index order (same seed) and materializes only its
    ``batch_size / process_count`` slice of each batch: the contiguous
    rows ``[p B/P, (p+1) B/P)``, or with ``microbatches`` > 1 its share of
    each of that many contiguous microbatches
    (``parallel.mesh.local_rows``), the rows the one-process step's
    microbatches give it. A process draws the random choices (window,
    points) of its own items only, as the JAX loader's processes do, so
    the items depend on the process count; with ``global_draws`` it draws
    those of every item of the batch, in the one-process order, and loads
    its own: N processes then hold the rows of the one-process loader's
    batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, microbatches: int = 1,
                 global_draws: bool = False):
        if batch_size < 1 or num_workers < 0:
            raise ValueError(f"batch_size {batch_size}, num_workers "
                             f"{num_workers}")
        if process_count > 1:
            if batch_size % (process_count * microbatches):
                raise ValueError(f"global batch {batch_size} is not a "
                                 f"multiple of {process_count} processes x "
                                 f"{microbatches} microbatches")
            if not drop_last:
                raise ValueError("loading in several processes needs "
                                 "drop_last (static per-process shapes)")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of "
                             f"{process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.microbatches = microbatches
        self.global_draws = global_draws
        self._rng = random.Random(seed)
        self._pool = (cf.ThreadPoolExecutor(num_workers)
                      if num_workers > 0 else None)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def close(self) -> None:
        """Stop the worker threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _batch_indices(self):
        """The item indices of each global batch of one epoch, and this
        process's positions in it."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            idx = order[i:i + bs]
            if self.drop_last and len(idx) < bs:
                return
            rows = range(len(idx))
            if self.process_count > 1:
                rows = local_rows(bs, self.process_count, self.process_index,
                                  self.microbatches)
            yield idx, rows

    def _plans(self, idx, rows) -> tuple[list, list]:
        """(this process's items of a batch, their random choices), drawn
        on this thread in index order."""
        ds = self.dataset
        own = [idx[r] for r in rows]
        if not self.global_draws:
            return own, [ds.draw(j) for j in own]
        plans = [ds.draw(j) for j in idx]
        return own, [plans[r] for r in rows]

    def __iter__(self) -> Iterator:
        ds = self.dataset
        if self._pool is None:
            for idx, rows in self._batch_indices():
                own, plans = self._plans(idx, rows)
                yield _stack([ds.load(j, p) for j, p in zip(own, plans)])
            return
        pending = collections.deque()
        for idx, rows in self._batch_indices():
            own, plans = self._plans(idx, rows)
            pending.append([self._pool.submit(ds.load, j, p)
                            for j, p in zip(own, plans)])
            if len(pending) > LOOKAHEAD:
                yield _stack([f.result() for f in pending.popleft()])
        while pending:
            yield _stack([f.result() for f in pending.popleft()])


def _tree_map(fn, batch):
    if isinstance(batch, tuple):
        return tuple(fn(x) for x in batch)
    return fn(batch)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def prefetch_to_device(iterator, buffer_size: int = 2, device=None):
    """Batches of ``iterator`` (arrays, or tuples of them such as
    ``(points, joints)``, carried whole) as tensors on ``device`` (default
    ``cuda``), ``buffer_size`` of them copied ahead of the consumer.

    On a CUDA device each batch is pinned on the host and copied on a side
    stream with an event recorded after its copies; the batch is handed
    out only after the consumer's current stream is made to wait on that
    event, and each tensor is marked as used on that stream
    (``record_stream``), so the allocator does not reuse its memory while
    work queued there may read it. A failed copy raises. On a CPU device
    the batches pass through as tensors."""
    from ..api import resolve_device
    device = resolve_device(device)
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    if device.type != "cuda":
        for batch in iterator:
            yield _tree_map(lambda x: _as_tensor(x).to(device), batch)
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        host = _tree_map(lambda x: _as_tensor(x).pin_memory(), batch)
        with torch.cuda.stream(side):
            dev = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    def take(entry):
        dev, done = entry
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        _tree_map(lambda t: t.record_stream(consumer), dev)
        return dev

    queue = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= buffer_size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())
