"""Background batch prefetching (counterpart of v3d_tpu/data/prefetch.py;
the torch DataLoader worker + pin_memory pipeline the reference relies on).

- ``PrefetchIterator``: a bounded queue filled by a daemon thread from any
  batch iterator, so host work (decode, assembly, collate) overlaps the
  running step.
- ``device_prefetch``: also copies each batch to the device one step ahead.
  On the card the producer thread pins the batch's arrays; the copies are
  issued without blocking on a side stream, and the consumer's stream waits
  on an event before it reads them.  ``put_fn`` (the JAX signature,
  prefetch.py:71-82) maps each host batch first, on the producer thread:
  ``parallel.mesh.shard_batch`` there makes a rank copy only its slice.

The producer thread does host work only.  ``reference_mode()`` is
process-wide and ``torch.no_grad`` thread-local, so any device stage of the
data (an encode, the conditioning) belongs on the consumer's thread, after
the batch comes out of the iterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class PrefetchIterator:
    """Pulls from ``it`` in a daemon thread into a queue of ``depth`` items.
    An exception of the producer is raised in the consumer where the
    failing item would have come."""

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._done = threading.Event()

        def run():
            try:
                for item in it:
                    if self._done.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # re-raised on the consumer's side
                self._err = e
            finally:
                # after close() nobody drains the queue: give up on a full one
                while True:
                    try:
                        self._q.put(_SENTINEL, timeout=0.05)
                        break
                    except queue.Full:
                        if self._done.is_set():
                            break

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer (a consumer that leaves the stream early): drain
        the queue so that a producer blocked in ``put`` ends."""
        self._done.set()
        while True:
            try:
                if self._q.get_nowait() is _SENTINEL:
                    break
            except queue.Empty:
                break


def _tree_map(fn, tree):
    """``fn`` on every tensor and numeric array of a nested dict / list /
    tuple batch; other leaves (ints, strings) as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "biuf":
        return fn(torch.from_numpy(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def pin_batch(batch):
    """The batch's arrays as tensors in pinned host memory."""
    return _tree_map(lambda x: x if x.is_cuda else x.pin_memory(), batch)


def device_prefetch(it: Iterable, put_fn: Optional[Callable] = None,
                    depth: int = 2, device="cuda") -> Iterator:
    """Yield the batches of ``it`` on ``device`` (every tensor and numeric
    array of a nested batch), each copied while the caller computes on the
    one before; ``put_fn`` maps each host batch before its copy, on the
    host stage."""
    dev = torch.device(device)
    card = dev.type == "cuda"
    if put_fn is not None:
        it = map(put_fn, it)             # runs on the producer thread
    if card:
        stream = torch.cuda.Stream(dev)
        it = map(pin_batch, it)          # runs on the producer thread

    def put(batch):
        if not card:
            return _tree_map(lambda x: x.to(dev), batch), None
        with torch.cuda.stream(stream):
            out = _tree_map(lambda x: x.to(dev, non_blocking=True), batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def take(pending):
        out, ready = pending
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            _tree_map(lambda x: x.record_stream(consumer), out)
        return out

    src = PrefetchIterator(it, depth=depth)
    try:
        pending = None
        for batch in src:
            nxt = put(batch)
            if pending is not None:
                yield take(pending)
            pending = nxt
        if pending is not None:
            yield take(pending)
    finally:
        src.close()
