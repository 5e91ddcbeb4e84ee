"""Asynchronous input pipeline: the reference's py_reader / double_buffer
analog (reference: python/paddle/fluid/layers/io.py:449 `py_reader`,
operators/reader/create_double_buffer_reader_op.cc,
reader/lod_tensor_blocking_queue.h).

Mirror of ``paddle_tpu/async_feeder.py``. A background thread pulls
batches from a python reader and converts them with a DataFeeder into a
bounded queue; the consumer iterates over ready feeds. The JAX package
calls `jax.device_put` at yield time and lets PJRT make the copy
asynchronous. Here `DeviceStager` does that work itself, on the producer
thread:

- each batch's arrays are copied into a ring of reused pinned host
  buffers (pinning a fresh buffer a batch costs more than the copy it
  saves); a buffer is refilled only once the event of its last copy has
  completed;
- the host-to-device copy is issued with ``non_blocking=True`` on a side
  `torch.cuda.Stream`, into device tensors allocated on that stream, and
  an event is recorded after it;
- at yield time the consumer's current stream waits on that event and
  each device tensor is marked as used by it (`record_stream`), so the
  step never reads a half-copied feed and the caching allocator never
  hands a feed's memory to a later batch while the step still reads it.

A `(data, lengths)` pair, or a nested `(data, (outer, inner))` one, moves
as the same tuple; a tensor already on the device passes through. With a
CUDA device a failure to pin or to copy raises: nothing hands pageable
arrays to the step instead. Where no device is named, the feeds land on
the port's default, card 0, or the host where no card is visible; on a
CPU device they are host tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from . import flags as _flags
from .observe import metrics as _metrics


def _leaves(value) -> list:
    """The arrays of one feed value: a tuple is a `(data, lengths)`
    structure, anything else is one array."""
    if isinstance(value, tuple):
        return [a for v in value for a in _leaves(v)]
    return [value]


def _rebuild(value, arrays):
    """`value`'s tuple structure over the next items of the iterator
    `arrays` (`_leaves`' inverse)."""
    if isinstance(value, tuple):
        return tuple(_rebuild(v, arrays) for v in value)
    return next(arrays)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _torch_device(where) -> torch.device:
    """A Place, a torch.device or a device string as a torch.device, a
    card's with its index."""
    if hasattr(where, "torch_device"):
        return where.torch_device()
    device = torch.device(where)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_device() -> torch.device:
    """Where feeds land when no place is named: card 0 (`CUDAPlace(0)`,
    the executor's default), or the host where no card is visible."""
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


class _Slot:
    """One ring entry: pinned host buffers by (feed name, leaf index) and
    the event recorded after their last copy."""

    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None


class _Staged:
    """A feed whose copy was issued, and the event that marks its end."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event


class DeviceStager:
    """Moves host feeds onto one device: `stage` on the producer thread,
    `hand_over` on the consumer's. Shared by `AsyncFeeder` and
    ``reader/py_reader.py``'s double buffer.

    `pinned_allocs` counts the pinned buffers allocated so far: once the
    ring has filled at a fixed batch shape it stops growing."""

    def __init__(self, device, ring_size: int):
        self.device = _torch_device(device)
        self.cuda = self.device.type == "cuda"
        self.pinned_allocs = 0
        self._slots: List[_Slot] = []
        self._next = 0
        # an abandoned iteration's producer may still be staging its last
        # batch when the next iteration's producer starts
        self._lock = threading.Lock()
        self.stream = None
        if self.cuda:
            self.stream = torch.cuda.Stream(device=self.device)
            self._slots = [_Slot() for _ in range(max(int(ring_size), 1))]

    def stage(self, feed: Dict) -> _Staged:
        with self._lock:
            if self.cuda:
                return self._stage_cuda(feed)
            out = {}
            for name, value in feed.items():
                tensors = []
                for a in _leaves(value):
                    if isinstance(a, torch.Tensor):
                        tensors.append(a.to(self.device))
                        continue
                    arr = np.asarray(a)
                    if not (arr.flags.c_contiguous and arr.flags.writeable):
                        arr = np.array(arr)
                    tensors.append(torch.from_numpy(arr).to(self.device))
                out[name] = _rebuild(value, iter(tensors))
            return _Staged(out, None)

    def _stage_cuda(self, feed: Dict) -> _Staged:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()   # its buffers' last copy has landed
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for name, value in feed.items():
                tensors = []
                for i, a in enumerate(_leaves(value)):
                    if isinstance(a, torch.Tensor) and a.device == self.device:
                        tensors.append(a)
                        continue
                    if isinstance(a, torch.Tensor):
                        a = a.cpu()
                    arr = np.asarray(a)
                    buf = slot.buffers.get((name, i))
                    if buf is None or tuple(buf.shape) != arr.shape \
                            or buf.dtype != _torch_dtype(arr.dtype):
                        buf = torch.empty(arr.shape,
                                          dtype=_torch_dtype(arr.dtype),
                                          pin_memory=True)
                        slot.buffers[(name, i)] = buf
                        self.pinned_allocs += 1
                    np.copyto(buf.numpy(), arr, casting="no")
                    # allocated on the side stream, so the caching
                    # allocator orders its reuse after this copy
                    dev = torch.empty(buf.shape, dtype=buf.dtype,
                                      device=self.device)
                    dev.copy_(buf, non_blocking=True)
                    tensors.append(dev)
                out[name] = _rebuild(value, iter(tensors))
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        return _Staged(out, slot.event)

    def hand_over(self, staged: _Staged) -> Dict:
        """The staged feed, safe to read on the caller's current stream."""
        if staged.event is None:
            return staged.feed
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(staged.event)
        for value in staged.feed.values():
            for t in _leaves(value):
                t.record_stream(consumer)
        return staged.feed


class AsyncFeeder:
    """`for feed in AsyncFeeder(feeder, reader, capacity=4, prepared=h):
    h.run(feed)`

    feeder: DataFeeder (or any fn batch -> feed dict); reader: batched
    reader (yields lists of samples). `device` (a Place, a torch.device
    or a string) or `prepared` (an `Executor.prepare()` handle, whose
    device it takes) sets where the feeds land; with neither, the port's
    default (`default_device`). On a card each feed array
    cycles through capacity + 2 pinned buffers, each refilled once its
    last copy has landed.

    After (or during) an iteration, `waits_s`, `starved`, `depths` and
    `produce_s` hold, a batch each of that iteration, the consumer's wait
    for it, whether the queue was empty when the consumer asked, the
    batches still queued once it had its batch, and the producer's seconds
    to convert and stage it. With the `observe` flag on, the JAX package's
    gauges are emitted as well (queue depth, consumer wait, starvation)."""

    def __init__(self, feeder, reader: Callable[[], Iterable],
                 capacity: int = 4, device=None, sharding=None,
                 pad_to: int = 0, prepared=None):
        if sharding is not None:
            raise NotImplementedError(
                "AsyncFeeder(sharding=...): ParallelExecutor's batch "
                "sharding is not ported yet (ROADMAP Queue 1 item 7)")
        self._feeder = feeder
        self._reader = reader
        self._capacity = capacity
        self._pad_to = pad_to
        if prepared is not None and device is None:
            # pair with an Executor.prepare() handle: feeds land on the
            # device its step runs on
            device = prepared.device
        self.stager = DeviceStager(
            default_device() if device is None else device, capacity + 2)
        self.waits_s: List[float] = []
        self.starved: List[bool] = []
        self.depths: List[int] = []
        self.produce_s: List[float] = []

    def _convert(self, batch) -> Dict:
        """Host-side conversion only — runs on the producer thread."""
        return (self._feeder.feed(batch, pad_to=self._pad_to)
                if hasattr(self._feeder, "feed") else self._feeder(batch))

    def __iter__(self):
        stager = self.stager
        q: queue.Queue = queue.Queue(maxsize=self._capacity)
        end = object()
        err = []
        stop = threading.Event()
        # fresh lists an iteration; the producer appends to its own, so an
        # abandoned iteration's producer cannot write into the next one's
        self.waits_s, self.starved, self.depths = [], [], []
        produce_s = self.produce_s = []

        def producer():
            try:
                for batch in self._reader():
                    t0 = time.perf_counter()
                    item = stager.stage(self._convert(batch))
                    produce_s.append(time.perf_counter() - t0)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return  # consumer abandoned the iteration
            except Exception as e:  # surface reader errors on the consumer
                err.append(e)
            finally:
                # the end sentinel must be DELIVERED, not best-effort: a
                # full queue here (consumer slower than producer) would
                # drop it and hang the consumer after it drains
                while not stop.is_set():
                    try:
                        q.put(end, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True,
                             name="async_feeder")
        t.start()
        observe = _flags.get_flag("observe")
        try:
            while True:
                t0 = time.perf_counter()
                starved = q.empty()
                item = q.get()
                wait = time.perf_counter() - t0
                if item is end:
                    break
                depth = q.qsize()
                self.waits_s.append(wait)
                self.starved.append(starved)
                self.depths.append(depth)
                if observe:
                    # a consumer wait with an empty queue means the
                    # producer (reader + host conversion) is the
                    # bottleneck: the overlap the feeder exists to provide
                    # is NOT happening
                    _metrics.gauge(
                        "feeder_queue_depth",
                        "batches buffered ahead of the consumer").set(depth)
                    _metrics.counter(
                        "feeder_batches_total",
                        "batches delivered to the consumer").inc()
                    _metrics.histogram(
                        "feeder_consumer_wait_seconds",
                        "time the consumer blocked waiting for a batch"
                    ).observe(wait)
                    if starved:
                        _metrics.counter(
                            "feeder_starvation_total",
                            "consumer arrivals that found the queue "
                            "empty (producer-bound pipeline)").inc()
                yield stager.hand_over(item)
        finally:
            # on break/close: release the producer and drop buffered batches
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        if err:
            raise err[0]
