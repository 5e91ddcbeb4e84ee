"""py_reader: blocking-queue input pipeline decoupling the python producer
from the step.

Mirror of ``paddle_tpu/reader/py_reader.py`` (reference:
python/paddle/fluid/layers/io.py:449 `py_reader` + `read_file`;
paddle/fluid/operators/reader/lod_tensor_blocking_queue.h — bounded queue
fed from python, consumed by the executor's read op; EOF raises
core.EOFException).

There is no in-graph read op: the blocking queue sits at the feed
boundary. A producer thread converts batches (DataFeeder) and, with
`use_double_buffer`, stages them on the device through the pinned,
side-stream copy of ``async_feeder.DeviceStager``; `Executor.run(feed=None)`
on a program bound to a PyReader pops the next batch, and raises
`EOFException` at the end of the data (the reference's drain contract).
The capacity bound gives backpressure.

`start()` launches the producer at once, onto the device last named for
the reader, by `layers.double_buffer(reader, place)` or by an executor
that popped it, else onto the port's default: card 0 where a card is
visible, the host where none is. An executor on another device than the
running pass's moves the batches it pops in its feed conversion, and the
next `start()` stages onto its device, as the reference's double_buffer
follows the executor's place.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List, Optional

from ..async_feeder import (DeviceStager, _Staged, _torch_device,
                            default_device)
from ..core import ir
from ..core.executor import EOFException
from ..data_feeder import DataFeeder
from ..layer_helper import LayerHelper

_EOF = object()


class PyReader:
    def __init__(self, feed_vars: List[ir.Variable], capacity: int,
                 program: Optional[ir.Program] = None,
                 use_double_buffer: bool = True):
        self.feed_vars = feed_vars
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self._program = program or ir.default_main_program()
        self._program._py_reader = self
        self._feeder = DataFeeder(feed_list=feed_vars,
                                  program=self._program)
        self._device = None
        self._stager: Optional[DeviceStager] = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event: Optional[threading.Event] = None
        self._producer_error: Optional[BaseException] = None
        self._batch_reader: Optional[Callable[[], Iterable]] = None
        self._tensor_provider: Optional[Callable[[], Iterable]] = None

    # -- binding (reference decorate_paddle_reader / decorate_tensor_provider)
    def decorate_paddle_reader(self, reader: Callable[[], Iterable]):
        """`reader()` yields BATCHES: lists of per-var sample tuples
        (compose with reader.batch)."""
        self._batch_reader = reader
        return self

    def decorate_tensor_provider(self, provider: Callable[[], Iterable]):
        """`provider()` yields ready feed dicts (or per-var array lists)."""
        self._tensor_provider = provider
        return self

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._batch_reader is None and self._tensor_provider is None:
            raise ValueError("bind a source first: decorate_paddle_reader "
                             "or decorate_tensor_provider")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("py_reader already started; call reset() "
                               "after EOFException before restarting")
        self._queue = queue.Queue(maxsize=self.capacity)
        self._producer_error = None
        self._stop_event = threading.Event()
        if self._device is None:
            self._device = default_device()
        stager = None
        if self.use_double_buffer:
            if self._stager is None or self._stager.device != self._device:
                self._stager = DeviceStager(self._device, self.capacity + 2)
            stager = self._stager
        self._thread = threading.Thread(
            target=self._produce,
            args=(self._queue, self._stop_event, stager),
            daemon=True, name="py_reader")
        self._thread.start()

    def reset(self):
        """Drain after EOF — or abandon a mid-epoch producer (reference
        reader->reset per epoch). A still-running producer is signalled to
        stop so it cannot stay blocked on the abandoned queue pinning
        device-resident batches."""
        if self._stop_event is not None:
            self._stop_event.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None
        self._queue = None
        self._producer_error = None

    def _produce(self, q, stop, stager):
        def put(item):
            # bounded put that honours reset(): without the stop check a
            # producer abandoned mid-epoch would block on the full old
            # queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def transfer(feed):
            # the double buffer: the copy of this batch runs while the
            # step before it does
            return feed if stager is None else stager.stage(feed)

        try:
            if self._tensor_provider is not None:
                for item in self._tensor_provider():
                    feed = (item if isinstance(item, dict) else
                            {v.name: a for v, a in zip(self.feed_vars, item)})
                    if not put(transfer(feed)):
                        return
            else:
                for batch in self._batch_reader():
                    if not put(transfer(self._feeder.feed(batch))):
                        return
        except BaseException as e:  # surfaced by next_feed, NOT silent EOF
            self._producer_error = e
        finally:
            put(_EOF)

    # -- executor hook -----------------------------------------------------
    def next_feed(self, device=None):
        """The next batch's feed dict, on the running pass's device.
        `device` is the popping executor's: the next `start()` stages onto
        it."""
        if self._queue is None:
            raise RuntimeError("py_reader not started — call reader.start()")
        item = self._queue.get()
        if item is _EOF:
            if self._producer_error is not None:
                err = self._producer_error
                raise RuntimeError(
                    "py_reader producer thread failed (this is NOT "
                    "end-of-data)") from err
            raise EOFException("py_reader drained (end of data pass)")
        if device is not None:
            self._device = _torch_device(device)
        if isinstance(item, _Staged):
            return self._stager.hand_over(item)
        return item

    def __iter__(self):
        """Also usable as a plain feed iterator."""
        while True:
            try:
                yield self.next_feed()
            except EOFException:
                return


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Declare feed vars + blocking-queue reader (reference io.py:449).
    Returns (reader, feed_vars) — the reference's read_file(reader) step is
    folded in because feeds are explicit here."""
    helper = LayerHelper("py_reader", name=name)
    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = []
    from ..layers import io as lio
    for i, (shape, dtype, lod) in enumerate(zip(shapes, dtypes, lod_levels)):
        v = lio.data(name=f"{helper.name}.slot{i}", shape=list(shape),
                     dtype=dtype, lod_level=lod, append_batch_size=False)
        feed_vars.append(v)
    reader = PyReader(feed_vars, capacity,
                      use_double_buffer=use_double_buffer)
    return reader, feed_vars
