"""Reader decorators (reference: python/paddle/reader/decorator.py:
map_readers :29, shuffle :51, chain :86, compose :118, buffered :165,
firstn :208, xmap_readers :236; minibatch in python/paddle/v2/minibatch.py).

A reader is a zero-arg callable returning an iterator of samples — identical
contract to the reference. `buffered` / `xmap_readers` use threads to overlap
host-side decode with device steps (the reference's double-buffer analog lives
in async_feeder.py).

A copy of ``paddle_tpu/reader/decorator.py`` (pure Python): the same
readers yield the same sequences under the same `random.seed`."""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Callable, Iterable, List


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            # reference semantics (decorator.py:135): alignment CHECKED ->
            # misaligned readers raise ComposeNotAligned
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            # unchecked: silently stop at the shortest reader
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer (overlaps host IO with device steps)."""

    class _End:
        pass

    def data_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def producer():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads
    (reference decorator.py:236)."""

    end = object()

    def data_reader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feeder():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=feeder, daemon=True).start()
        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            i, mapped = item
            if order:
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            else:
                yield mapped
        if order:
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1

    return data_reader


def cache(reader):
    all_data = []
    lock = threading.Lock()
    done = [False]

    def data_reader():
        with lock:
            if not done[0]:
                all_data.extend(reader())
                done[0] = True
        yield from all_data

    return data_reader


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists (reference v2/minibatch.py). drop_last
    defaults True, as in the JAX package: every step then sees one
    shape."""

    def batch_reader():
        b = []
        for inst in reader():
            b.append(inst)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


class ComposeNotAligned(ValueError):
    """Raised by compose(check_alignment=True) when input readers yield
    different numbers of samples (reference decorator.py:114)."""


class PipeReader:
    """Stream records from a shell command's stdout (reference
    decorator.py PipeReader): `PipeReader("cat f.txt").get_line()` yields
    decoded lines; file_type="gzip" decompresses on the fly. The command
    is run WITHOUT a shell (split argv), matching the reference."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import subprocess
        import zlib
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type == "gzip":
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        elif file_type != "plain":
            raise TypeError(f"file_type {file_type} is not allowed")
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(command.split(" "), bufsize=bufsize,
                                        stdout=subprocess.PIPE)

    def get_line(self, cut_lines=True, line_break="\n"):
        remained = b""
        lb = line_break.encode() if isinstance(line_break, str) else line_break
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if buff:
                if self.file_type == "gzip":
                    buff = self.dec.decompress(buff)
                if cut_lines:
                    lines = (remained + buff).split(lb)
                    remained = lines.pop()
                    for line in lines:
                        yield line.decode(errors="replace")
                else:
                    yield buff
            else:
                if self.file_type == "gzip":
                    # bytes still buffered in the decompressobj at EOF
                    # would otherwise be dropped (truncated last lines)
                    tail = self.dec.flush()
                    if tail:
                        if cut_lines:
                            remained += tail
                        else:
                            yield tail
                break
        if cut_lines and remained:
            lines = remained.split(lb)
            if lines and lines[-1] == b"":   # trailing line break only
                lines.pop()
            for line in lines:
                yield line.decode(errors="replace")
        elif remained:
            yield remained.decode(errors="replace")
