"""Data-input layers (mirror of ``paddle_tpu/layers/io.py``; reference:
python/paddle/fluid/layers/io.py): `data`, and the reader-layer surface
over ``reader/`` and ``recordio/`` (`py_reader`, `open_recordio_file`,
`open_files`, `double_buffer`, `read_file`, `shuffle`, `batch`,
`random_data_generator`, `load`, `Preprocessor`), and the
parameter-server layers over ``pserver/`` (`ListenAndServ`, `Send`,
`Recv`)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable (reference io.py:35 `data`).

    With append_batch_size (default, as in the reference) a -1 batch dim
    is prepended. `lod_level` > 0 declares a variable-length sequence
    input, padded: one more -1 dim a level ([batch, time, *feature] at
    level 1, [batch, seqs, time, *feature] at level 2), with an int32
    length companion a level (`name@SEQLEN`, `name@SEQLEN.1`). Feed it a
    `(padded, lengths)` pair (`lod_tensor.create_lod_tensor` and
    `data_feeder.DataFeeder` build one).
    """
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if lod_level > 0:
        dyn = [-1] * lod_level
        shape = ([-1] + dyn + shape) if append_batch_size else (dyn + shape)
    elif append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.current_block()
    if name in block.vars:
        v = block.vars[name]
    else:
        v = block.create_var(name=name, shape=shape, dtype=dtype,
                             lod_level=lod_level, stop_gradient=stop_gradient,
                             is_data=True)
    for lvl in range(lod_level):
        helper.ensure_seqlen_var(v, level=lvl)
    return v


# ---------------------------------------------------------------------------
# reader-layer surface (reference io.py exposes the reader stack here; the
# implementations live in reader/ and recordio/ and are re-surfaced under
# the reference names)
# ---------------------------------------------------------------------------

def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Blocking-queue reader + its feed vars (reference io.py:449)."""
    from ..reader.py_reader import py_reader as _impl
    return _impl(capacity, shapes, dtypes, lod_levels=lod_levels, name=name,
                 use_double_buffer=use_double_buffer)


def _recordio_scan(filenames, pass_num, batch_size=16):
    """Batches of unpickled records (pickled per-var tuples, as
    recordio_writer writes them) over `filenames` in turn, `pass_num`
    times; the last batch of a pass may be short."""
    import pickle
    from .. import recordio as rio

    def scan():
        for _ in range(pass_num):
            batch = []
            for fn in filenames:
                for rec in rio.reader(fn)():
                    batch.append(pickle.loads(rec))
                    if len(batch) == batch_size:
                        yield batch
                        batch = []
            if batch:
                yield batch

    return scan


def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       pass_num=1, for_parallel=True):
    """RecordIO-backed reader (reference io.py:320): a PyReader whose
    producer scans the file in batches of 16 records."""
    reader, feed_vars = py_reader(capacity=64, shapes=shapes, dtypes=dtypes,
                                  lod_levels=lod_levels)
    reader.decorate_paddle_reader(_recordio_scan([filename], pass_num))
    return reader, feed_vars


def open_files(filenames, shapes, dtypes, lod_levels=None, thread_num=1,
               buffer_size=None, pass_num=1, for_parallel=True):
    """Multi-file RecordIO reader (reference io.py:699 open_files): the
    files scanned in turn into one blocking queue."""
    reader, feed_vars = py_reader(capacity=buffer_size or 64, shapes=shapes,
                                  dtypes=dtypes, lod_levels=lod_levels)
    reader.decorate_paddle_reader(_recordio_scan(list(filenames), pass_num))
    return reader, feed_vars


def double_buffer(reader, place=None, name=None):
    """Double-buffering decorator (reference io.py:866). A PyReader
    already double-buffers (its producer stages batches on the device);
    `place`, where given, is where it stages from its next `start()`. A
    plain python reader is wrapped in a buffered prefetch."""
    from ..reader import decorator as dec
    if hasattr(reader, "decorate_paddle_reader"):
        if place is not None:
            from ..async_feeder import _torch_device
            reader._device = _torch_device(place)
        return reader
    return dec.buffered(reader, 2)


def ListenAndServ(endpoint, inputs=None, fan_in=1, optimizer_mode=True):
    """Parameter-server serving loop (reference io.py:114): the host
    `ParameterServer` (``pserver/server.py``) IS the listen-and-serv op —
    this starts it on `endpoint` and returns the server handle (stop() to
    shut down)."""
    from ..pserver import ParameterServer
    return ParameterServer(endpoint).start()


_ps_clients = {}


def _ps_client(endpoint):
    """One cached PSClient (socket + pool) per endpoint — Send/Recv are
    called per training step; constructing a client per call would leak a
    socket and a thread pool each step."""
    from ..pserver import PSClient
    if endpoint not in _ps_clients:
        _ps_clients[endpoint] = PSClient([endpoint])
    return _ps_clients[endpoint]


def Send(endpoint, var_names, scope=None, sync=True):
    """Push variables to a pserver (reference io.py:209 Send). Dense push
    via the PSClient protocol; a scope tensor (on the card or the host)
    travels as host numpy."""
    from ..core.executor import global_scope, host_array
    scope = scope or global_scope()
    c = _ps_client(endpoint)
    for n in (var_names if isinstance(var_names, (list, tuple)) else [var_names]):
        val = scope.find_var(n)
        if val is None:
            raise KeyError(f"Send: variable {n!r} not found in scope")
        # grads are sent under their parameter's name (the reference's
        # transpiler maps w@GRAD slices onto the pserver-side param block)
        target = n[:-len("@GRAD")] if n.endswith("@GRAD") else n
        c.push_grad(endpoint, target, host_array(val))


def Recv(endpoint, var_names, scope=None, sync=True):
    """Fetch variables from a pserver (reference io.py:241 Recv) into the
    scope, as host numpy (a later Executor run moves each to its place)."""
    from ..core.executor import global_scope
    scope = scope or global_scope()
    c = _ps_client(endpoint)
    out = []
    for n in (var_names if isinstance(var_names, (list, tuple)) else [var_names]):
        val = c.get_param(endpoint, n)
        scope.set_var(n, val)
        out.append(val)
    return out


def read_file(reader):
    """Pop the reader's output variables (reference io.py read_file): the
    PyReader's feed vars ARE the read results, armed to pop from the
    blocking queue on each run."""
    if isinstance(reader, (tuple, list)):
        reader, feed_vars = reader
    else:
        feed_vars = reader.feed_vars
    return feed_vars if len(feed_vars) > 1 else feed_vars[0]


def shuffle(reader, buffer_size):
    """Shuffling reader decorator at the layers level (reference io.py
    shuffle)."""
    from ..reader import decorator as dec
    return dec.shuffle(reader, buffer_size)


def batch(reader, batch_size):
    """Batching reader decorator at the layers level (reference io.py
    batch): keeps the last partial batch, as the reference does."""
    from ..reader import decorator as dec
    return dec.batch(reader, batch_size, drop_last=False)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True):
    """Uniform-random python reader (reference io.py
    random_data_generator): yields tuples of float32 arrays."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(0)
        while True:
            yield tuple(rng.uniform(low, high, s).astype(np.float32)
                        for s in shapes)

    return reader


def load(out, file_path, load_as_fp16=None):
    """Load a saved array into `out` at run time (reference io.py load ->
    load op): the file is one np.save'd array, as io.save_vars writes."""
    helper = LayerHelper("load")
    helper.append_op("load", outputs={"Out": [out.name]},
                     attrs={"file_path": file_path,
                            "load_as_fp16": bool(load_as_fp16)})
    return out


class Preprocessor:
    """In-graph batch preprocessing (reference io.py:943 Preprocessor).

    The body is declared with regular layers inside `.block()`, captured as
    its own Program, and run on each batch popped from the source reader
    on `place` (default `CUDAPlace(0)`, as for an `Executor`): calling the
    Preprocessor returns the reader of its outputs, tensors on that
    device."""

    def __init__(self, reader, name=None, place=None):
        self._source = reader
        self._place = place
        self._in_vars = None
        self._out_vars = None
        self._program = None
        self._startup = None

    def inputs(self, dtypes, shapes):
        assert self._program is not None, "call inside .block()"
        self._in_vars = [
            data(name=f"_preproc_in_{i}", shape=list(s), dtype=d,
                 append_batch_size=False)
            for i, (d, s) in enumerate(zip(dtypes, shapes))]
        return self._in_vars

    def outputs(self, *outs):
        self._out_vars = list(outs)

    def block(self):
        import contextlib
        from .. import unique_name
        from ..core.ir import Program, program_guard

        @contextlib.contextmanager
        def guard():
            self._program, self._startup = Program(), Program()
            with program_guard(self._program, self._startup), \
                    unique_name.guard():
                yield self
        return guard()

    def __call__(self):
        from ..core.executor import Executor, Scope
        assert self._in_vars and self._out_vars, \
            "Preprocessor.block() must declare inputs() and outputs()"
        exe = Executor(self._place)
        scope = Scope()
        exe.run(self._startup, scope=scope)

        def reader():
            for item in self._source():
                feed = {v.name: arr for v, arr in zip(self._in_vars, item)}
                yield tuple(exe.run(self._program, feed=feed,
                                    fetch_list=self._out_vars, scope=scope,
                                    return_numpy=False))
        return reader
