"""paddle_tpu_torch's data plane and Trainer against paddle_tpu, on the CPU.

RecordIO files, the reader decorators and creators, py_reader with
`Executor.run(feed=None)`, AsyncFeeder, the layers-io surface, the
Trainer with its legacy and ark checkpoints, the metrics, the
evaluator, the debugger's listings and the profiler's host spans: the
same inputs, made from a seed, through both packages. Nothing on this
path reaches a Pallas kernel. The CUDA side of AsyncFeeder (pinned ring,
side stream, events) is checked on the card by tests/test_torch_cuda.py.

Tolerances, stated at each case: RecordIO bytes, reader sequences,
metric values, listings and the port's own resume are held exactly; a
loss of the two packages' float32 steps within LOSS_RTOL relative (the
same ops in another summation order).
"""

import json
import os
import pickle
import random
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import recordio as jrio
from paddle_tpu.async_feeder import AsyncFeeder as JAsyncFeeder
from paddle_tpu.reader import creator as jcreator
from paddle_tpu.reader import decorator as jdec
from paddle_tpu.recordio import snappy_codec as jsnappy

import paddle_tpu_torch as ptt
from paddle_tpu_torch import recordio as trio
from paddle_tpu_torch.async_feeder import (AsyncFeeder, DeviceStager,
                                          default_device)
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as tdec
from paddle_tpu_torch.recordio import snappy_codec as tsnappy

LOSS_RTOL = 1e-6
PACKAGES = {"jax": fluid, "torch": ptt}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops run far faster on one thread than on a pool that
    several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------

def _records(seed=0, n=300):
    rng = np.random.RandomState(seed)
    recs = [b"", b"x", b"abcabcabcabc" * 40]
    recs += [bytes(rng.randint(0, 4, rng.randint(0, 2000), dtype=np.uint8))
             for _ in range(n)]
    recs += [pickle.dumps((rng.rand(3, 4).astype(np.float32),
                           np.array([i], np.int64))) for i in range(20)]
    return recs


@pytest.mark.parametrize("compressor", [0, 1, 2])
def test_recordio_files_byte_identical_and_read_by_the_other(tmp_path,
                                                              compressor):
    """Equal bytes for the same records and compressor (exact), and each
    package scans the other's file back to the same records."""
    recs = _records()
    paths = {}
    for name, mod in (("jax", jrio), ("torch", trio)):
        paths[name] = str(tmp_path / f"{name}.recordio")
        with mod.Writer(paths[name], max_num_records=37,
                        compressor=compressor) as w:
            for r in recs:
                w.write(r)
    assert open(paths["jax"], "rb").read() == open(paths["torch"],
                                                   "rb").read()
    assert list(trio.Scanner(paths["jax"])) == recs
    assert list(jrio.Scanner(paths["torch"])) == recs


def test_recordio_native_library_is_the_ports_own():
    lib = trio._load_native()
    assert lib, "g++ builds the host library here"
    assert lib._name == os.path.join(trio.BUILD_DIR, "librecordio.so")
    assert os.path.dirname(trio.BUILD_DIR) == os.path.dirname(
        os.path.abspath(ptt.__file__))


@pytest.mark.parametrize("compressor", [0, 1, 2])
def test_recordio_python_fallback_matches_native(tmp_path, monkeypatch,
                                                 compressor):
    """Native and pure-Python codecs write equal bytes and read each
    other's files (mirror of tests/test_data_plane.py:49-57)."""
    recs = _records(seed=3, n=120)
    native_path, py_path = str(tmp_path / "n.rio"), str(tmp_path / "p.rio")
    trio.write_file(native_path, recs, compressor=compressor)
    monkeypatch.setattr(trio, "_native", False)
    trio.write_file(py_path, recs, compressor=compressor)
    assert list(trio.Scanner(native_path)) == recs
    monkeypatch.undo()
    assert open(native_path, "rb").read() == open(py_path, "rb").read()
    assert list(trio.Scanner(py_path)) == recs


def test_recordio_gzip_empty_records_and_corruption(tmp_path):
    """Mirror of tests/test_data_plane.py:38-46: empty records survive
    gzip; a flipped payload byte fails the checksum in both packages."""
    path = str(tmp_path / "z.recordio")
    records = [b"", b"x", b"", b"longer record" * 50]
    with trio.Writer(path, compressor=trio.GZIP) as w:
        for r in records:
            w.write(r)
    assert list(trio.Scanner(path)) == records
    path = str(tmp_path / "c.recordio")
    trio.write_file(path, [b"hello world" * 10])
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for mod in (trio, jrio):
        with pytest.raises(IOError, match="checksum"):
            list(mod.Scanner(path))


def test_snappy_codec_native_python_and_the_jax_package_agree():
    """Mirror of tests/test_data_plane.py:374-473: the port's native and
    Python snappy paths cross-decode, equal the JAX package's streams,
    and reject corrupt input."""
    assert tsnappy._native() is not None
    rng = np.random.RandomState(11)
    cases = [b"", b"ab", b"abcabcabcabc" * 500,
             bytes(rng.randint(0, 256, 70000, dtype=np.uint8)),
             bytes(rng.randint(0, 3, 300000, dtype=np.uint8))]
    for data in cases:
        stream = tsnappy.compress(data)
        assert stream == jsnappy.compress(data)
        assert tsnappy._decompress_py(stream) == data
        assert tsnappy.decompress(tsnappy._compress_py(data)) == data
        assert tsnappy._crc32c_py(data) == tsnappy._crc32c(data)
        framed = tsnappy.compress_framed(data)
        assert framed == jsnappy.compress_framed(data)
        assert jsnappy.decompress_framed(framed) == data
    assert tsnappy._crc32c(b"123456789") == 0xE3069283
    stream = bytes([0x0c, 0x08]) + b"abc" + bytes([0x15, 0x03])
    with pytest.raises(IOError):
        tsnappy.decompress(stream[:-1])
    framed = bytearray(tsnappy.compress_framed(b"abcabcabcabc" * 100))
    framed[-1] ^= 0xFF
    with pytest.raises(IOError, match="CRC32C|snappy"):
        tsnappy.decompress_framed(bytes(framed))


def test_convert_reader_to_recordio_files_like_paddle_tpu(tmp_path):
    rng = np.random.RandomState(0)
    samples = [(rng.rand(4).astype(np.float32), np.array([i], np.int64))
               for i in range(25)]
    counts = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        counts[name] = pkg.convert_reader_to_recordio_files(
            str(d / "part"), 10, lambda: iter(samples))
        assert pkg.convert_reader_to_recordio_file(
            str(d / "one"), lambda: iter(samples), compressor=2) == 25
    assert counts["jax"] == counts["torch"] == [10, 10, 5]
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert open(tmp_path / "jax" / f, "rb").read() == \
            open(tmp_path / "torch" / f, "rb").read()
    back = list(tcreator.recordio(str(tmp_path / "torch" / "part-*"))())
    assert len(back) == 25
    for (x, y), (bx, by) in zip(samples, back):
        np.testing.assert_array_equal(x, bx)
        np.testing.assert_array_equal(y, by)


# ---------------------------------------------------------------------------
# reader decorators and creators: the JAX package's sequences, exactly
# ---------------------------------------------------------------------------

def _items(n=23):
    return lambda: iter(range(n))


def _pairs(n=23):
    return lambda: iter([(i, -i) for i in range(n)])


_DECORATOR_CASES = {
    "map_readers": lambda d: d.map_readers(lambda a, b: a * 10 + b,
                                           _items(), _items(7)),
    "shuffle": lambda d: d.shuffle(_items(50), 16),
    "chain": lambda d: d.chain(_items(3), _items(5), _pairs(2)),
    "compose": lambda d: d.compose(_items(6), _pairs(6)),
    "compose_unchecked": lambda d: d.compose(_items(6), _items(4),
                                             check_alignment=False),
    "buffered": lambda d: d.buffered(_items(40), 3),
    "firstn": lambda d: d.firstn(_items(40), 9),
    "xmap_ordered": lambda d: d.xmap_readers(lambda x: x * x, _items(40), 3,
                                             4, order=True),
    "cache": lambda d: d.cache(d.shuffle(_items(20), 8)),
    "batch": lambda d: d.batch(_items(23), 5),
    "batch_keep_last": lambda d: d.batch(_items(23), 5, drop_last=False),
    "shuffle_then_batch": lambda d: d.batch(d.shuffle(_pairs(30), 7), 4),
}


@pytest.mark.parametrize("case", sorted(_DECORATOR_CASES))
def test_reader_decorator_yields_the_jax_sequence(case):
    """Under the same random.seed each decorator yields what the JAX
    one does, element for element; a cached reader repeats itself."""
    out = {}
    for name, d in (("jax", jdec), ("torch", tdec)):
        random.seed(5)
        r = _DECORATOR_CASES[case](d)
        out[name] = (list(r()), list(r()))
    assert out["torch"] == out["jax"]
    assert out["torch"][0]


def test_xmap_unordered_and_compose_misaligned_like_paddle_tpu():
    for d in (jdec, tdec):
        got = list(d.xmap_readers(lambda x: x + 1, _items(30), 4, 2)())
        assert sorted(got) == list(range(1, 31))
    with pytest.raises(tdec.ComposeNotAligned):
        list(tdec.compose(_items(3), _items(4))())


def test_reader_creators_like_paddle_tpu(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    text = tmp_path / "t.txt"
    text.write_text("alpha\nbeta\n\ngamma\n")
    rio_path = str(tmp_path / "r.recordio")
    samples = [(np.full(3, i, np.float32), np.array([i])) for i in range(9)]
    jrio.write_file(rio_path, (pickle.dumps(s) for s in samples))
    for c in (jcreator, tcreator):
        assert [a.tolist() for a in c.np_array(arr)()] == arr.tolist()
        assert list(c.text_file(str(text))()) == ["alpha", "beta", "",
                                                  "gamma"]
    t = list(tcreator.recordio(rio_path)())
    j = list(jcreator.recordio(rio_path)())
    assert len(t) == len(j) == 9
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_pipe_reader_like_paddle_tpu(tmp_path):
    import gzip
    p = tmp_path / "lines.txt"
    p.write_text("one\ntwo\nthree")
    gz = tmp_path / "lines.gz"
    gz.write_bytes(gzip.compress(b"x1\nx2\n"))
    for d in (jdec, tdec):
        assert list(d.PipeReader(f"cat {p}").get_line()) == ["one", "two",
                                                             "three"]
        assert list(d.PipeReader(f"cat {gz}", file_type="gzip")
                    .get_line()) == ["x1", "x2"]


# ---------------------------------------------------------------------------
# py_reader: train from a RecordIO file, on both packages from one state
# ---------------------------------------------------------------------------

def _regression_recordio(path, n=96, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(4, 1).astype(np.float32)
    samples = []
    for _ in range(n):
        x = rng.randn(4).astype(np.float32)
        samples.append(pickle.dumps((x, (x @ w_true).astype(np.float32))))
    jrio.write_file(path, samples)


def _py_reader_regression(pkg, path, lod=False):
    """The linear regression of tests/test_data_plane.py:238-286, built
    with `pkg`'s layers, its batches fed as per-var dicts."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        reader, (xv, yv) = pkg.reader.py_reader(
            capacity=8, shapes=[[-1, 4], [-1, 1]],
            dtypes=["float32", "float32"])
        pred = pkg.layers.fc(input=xv, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, yv))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)

    def batches():
        batch = []
        for rec in jrio.Scanner(path):
            batch.append(pickle.loads(rec))
            if len(batch) == 16:
                yield {xv.name: np.stack([b[0] for b in batch]),
                       yv.name: np.stack([b[1] for b in batch])}
                batch = []

    reader.decorate_tensor_provider(batches)
    return main, startup, reader, loss


def _startup_state(main, startup):
    """The JAX startup's persistables as numpy."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _drain(pkg, exe, main, reader, loss, scope, epochs):
    """Per-epoch losses of exe.run(feed=None) until EOFException."""
    out = []
    for _ in range(epochs):
        reader.start()
        losses = []
        while True:
            try:
                l, = exe.run(main, feed=None, fetch_list=[loss], scope=scope)
            except pkg.EOFException:
                reader.reset()
                break
            losses.append(float(np.asarray(l).reshape(-1)[0]))
        out.append(losses)
    return out


def test_py_reader_trains_from_recordio_like_paddle_tpu(tmp_path):
    """6 steps and one EOFException an epoch on both; per-step losses
    within LOSS_RTOL from one state; the loss falls."""
    path = str(tmp_path / "train.recordio")
    _regression_recordio(path)
    losses = {}
    state = None
    for name, pkg in PACKAGES.items():
        main, startup, reader, loss = _py_reader_regression(pkg, path)
        if state is None:
            state = _startup_state(main, startup)
        if name == "jax":
            scope = fluid.Scope()
            for k, v in state.items():
                scope.set_var(k, v)
            exe = fluid.Executor(fluid.CPUPlace())
        else:
            scope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
            exe = ptt.Executor(ptt.CPUPlace())
        losses[name] = _drain(pkg, exe, main, reader, loss, scope, 3)
    assert [len(e) for e in losses["torch"]] == [6, 6, 6]
    assert _rel(losses["torch"], losses["jax"]) <= LOSS_RTOL
    assert np.mean(losses["torch"][-1]) < np.mean(losses["torch"][0]) * 0.5


def test_py_reader_prepared_handle_pops_and_learns_the_device(tmp_path):
    """PreparedProgram.run(feed=None) pops as Executor.run does; a reader
    started without a place stages onto the port's default device (the
    host, where no card is visible) from start(), and keeps it after
    reset()."""
    path = str(tmp_path / "train.recordio")
    _regression_recordio(path, n=32)
    main, startup, reader, loss = _py_reader_regression(ptt, path)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    handle = exe.prepare(main, fetch_list=[loss], scope=scope)
    for _ in range(2):
        reader.start()
        n = 0
        with pytest.raises(ptt.EOFException):
            while True:
                handle.run()
                n += 1
        reader.reset()
        assert n == 2
        assert reader._stager is not None \
            and reader._stager.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="not started"):
        reader.next_feed()


def test_py_reader_producer_error_is_not_eof():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        reader, (xv,) = ptt.reader.py_reader(
            capacity=2, shapes=[[-1, 4]], dtypes=["float32"])

    def bad():
        yield {xv.name: np.zeros((2, 4), np.float32)}
        raise ValueError("broken source")

    reader.decorate_tensor_provider(bad)
    reader.start()
    assert isinstance(reader.next_feed(ptt.CPUPlace())[xv.name],
                      torch.Tensor)
    with pytest.raises(RuntimeError, match="NOT end-of-data") as e:
        reader.next_feed()
    assert isinstance(e.value.__cause__, ValueError)
    reader.reset()


def test_py_reader_starts_its_producer_at_start():
    """start() launches the producer onto the reader's default device, so
    the first batches are staged before anything pops; iterated directly,
    the reader yields them there (host tensors on a host with no card)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        reader, (xv,) = ptt.reader.py_reader(
            capacity=2, shapes=[[-1, 4]], dtypes=["float32"])
    reader.decorate_tensor_provider(
        lambda: ({xv.name: np.full((2, 4), i, np.float32)} for i in range(5)))
    reader.start()
    deadline = time.time() + 30
    while reader._queue.qsize() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert reader._queue.qsize() == 2
    assert reader._stager.device == default_device()
    seen = list(reader)
    assert all(isinstance(f[xv.name], torch.Tensor)
               and f[xv.name].device == default_device() for f in seen)
    assert [float(f[xv.name][0, 0]) for f in seen] == [0.0, 1.0, 2.0, 3.0,
                                                        4.0]
    reader.reset()


def test_preprocessor_runs_on_the_card_by_default():
    """Preprocessor without a place runs where an Executor() does, on
    CUDAPlace(0): its outputs are card tensors there, and on a host with
    no card it raises as CUDAPlace(0) does, rather than falling back."""
    def source():
        yield (np.ones((2, 3), np.float32),)

    pre = ptt.layers.Preprocessor(source)
    with pre.block():
        x, = pre.inputs(["float32"], [[2, 3]])
        pre.outputs(ptt.layers.scale(x, scale=2.0))
    if torch.cuda.is_available():
        out, = next(iter(pre()()))
        assert out.is_cuda and out.tolist() == [[2.0] * 3] * 2
    else:
        with pytest.raises(RuntimeError, match=r"CUDAPlace\(0\)"):
            pre()


# ---------------------------------------------------------------------------
# AsyncFeeder
# ---------------------------------------------------------------------------

def _batches(n=6):
    return [{"a": np.full((2, 2), i, np.float32)} for i in range(n)]


def test_async_feeder_order_and_host_tensors_on_cpu():
    """Batches arrive in order on both; with a CPU device the port yields
    host tensors, and with no device named, on a host with no card, too
    (the default is card 0 where one is visible)."""
    batches = _batches(9)

    def reader():
        yield from ([b] for b in batches)

    jseen = [float(f["a"][0, 0])
             for f in JAsyncFeeder(lambda b: b[0], reader, capacity=2)]
    feeder = AsyncFeeder(lambda b: b[0], reader, capacity=2,
                         device=ptt.CPUPlace())
    tseen = []
    for f in feeder:
        assert isinstance(f["a"], torch.Tensor) and f["a"].device.type == "cpu"
        tseen.append(float(f["a"][0, 0]))
    assert tseen == jseen == [float(i) for i in range(9)]
    assert len(feeder.waits_s) == len(feeder.starved) == \
        len(feeder.produce_s) == 9
    default = AsyncFeeder(lambda b: b[0], reader)
    assert default.stager.device == default_device() == torch.device("cpu")
    plain = [f["a"] for f in default]
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in plain)
    assert [float(a[0, 0]) for a in plain] == tseen


def test_async_feeder_slow_consumer_terminates():
    """Mirror of tests/test_data_plane.py:288-306: with the queue full when
    the reader ends, the end sentinel is still delivered."""
    batches = _batches()

    def reader():
        yield from ([b] for b in batches)

    seen = []
    for feed in AsyncFeeder(lambda b: b[0], reader, capacity=1,
                            device="cpu"):
        time.sleep(0.05)
        seen.append(float(feed["a"][0, 0]))
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_async_feeder_surfaces_a_producer_error_after_the_good_batches():
    def reader():
        yield [{"a": np.zeros(2, np.float32)}]
        raise KeyError("decode failed")

    seen = []
    with pytest.raises(KeyError, match="decode failed"):
        for feed in AsyncFeeder(lambda b: b[0], reader, device="cpu"):
            seen.append(feed)
    assert len(seen) == 1


def test_async_feeder_abandon_on_break_releases_the_producer():
    produced = []

    def reader():
        for i in range(1000):
            produced.append(i)
            yield [{"a": np.full(3, i, np.float32)}]

    feeder = AsyncFeeder(lambda b: b[0], reader, capacity=2, device="cpu")
    for i, feed in enumerate(feeder):
        if i == 2:
            break
    def producers():
        return [t for t in threading.enumerate()
                if t.name == "async_feeder" and t.is_alive()]

    t0 = time.time()
    while producers() and time.time() - t0 < 5:
        time.sleep(0.05)
    assert not producers()
    assert len(produced) < 20
    # a second iteration of the same feeder starts over
    assert [float(f["a"][0]) for f in feeder][:3] == [0.0, 1.0, 2.0]


def _lod_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name="words", shape=[1], dtype="int64",
                                lod_level=1)
        label = pkg.layers.data(name="label", shape=[1], dtype="float32")
        emb = pkg.layers.embedding(input=words, size=[20, 8])
        pooled = pkg.layers.sequence_pool(input=emb, pool_type="sum")
        pred = pkg.layers.fc(input=pooled, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, words, label, loss


def _lod_rows(n_batches=3, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, 20, (rng.randint(1, 7), 1)).tolist(),
              [float(rng.rand())]) for _ in range(batch)]
            for _ in range(n_batches)]


def test_lod_pair_through_async_feeder_and_py_reader_like_paddle_tpu():
    """A `(data, lengths)` feed moves as a pair through AsyncFeeder and
    through py_reader; the losses equal the JAX package's fed directly
    (LOSS_RTOL), from one state."""
    rows = _lod_rows()
    main, startup, words, label, loss = _lod_program(fluid)
    state = _startup_state(main, startup)
    jscope = fluid.Scope()
    for k, v in state.items():
        jscope.set_var(k, v)
    jexe = fluid.Executor(fluid.CPUPlace())
    jfeeder = fluid.DataFeeder([words, label], fluid.CPUPlace(),
                               program=main)
    want = [float(np.asarray(jexe.run(main, feed=jfeeder.feed(b),
                                      fetch_list=[loss],
                                      scope=jscope)[0]).reshape(-1)[0])
            for b in rows]

    main, startup, words, label, loss = _lod_program(ptt)
    scope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    handle = exe.prepare(main, fetch_list=[loss], scope=scope)
    feeder = ptt.DataFeeder([words, label], program=main)
    got = []
    for feed in AsyncFeeder(feeder, lambda: iter(rows), capacity=2,
                            prepared=handle):
        data, lens = feed["words"]
        assert isinstance(data, torch.Tensor) and isinstance(lens,
                                                            torch.Tensor)
        assert lens.dtype == torch.int32
        got.append(float(handle.run(feed)[0].reshape(-1)[0]))
    assert _rel(got, want) <= LOSS_RTOL

    # the same pairs through a py_reader bound to this program
    scope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
    reader = ptt.reader.PyReader([words, label], capacity=2, program=main)
    reader.decorate_paddle_reader(lambda: iter(rows))
    got = _drain(ptt, exe, main, reader, loss, scope, 1)[0]
    assert _rel(got, want) <= LOSS_RTOL


def test_async_feeder_sharding_waits_for_parallel_executor():
    """`sharding=` is ported (ROADMAP item 7): on a one-rank mesh the
    feeder stages the whole batch and marks it as the rank's shard, which
    a ParallelExecutor over that mesh takes."""
    from paddle_tpu_torch.distributed import LocalShard
    mesh = ptt.parallel.make_mesh([1], ["dp"])
    batches = [[np.full(3, i, np.float32), np.full(3, i + 1, np.float32)]
               for i in range(2)]
    feeds = list(AsyncFeeder(lambda b: {"x": np.stack(b)},
                             lambda: iter(batches), device="cpu",
                             sharding=ptt.parallel.batch_sharded(mesh)))
    assert len(feeds) == 2 and all(isinstance(f["x"], LocalShard)
                                   for f in feeds)
    assert np.array_equal(feeds[1]["x"].data.numpy(), np.stack(batches[1]))
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[3], dtype="float32")
        y = ptt.layers.reduce_sum(x)
    pe = ptt.ParallelExecutor(use_cuda=False, main_program=main,
                              scope=ptt.Scope(), mesh=mesh)
    assert float(pe.run([y], feed=feeds[1])[0]) == 9.0


def test_device_stager_on_cpu_keeps_nested_structure():
    stager = DeviceStager("cpu", 3)
    feed = {"x": (np.ones((2, 3, 1), np.int64),
                  (np.array([1, 2], np.int32),
                   np.array([[1, 0], [2, 1]], np.int32))),
            "y": np.zeros(2, np.float32)}
    out = stager.hand_over(stager.stage(feed))
    data, (outer, inner) = out["x"]
    assert data.dtype == torch.int64 and outer.tolist() == [1, 2]
    assert inner.tolist() == [[1, 0], [2, 1]]
    assert out["y"].dtype == torch.float32
    assert stager.pinned_allocs == 0


def test_device_stager_passes_device_tensors_through():
    """A feed already on the stager's device (a Preprocessor's output) is
    handed on as it is; numpy beside it is converted."""
    stager = DeviceStager("cpu", 2)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = stager.hand_over(stager.stage({"t": t, "n": np.ones(2, np.int64)}))
    assert out["t"] is t
    assert out["n"].dtype == torch.int64 and out["n"].tolist() == [1, 1]


# ---------------------------------------------------------------------------
# layers-io surface
# ---------------------------------------------------------------------------

def test_layers_io_surface_like_paddle_tpu(tmp_path):
    """Mirror of tests/test_data_plane.py:308-351:
    open_recordio_file, open_files, double_buffer, read_file, shuffle,
    batch, random_data_generator, with the JAX package's results; and
    ListenAndServ / Send / Recv round-trip through the port's parameter
    server."""
    path = str(tmp_path / "s.recordio")
    samples = [(np.full((4,), i, np.float32), np.array([i % 2], np.int64))
               for i in range(40)]
    jrio.write_file(path, (pickle.dumps(s) for s in samples))
    second = str(tmp_path / "t.recordio")
    jrio.write_file(second, (pickle.dumps(s) for s in samples[:8]))
    got = {}
    for name, pkg in PACKAGES.items():
        with pkg.program_guard(pkg.Program(), pkg.Program()), \
                pkg.unique_name.guard():
            reader, feed_vars = pkg.layers.open_recordio_file(
                path, shapes=[[-1, 4], [-1, 1]], dtypes=["float32", "int64"])
            assert pkg.layers.read_file(reader) == feed_vars
            reader.start()
            feeds = list(iter(reader))
            reader.reset()
            freader, fvars = pkg.layers.open_files(
                [path, second], shapes=[[-1, 4], [-1, 1]],
                dtypes=["float32", "int64"], pass_num=2)
            freader.start()
            ffeeds = list(iter(freader))
            freader.reset()
        got[name] = (
            [[np.asarray(f[v.name]).tolist() for v in feed_vars]
             for f in feeds],
            [[np.asarray(f[v.name]).tolist() for v in fvars]
             for f in ffeeds],
            list(pkg.layers.double_buffer(lambda: iter(range(5)))()),
            list(pkg.layers.batch(lambda: iter(range(7)), 3)()),
            [a.tolist() for a in next(iter(pkg.layers.random_data_generator(
                -1.0, 1.0, [[2, 3], [1]])()))])
        random.seed(1)
        got[name] += (list(pkg.layers.shuffle(lambda: iter(range(9)),
                                              4)()),)
    assert got["torch"] == got["jax"]
    assert sum(len(f[0]) for f in got["torch"][0]) == 40
    assert len(got["torch"][1]) == 6          # 96 records, batches of 16
    # ListenAndServ/Send/Recv round-trip through the host PS runtime
    srv = ptt.layers.ListenAndServ("127.0.0.1:0")
    try:
        c = ptt.pserver.PSClient([srv.endpoint])
        c.init_param(srv.endpoint, "w", np.ones((2, 2), np.float32),
                     "sgd", lr=0.1, attrs={})
        c.close()
        scope = ptt.Scope()
        got, = ptt.layers.Recv(srv.endpoint, ["w"], scope=scope)
        np.testing.assert_allclose(got, np.ones((2, 2)))
        scope.set_var("w@GRAD", np.ones((2, 2), np.float32))
        ptt.layers.Send(srv.endpoint, ["w@GRAD"], scope=scope)
        got2, = ptt.layers.Recv(srv.endpoint, ["w"], scope=scope)
        np.testing.assert_allclose(got2, 0.9 * np.ones((2, 2)), rtol=1e-6)
    finally:
        srv.stop()


def test_load_layer_and_preprocessor_like_paddle_tpu(tmp_path):
    arr = np.random.RandomState(2).rand(3, 5).astype(np.float32)
    np.save(str(tmp_path / "w.npy"), arr)
    outs = {}
    for name, pkg in PACKAGES.items():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            block = main.global_block()
            out = block.create_var(name="loaded", shape=[3, 5],
                                   dtype="float32")
            pkg.layers.load(out, str(tmp_path / "w"))
            doubled = pkg.layers.scale(out, scale=2.0)
        exe = pkg.Executor(pkg.CPUPlace())
        outs[name] = np.asarray(exe.run(main, fetch_list=[doubled],
                                        scope=pkg.Scope())[0])

        def source():
            for i in range(3):
                yield (np.full((2, 3), i, np.float32),)

        pre = (pkg.layers.Preprocessor(source, place=ptt.CPUPlace())
               if pkg is ptt else pkg.layers.Preprocessor(source))
        with pre.block():
            x, = pre.inputs(["float32"], [[2, 3]])
            pre.outputs(pkg.layers.scale(x, scale=3.0, bias=1.0))
        outs[name + "_pre"] = [np.asarray(o[0]).tolist() for o in pre()()]
    np.testing.assert_array_equal(outs["torch"], 2 * arr)
    np.testing.assert_array_equal(outs["jax"], outs["torch"])
    assert outs["torch_pre"] == outs["jax_pre"]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _train_func(pkg, dropout=0.0):
    def fn():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        pred = pkg.layers.fc(input=h, size=1)
        return pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
    return fn


def _reader(n_batches=5, batch=8, seed=0):
    """A deterministic reader: every call yields the same batches."""
    def r():
        rng = np.random.RandomState(seed)
        w = np.linspace(-1, 1, 4).astype(np.float32).reshape(4, 1)
        for _ in range(n_batches):
            rows = []
            for _ in range(batch):
                x = rng.randn(4).astype(np.float32)
                rows.append((x, x @ w))
            yield rows
    return r


def _momentum(pkg):
    return lambda: pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9)


def _trainer(pkg, dropout=0.0, **kw):
    place = fluid.CPUPlace() if pkg is fluid else ptt.CPUPlace()
    return pkg.Trainer(train_func=_train_func(pkg, dropout),
                       optimizer_func=_momentum(pkg), place=place, **kw)


def _scope_arrays(trainer):
    out = {}
    for v in trainer.train_program.global_block().vars.values():
        val = trainer.scope.find_var(v.name)
        if v.persistable and val is not None:
            # a copy: the optimizer updates the scope's tensors in place
            out[v.name] = val.numpy().copy() \
                if isinstance(val, torch.Tensor) else np.array(val)
    return out


def _recorder():
    events, losses = [], []

    def handler(e):
        events.append((type(e).__name__, getattr(e, "epoch", None),
                       getattr(e, "step", None)))
        if type(e).__name__ == "EndStepEvent":
            losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))
    return handler, events, losses


def test_trainer_events_and_losses_like_paddle_tpu():
    """Equal event sequences; per-step losses within LOSS_RTOL from the
    JAX trainer's startup state; test() and the parameters after."""
    jt = _trainer(fluid)
    tt = _trainer(ptt)
    ptt.io.state_from_numpy(_scope_arrays(jt), ptt.CPUPlace(),
                            scope=tt.scope)
    runs = {}
    for name, t in (("jax", jt), ("torch", tt)):
        handler, events, losses = _recorder()
        t.train(num_epochs=2, event_handler=handler, reader=_reader(),
                feed_order=["x", "y"])
        runs[name] = (events, losses, t.test(_reader(2, seed=9), ["x", "y"]))
    assert runs["torch"][0] == runs["jax"][0]
    assert len(runs["torch"][1]) == 10
    assert _rel(runs["torch"][1], runs["jax"][1]) <= LOSS_RTOL
    assert _rel(runs["torch"][2], runs["jax"][2]) <= LOSS_RTOL
    ja, ta = _scope_arrays(jt), _scope_arrays(tt)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6)


def test_trainer_legacy_checkpoint_rotation_and_success(tmp_path):
    """Mirror of tests/test_trainer_and_transpilers.py:36-67."""
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = ptt.CheckpointConfig(checkpoint_dir=ckpt_dir,
                               max_num_checkpoints=2, step_interval=3)
    trainer = _trainer(ptt, checkpoint_config=cfg)
    handler, events, losses = _recorder()
    trainer.train(num_epochs=2, event_handler=handler, reader=_reader(8, 16),
                  feed_order=["x", "y"])
    assert losses[-1] < losses[0]
    serials = sorted(d for d in os.listdir(ckpt_dir)
                     if d.startswith("checkpoint_"))
    assert serials == ["checkpoint_3", "checkpoint_4"]
    for s in serials:
        assert os.path.exists(os.path.join(ckpt_dir, s, "_SUCCESS"))
    with open(os.path.join(ckpt_dir, "checkpoint_4",
                           "trainer_0_trainer_args.json")) as f:
        assert json.load(f) == {"epoch_id": 1, "step_id": 15}
    trainer2 = _trainer(ptt, checkpoint_config=ptt.CheckpointConfig(
        checkpoint_dir=ckpt_dir))
    assert trainer2.checkpoint_cfg.step_id == 15
    np.testing.assert_array_equal(_scope_arrays(trainer2)["fc_0.w_0"],
                                  np.load(os.path.join(
                                      ckpt_dir, "checkpoint_4",
                                      "fc_0.w_0.npy")))


def _run_with_snapshot(trainer, ckpt, snap, snap_at, epochs=2):
    """Train with ark checkpoints into `ckpt`, copying the dir to `snap`
    just before step `snap_at` (what a crash there would leave)."""
    handler, events, losses = _recorder()

    def h(e):
        if type(e).__name__ == "BeginStepEvent" and e.step == snap_at:
            shutil.copytree(ckpt, snap)
        handler(e)

    pkg = fluid if isinstance(trainer, fluid.Trainer) else ptt
    trainer.train(num_epochs=epochs, event_handler=h, reader=_reader(),
                  feed_order=["x", "y"],
                  checkpoint=pkg.ark.CheckpointConfig(
                      checkpoint_dir=ckpt, step_interval=3,
                      max_num_checkpoints=2))
    return losses


def test_ark_resume_equals_the_uninterrupted_run_with_dropout(tmp_path):
    """A run resumed from the newest serial (mid-epoch: cursor at step 6,
    one batch into epoch 1) fetches the uninterrupted run's losses bit
    for bit, dropout masks included (the run count is restored)."""
    ckpt, snap = str(tmp_path / "ckpt"), str(tmp_path / "snap")
    full = _run_with_snapshot(_trainer(ptt, dropout=0.3), ckpt, snap, 7)
    serials = ptt.ark.list_checkpoints(snap)
    manifest = ptt.ark.read_manifest(serials[-1][1])
    assert manifest["cursor"] == {"epoch_id": 1, "step_id": 6,
                                  "step_in_epoch": 1}
    assert manifest["rng"] == {"train_runs": 6}
    resumed = _trainer(ptt, dropout=0.3)
    handler, events, losses = _recorder()
    resumed.train(num_epochs=2, event_handler=handler, reader=_reader(),
                  feed_order=["x", "y"],
                  checkpoint=ptt.ark.CheckpointConfig(checkpoint_dir=snap,
                                                      step_interval=3))
    assert events[0] == ("BeginEpochEvent", 1, None)
    assert events[1] == ("BeginStepEvent", 1, 6)
    assert losses == full[6:]
    # without the restored run count the masks differ
    fresh = _trainer(ptt, dropout=0.3)
    arrays, _ = ptt.ark.load_checkpoint(serials[-1][1])
    fresh._ark_restore(arrays, {"rng": {}})
    out, = fresh._executor_run(fresh_feed(fresh), [fresh.loss])
    assert float(out.reshape(-1)[0]) != full[6]


def fresh_feed(trainer):
    rows = list(_reader()())[1]
    return ptt.DataFeeder(["x", "y"], program=trainer.train_program).feed(
        rows)


def test_jax_written_ark_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's Trainer writes the serials; the port's Trainer
    resumes from the newest one: parameters, Momentum's velocities and
    the cursor restored, and each later loss within LOSS_RTOL of the JAX
    run's (no dropout)."""
    ckpt, snap = str(tmp_path / "ckpt"), str(tmp_path / "snap")
    jlosses = _run_with_snapshot(_trainer(fluid), ckpt, snap, 4)
    latest = ptt.ark.latest_checkpoint(snap, verify=True)
    arrays, manifest = ptt.ark.load_checkpoint(latest)
    assert manifest["cursor"] == {"epoch_id": 0, "step_id": 3,
                                  "step_in_epoch": 3}
    assert any("velocity" in k for k in arrays)
    port = _trainer(ptt)
    seen = {}

    def handler(e):
        if type(e).__name__ == "BeginStepEvent" and not seen:
            seen.update(_scope_arrays(port))
            seen["__step"] = e.step
        rec(e)

    rec, events, losses = _recorder()
    port.train(num_epochs=2, event_handler=handler, reader=_reader(),
               feed_order=["x", "y"],
               checkpoint=ptt.ark.CheckpointConfig(checkpoint_dir=snap,
                                                   step_interval=100))
    assert seen.pop("__step") == 3
    assert set(arrays) <= set(seen)
    for k, v in arrays.items():
        np.testing.assert_array_equal(seen[k], v)
    assert len(losses) == len(jlosses) - 3
    assert _rel(losses, jlosses[3:]) <= LOSS_RTOL


def test_trainer_not_ported_options_name_their_roadmap_items():
    # parallel=True is ported (item 7): the Trainer runs a ParallelExecutor
    assert _trainer(ptt, parallel=True).parallel
    # pulse_port is ported (item 8.1): as in the JAX package, it is
    # refused while the `observe` flag is off
    with pytest.raises(RuntimeError, match="requires the observe flag"):
        _trainer(ptt, pulse_port=0)
    with pytest.raises(TypeError, match="ark.CheckpointConfig"):
        _trainer(ptt).train(1, reader=_reader(1), feed_order=["x", "y"],
                            checkpoint=ptt.CheckpointConfig())


def test_trainer_save_params_inference_model_and_inferencer(tmp_path):
    trainer = _trainer(ptt)
    trainer.train(num_epochs=1, reader=_reader(2), feed_order=["x", "y"])
    params = str(tmp_path / "params")
    trainer.save_params(params)

    def infer_func():
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        h = ptt.layers.fc(input=x, size=8, act="relu")
        return ptt.layers.fc(input=h, size=1)

    inf = ptt.Inferencer(infer_func, params, place=ptt.CPUPlace())
    x = np.ones((3, 4), np.float32)
    out, = inf.infer({"x": x})
    p = _scope_arrays(trainer)
    ref = np.maximum(x @ p["fc_0.w_0"] + p["fc_0.w_1"], 0) @ p["fc_1.w_0"] \
        + p["fc_1.w_1"]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    trainer.save_inference_model(str(tmp_path / "inf"), ["x", "y"], [])
    assert os.path.exists(str(tmp_path / "inf" / "__model__"))


# ---------------------------------------------------------------------------
# metrics, evaluator, debugger, profiler
# ---------------------------------------------------------------------------

def _metric_updates():
    rng = np.random.RandomState(4)
    return {
        "Accuracy": [((rng.rand(),), {"weight": w}) for w in (3, 5, 8)],
        "ChunkEvaluator": [((rng.randint(0, 9, 3), rng.randint(1, 9, 3),
                             rng.randint(0, 4, 3)), {}) for _ in range(3)],
        "EditDistance": [((rng.randint(0, 3, 6).astype(np.float32), 6), {})
                         for _ in range(3)],
        "Auc": [((rng.rand(20, 2), rng.randint(0, 2, 20)), {})
                for _ in range(3)],
        "Precision": [((rng.rand(10), rng.randint(0, 2, 10)), {})
                      for _ in range(3)],
        "Recall": [((rng.rand(10), rng.randint(0, 2, 10)), {})
                   for _ in range(3)],
        "DetectionMAP": [((rng.rand(), 4), {}) for _ in range(3)],
    }


@pytest.mark.parametrize("cls", sorted(_metric_updates()))
def test_metric_eval_equals_paddle_tpu(cls):
    """Fed the same numbers, each metric's eval() equals the JAX one's,
    exactly; reset() zeroes it as the JAX one's does."""
    out = {}
    for name, pkg in PACKAGES.items():
        m = getattr(pkg.metrics, cls)()
        for args, kw in _metric_updates()[cls]:
            m.update(*args, **kw)
        first = m.eval()
        m.reset()
        out[name] = (first, {k: (v.tolist() if isinstance(v, np.ndarray)
                                 else v) for k, v in vars(m).items()})
    assert out["torch"] == out["jax"]


def test_composite_metric_and_weighted_average_like_paddle_tpu():
    out = {}
    rng = np.random.RandomState(8)
    preds, labels = rng.rand(12), rng.randint(0, 2, 12)
    for name, pkg in PACKAGES.items():
        c = pkg.metrics.CompositeMetric()
        c.add_metric(pkg.metrics.Precision())
        c.add_metric(pkg.metrics.Recall())
        c.update(preds, labels)
        wa = pkg.average.WeightedAverage()
        for v, w in ((0.5, 2), (np.array([1.5]), 3), (2.0, np.array([1.0]))):
            wa.add(v, w)
        out[name] = (c.eval(), wa.eval())
        wa.reset()
        with pytest.raises(ValueError):
            wa.eval()
    assert out["torch"] == out["jax"]


def test_evaluator_accuracy_like_paddle_tpu(capsys):
    """evaluator.Accuracy over 3 batches from one state: eval() within
    LOSS_RTOL of the JAX one; the other three evaluators build their ops
    (tests/test_torch_structured.py and test_torch_detection.py run
    them against the JAX package)."""
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(8, 4).astype(np.float32),
              "lbl": rng.randint(0, 3, (8, 1)).astype(np.int64)}
             for _ in range(3)]
    out, state = {}, None
    for name, pkg in PACKAGES.items():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[-1, 4], dtype="float32",
                                append_batch_size=False)
            lbl = pkg.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                                  append_batch_size=False)
            p = pkg.layers.fc(input=x, size=3, act="softmax")
            ev = pkg.evaluator.Accuracy(input=p, label=lbl)
        if state is None:
            state = _startup_state(main, startup)
        if pkg is fluid:
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
            for k, v in state.items():
                scope.set_var(k, v)
        else:
            scope = ptt.io.state_from_numpy(state, ptt.CPUPlace())
            exe = ptt.Executor(ptt.CPUPlace())
        for feed in feeds:
            acc, = exe.run(main, feed=feed, fetch_list=ev.metrics,
                           scope=scope)
            ev.update(acc, 8)
        out[name] = ev.eval()
    assert "deprecated" in capsys.readouterr().err
    assert abs(out["torch"] - out["jax"]) <= LOSS_RTOL
    for cls, op, args in (
            ("ChunkEvaluator", "chunk_eval", dict(chunk_scheme="IOB",
                                                  num_chunk_types=2)),
            ("EditDistance", "edit_distance", {}),
            ("DetectionMAP", "detection_map", dict(class_num=3))):
        main = ptt.Program()
        with ptt.program_guard(main, ptt.Program()):
            a = ptt.layers.data("a", shape=[4, 6], dtype="float32")
            b = ptt.layers.data("b", shape=[4, 6], dtype="float32")
            ev = getattr(ptt.evaluator, cls)(a, b, **args)
        assert [o.type for o in main.global_block().ops] == [op]
        assert ev.metrics


def test_debugger_listings_equal_paddle_tpu(tmp_path):
    """pprint_program_codes (with and without the backward) and the DOT
    text of one program built in both packages: equal text."""
    out = {}
    for name, pkg in PACKAGES.items():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[4], dtype="float32")
            h = pkg.layers.fc(input=x, size=3, act="relu")
            loss = pkg.layers.mean(h)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        out[name] = (
            pkg.debugger.pprint_program_codes(main),
            pkg.debugger.pprint_program_codes(main, show_backward=True),
            pkg.debugger.draw_block_graphviz(
                main.global_block(), highlights=[r"mean"],
                path=str(tmp_path / f"{name}.dot")))
    assert out["torch"] == out["jax"]
    assert "= mul(" in out["torch"][0] and "_grad" in out["torch"][1]


def test_profiler_host_spans_exported_as_chrome_trace(tmp_path):
    """record_event spans (one body raising) reach print_host_events and
    export_chrome_tracing as in the JAX package; profiler(state="CPU")
    writes torch.profiler's trace with the record_event range in it."""
    from paddle_tpu_torch import profiler as prof
    prof.reset_profiler()
    with prof.record_event("phase_a"):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with prof.record_event("phase_b"):
            raise ValueError("boom")
    rows = prof.print_host_events()
    assert [r[0] for r in rows] == ["phase_a", "phase_b"]
    path = prof.export_chrome_tracing(str(tmp_path / "timeline.json"))
    evs = {e["name"]: e for e in json.load(open(path))["traceEvents"]}
    assert evs["phase_a"]["ph"] == "X" and evs["phase_a"]["dur"] >= 9000
    assert evs["phase_b"]["cat"] == "host"
    with prof.profiler(state="CPU", profile_path=str(tmp_path / "p")) as p:
        with prof.record_event("inside"):
            torch.ones(64).sum()
    trace = json.load(open(tmp_path / "p" / "trace.json"))
    assert any(e.get("name") == "inside" for e in trace["traceEvents"])
    assert any(e.key == "inside" for e in p.key_averages())
    prof.start_profiler("CPU", profile_path=str(tmp_path / "q"))
    with pytest.raises(RuntimeError, match="already running"):
        prof.start_profiler("CPU")
    assert prof.stop_profiler(profile_path=str(tmp_path / "q")).endswith(
        "trace.json")
    with pytest.raises(ValueError, match="CPU / GPU / All"):
        prof.start_profiler("XPU")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            prof.start_profiler("GPU")


_PORTED_MODULES = ["recordio", "recordio.snappy_codec", "recordio_writer",
                   "reader", "reader.decorator", "reader.creator",
                   "reader.py_reader", "async_feeder", "layers.io",
                   "ark.checkpoint", "trainer", "metrics", "average",
                   "evaluator", "profiler", "debugger", "annotations"]


@pytest.mark.parametrize("name", _PORTED_MODULES)
def test_ported_module_has_the_jax_modules_public_names(name):
    """Every public function and class the JAX module defines (or, for a
    package, exports) has its namesake in the port's module."""
    import importlib
    import inspect
    jmod = importlib.import_module("paddle_tpu." + name)
    tmod = importlib.import_module("paddle_tpu_torch." + name)
    own = {n for n, v in vars(jmod).items()
           if not n.startswith("_") and (inspect.isfunction(v)
                                         or inspect.isclass(v))
           and (v.__module__.startswith(jmod.__name__ + ".")
                or v.__module__ == jmod.__name__)}
    assert own
    assert own <= set(vars(tmod)), sorted(own - set(vars(tmod)))
