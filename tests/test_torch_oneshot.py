"""paddle_tpu_torch's one-shot serving and hot swap against paddle_tpu.

The JAX package saves every model dir here (the MLP of
tests/test_serve.py, `resnet_cifar10` depth 8 at 32 x 32 x 3 NHWC in
`is_test` mode with non-trivial batch-norm statistics, and `tiny_lm`), and
both packages' `InferenceServer(CPUPlace())` serve it under the same
request script: the bucketing planner, the outputs, the batcher's
coalescing, rejections and outcome counters, hot swap of one-shot and
generative models, and the spans recorded with the `observe` flag on.
"""

import os
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import flags as jflags
from paddle_tpu import observe as jobserve
from paddle_tpu import serve as jserve
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import tiny_lm as jtiny
from paddle_tpu.serve import batcher as jbatcher
from paddle_tpu.serve import bucketing as jbucketing

import paddle_tpu_torch as ptt
from paddle_tpu_torch import observe as tobserve
from paddle_tpu_torch.serve import batcher as tbatcher
from paddle_tpu_torch.serve import bucketing as tbucketing

FEAT, CLASSES = 6, 3
MLP_TOL = 1e-5
# resnet_cifar10 depth 8 (7 convs, 7 batch norms) through torch's CPU
# convs against XLA's: float32 sums of up to 576 products in another
# order, then softmax over 10 classes. The largest difference read on
# this script was 1.2e-7 (one float32 ulp of a probability near 1); the
# tolerance leaves room for other CPUs' vector widths
RESNET_TOL = 1e-6
IMG = (32, 32, 3)
LM_SIG = dict(max_slots=4, block_size=4, max_context=24,
              prefill_rows=(1, 2), prefill_seq_rungs=(8,))


class _Pkg:
    """One package's serving surface, so each script runs on both."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.serve, self.place = jserve, fluid.CPUPlace()
            self.metrics, self.batcher_mod = jobserve.metrics, jbatcher
            self.tracer = jobserve.tracer.get_tracer
            self.set_flag = jflags.set_flag
        else:
            self.serve, self.place = ptt.serve, ptt.CPUPlace()
            self.metrics, self.batcher_mod = tobserve.metrics, tbatcher
            self.tracer = tobserve.get_tracer
            self.set_flag = ptt.flags.set_flag

    def server(self, **cfg):
        return self.serve.InferenceServer(
            self.place, self.serve.ServeConfig(**cfg))

    def outcomes(self, model, metric="serve_requests_total",
                 label="outcome"):
        return {lab[label]: v
                for lab, v in self.metrics.counter(metric).items()
                if lab.get("model") == model}


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}


@pytest.fixture(autouse=True)
def _fresh_port_telemetry(monkeypatch):
    """The repo conftest resets the JAX package's telemetry after each
    test; this does the same for the port's (metrics, spans, the
    `observe` flag). The JAX side runs its Pallas kernels under the
    interpreter, as its own tests do."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    prev = ptt.flags.get_flag("observe")
    yield
    ptt.flags.set_flag("observe", prev)
    tobserve.reset()


# ---------------------------------------------------------------------------
# model dirs, saved by the JAX package
# ---------------------------------------------------------------------------

def _save_mlp(dirname, scale=1.0):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[FEAT], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=CLASSES, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if scale != 1.0:
        for v in main.global_block().vars.values():
            if isinstance(v, fluid.Parameter):
                scope.set_var(v.name,
                              np.asarray(scope.find_var(v.name)) * scale)
    fluid.io.save_inference_model(str(dirname), ["x"], [pred], exe,
                                  main_program=main, scope=scope)


def _save_resnet(dirname):
    """resnet_cifar10 depth 8, NHWC, `is_test`, running means ~N(0, 0.1)
    and variances in [0.5, 1.5] so the inference normalization does real
    work."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="image", shape=list(IMG),
                                dtype="float32")
        pred = jresnet.resnet_cifar10(img, class_dim=10, depth=8,
                                      is_test=True, data_format="NHWC")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(7)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            mean, var = op.input("Mean")[0], op.input("Variance")[0]
            c = np.asarray(scope.find_var(mean)).shape
            scope.set_var(mean, (rng.randn(*c) * 0.1).astype(np.float32))
            scope.set_var(var, rng.uniform(0.5, 1.5, c).astype(np.float32))
    fluid.io.save_inference_model(str(dirname), ["image"], [pred], exe,
                                  main_program=main, scope=scope)


def _save_seq_model(dirname):
    """relu over a [batch, -1, 4] feed: two bucket groups by seq rung."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[-1, 4], dtype="float32")
        out = fluid.layers.relu(x)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(dirname), ["x"], [out], exe,
                                  main_program=main, scope=scope)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("oneshot")
    out = {k: str(root / k) for k in ("mlp", "mlp2", "resnet", "seq",
                                      "lm", "lm2", "lm8")}
    _save_mlp(out["mlp"])
    _save_mlp(out["mlp2"], scale=2.0)
    _save_resnet(out["resnet"])
    _save_seq_model(out["seq"])
    jtiny.save_tiny_lm(out["lm"], seed=11, **LM_SIG)
    jtiny.save_tiny_lm(out["lm2"], seed=12, **LM_SIG)
    jtiny.save_tiny_lm(out["lm8"], kv_dtype="int8", **LM_SIG)
    return out


def _mlp_server(pkg, dirs, ladder_rows=(1, 2, 4), **cfg):
    srv = pkg.server(**{"batch_timeout_ms": 5.0, **cfg})
    srv.add_model("m", dirs["mlp"],
                  ladder=pkg.serve.BucketLadder(rows=ladder_rows))
    return srv


# ---------------------------------------------------------------------------
# bucketing: the planner against the reference's, case by case
# ---------------------------------------------------------------------------

def _plain(v):
    """A comparable form of a planner result."""
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.shape, v.tobytes())
    if hasattr(v, "group_key") and hasattr(v, "feeds"):
        return ("planned", _plain(v.feeds), v.rows, v.group_key)
    if hasattr(v, "rows") and hasattr(v, "dims"):
        return ("ladder", v.rows, v.dims)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def _trace(mod):
    rng = np.random.RandomState(3)
    return [mod.trace_request(int(r), {"x": {1: int(t)}}, ts=i * 0.5)
            for i, (r, t) in enumerate(zip(rng.randint(1, 9, 40),
                                           rng.randint(3, 30, 40)))]


def _round_trip(mod, tmp):
    path = os.path.join(tmp, "trace.json")
    mod.save_trace(path, _trace(mod))
    return mod.load_trace(path)


def _bad_trace(mod, tmp):
    path = os.path.join(tmp, "bad_trace.json")
    with open(path, "w") as f:
        f.write('{"requests": [{"ts": 0}]}')
    return mod.load_trace(path)


SPEC = {"x": ((-1, FEAT), "float32")}
SEQ_SPEC = {"x": ((-1, -1, 4), "float32")}
TWO_SPEC = {"a": ((-1, 2), "float32"), "b": ((-1, 3), "int64")}
BUCKET_CASES = {
    "rows_rung": lambda m, t: [m.BucketLadder(rows=(1, 2, 4, 8)).rows_rung(n)
                               for n in (1, 2, 3, 5, 8)],
    "rows_rung_overflow": lambda m, t: m.BucketLadder(
        rows=(1, 2, 4, 8)).rows_rung(9),
    "ladder_bad_rows": lambda m, t: m.BucketLadder(rows=(0, 2)),
    "ladder_sorted": lambda m, t: m.BucketLadder(
        rows=(4, 1, 2, 2), dims={"x": {1: (16, 8)}}),
    "dim_rung_overflow": lambda m, t: m.BucketLadder(
        dims={"x": {1: (8, 16)}}).dim_rung("x", 1, 17),
    "plan_pads_dynamic_axis": lambda m, t: m.plan_request(
        SEQ_SPEC, m.BucketLadder(rows=(1, 2), dims={"x": {1: (8, 16)}}),
        {"x": np.ones((1, 5, 4), "f4")}),
    "plan_groups_by_padded_shape": lambda m, t: m.plan_request(
        SEQ_SPEC, m.BucketLadder(rows=(1, 2), dims={"x": {1: (8, 16)}}),
        {"x": np.ones((1, 12, 4), "f4")}),
    "plan_unladdered_dim": lambda m, t: m.plan_request(
        SEQ_SPEC, m.BucketLadder(rows=(1, 2)),
        {"x": np.ones((2, 5, 4), "f4")}),
    "plan_wrong_names": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)), {"y": np.ones((1, FEAT), "f4")}),
    "plan_static_mismatch": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)),
        {"x": np.ones((1, FEAT + 1), "f4")}),
    "plan_over_the_ladder": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)), {"x": np.ones((3, FEAT), "f4")}),
    "plan_rank_mismatch": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)), {"x": np.ones((1, FEAT, 1), "f4")}),
    "plan_rows_disagree": lambda m, t: m.plan_request(
        TWO_SPEC, m.BucketLadder(rows=(1, 2, 4)),
        {"a": np.ones((2, 2), "f4"), "b": np.ones((3, 3), "i8")}),
    "plan_zero_rows": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)), {"x": np.ones((0, FEAT), "f4")}),
    "plan_casts_float64": lambda m, t: m.plan_request(
        TWO_SPEC, m.BucketLadder(rows=(1, 2, 4)),
        {"a": np.arange(6.0).reshape(3, 2),
         "b": np.arange(9, dtype=np.int32).reshape(3, 3)}),
    "plan_refuses_strings": lambda m, t: m.plan_request(
        SPEC, m.BucketLadder(rows=(1, 2)),
        {"x": np.array([["a"] * FEAT])}),
    "warm_feed_shapes": lambda m, t: m.warm_feed_shapes(
        SPEC, m.BucketLadder(rows=(1, 4))),
    "warm_feed_shapes_dims": lambda m, t: m.warm_feed_shapes(
        SEQ_SPEC, m.BucketLadder(rows=(1, 2), dims={"x": {1: (8, 16)}})),
    "warm_needs_dim_rungs": lambda m, t: m.warm_feed_shapes(
        SEQ_SPEC, m.BucketLadder(rows=(1,))),
    "warm_too_many": lambda m, t: m.warm_feed_shapes(
        SEQ_SPEC, m.BucketLadder(rows=tuple(range(1, 9)),
                                 dims={"x": {1: tuple(range(1, 10))}})),
    "pad_rows": lambda m, t: m.pad_rows(
        {"x": np.arange(12, dtype="f4").reshape(2, FEAT)}, 2, 4),
    "pad_rows_exact": lambda m, t: m.pad_rows(
        {"x": np.ones((2, FEAT), "f4")}, 2, 2),
    "concat_requests": lambda m, t: m.concat_requests(
        [m.plan_request(SEQ_SPEC, m.BucketLadder(
            rows=(1, 2, 4, 8), dims={"x": {1: (8,)}}),
            {"x": np.full((n, 3 + n, 4), n, "f4")}) for n in (1, 2, 3)]),
    "concat_one": lambda m, t: m.concat_requests(
        [m.plan_request(SPEC, m.BucketLadder(),
                        {"x": np.ones((2, FEAT), "f4")})]),
    "from_trace": lambda m, t: m.BucketLadder.from_trace(
        {"requests": _trace(m)}, max_rungs=3, dim_max_rungs=2),
    "from_trace_list": lambda m, t: m.BucketLadder.from_trace(
        _trace(m), max_rungs=8, dim_max_rungs=8, max_warm=16),
    "from_trace_empty": lambda m, t: m.BucketLadder.from_trace([]),
    "from_trace_over_budget": lambda m, t: m.BucketLadder.from_trace(
        _trace(m), dim_max_rungs=8, max_warm=4),
    "trace_round_trip": _round_trip,
    "trace_malformed": _bad_trace,
    "predicted_padding_waste": lambda m, t: m.predicted_padding_waste(
        m.BucketLadder(rows=(2, 8), dims={"x": {1: (10, 30)}}), _trace(m)),
}


def _outcome(fn, *args):
    try:
        return ("ok", _plain(fn(*args)))
    except Exception as e:          # noqa: BLE001
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucketing_equals_paddle_tpu(case, tmp_path):
    fn = BUCKET_CASES[case]
    ref = _outcome(fn, jbucketing, str(tmp_path))
    got = _outcome(fn, tbucketing, str(tmp_path))
    assert got == ref
    if case.endswith(("overflow", "mismatch", "ladder", "names", "disagree",
                      "zero_rows", "strings", "rungs", "many", "empty",
                      "budget", "malformed", "bad_rows")):
        assert ref[0] == "raise", ref


# ---------------------------------------------------------------------------
# one-shot parity: the same request script through both servers
# ---------------------------------------------------------------------------

SIZES = (1, 3, 2, 4, 1, 2)
BURST = (1, 2, 1)


def _script(pkg, model, mdir, feed_name, shape):
    """Solo requests of SIZES, then a BURST submitted together (coalesced
    under the 200 ms window). Returns the outputs, the number of batches
    the burst took, the served version's key and the outcome counts."""
    rng = np.random.RandomState(0)
    feeds = [rng.rand(n, *shape).astype(np.float32) for n in SIZES + BURST]
    srv = pkg.server(batch_timeout_ms=1.0)
    try:
        ver = srv.add_model(model, mdir,
                            ladder=pkg.serve.BucketLadder(rows=(1, 2, 4)))
        outs = [srv.infer(model, {feed_name: f})[0]
                for f in feeds[:len(SIZES)]]
        srv._batchers[model].reconfigure(batch_timeout_ms=200.0)
        before = srv.stats()["models"][model]["batches"]
        futs = [srv.submit(model, {feed_name: f})
                for f in feeds[len(SIZES):]]
        outs += [f.result(timeout=60)[0] for f in futs]
        burst_batches = srv.stats()["models"][model]["batches"] - before
        padded = ver.prepared.run({feed_name: np.concatenate(
            [feeds[1], np.zeros((1,) + shape, np.float32)])})[0]
        return {"outs": outs, "burst_batches": burst_batches,
                "version_key": ver.version_key, "padded": padded,
                "outcomes": pkg.outcomes(model),
                "versions": {f.version_id for f in futs}}
    finally:
        srv.close()


@pytest.fixture(scope="module")
def scripted(dirs):
    out = {}
    for model, feed_name, shape in (("mlp", "x", (FEAT,)),
                                    ("resnet", "image", IMG)):
        for name, pkg in PKGS.items():
            out[model, name] = _script(pkg, model, dirs[model], feed_name,
                                       shape)
    return out


@pytest.mark.parametrize("model,tol", [("mlp", MLP_TOL),
                                       ("resnet", RESNET_TOL)])
def test_oneshot_outputs_equal_paddle_tpu(scripted, model, tol):
    ref, got = scripted[model, "jax"], scripted[model, "torch"]
    assert [o.shape for o in got["outs"]] == [o.shape for o in ref["outs"]]
    assert [o.shape[0] for o in got["outs"]] == list(SIZES + BURST)
    for a, b in zip(got["outs"], ref["outs"]):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)
    assert got["outcomes"] == ref["outcomes"] == {"ok": len(SIZES + BURST)}
    # the burst coalesced: fewer batches than requests, in both
    assert got["burst_batches"] == ref["burst_batches"] == 1
    assert len(got["versions"]) == 1


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_padded_rows_do_not_reach_the_valid_rows(scripted, model):
    """A 3-row request rides the 4-row rung: its rows equal the padded
    batch's first 3 rows exactly (batch norm in `is_test` normalizes by
    the running statistics, so a zero row cannot reach a real row)."""
    got = scripted[model, "torch"]
    np.testing.assert_array_equal(got["outs"][1], got["padded"][:3])


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_version_key_equals_paddle_tpu(scripted, model):
    assert scripted[model, "torch"]["version_key"] == \
        scripted[model, "jax"]["version_key"]
    assert len(scripted[model, "torch"]["version_key"]) == 64


# ---------------------------------------------------------------------------
# batcher semantics: one case per reference TestServing test
# ---------------------------------------------------------------------------

def _coalesce(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=60.0)
    try:
        n, outs = 4, [None] * 4
        barrier = threading.Barrier(n)
        xs = [np.random.RandomState(i).randn(1, FEAT).astype(np.float32)
              for i in range(n)]

        def client(i):
            barrier.wait()
            outs[i], = srv.infer("m", {"x": xs[i]})

        ts = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert all(o is not None and o.shape == (1, CLASSES) for o in outs)
        occ = pkg.metrics.histogram("serve_batch_occupancy").summary(
            model="m")
        assert occ["count"] < n and occ["max"] >= 2
    finally:
        srv.close()


def _queue_full(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=200.0, max_queue=2)
    try:
        x = {"x": np.zeros((1, FEAT), "f4")}
        futs = [srv.submit("m", x), srv.submit("m", x)]
        with pytest.raises(pkg.serve.QueueFullError) as ei:
            srv.submit("m", x)
        assert ei.value.retriable
        for f in futs:
            f.result(timeout=30)
    finally:
        srv.close()


def _deadline_queued(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=400.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(pkg.serve.DeadlineExceededError) as ei:
            srv.infer("m", {"x": np.zeros((1, FEAT), "f4")}, deadline_ms=30)
        assert time.monotonic() - t0 < 0.35
        assert ei.value.retriable
    finally:
        srv.close()


def _deadline_behind_head(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=400.0)
    try:
        zeros = {"x": np.zeros((1, FEAT), "f4")}
        a = srv.submit("m", zeros)
        t0 = time.monotonic()
        b = srv.submit("m", zeros, deadline_ms=30)
        with pytest.raises(pkg.serve.DeadlineExceededError):
            b.result(timeout=30)
        assert time.monotonic() - t0 < 0.35
        a.result(timeout=30)
    finally:
        srv.close()


def _full_queue_first(pkg, dirs):
    srv = pkg.server(batch_timeout_ms=2000.0)
    srv.add_model("m", dirs["seq"], ladder=pkg.serve.BucketLadder(
        rows=(1, 2, 4), dims={"x": {1: (8, 16)}}))
    try:
        lone = srv.submit("m", {"x": np.ones((1, 5, 4), "f4")})
        t0 = time.monotonic()
        futs = [srv.submit("m", {"x": np.ones((2, 12, 4), "f4")})
                for _ in range(2)]
        for f in futs:
            out, = f.result(timeout=30)
            assert out.shape == (2, 16, 4)
        assert time.monotonic() - t0 < 1.0
        assert not lone.done()
    finally:
        srv.close()        # fails the lone head: outcome "error"


def _client_cancel(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=100.0)
    try:
        zeros = {"x": np.zeros((1, FEAT), "f4")}
        f1 = srv.submit("m", zeros, deadline_ms=50)
        assert f1.cancel()
        f2 = srv.submit("m", zeros)
        f2.cancel()
        time.sleep(0.25)
        out, = srv.infer("m", zeros, deadline_ms=5000)
        assert out.shape == (1, CLASSES)
    finally:
        srv.close()


def _reconfigure(pkg, dirs):
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=500.0, max_queue=8)
    try:
        srv.add_model("m", dirs["mlp"], max_queue=1)
        srv.submit("m", {"x": np.zeros((1, FEAT), "f4")})
        with pytest.raises(pkg.serve.QueueFullError):
            srv.submit("m", {"x": np.zeros((1, FEAT), "f4")})
    finally:
        srv.close()        # fails the queued one: outcome "error"


def _unknown_model(pkg, dirs):
    srv = _mlp_server(pkg, dirs)
    try:
        with pytest.raises(pkg.serve.ModelNotFoundError) as ei:
            srv.infer("nope", {"x": np.zeros((1, FEAT), "f4")})
        return str(ei.value)
    finally:
        srv.close()


def _misuse(pkg, dirs):
    srv = _mlp_server(pkg, dirs)
    try:
        srv.add_model("lm", dirs["lm"])
        with pytest.raises(pkg.serve.BadRequestError) as e1:
            srv.infer("lm", {"x": np.zeros((1, FEAT), "f4")})
        with pytest.raises(pkg.serve.BadRequestError) as e2:
            srv.generate("m", [1, 2, 3])
        with pytest.raises(pkg.serve.ModelNotFoundError) as e3:
            srv.generate("nope", [1, 2, 3])
        return [str(e1.value), str(e2.value), str(e3.value)]
    finally:
        srv.close()


BATCHER_CASES = {
    "concurrent_requests_coalesce": _coalesce,
    "queue_full_fast_reject_is_retriable": _queue_full,
    "deadline_exceeded_while_queued": _deadline_queued,
    "deadline_behind_an_undeadlined_head": _deadline_behind_head,
    "full_queue_runs_before_older_waiting_head": _full_queue_first,
    "client_cancel_does_not_kill_executor_thread": _client_cancel,
    "add_model_again_reconfigures_live_batcher": _reconfigure,
    "unknown_model": _unknown_model,
    "oneshot_vs_generative_misuse": _misuse,
}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_batcher_semantics_equal_paddle_tpu(case, dirs):
    seen = {}
    for name, pkg in PKGS.items():
        ret = BATCHER_CASES[case](pkg, dirs)
        seen[name] = (ret, pkg.outcomes("m"),
                      pkg.outcomes("m", "serve_rejects_total", "reason"))
    assert seen["torch"] == seen["jax"]


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------

def test_concurrent_hot_swap_zero_errors_and_old_version_retires(tmp_path):
    mdir = str(tmp_path / "model")
    _save_mlp(mdir)
    pkg = PKGS["torch"]
    srv = pkg.server(batch_timeout_ms=1.0)
    srv.add_model("m", mdir, ladder=ptt.serve.BucketLadder(rows=(1, 2, 4)))
    try:
        v0 = srv.registry.get("m")
        x = np.full((1, FEAT), 0.5, "f4")
        before, = srv.infer("m", {"x": x})
        errors, served = [], set()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    fut = srv.submit("m", {"x": x})
                    out, = fut.result(timeout=30)
                    assert out.shape == (1, CLASSES)
                    served.add(fut.version_id)
                except Exception as e:      # noqa: BLE001
                    errors.append(repr(e))

        ts = [threading.Thread(target=client) for _ in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.2)
        _save_mlp(mdir, scale=2.0)
        assert srv.reload("m") is True
        time.sleep(0.2)
        stop.set()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert errors == []
        v1 = srv.registry.get("m")
        assert v1.version_id != v0.version_id
        assert served == {v0.version_id, v1.version_id}
        assert v0.wait_retired(10) and v0._refs == 0
        after, = srv.infer("m", {"x": x})
        assert not np.array_equal(before, after)
        assert tobserve.metrics.counter("serve_hot_swaps_total").value(
            model="m") == 1
    finally:
        srv.close()


def test_watcher_picks_up_atomic_resave(tmp_path):
    mdir = str(tmp_path / "model")
    _save_mlp(mdir)
    srv = PKGS["torch"].server(batch_timeout_ms=5.0)
    srv.add_model("m", mdir, ladder=ptt.serve.BucketLadder(rows=(1, 2)))
    try:
        v0 = srv.registry.get("m").version_id
        srv.start_watch(interval_s=0.1)
        _save_mlp(mdir, scale=3.0)
        deadline = time.time() + 20
        while time.time() < deadline \
                and srv.registry.get("m").version_id == v0:
            time.sleep(0.05)
        assert srv.registry.get("m").version_id != v0
    finally:
        srv.close()
    assert srv.registry._watcher is None


def test_reload_without_change_is_a_noop(dirs):
    srv = _mlp_server(PKGS["torch"], dirs)
    try:
        assert srv.reload("m") is False
        assert srv.reload("m", force=True) is True
    finally:
        srv.close()


def test_prepare_commit_abort_and_the_staged_version_serves_like_paddle_tpu(
        dirs):
    x = np.random.RandomState(1).randn(3, FEAT).astype(np.float32)
    with jserve.InferenceServer(fluid.CPUPlace()) as ref:
        ref.add_model("m", dirs["mlp2"],
                      ladder=jserve.BucketLadder(rows=(1, 2, 4)))
        want, = ref.infer("m", {"x": x})
    srv = _mlp_server(PKGS["torch"], dirs)
    try:
        v1 = srv.registry.get("m")
        v1_out, = srv.infer("m", {"x": x})
        staged = srv.prepare_swap("m", dirs["mlp2"])
        assert staged.warmed and srv.registry.staged("m") is staged
        # staged, not published: v1 keeps serving, the slot keeps its dir
        np.testing.assert_array_equal(srv.infer("m", {"x": x})[0], v1_out)
        assert srv.model_detail()["m"]["version"] == v1.version_id
        assert srv.abort_swap("m") is True and staged.retired()
        assert srv.registry.staged("m") is None
        assert srv.abort_swap("m") is False
        with pytest.raises(ptt.serve.ModelUnavailableError, match="prepare"):
            srv.commit_swap("m")
        staged = srv.prepare_swap("m", dirs["mlp2"])
        assert srv.commit_swap("m") is staged
        assert v1.wait_retired(10)
        got, = srv.infer("m", {"x": x})
        np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=0)
        detail = srv.model_detail()["m"]
        assert detail["version"] == staged.version_id and detail["warmed"]
        assert detail["version_key"] == staged.version_key
        assert srv.registry._slot("m").dirname == os.path.abspath(
            dirs["mlp2"])
    finally:
        srv.close()


def _shrunk_ladder_script(pkg, dirs):
    """Requests admitted under rows (1, 2, 4); a swap publishes a version
    whose ladder tops out at 2 before their batch runs: `_execute`
    re-chunks the batch, and the one request too big for the new ladder
    fails alone."""
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=5000.0)
    try:
        batcher = srv._batchers["m"]
        ver = srv.registry.get("m")
        rng = np.random.RandomState(2)
        feeds = [rng.randn(n, FEAT).astype(np.float32) for n in (2, 1, 3, 1)]
        reqs = [pkg.batcher_mod._Request(
            pkg.serve.plan_request(ver.spec, ver.ladder, {"x": f}),
            Future(), None) for f in feeds]
        srv.add_model("m", dirs["mlp"],
                      ladder=pkg.serve.BucketLadder(rows=(1, 2)))
        batcher._execute(reqs)
        outs = []
        for r in reqs:
            try:
                outs.append(r.future.result(timeout=10)[0])
            except pkg.serve.BadRequestError as e:
                outs.append(str(e))
        occ = pkg.metrics.histogram("serve_batch_occupancy").summary(
            model="m")
        return outs, occ["count"]
    finally:
        srv.close()


def test_shrunk_ladder_rechunks_the_queued_batch(dirs):
    seen = {name: _shrunk_ladder_script(pkg, dirs)
            for name, pkg in PKGS.items()}
    (ref, ref_batches), (got, got_batches) = seen["jax"], seen["torch"]
    assert got_batches == ref_batches == 2      # [2], then [1, 1]
    assert "shrank the ladder to max 2" in got[2] and got[2] == ref[2]
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i], ref[i], atol=MLP_TOL, rtol=0)
    assert PKGS["torch"].outcomes("m") == PKGS["jax"].outcomes("m") == \
        {"ok": 3, "error": 1}


def test_kind_change_oneshot_to_generative_and_back(dirs):
    srv = _mlp_server(PKGS["torch"], dirs)
    try:
        x = {"x": np.ones((1, FEAT), "f4")}
        assert srv.infer("m", x)[0].shape == (1, CLASSES)
        ver = srv.add_model("m", dirs["lm"])
        assert ver.generative and "m" not in srv._batchers
        assert len(srv.generate("m", [1, 2, 3], max_new_tokens=3).tokens) == 3
        with pytest.raises(ptt.serve.BadRequestError, match="generative"):
            srv.infer("m", x)
        ver2 = srv.add_model("m", dirs["mlp"],
                             ladder=ptt.serve.BucketLadder(rows=(1, 2)))
        assert not ver2.generative and "m" not in srv._engines
        assert srv.infer("m", x)[0].shape == (1, CLASSES)
        with pytest.raises(ptt.serve.BadRequestError, match="one-shot"):
            srv.generate("m", [1, 2, 3])
        assert ver.wait_retired(10)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# generative hot swap
# ---------------------------------------------------------------------------

P_V1 = [[3, 1, 4, 1, 5], [2, 7, 1]]
P_V2 = [[9, 9, 8, 2], [1], [5, 5, 5]]


def _generative_swap(pkg, dirs):
    """v1 streams start (first token out), v2 is staged and committed
    while they decode, then more requests arrive: the first finish on v1,
    the later on v2, and no v2 prefill runs before v1's slots drain."""
    srv = pkg.server()
    try:
        v1 = srv.add_model("lm", dirs["lm"])
        streams = [srv.submit_stream("lm", p, max_new_tokens=10)
                   for p in P_V1]
        first = [next(iter(s)) for s in streams]
        staged = srv.prepare_swap("lm", dirs["lm2"])
        v2_runs, prefill_run = [], staged.prepared.run

        def run(feed, *a, **k):
            v2_runs.append(all(s.future.done() for s in streams))
            return prefill_run(feed, *a, **k)

        staged.prepared.run = run
        srv.commit_swap("lm")
        futs = [srv.submit_generate("lm", p, max_new_tokens=6)
                for p in P_V2]
        r1 = [s.future.result(timeout=120) for s in streams]
        r2 = [f.result(timeout=120) for f in futs]
        assert v1.wait_retired(10)
        assert v2_runs and all(v2_runs)
        assert [r.tokens[0] for r in r1] == first
        assert {r.version_id for r in r1} == {v1.version_id}
        assert {r.version_id for r in r2} == {staged.version_id}
        return [r.tokens for r in r1], [r.tokens for r in r2]
    finally:
        srv.close()


def test_generative_swap_mid_generation_equals_paddle_tpu(dirs):
    seen = {n: _generative_swap(p, dirs) for n, p in PKGS.items()}
    assert seen["torch"] == seen["jax"]
    # and each side equals a solo run of its own version
    with ptt.serve.InferenceServer(ptt.CPUPlace()) as solo:
        solo.add_model("lm2", dirs["lm2"])
        assert seen["torch"][1] == [solo.generate("lm2", p,
                                                  max_new_tokens=6).tokens
                                    for p in P_V2]


def _idle(srv, name, timeout=20.0):
    """Wait until the engine has released its version (gone idle)."""
    ver = srv.registry.get(name)
    deadline = time.monotonic() + timeout
    while ver._refs and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ver._refs == 0


def test_requant_metric_equals_paddle_tpu_across_an_idle_spell(dirs):
    """Each engine releases its version when idle and resets its requant
    watermark when it binds again, so the metric re-publishes the device
    counter after every idle spell — in both packages alike."""
    seen = {}
    for name, pkg in PKGS.items():
        srv = pkg.server()
        try:
            ver = srv.add_model("q8", dirs["lm8"])
            tokens = []
            for p in P_V1 + P_V2[:1]:
                tokens.append(srv.generate("q8", p,
                                           max_new_tokens=12).tokens)
                _idle(srv, "q8")
            rq = ver.decode.signature["requant_var"]
            seen[name] = (tokens, pkg.outcomes(
                "q8", "serve_generate_requests_total"),
                pkg.metrics.counter(
                    "serve_kv_requant_events_total").value(model="q8"),
                int(np.asarray(ver.scope.find_var(rq))[0]))
        finally:
            srv.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][2] > seen["torch"][3] > 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _span_script(pkg, dirs, observe):
    pkg.set_flag("observe", observe)
    pkg.tracer().clear()
    srv = _mlp_server(pkg, dirs, batch_timeout_ms=100.0)
    try:
        srv.add_model("lm", dirs["lm"])
        x = {"x": np.ones((1, FEAT), "f4")}
        futs = [srv.submit("m", x), srv.submit("m", x)]   # one batch
        for f in futs:
            f.result(timeout=30)
        srv.infer("m", x)                                 # a lone one
        srv.generate("lm", [1, 2, 3], max_new_tokens=2)
    finally:
        srv.close()
    spans = pkg.tracer().events(cat="serve")
    ids = {s.args["span_id"]: i for i, s in enumerate(spans)}
    return [(s.name, s.cat, sorted(s.args),
             ids.get(s.args.get("parent_span_id")),
             ids.get(s.args.get("batch_span")),
             s.args.get("outcome"), s.args.get("requests"))
            for s in spans]


def test_spans_equal_paddle_tpu(dirs):
    got = _span_script(PKGS["torch"], dirs, True)
    ref = _span_script(PKGS["jax"], dirs, True)
    assert got == ref
    assert [s[0] for s in got] == ["serve_batch", "serve_request",
                                   "serve_request", "serve_batch",
                                   "serve_request", "serve_generate"]
    # the coalesced batch is parented to its first request, whose span
    # (and its sibling's) links back to it
    assert got[0][3] == 1 and got[1][4] == got[2][4] == 0
    assert got[3][3] == 4 and got[4][4] is None


def test_no_spans_with_observe_off(dirs):
    assert _span_script(PKGS["torch"], dirs, False) == []


# ---------------------------------------------------------------------------
# one executor, several threads
# ---------------------------------------------------------------------------

def test_executor_run_counts_are_exact_under_threads():
    """Two threads run one Executor's two prepared programs 200 times each
    with a tiny switch interval: each program's run count comes out exact
    (the count is a read then a write under the executor's lock)."""
    exe = ptt.Executor(ptt.CPUPlace())
    progs = []
    for k in (2.0, 3.0):
        prog = ptt.Program()
        with ptt.program_guard(prog, ptt.Program()), ptt.unique_name.guard():
            x = ptt.layers.data("x", shape=[2], dtype="float32")
            y = ptt.layers.scale(x, scale=k)
        progs.append((prog, exe.prepare(prog, fetch_list=[y],
                                        scope=ptt.Scope())))
    feed = {"x": np.ones((1, 2), np.float32)}
    errors = []

    def worker():
        try:
            for _ in range(200):
                for _, prepared in progs:
                    prepared.run(feed)
                exe.run(progs[0][0], feed=feed,
                        fetch_list=[progs[0][1].fetch_names[0]])
        except Exception as e:              # noqa: BLE001
            errors.append(repr(e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts) and errors == []
    assert exe._run_counts[progs[0][0]._uid] == 800
    assert exe._run_counts[progs[1][0]._uid] == 400
    assert len(exe._prepared) == 1
