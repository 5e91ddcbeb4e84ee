"""paddle_tpu_torch's observe/ against paddle_tpu's, on the CPU.

The health engine's detectors, the plan-build (recompile) observatory,
the step log through the executor, the memory observatory's estimates,
the chrome-trace merge and stitch, the W3C trace context on the wire,
and a live pulse endpoint after a few Trainer steps: the same inputs
through both packages. Timestamps are injected wherever a detector reads
a window; no test here compares wall-clock times. Nothing on this path
reaches a Pallas kernel.

Tolerances: everything here is held exactly (alerts, causes, bytes,
merged documents, parsed metric families), except the losses a Trainer
fetches, which only feed the health plane and are not compared.
"""

import json
import signal
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import observe as jobs

import paddle_tpu_torch as ptt
from paddle_tpu_torch import observe as tobs

PACKAGES = {"jax": (fluid, jobs), "torch": (ptt, tobs)}


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """The repo conftest resets paddle_tpu's telemetry after each test;
    this does the same for the port's, and holds that no pulse or
    scrape thread survives `reset_all()`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = ptt.get_flag("observe")
    tobs.reset_all()
    yield
    torch.set_num_threads(n)
    ptt.set_flag("observe", prev)
    tobs.reset_all()
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(("pulse", "horizon-scrape"))]
    assert not leaked, leaked


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _alert(a):
    d = a.as_dict()
    d.pop("ts")
    return json.dumps(d, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# the detectors: one synthetic series each, timestamps injected
# ---------------------------------------------------------------------------

T0 = 1_700_000_000.0


def _case_non_finite(obs, eng):
    eng.add_detector(obs.health.NonFiniteDetector(series="s"))
    out = []
    for i, v in enumerate((1.0, 0.5, float("nan"), 0.4)):
        eng.feed("s", v, ts=T0 + i)
        out.append(eng.evaluate(now=T0 + i))
    eng.clear_alerts()
    out.append(eng.evaluate(now=T0 + 5))
    eng.feed("s", float("inf"), ts=T0 + 6)
    out.append(eng.evaluate(now=T0 + 6))
    return out


def _case_spike(obs, eng):
    eng.add_detector(obs.health.SpikeDetector(series="g", window=32, k=10,
                                              min_points=8))
    rng = np.random.RandomState(0)
    out = []
    for i in range(16):
        eng.feed("g", 1.0 + float(rng.rand()) * 0.01, ts=T0 + i)
    out.append(eng.evaluate(now=T0 + 16))
    eng.feed("g", 50.0, ts=T0 + 17)
    out.append(eng.evaluate(now=T0 + 17))
    eng.feed("g", 1.0, ts=T0 + 18)
    out.append(eng.evaluate(now=T0 + 18))
    return out


def _case_rate_collapse(obs, eng):
    eng.add_detector(obs.health.RateCollapseDetector(
        recent_s=5.0, trailing_s=30.0, frac=0.25, min_trailing=20))
    now = T0 + 100
    for i in range(30):
        eng.feed("steps", 1.0, ts=now - 35 + i)
    out = [eng.evaluate(now=now)]
    for i in range(10):
        eng.feed("steps", 1.0, ts=now - 4 + i * 0.3)
    out.append(eng.evaluate(now=now))
    return out


def _case_rate_spike(obs, eng):
    eng.add_detector(obs.health.RateSpikeDetector(
        name="ps_retry_storm", series="r", window_s=15.0, threshold=8.0))
    out = []
    for i in range(10):
        eng.feed("r", 1.0, ts=T0 + i)
        out.append(eng.evaluate(now=T0 + i))
    out.append(eng.evaluate(now=T0 + 60))
    return out


def _case_recompile(obs, eng):
    eng.add_detector(obs.health.RecompileDetector(grace_steps=5))
    sl = obs.steplog
    sl.observatory().record(1, "feed_shape", "executor")
    out = [eng.evaluate(now=T0)]
    for i in range(10):
        sl.get_steplog().record(
            sl.StepStats(1, "executor", T0 + i, {"device_compute": 1e-6}),
            emit_metrics=False, emit_trace=False)
    out.append(eng.evaluate(now=T0 + 10))
    sl.observatory().record(1, "padding_bucket", "serving")
    out.append(eng.evaluate(now=T0 + 11))
    out.append(eng.evaluate(now=T0 + 12))
    return out


def _case_capacity(obs, eng):
    eng.add_detector(obs.health.QueueSaturationDetector(frac=0.9))
    eng.add_detector(obs.health.KvCacheExhaustionDetector(frac=0.9))
    m = obs.metrics
    m.gauge("serve_queue_depth").set(250, model="m")
    m.gauge("serve_queue_capacity").set(256, model="m")
    m.gauge("serve_kv_blocks_in_use").set(95, model="lm", version="v1")
    m.gauge("serve_kv_blocks_capacity").set(100, model="lm", version="v1")
    out = [eng.evaluate(now=T0)]
    m.gauge("serve_queue_depth").set(10, model="m")
    m.gauge("serve_kv_blocks_in_use").set(5, model="lm", version="v1")
    out.append(eng.evaluate(now=T0 + 1))
    return out


def _case_replication_quorum(obs, eng):
    eng.add_detector(obs.health.ReplicationStallDetector(window_s=20.0,
                                                         min_points=4))
    eng.add_detector(obs.health.QuorumLossDetector())
    for i in range(6):
        eng.feed("ps_replication_lag", 10.0 * (i + 1), ts=T0 + i)
        eng.feed("ps_push_serves", 1.0, ts=T0 + i)
    obs.metrics.gauge("quorum_lease_ok").set(0.0, resource="master")
    out = [eng.evaluate(now=T0 + 6)]
    obs.metrics.gauge("quorum_lease_ok").set(1.0, resource="master")
    out.append(eng.evaluate(now=T0 + 60))
    return out


def _case_master(obs, eng):
    eng.add_detector(obs.health.TaskStarvationDetector(window_s=15.0))
    eng.add_detector(obs.health.TaskDiscardDetector())
    m = obs.metrics
    m.gauge("master_tasks_todo").set(4)
    m.gauge("master_tasks_pending").set(2)
    eng.feed("master_task_progress", 1.0, ts=T0)
    m.counter("master_tasks_discarded_total").inc(0)
    out = [eng.evaluate(now=T0 + 1)]
    m.counter("master_tasks_discarded_total").inc(2)
    out.append(eng.evaluate(now=T0 + 60))
    return out


def _case_compression(obs, eng):
    eng.add_detector(obs.health.CompressionCollapseDetector(
        window_s=30.0, min_bytes=1000.0))
    eng.feed("wire_raw_bytes", 100_000.0, ts=T0)
    eng.feed("wire_encoded_bytes", 25_000.0, ts=T0)
    out = [eng.evaluate(now=T0)]
    eng.feed("wire_raw_bytes", 100_000.0, ts=T0 + 120)
    eng.feed("wire_encoded_bytes", 100_000.0, ts=T0 + 120)
    out.append(eng.evaluate(now=T0 + 120))
    return out


DETECTOR_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_non_finite, _case_spike, _case_rate_collapse, _case_rate_spike,
    _case_recompile, _case_capacity, _case_replication_quorum,
    _case_master, _case_compression)}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_detectors_fire_the_same_alerts_as_paddle_tpu(case):
    got = {}
    for name, (_, obs) in PACKAGES.items():
        obs.reset_all()
        eng = obs.health.HealthEngine()
        evals = DETECTOR_CASES[case](obs, eng)
        got[name] = ([[_alert(a) for a in ev] for ev in evals],
                     [_alert(a) for a in eng.history()])
        obs.reset_all()
    assert got["torch"] == got["jax"]
    assert any(got["torch"][0]), "the case fired nothing"


def test_timeseries_and_default_watches_match_paddle_tpu():
    from paddle_tpu.observe import health as jh
    from paddle_tpu_torch.observe import health as th
    assert th.DEFAULT_WATCHES == jh.DEFAULT_WATCHES
    out = {}
    for name, h in (("jax", jh), ("torch", th)):
        ts = h.TimeSeries(capacity=8)
        for i in range(20):
            ts.append(float(i * i), ts=T0 + i)
        out[name] = (ts.values(), ts.window_sum(3.0, now=T0 + 19),
                     ts.rate(3.0, now=T0 + 19), ts.derivative())
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the plan-build observatory and the step log
# ---------------------------------------------------------------------------

def test_observatory_attributes_the_same_causes_as_paddle_tpu():
    events = [
        ("build", 1, 0, ("x",), ("loss",), None, "executor", 10),
        ("shape", 1, (("x", (4, 4), "float32"),), "executor"),
        ("build", 1, 0, ("x",), ("loss",), None, "executor", 10),
        ("build", 1, 1, ("x",), ("loss",), None, "executor", 10),
        ("build", 1, 1, ("x", "y"), ("loss",), None, "executor", 10),
        ("build", 1, 1, ("x", "y"), ("loss", "acc"), None, "executor", 10),
        ("build", 1, 1, ("x", "y"), ("loss", "acc"), None, "executor", 11),
        ("build", 1, 1, ("x", "y"), ("loss", "acc"), (("k", 1),),
         "executor", 11),
        ("build", 2, 0, ("t",), ("o",), None, "serving", 12),
        ("warmup", 2, "serving"),
        ("shape", 2, (("t", (8, 16), "int64"),), "serving"),
    ]
    got = {}
    for name, (_, obs) in PACKAGES.items():
        obs.reset_all()
        o = obs.steplog.observatory()
        causes = []
        for ev in events:
            if ev[0] == "build":
                _, uid, ver, feeds, fetches, copts, src, scope = ev
                causes.append(o.note_entry_build(uid, ver, feeds, fetches,
                                                 copts, source=src,
                                                 scope_uid=scope))
            elif ev[0] == "shape":
                o.note_shape_miss(ev[1], ev[2], ev[3],
                                  "padding_bucket" if ev[3] == "serving"
                                  else "feed_shape")
            else:
                o.record(ev[1], "warmup", ev[2])
        got[name] = (causes, o.counts(),
                     [(e.program_uid, e.cause, e.source, e.detail)
                      for e in o.events()],
                     [e.cause for e in o.unexpected()],
                     obs.metrics.default_registry().get(
                         "executor_recompiles_total").items())
        obs.reset_all()
    assert got["torch"] == got["jax"]
    assert "copts_change" in got["torch"][0]


def _mlp(pkg):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    loss = pkg.layers.mean(pkg.layers.fc(input=x, size=2))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _flow_shapes(pkg, obs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _mlp(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    pkg.set_flag("observe", True)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    feed = {"x": np.ones((4, 4), np.float32)}
    prepared.run(feed)
    prepared.run(dict(feed))
    prepared.run({"x": np.ones((6, 4), np.float32)})
    return main


def _flow_mutation(pkg, obs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _mlp(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    pkg.set_flag("observe", True)
    feed = {"x": np.ones((4, 4), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with pkg.program_guard(main):
        pkg.layers.mean(pkg.layers.scale(main.global_block().var("x"),
                                         scale=2.0))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main


def _flow_scopes_and_fetches(pkg, obs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _mlp(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    pkg.set_flag("observe", True)
    feed = {"x": np.ones((4, 4), np.float32)}
    s1, s2 = pkg.Scope(), pkg.Scope()
    for s in (s1, s2):
        exe.run(startup, scope=s)
        exe.run(main, feed=feed, fetch_list=[loss], scope=s)
    exe.run(main, feed=feed, fetch_list=[], scope=s1)
    # a handle prepared again on a key already built records nothing
    exe.prepare(main, fetch_list=[loss], scope=s1).run(feed)
    return main


def _flow_observe_off(pkg, obs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _mlp(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    pkg.set_flag("observe", False)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    feed = {"x": np.ones((4, 4), np.float32)}
    prepared.run(feed)
    obs.default_registry().reset()
    obs.get_steplog().clear()
    for _ in range(3):
        prepared.run(feed)
    assert obs.default_registry().names() == []
    assert obs.get_steplog().phase_summary()["steps"] == 0
    prepared.run({"x": np.ones((6, 4), np.float32)})   # untracked: off
    return main


FLOWS = {f.__name__[len("_flow_"):]: f for f in (
    _flow_shapes, _flow_mutation, _flow_scopes_and_fetches,
    _flow_observe_off)}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_executor_records_what_paddle_tpu_records(flow):
    """The plan builds (the JAX executor's compile-cache misses) with
    their causes, and the step log's records: which steps, which phases
    (`bind` on the binding step only), which sources."""
    got = {}
    for name, (pkg, obs) in PACKAGES.items():
        obs.reset_all()
        main = FLOWS[flow](pkg, obs)
        steps = obs.get_steplog().recent(64)
        got[name] = (
            [e.cause for e in obs.observatory().events()
             if e.program_uid == main._uid],
            [(sorted(s.phases), s.source) for s in steps
             if s.program_uid == main._uid],
            obs.get_steplog().phase_summary()["steps"],
            len(obs.get_tracer().events(cat="step")))
        pkg.set_flag("observe", False)
        obs.reset_all()
    assert got["torch"] == got["jax"]


def test_step_stats_phases_and_metrics_on_the_port():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss = _mlp(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    ptt.set_flag("observe", True)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    feed = {"x": np.ones((4, 4), np.float32)}
    prepared.run(feed)
    prepared.run(feed)
    first, second = tobs.get_steplog().recent()
    assert set(first.phases) == set(tobs.steplog.PHASES)
    assert set(second.phases) == set(tobs.steplog.PHASES) - {"bind"}
    assert all(v >= 0 for v in second.phases.values())
    reg = tobs.default_registry()
    assert reg.get("executor_steps_total").value(source="executor") == 2
    assert reg.get("executor_step_phase_us").summary(
        phase="device_compute", source="executor")["count"] == 2
    assert [e["kind"] for e in tobs.get_flight().events()].count("step") == 2


def test_parallel_executor_records_under_source_parallel():
    from paddle_tpu_torch.parallel import ParallelExecutor
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss = _mlp(ptt)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    ptt.set_flag("observe", True)
    pe = ParallelExecutor(use_cuda=False, main_program=main,
                          loss_name=loss.name, scope=scope)
    for shape in ((4, 4), (4, 4), (8, 4)):
        pe.run([loss], feed={"x": np.ones(shape, np.float32)})
    steps = tobs.get_steplog().recent()
    assert [s.source for s in steps] == ["parallel"] * 3
    assert ["bind" in s.phases for s in steps] == [True, False, False]
    assert [(e.cause, e.source) for e in tobs.observatory().events()
            if e.program_uid == main._uid] == [("first_call", "parallel"),
                                               ("feed_shape", "parallel")]


def test_track_and_preseed_shapes_match_paddle_tpu():
    class Entry:
        pass

    got = {}
    for name, (_, obs) in PACKAGES.items():
        obs.reset_all()
        e1, e2 = Entry(), Entry()
        a = {"x": np.zeros((2, 3), np.float32)}
        b = {"x": np.zeros((4, 3), np.float32)}
        obs.preseed_shapes(e2, b)
        for entry, src in ((e1, "executor"), (e2, "serving")):
            for f in (a, a, b, a):
                obs.track_shapes(entry, 7, f, source=src)
        got[name] = [(e.cause, e.source, e.detail)
                     for e in obs.observatory().events()]
        obs.reset_all()
    assert got["torch"] == got["jax"]
    # a tensor and the numpy array it came from have one signature
    from paddle_tpu_torch.observe import steplog
    assert steplog.shape_sig({"x": torch.zeros(2, 3)}) == \
        steplog.shape_sig({"x": np.zeros((2, 3), np.float32)})


# ---------------------------------------------------------------------------
# the memory observatory
# ---------------------------------------------------------------------------

def _train_prog(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=32, act="relu")
        pred = pkg.layers.fc(input=h, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred,
                                                        label=y))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


MEMORY_FIELDS = ("param_bytes", "optimizer_slot_bytes", "grad_bytes",
                 "activation_bytes", "feed_bytes", "peak_bytes")


def test_memory_estimates_equal_paddle_tpu_through_the_executor():
    """note_program at plan build (the JAX package's compile), with the
    same Program and feed shapes: the same bytes, field by field; on the
    CPU both are estimate-only."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 16).astype(np.float32),
            "y": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    got = {}
    for name, (pkg, obs) in PACKAGES.items():
        obs.reset_all()
        main, startup, loss = _train_prog(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        pkg.set_flag("observe", True)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        rep = obs.memory.report()
        got[name] = (rep["live"],
                     [{f: r[f] for f in MEMORY_FIELDS}
                      for r in rep["programs"].values()],
                     obs.memory.get_observatory().segment_peak(),
                     obs.memory.get_observatory().flight_section()[
                         "estimate_peak_bytes"])
        direct = obs.memory.note_program(main, {"x": np.zeros((32, 16)),
                                                "y": np.zeros((32, 1))},
                                         name="direct")
        got[name] += ({f: direct[f] for f in MEMORY_FIELDS},)
        pkg.set_flag("observe", False)
        obs.reset_all()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is False and got["torch"][1][0]["peak_bytes"] > 0


def test_memory_observatory_is_estimate_only_on_the_cpu(recwarn):
    obs = tobs.memory.get_observatory()
    assert obs.live_device_stats() is None
    assert obs.live_available() is False
    rep = obs.report()
    assert rep["live"] is False and "devices" not in rep
    assert "devices" not in obs.flight_section()
    assert not [w for w in recwarn.list if "memory" in str(w.message)]
    # a failing estimate never raises
    assert tobs.memory.note_program(object(), {"x": np.zeros(3)}) is None


# ---------------------------------------------------------------------------
# traces: merge, stitch, tree; the wire format
# ---------------------------------------------------------------------------

def _trace_files(tmp_path):
    """Two processes' chrome traces: a client span in one, and the server
    span it caused in the other, on a clock 5 ms ahead; plus a plain
    span and one whose parent is in neither file."""
    tid = "ab" * 16
    client = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 100, "tid": 0,
         "args": {"name": "trainer"}},
        {"name": "rpc:client", "ph": "X", "pid": 100, "tid": 1,
         "ts": 1_000_000, "dur": 4_000,
         "args": {"trace_id": tid, "span_id": "1" * 16}},
        {"name": "plain", "ph": "X", "pid": 100, "tid": 1, "ts": 999_000,
         "dur": 10, "args": {}}]}
    server = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 100, "tid": 0,
         "args": {"name": "pserver"}},
        {"name": "rpc:server", "ph": "X", "pid": 100, "tid": 7,
         "ts": 1_006_000, "dur": 1_000,
         "args": {"trace_id": tid, "span_id": "2" * 16,
                  "parent_span_id": "1" * 16}},
        {"name": "lost", "ph": "X", "pid": 100, "tid": 7, "ts": 1_008_000,
         "dur": 10, "args": {"trace_id": tid, "span_id": "3" * 16,
                             "parent_span_id": "9" * 16}}]}
    paths = []
    for name, doc in (("client", client), ("server", server)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    return paths, tid


def test_merge_stitch_and_tree_equal_paddle_tpu(tmp_path):
    paths, tid = _trace_files(tmp_path)
    got = {}
    for name, (_, obs) in PACKAGES.items():
        merged = obs.tracer.merge_chrome_traces(paths, strict=True)
        stitched, stats = obs.stitch_traces(paths)
        tree = obs.trace_tree(stitched["traceEvents"], tid)
        got[name] = json.dumps(
            [merged, stitched, stats,
             {k: (sorted(v) if isinstance(v, (set, dict)) else v)
              for k, v in tree.items()},
             obs.stitch.estimate_skew_us(merged[0]["traceEvents"])],
            sort_keys=True, default=str)
    assert got["torch"] == got["jax"]
    stats = json.loads(got["torch"])[2]
    assert stats["edges"] == 1 and stats["orphans"] == 1


def test_load_chrome_trace_names_the_bad_file(tmp_path):
    bad = tmp_path / "empty.json"
    bad.write_text("")
    for _, obs in PACKAGES.values():
        with pytest.raises(ValueError, match="empty.json"):
            obs.tracer.load_chrome_trace(str(bad))


def test_trace_context_crosses_between_the_packages():
    from paddle_tpu.observe import xray as jx
    from paddle_tpu_torch.observe import xray as tx
    ptt.set_flag("observe", True)
    for src, dst in ((jx, tx), (tx, jx)):
        ctx = src.SpanContext().child().with_baggage(drill="cross", n=3)
        wire = src.to_wire(ctx)
        back = dst.from_wire(json.loads(json.dumps(wire)))
        assert (back.trace_id, back.span_id, back.baggage) == \
            (ctx.trace_id, ctx.span_id, {"drill": "cross", "n": "3"})
        assert dst.to_wire(back) == wire
        with dst.activate(back):
            assert dst.baggage("drill") == "cross"
            assert dst.current() is back
        assert dst.baggage() == {}
    for junk in (None, {}, {"traceparent": "00-zz-1-01"}, "x"):
        assert tx.from_wire(junk) is None and jx.from_wire(junk) is None


def test_a_spans_chrome_export_stitches_under_its_wire_parent(tmp_path):
    """A span recorded by the port under a context that came over the
    wire from a JAX package span: one trace, one edge, no orphan."""
    from paddle_tpu.observe import tracer as jtracer, xray as jx
    from paddle_tpu_torch.observe import tracer as ttracer, xray as tx
    ptt.set_flag("observe", True)
    fluid.set_flag("observe", True)
    names = (jtracer._process_name, ttracer._process_name)
    jx.set_process_name("jax-side")
    tx.set_process_name("port-side")
    try:
        with jx.span("client") as root:
            wire = jx.to_wire(root)
        with tx.activate(tx.from_wire(wire)):
            with tx.span("server"):
                pass
        paths = [str(tmp_path / "j.json"), str(tmp_path / "t.json")]
        jobs.get_tracer().export_chrome(paths[0])
        tobs.get_tracer().export_chrome(paths[1])
        doc, stats = tobs.stitch_traces(paths)
        tree = tobs.trace_tree(doc["traceEvents"], root.trace_id)
        assert stats["edges"] == 1 and stats["orphans"] == 0
        assert len(tree["roots"]) == 1 and len(tree["pids"]) == 2
    finally:
        jtracer._process_name, ttracer._process_name = names
        fluid.set_flag("observe", False)


# ---------------------------------------------------------------------------
# the live plane: pulse after a few Trainer steps
# ---------------------------------------------------------------------------

def _train_func(pkg):
    def fn():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1, param_attr=pkg.ParamAttr(
            initializer=pkg.initializer.Constant(0.1)))
        return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    return fn


def _reader(steps=3):
    rng = np.random.RandomState(0)
    rows = [[(rng.rand(4).astype(np.float32),
              rng.rand(1).astype(np.float32)) for _ in range(8)]
            for _ in range(steps)]
    return lambda: iter(rows)


def test_live_pulse_after_trainer_steps_matches_paddle_tpu():
    from paddle_tpu.observe.metrics import parse_prometheus_text as jparse
    from paddle_tpu_torch.observe.metrics import \
        parse_prometheus_text as tparse
    got = {}
    for name, (pkg, obs) in PACKAGES.items():
        obs.reset_all()
        pkg.set_flag("observe", True)
        trainer = pkg.Trainer(_train_func(pkg),
                              lambda pkg=pkg: pkg.optimizer.SGD(
                                  learning_rate=0.1),
                              place=pkg.CPUPlace(), pulse_port=0)
        port = trainer.pulse_port
        losses = []

        def handler(ev, losses=losses, pkg=pkg):
            if isinstance(ev, pkg.EndStepEvent):
                losses.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))
        trainer.train(1, handler, reader=_reader(), feed_order=["x", "y"])
        code, body = _get(port, "/metrics")
        assert code == 200
        parsed = (jparse if name == "jax" else tparse)(body.decode())
        code_h, health = _get(port, "/healthz")
        code_s, status = _get(port, "/status")
        assert code_s == 200
        status = json.loads(status)
        got[name] = dict(
            families=set(parsed), health=code_h,
            status_keys=sorted(status),
            steps=sorted(status["steps"]),
            memory_keys=sorted(status["memory"]),
            last_loss=parsed["trainer_last_loss"]["samples"],
            losses=losses,
            flight=sorted(json.loads(_get(port, "/flight")[1])),
            trace=sorted(json.loads(_get(port, "/trace")[1])))
        pkg.set_flag("observe", False)
        obs.reset_all()
    j, t = got["jax"], got["torch"]
    assert t["families"] == j["families"]
    for k in ("health", "status_keys", "steps", "memory_keys", "flight",
              "trace"):
        assert t[k] == j[k], k
    assert t["health"] == 200
    assert "executor_steps_total" in t["families"]
    # trainer_last_loss is the last loss fetched
    assert t["last_loss"][0][2] == pytest.approx(t["losses"][-1], rel=1e-6)


def test_start_pulse_refused_while_observe_is_off():
    ptt.set_flag("observe", False)
    with pytest.raises(RuntimeError, match="requires the observe flag"):
        tobs.start_pulse(0)
    assert tobs.pulse.get_pulse() is None
    with pytest.raises(RuntimeError, match="requires the observe flag"):
        ptt.serve.InferenceServer(ptt.CPUPlace(), ptt.serve.ServeConfig(
            pulse_port=0))


def test_non_finite_loss_turns_healthz_unready_and_lands_in_flight():
    ptt.set_flag("observe", True)
    port = tobs.start_pulse(0)
    assert _get(port, "/healthz")[0] == 200
    tobs.health.note_loss_fetch([np.float32(0.5)])
    tobs.health.note_loss_fetch([np.array([float("inf")], np.float32)])
    code, body = _get(port, "/healthz")
    assert code == 503
    assert json.loads(body)["status"] != "ok"
    alerts = [e for e in json.loads(_get(port, "/flight")[1])["events"]
              if e["kind"] == "alert"]
    assert [a["rule"] for a in alerts] == ["non_finite_loss"]


def test_nothing_outlives_reset_all():
    """The pulse server and its ticker, a scraper over it, a serving
    /readyz check: after reset_all (and the scraper's own stop) no
    thread of the plane is left, and the plane never installed a signal
    handler or an excepthook of its own."""
    from paddle_tpu_torch.observe.metrics import parse_prometheus_text
    before = (signal.getsignal(signal.SIGTERM), sys.excepthook)
    ptt.set_flag("observe", True)
    port = tobs.start_pulse(0)
    assert tobs.start_pulse(0) == port
    srv = ptt.serve.InferenceServer(ptt.CPUPlace(), ptt.serve.ServeConfig(
        pulse_port=0))
    assert srv.pulse_port == port
    code, body = _get(port, "/readyz")
    assert code == 200 and f"serve_queues@{id(srv):x}" in \
        json.loads(body)["checks"]
    scraper = tobs.Scraper([("self", f"http://127.0.0.1:{port}")],
                           interval_s=0.05).start()
    assert scraper.poll_once()
    parse_prometheus_text(_get(port, "/metrics")[1].decode())
    names = {t.name for t in threading.enumerate()}
    assert f"pulse@{port}" in names and "horizon-scrape" in names
    srv.close()
    assert f"serve_queues@{id(srv):x}" not in \
        json.loads(_get(port, "/readyz")[1])["checks"]
    scraper.stop()
    tobs.reset_all()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("pulse", "horizon-scrape"))]
    assert left == []
    assert (signal.getsignal(signal.SIGTERM), sys.excepthook) == before
    assert tobs.pulse.get_pulse() is None


def test_every_public_observe_name_is_ported():
    for sub in ("", ".flight", ".health", ".memory", ".metrics", ".pulse",
                ".scrape", ".steplog", ".stitch", ".tracer", ".xray"):
        j = sys.modules["paddle_tpu.observe" + sub]
        t = sys.modules["paddle_tpu_torch.observe" + sub]
        pub = {n for n in dir(j) if not n.startswith("_")
               and not isinstance(getattr(j, n), type(sys))}
        assert pub <= set(dir(t)), (sub, sorted(pub - set(dir(t))))


def test_served_warm_shapes_record_what_paddle_tpu_records(tmp_path,
                                                            monkeypatch):
    """A generative dir served by both packages with `pulse_port` set:
    the warm runs' plan-build events (`first_call`, then `warmup` for
    each further rung), no unexpected event once requests on warmed
    rungs are served, and /readyz 200 with the server's check."""
    from paddle_tpu import serve as jserve
    from paddle_tpu_torch.models import tiny_lm as ttiny
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    mdir = str(tmp_path / "lm")
    sig = ttiny.save_tiny_lm(mdir, prefill_seq_rungs=(16, 32),
                             max_context=64)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, sig["vocab"], size=n).tolist()
               for n in (5, 20)]
    got = {}
    for name, (pkg, obs) in PACKAGES.items():
        obs.reset_all()
        pkg.set_flag("observe", True)
        serve = jserve if pkg is fluid else pkg.serve
        srv = serve.InferenceServer(pkg.CPUPlace(),
                                    serve.ServeConfig(pulse_port=0))
        try:
            srv.add_model("lm", mdir)
            tokens = [srv.generate("lm", p, max_new_tokens=4).tokens
                      for p in prompts]
            code, body = _get(srv.pulse_port, "/readyz")
            got[name] = dict(
                events=[(e.cause, e.source) for e in
                        obs.observatory().events()],
                unexpected=obs.observatory().unexpected(),
                ready=code, checks=sorted(json.loads(body)["checks"]),
                tokens=tokens)
        finally:
            srv.close()
            pkg.set_flag("observe", False)
            obs.reset_all()
    j, t = got["jax"], got["torch"]
    assert t["events"] == j["events"]
    assert ("warmup", "serving") in t["events"]
    assert t["unexpected"] == [] == j["unexpected"]
    assert t["ready"] == 200 == j["ready"]
    assert [c.split("@")[0] for c in t["checks"]] == \
        [c.split("@")[0] for c in j["checks"]]
    assert t["tokens"] == j["tokens"]
