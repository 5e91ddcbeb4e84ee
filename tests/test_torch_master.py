"""fluid-elastic in the port: the elastic data master
(``paddle_tpu_torch/master``) and its HA pair behind the port's quorum,
on the CPU.

Every case of ``tests/test_elastic.py`` but its slow drill sweep, and
the master cases of ``tests/test_data_plane.py`` (the task lifecycle,
timeout re-issue and the failure budget, snapshot recovery, and a
consumer process killed mid-task), run here against the port's copies
with the same assertions: quorum-backed master failover, exactly-once
task accounting, ark-idiom snapshots, trainer churn. Then the interop:
the port's `MasterClient` against a JAX master and the reverse give the
same replies, both packages' masters fed the same calls hand out the
same task stream and write the same snapshot bytes. Last, a one-layer
Transformer stepped by the `Executor` on records leased from a
quorum-fenced master pair whose primary is killed mid-pass gives the
same losses, bit for bit, as the replay of the delivered batch ids
(chip_smoke.py's phase 7r, at a small size on the host).

The drills themselves (`tools/torch_chaos_drill.py --scenario
master_kill|master_partition|trainer_churn --cpu`) run in
``tests/test_torch_tools.py``."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ark
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.ark.liveness import EvictingBarrier
from paddle_tpu_torch.master import (DatasetMismatchError, Master,
                                     MasterClient)
from paddle_tpu_torch.pserver import ParameterServer, PSClient
from paddle_tpu_torch.quorum import QuorumNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """The repo conftest resets the JAX package's telemetry; this resets
    the port's (the flight recorder and metrics these cases read)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = fluid.get_flag("observe")
    tobs.reset_all()
    yield
    torch.set_num_threads(n)
    fluid.set_flag("observe", prev)
    tobs.reset_all()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(endpoint, timeout=30):
    host, port = endpoint.rsplit(":", 1)
    deadline = time.time() + timeout
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            return
        except OSError:
            if time.time() > deadline:
                raise TimeoutError(endpoint)
            time.sleep(0.2)


# ---------------------------------------------------------------------------
# snapshot corpus: the ark atomic idiom + previous-serial fallback
# ---------------------------------------------------------------------------

def _seed_master_snapshot(snap):
    """Two mutations so BOTH serials (current + .prev) exist."""
    m = Master("127.0.0.1:0", snapshot_path=snap, timeout_dur=60).start()
    c = MasterClient(m.endpoint)
    c.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)
    _, t1 = c.get_task()
    c.task_finished(t1["task_id"], t1["epoch"])
    _, t2 = c.get_task()
    c.task_finished(t2["task_id"], t2["epoch"])
    c.close()
    m.stop()


@pytest.mark.parametrize("corruption", ["truncated", "bitflip", "empty"])
def test_master_snapshot_torn_falls_back_to_previous_serial(
        tmp_path, corruption):
    """A torn/bit-rotted CURRENT snapshot recovers from the `.prev`
    serial (one mutation behind, the documented fallback) — never a
    JSONDecodeError out of recovery."""
    snap = str(tmp_path / "master.json")
    _seed_master_snapshot(snap)
    if corruption == "truncated":
        raw = open(snap).read()
        open(snap, "w").write(raw[: len(raw) // 2])
    elif corruption == "bitflip":
        doc = json.load(open(snap))
        doc["state"]["done"][0]["task_id"] = 999   # sha now mismatches
        json.dump(doc, open(snap, "w"))
    else:
        open(snap, "w").write("")
    m = Master("127.0.0.1:0", snapshot_path=snap).start()
    try:
        c = MasterClient(m.endpoint)
        st = c.stats()
        # the previous serial: 2 tasks total, one finish may be lost
        assert st["done"] + st["todo"] == 2 and st["pending"] == 0, st
        assert st["done"] >= 1
        c.close()
    finally:
        m.stop()


def test_master_snapshot_double_corruption_starts_empty(tmp_path):
    """Both serials gone: recovery starts EMPTY with a log line — it
    never crashes the process."""
    snap = str(tmp_path / "master.json")
    _seed_master_snapshot(snap)
    open(snap, "w").write("garbage{")
    open(snap + ".prev", "wb").write(b"\x00\xff\x01")
    m = Master("127.0.0.1:0", snapshot_path=snap).start()
    try:
        c = MasterClient(m.endpoint)
        assert c.stats() == {"todo": 0, "pending": 0, "done": 0}
        # and the dataset can be re-registered
        c.set_dataset(["x", "y"])
        s, _ = c.get_task()
        assert s == "ok"
        c.close()
    finally:
        m.stop()


def test_master_legacy_flat_snapshot_still_loads(tmp_path):
    """Pre-elastic snapshots (flat dict, no embedded sha) keep loading:
    pending returns to todo, pass survives."""
    snap = str(tmp_path / "legacy.json")
    legacy = {"todo": [{"task_id": 0, "payload": ["a"], "epoch": 0,
                        "num_failure": 0}],
              "pending": [{"task_id": 1, "payload": ["b"], "epoch": 2,
                           "num_failure": 1}],
              "done": [{"task_id": 2, "payload": ["c"], "epoch": 1,
                        "num_failure": 0}],
              "pass": 3}
    json.dump(legacy, open(snap, "w"))
    m = Master("127.0.0.1:0", snapshot_path=snap).start()
    try:
        c = MasterClient(m.endpoint)
        st = c.stats()
        assert st == {"todo": 2, "pending": 0, "done": 1}, st
        assert m.ha_status()["pass"] == 3
        # legacy state carries no fingerprint: re-registration stays the
        # historical silent no-op
        c.set_dataset(["whatever"])
        assert c.stats()["todo"] == 2
        c.close()
    finally:
        m.stop()


# ---------------------------------------------------------------------------
# satellite: set_dataset mismatch detection
# ---------------------------------------------------------------------------

def test_master_set_dataset_mismatch_raises(tmp_path):
    snap = str(tmp_path / "m.json")
    m = Master("127.0.0.1:0", snapshot_path=snap, timeout_dur=60).start()
    try:
        c = MasterClient(m.endpoint)
        c.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)
        # identical re-registration: the historical idempotent no-op
        c.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)
        assert c.stats()["todo"] == 2
        # a DIFFERENT dataset: pointed error, not silent wrong training
        with pytest.raises(RuntimeError, match="mismatch"):
            c.set_dataset(["x", "y"])
        # a different chunking of the same payloads is a different task
        # set too
        with pytest.raises(RuntimeError, match="mismatch"):
            c.set_dataset(["a", "b", "c", "d"], chunks_per_task=1)
        c.close()
    finally:
        m.stop()

    # the mismatch survives recovery (the fingerprint is in the snapshot)
    m2 = Master("127.0.0.1:0", snapshot_path=snap).start()
    try:
        with pytest.raises(DatasetMismatchError):
            m2.set_dataset(["x", "y", "z"])
        m2.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)  # no-op
    finally:
        m2.stop()


# ---------------------------------------------------------------------------
# satellite: clean generator close returns the lease immediately
# ---------------------------------------------------------------------------

def test_records_generator_close_returns_lease_without_failure_burn():
    """A trainer shutting down mid-task (GeneratorExit) must hand the
    lease back NOW — re-issue is immediate, not timeout-bound — and
    without burning num_failure (failure_max=0 would otherwise discard
    the task on its very next settle)."""
    m = Master("127.0.0.1:0", timeout_dur=60.0, failure_max=0).start()
    try:
        c = MasterClient(m.endpoint)
        c.set_dataset(["only-item"])
        gen = c.records(lambda item: [item])
        assert next(gen) == "only-item"
        gen.close()                      # trainer shutdown mid-task
        # the lease came back instantly: with timeout_dur=60 a stranded
        # lease would answer "none" for a minute
        s, t = c.get_task()
        assert s == "ok", s
        # ...and the budget was NOT burned: epoch advanced, failures 0
        assert t["epoch"] == 2
        with m._lock:
            assert m._pending[t["task_id"]].num_failure == 0
        assert c.task_finished(t["task_id"], t["epoch"])
        s, _ = c.get_task()
        assert s == "no_more"
        c.close()
    finally:
        m.stop()


# ---------------------------------------------------------------------------
# satellite: MasterClient retry across a master restart
# ---------------------------------------------------------------------------

def test_master_client_retries_across_master_restart(tmp_path):
    snap = str(tmp_path / "m.json")
    port = _free_port()
    ep = f"127.0.0.1:{port}"
    m = Master(ep, snapshot_path=snap, timeout_dur=60).start()
    c = MasterClient(ep, retry=ark.RetryPolicy(max_attempts=8,
                                               base_delay=0.05, seed=3))
    try:
        c.set_dataset(list(range(4)), chunks_per_task=2)
        _, t = c.get_task()
        c.task_finished(t["task_id"], t["epoch"])
        m.stop()
        time.sleep(0.1)

        # restart on the SAME endpoint while the client retries
        def restart():
            time.sleep(0.3)
            Master(ep, snapshot_path=snap, timeout_dur=60).start()

        threading.Thread(target=restart, daemon=True).start()
        s, t2 = c.get_task()            # rides the backoff transparently
        assert s == "ok"
        assert c.task_finished(t2["task_id"], t2["epoch"])
        assert c.stats()["done"] == 1 + 1  # recovered serial kept t1 done
    finally:
        c.close()
        # reach the restarted instance for shutdown
        MasterClient(ep).stop_master()


# ---------------------------------------------------------------------------
# concurrent multi-client task lifecycle (satellite: today's tier-1 is
# single-client only)
# ---------------------------------------------------------------------------

def test_concurrent_multi_client_task_lifecycle():
    """N threads pulling from one master: no task issued twice at one
    epoch, no task lost, and a stale task_finished after a re-issue is
    rejected."""
    N_TASKS, N_CLIENTS = 40, 6
    m = Master("127.0.0.1:0", timeout_dur=30.0).start()
    try:
        admin = MasterClient(m.endpoint)
        admin.set_dataset(list(range(N_TASKS)), chunks_per_task=1)
        lock = threading.Lock()
        issued, finished, errors = [], [], []

        def worker(cid):
            c = MasterClient(m.endpoint)
            try:
                while True:
                    s, t = c.get_task()
                    if s == "no_more":
                        return
                    if s == "none":
                        time.sleep(0.005)
                        continue
                    with lock:
                        issued.append((t["task_id"], t["epoch"]))
                    if c.task_finished(t["task_id"], t["epoch"]):
                        with lock:
                            finished.append(t["task_id"])
            except Exception as e:       # noqa: BLE001
                with lock:
                    errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(N_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors, errors
        # no task issued twice at one epoch
        assert len(issued) == len(set(issued)), "duplicate (task, epoch)"
        # no task lost: every task finished exactly once
        assert sorted(finished) == list(range(N_TASKS))
        st = admin.stats()
        assert st == {"todo": 0, "pending": 0, "done": N_TASKS}
        admin.close()
    finally:
        m.stop()


def test_stale_finish_after_reissue_rejected():
    m = Master("127.0.0.1:0", timeout_dur=0.3, failure_max=5,
               check_interval=0.05).start()
    try:
        c = MasterClient(m.endpoint)
        c.set_dataset(["only"])
        _, t = c.get_task()
        time.sleep(0.7)                       # lease expires, re-queued
        s, t2 = c.get_task()
        assert s == "ok" and t2["epoch"] > t["epoch"]
        # the stale first lease can no longer finish the task
        assert c.task_finished(t["task_id"], t["epoch"]) is False
        assert c.task_finished(t2["task_id"], t2["epoch"]) is True
        c.close()
    finally:
        m.stop()


# ---------------------------------------------------------------------------
# master HA: replication, quorum-fenced promotion, exactly-once
# ---------------------------------------------------------------------------

def _ha_pair(tmp_path, lease_s=0.4):
    nodes = [QuorumNode("127.0.0.1:0", str(tmp_path / "q"),
                        node_id=f"t{i}").start() for i in range(3)]
    qeps = [n.endpoint for n in nodes]
    standby = Master("127.0.0.1:0").start()
    standby.start_standby(lease_s=lease_s, quorum_endpoints=qeps,
                          quorum_resource="t-master")
    primary = Master("127.0.0.1:0", timeout_dur=30.0,
                     check_interval=0.1).start()
    primary.start_replication(standby.endpoint, lease_s=lease_s,
                              quorum_endpoints=qeps,
                              quorum_resource="t-master")
    return nodes, qeps, primary, standby


def test_master_failover_preserves_pending_lease_exactly_once(tmp_path):
    """The exactly-once pin: a lease issued at the old primary is still
    settleable at the promoted standby — the task-id/epoch pair
    matches, the finish is accepted ONCE, and its replay reads stale."""
    nodes, qeps, primary, standby = _ha_pair(tmp_path)
    try:
        cli = MasterClient(primary.endpoint,
                           standbys=[standby.endpoint],
                           quorum_endpoints=qeps,
                           quorum_resource="t-master", failover_s=15.0)
        cli.set_dataset(list(range(6)), chunks_per_task=2)
        s, t = cli.get_task()
        assert s == "ok"
        primary.stop()                       # SIGKILL-equivalent
        deadline = time.monotonic() + 10
        while standby.ha_status()["role"] != "primary":
            assert time.monotonic() < deadline, standby.ha_status()
            time.sleep(0.02)
        assert standby.fence_epoch > 1
        # the surviving trainer's settle lands exactly once
        assert cli.task_finished(t["task_id"], t["epoch"]) is True
        assert cli.task_finished(t["task_id"], t["epoch"]) is False
        # the pass drains at the promoted master
        done = 1
        while True:
            s, t = cli.get_task()
            if s == "no_more":
                break
            if s == "none":
                time.sleep(0.02)
                continue
            assert cli.task_finished(t["task_id"], t["epoch"])
            done += 1
        assert done == 3
        cli.close()
    finally:
        primary.stop()
        standby.stop()
        for n in nodes:
            n.stop()


def test_standby_redirects_task_commands(tmp_path):
    """A standby (and, by the same gate, a fenced/deposed primary) must
    never mutate task state: task commands answer with a redirect the
    client surfaces as NotMaster when nothing rules."""
    standby = Master("127.0.0.1:0").start()
    standby.start_standby(lease_s=30.0, auto_promote=False)
    try:
        c = MasterClient(standby.endpoint, retry=ark.NO_RETRY,
                         failover_s=0.0)
        with pytest.raises(RuntimeError, match="NotMaster"):
            c.get_task()
        # reads still answer
        assert c.ha_status()["role"] == "standby"
        c.close()
    finally:
        standby.stop()


def test_stale_epoch_replication_stream_rejected(tmp_path):
    """A deposed primary reconnecting after a blip must never overwrite
    a node that ruled (or replicated) at a higher epoch — whatever the
    receiver's role or fence state, a stream below its fencing epoch is
    a redirect, not an install."""
    m = Master("127.0.0.1:0").start()
    try:
        m.start_standby(lease_s=30.0, auto_promote=False)
        # the real primary feeds it at epoch 3
        newer = {"todo": [], "done": [{"task_id": 0, "payload": ["a"],
                                       "epoch": 1, "num_failure": 0}],
                 "pending": [], "pass": 0, "dataset_fp": None}
        status, v = m._h_m_replicate(records=[], epoch=3,
                                     primary="1.2.3.4:1", lease_s=30.0,
                                     snapshot=newer, base_seq=7)
        assert status == "ok" and v["applied_seq"] == 7
        # a STALE predecessor (epoch 1) reconnects with its old state
        stale = {"todo": [{"task_id": 0, "payload": ["a"], "epoch": 0,
                           "num_failure": 0}],
                 "pending": [], "done": [], "pass": 0, "dataset_fp": None}
        status, v = m._h_m_replicate(records=[], epoch=1,
                                     primary="5.6.7.8:1", lease_s=30.0,
                                     snapshot=stale, base_seq=99)
        assert status == "redirect" and v["epoch"] == 3
        with m._lock:
            assert len(m._done) == 1     # the newer state survived
        assert m._primary_endpoint == "1.2.3.4:1"
    finally:
        m.stop()


def test_master_pair_without_quorum_crash_stop_promotes(tmp_path):
    """No arbiters configured: the pair keeps the documented crash-stop
    model — lease-expiry auto-promotion, epoch bumped."""
    standby = Master("127.0.0.1:0").start()
    standby.start_standby(lease_s=0.4)
    primary = Master("127.0.0.1:0").start()
    primary.start_replication(standby.endpoint, lease_s=0.4)
    try:
        c = MasterClient(primary.endpoint, standbys=[standby.endpoint],
                         failover_s=10.0)
        c.set_dataset(["a", "b"])
        s, t = c.get_task()
        assert s == "ok"
        primary.stop()
        deadline = time.monotonic() + 8
        while standby.ha_status()["role"] != "primary":
            assert time.monotonic() < deadline, standby.ha_status()
            time.sleep(0.02)
        assert c.task_finished(t["task_id"], t["epoch"]) is True
        c.close()
    finally:
        primary.stop()
        standby.stop()


# ---------------------------------------------------------------------------
# scale-UP: barrier growth + heartbeat admission
# ---------------------------------------------------------------------------

def test_evicting_barrier_join_is_next_generation():
    """join() while a generation is in flight defers admission to the
    boundary — the world NEVER grows mid-batch."""
    b = EvictingBarrier(2)
    results = []

    def waiter(member):
        results.append((member, b.wait(timeout=10.0, member=member)))

    th0 = threading.Thread(target=waiter, args=(0,), daemon=True)
    th0.start()
    deadline = time.monotonic() + 5
    while b._arrived < 1:                 # generation now in flight
        assert time.monotonic() < deadline
        time.sleep(0.005)
    assert b.join(7) is True              # deferred: mid-generation
    assert b.live_parties == 2            # unchanged until the boundary
    th1 = threading.Thread(target=waiter, args=(1,), daemon=True)
    th1.start()
    th0.join(timeout=5)
    th1.join(timeout=5)
    assert len(results) == 2              # gen completed at the OLD size
    assert b.live_parties == 3            # admission landed at the edge
    # idle barrier: immediate admission
    assert b.join(8) is True
    assert b.live_parties == 4
    # joining twice is a no-op; evicting a pending joiner cancels the
    # admission instead of shrinking a world it never grew
    assert b.join(8) is False
    b2 = EvictingBarrier(1)
    b2._arrived = 1                       # simulate an in-flight gen
    assert b2.join(9) is True
    assert 9 in b2._joining
    assert b2.evict(9) is True
    assert 9 not in b2._joining and b2.live_parties == 1
    b2._arrived = 0
    # a joiner evicted before its boundary is a normal EVICTED member:
    # its next heartbeat readmits it (no permanent lockout), growing
    # the live world by the admission it was owed
    assert 9 in b2.evicted
    assert b2.readmit(9) is True
    assert b2.live_parties == 2


def test_heartbeat_admits_new_trainer_and_world_grows():
    """Server-level scale-up: a NEVER-SEEN trainer id heartbeating in
    is admitted, the sync world grows, and a full-world batch applies
    averaged over the grown world."""
    fluid.set_flag("observe", True)
    from paddle_tpu_torch.observe import metrics as obs_metrics
    obs_metrics.default_registry().reset()
    srv = ParameterServer("127.0.0.1:0", trainers=1).start()
    ep = srv.endpoint
    c = PSClient([ep])
    try:
        c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 1.0, {})
        c.heartbeat(ep, trainer_id=0, session="s0", lease_s=5.0)
        assert srv._sync_barrier.live_parties == 1
        # trainer 5 was never part of this world
        c.heartbeat(ep, trainer_id=5, session="s5", lease_s=5.0)
        assert srv._sync_barrier.live_parties == 2
        adm = obs_metrics.default_registry().get(
            "pserver_trainers_admitted_total")
        assert adm is not None and adm.total() == 1
        # repeated beats do NOT grow the world again
        c.heartbeat(ep, trainer_id=5, session="s5", lease_s=5.0)
        assert srv._sync_barrier.live_parties == 2

        # a 2-party batch: both must arrive, update averages over 2
        c.push_grads_sync({ep: {"w": np.full(4, 2.0, np.float32)}},
                          batch_id=0, trainer_id=0, session="s0")
        c.push_grads_sync({ep: {"w": np.full(4, 4.0, np.float32)}},
                          batch_id=0, trainer_id=5, session="s5")
        done = []

        def arrive(tid):
            c2 = PSClient([ep])
            c2.sync_apply([ep], trainer_id=tid)
            done.append(tid)
            c2.close()

        th = threading.Thread(target=arrive, args=(5,), daemon=True)
        th.start()
        time.sleep(0.2)
        assert not done                   # barrier waits for BOTH
        c.sync_apply([ep], trainer_id=0)
        th.join(timeout=10)
        assert sorted(done) == [5]
        np.testing.assert_allclose(c.get_param(ep, "w"),
                                   np.full(4, -3.0, np.float32))
        c.close()
    finally:
        fluid.set_flag("observe", False)
        srv.stop()


# ---------------------------------------------------------------------------
# observability: detectors, metrics, pulse
# ---------------------------------------------------------------------------

def test_task_starvation_and_discard_detectors():
    from paddle_tpu_torch.observe import health as obs_health
    from paddle_tpu_torch.observe import metrics as obs_metrics

    fluid.set_flag("observe", True)
    reg = obs_metrics.default_registry()
    reg.reset()
    engine = obs_health.HealthEngine()
    starv = obs_health.TaskStarvationDetector(window_s=0.2)
    disc = obs_health.TaskDiscardDetector()
    engine.add_detector(starv)
    engine.add_detector(disc)
    try:
        now = time.time()
        # no outstanding work: quiet
        assert engine.evaluate(now) == []
        # outstanding work + recent progress: quiet
        reg.gauge("master_tasks_todo", "t").set(5.0, endpoint="m")
        reg.gauge("master_tasks_pending", "t").set(1.0, endpoint="m")
        engine.feed("master_task_progress", 1.0)
        assert not engine.evaluate(time.time())
        # progress stops for the window while work is outstanding: fire
        time.sleep(0.3)
        alerts = {a.rule for a in engine.evaluate(time.time())}
        assert "task_starvation" in alerts
        # progress resumes: self-clears
        engine.feed("master_task_progress", 1.0)
        assert "task_starvation" not in {
            a.rule for a in engine.evaluate(time.time())}

        # discard detector: discards that PRE-DATE the plane arming are
        # baselined, not alerted — a fresh engine's first check sees the
        # existing count as history
        reg.counter("master_tasks_discarded_total", "d").inc(2)
        engine2 = obs_health.HealthEngine()
        engine2.add_detector(obs_health.TaskDiscardDetector())
        assert "task_discard" not in {
            a.rule for a in engine2.evaluate(time.time())}   # baselined
        # NEW discards while armed fire, sticky
        reg.counter("master_tasks_discarded_total", "d").inc()
        assert "task_discard" in {
            a.rule for a in engine2.evaluate(time.time())}
        assert "task_discard" in {
            a.rule for a in engine2.evaluate(time.time())}
        engine2.clear_alerts()
        assert "task_discard" not in {
            a.rule for a in engine2.evaluate(time.time())}
    finally:
        fluid.set_flag("observe", False)
        reg.reset()


def test_master_metrics_and_pulse(tmp_path):
    import urllib.request

    from paddle_tpu_torch.observe import health as obs_health
    from paddle_tpu_torch.observe import metrics as obs_metrics
    from paddle_tpu_torch.observe import pulse as obs_pulse

    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    obs_health.reset()
    m = Master("127.0.0.1:0", timeout_dur=0.3, failure_max=0,
               check_interval=0.05, pulse_port=0).start()
    try:
        assert m.pulse_port
        c = MasterClient(m.endpoint)
        c.set_dataset(list(range(4)), chunks_per_task=1)
        _, t = c.get_task()
        c.task_finished(t["task_id"], t["epoch"])
        _, t = c.get_task()
        c.task_failed(t["task_id"], t["epoch"])   # failure_max=0: discard
        reg = obs_metrics.default_registry()
        assert reg.get("master_tasks_issued_total").total() == 2
        assert reg.get("master_tasks_finished_total").total() == 1
        assert reg.get("master_tasks_discarded_total").total() == 1
        assert reg.get("master_tasks_todo").value(
            endpoint=m.endpoint) == 2.0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{m.pulse_port}/healthz",
                timeout=10) as r:
            doc = json.loads(r.read())
        key = f"master_queues@{m.endpoint}"
        assert key in doc["checks"]
        detail = doc["checks"][key]["detail"]
        assert detail["role"] == "solo" and detail["issuing"] is True
        assert detail["todo"] == 2 and detail["done"] == 2
        c.close()
    finally:
        m.stop()
        obs_pulse.stop_pulse()
        obs_health.reset()
        obs_metrics.default_registry().reset()
        fluid.set_flag("observe", False)


# ---------------------------------------------------------------------------
# tests/test_data_plane.py's master cases
# ---------------------------------------------------------------------------

def test_master_task_lifecycle(tmp_path):
    m = Master("127.0.0.1:0", timeout_dur=60).start()
    try:
        c = MasterClient(m.endpoint)
        c.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)
        s1, t1 = c.get_task()
        s2, t2 = c.get_task()
        assert s1 == s2 == "ok"
        assert {tuple(t1["payload"]), tuple(t2["payload"])} == {
            ("a", "b"), ("c", "d")}
        s3, _ = c.get_task()
        assert s3 == "none"                     # all leased, none done
        assert c.task_finished(t1["task_id"], t1["epoch"])
        assert c.task_finished(t2["task_id"], t2["epoch"])
        s4, _ = c.get_task()
        assert s4 == "no_more"                  # pass complete
        c.start_new_pass()
        s5, _ = c.get_task()
        assert s5 == "ok"
        c.close()
    finally:
        m.stop()


def test_master_timeout_reissue_and_failure_max():
    m = Master("127.0.0.1:0", timeout_dur=0.3, failure_max=2,
               check_interval=0.05).start()
    try:
        c = MasterClient(m.endpoint)
        c.set_dataset(["only"])
        _, t = c.get_task()
        time.sleep(0.7)                          # let the lease expire
        s, t2 = c.get_task()
        assert s == "ok" and t2["task_id"] == t["task_id"]
        assert t2["epoch"] > t["epoch"]
        # the stale first lease can no longer finish the task
        assert not c.task_finished(t["task_id"], t["epoch"])
        # fail it past failure_max -> discarded (moves to done)
        assert c.task_failed(t2["task_id"], t2["epoch"])
        s, t3 = c.get_task()
        assert s == "ok"
        c.task_failed(t3["task_id"], t3["epoch"])  # num_failure=3 > 2
        s, _ = c.get_task()
        assert s == "no_more"                    # discarded == pass done
        c.close()
    finally:
        m.stop()


def test_master_snapshot_recover(tmp_path):
    snap = str(tmp_path / "master.json")
    m = Master("127.0.0.1:0", snapshot_path=snap, timeout_dur=60).start()
    c = MasterClient(m.endpoint)
    c.set_dataset(list(range(6)), chunks_per_task=2)
    _, t = c.get_task()
    c.task_finished(t["task_id"], t["epoch"])
    _, t2 = c.get_task()                         # leased but never finished
    c.close()
    m.stop()

    m2 = Master("127.0.0.1:0", snapshot_path=snap).start()
    try:
        c2 = MasterClient(m2.endpoint)
        st = c2.stats()
        # 1 done; the dangling lease went back to todo (reference :166)
        assert st["done"] == 1 and st["todo"] == 2 and st["pending"] == 0
        c2.close()
    finally:
        m2.stop()


MASTER_SCRIPT = """
import sys
from paddle_tpu_torch.master import Master
m = Master(sys.argv[1], timeout_dur=2.0, check_interval=0.2)
m.serve_forever()
"""

CONSUMER_SCRIPT = """
import sys, time
from paddle_tpu_torch.master import MasterClient
endpoint, out_path, crash_after = sys.argv[1], sys.argv[2], int(sys.argv[3])
c = MasterClient(endpoint)
done = []
n = 0
while True:
    status, task = c.get_task()
    if status == "no_more":
        break
    if status == "none":
        time.sleep(0.2)
        continue
    n += 1
    if crash_after and n > crash_after:
        time.sleep(60)   # hold the lease and get SIGKILLed by the parent
    time.sleep(0.1)      # "process" the task
    c.task_finished(task["task_id"], task["epoch"])
    done.extend(task["payload"])
with open(out_path, "w") as f:
    f.write(",".join(str(d) for d in done))
"""


def test_master_kill_recovery(tmp_path):
    """Kill a trainer mid-task: its lease expires and the surviving trainer
    completes the pass (the P9 elastic property, reference
    go/master/service.go:341)."""
    port = _free_port()
    endpoint = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    master = subprocess.Popen([sys.executable, "-c", MASTER_SCRIPT,
                               endpoint], env=env)
    victim = survivor = None
    try:
        _wait_port(endpoint)
        c = MasterClient(endpoint)
        c.set_dataset(list(range(8)))
        out_v = str(tmp_path / "victim.txt")
        out_s = str(tmp_path / "survivor.txt")
        victim = subprocess.Popen([sys.executable, "-c", CONSUMER_SCRIPT,
                                   endpoint, out_v, "1"], env=env)
        time.sleep(1.0)  # victim takes a task then hangs on its next one
        victim.send_signal(signal.SIGKILL)
        survivor = subprocess.Popen([sys.executable, "-c", CONSUMER_SCRIPT,
                                     endpoint, out_s, "0"], env=env)
        survivor.wait(timeout=60)
        assert survivor.returncode == 0
        st = c.stats()
        assert st["done"] == 8 and st["todo"] == 0 and st["pending"] == 0
        c.close()
    finally:
        for p in (victim, survivor, master):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGKILL)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _master_script(client_mod, endpoint):
    """One fixed sequence of task calls through `client_mod`'s client;
    every reply."""
    c = client_mod.MasterClient(endpoint, failover_s=0.0)
    out = []
    try:
        out.append(("set", c.set_dataset(list(range(6)), chunks_per_task=2)))
        tasks = [c.get_task() for _ in range(3)]
        out.append(("tasks", tasks))
        out.append(("none", c.get_task()))
        (_, t0), (_, t1), (_, t2) = tasks
        out.append(("finish", c.task_finished(t0["task_id"], t0["epoch"])))
        out.append(("stale", c.task_finished(t0["task_id"], t0["epoch"] + 7)))
        out.append(("fail", c.task_failed(t1["task_id"], t1["epoch"])))
        out.append(("return", c.task_returned(t2["task_id"], t2["epoch"])))
        out.append(("stats", c.stats()))
        st = c.ha_status()
        out.append(("ha", {k: v for k, v in st.items()
                           if k not in ("endpoint", "primary")}))
        with pytest.raises(Exception) as err:
            c.set_dataset(["other"], chunks_per_task=1)
        out.append(("mismatch", type(err.value).__name__,
                    "mismatch" in str(err.value).lower()))
        while True:
            status, t = c.get_task()
            if status != "ok":
                out.append(("drained", status))
                break
            out.append(("again", t, c.task_finished(t["task_id"],
                                                    t["epoch"])))
        c.start_new_pass()
        out.append(("pass2", c.get_task(), c.stats()))
    finally:
        c.close()
    return out


@pytest.mark.parametrize("client_pkg,master_pkg", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_clients_and_masters_interoperate_across_packages(client_pkg,
                                                          master_pkg):
    """Both packages' masters speak the pserver RPC framing with builtins
    only: the port's client against a JAX master, the JAX client against
    the port's, and the port against itself give the JAX-against-JAX
    replies."""
    import paddle_tpu.master as jm
    import paddle_tpu_torch.master as tm
    pkgs = {"jax": jm, "port": tm}

    def run(cpkg, mpkg):
        m = pkgs[mpkg].Master("127.0.0.1:0", timeout_dur=60).start()
        try:
            return _master_script(pkgs[cpkg], m.endpoint)
        finally:
            m.stop()

    ref = run("jax", "jax")
    assert run(client_pkg, master_pkg) == ref
    assert ref[1][1][0] == ("ok", {"task_id": 0, "payload": [0, 1],
                                   "epoch": 1})


def test_both_masters_hand_out_the_same_tasks_and_snapshot_bytes(tmp_path):
    """The same calls into both packages' masters: the same task rows at
    every step, and after each mutation the same snapshot bytes (and the
    same `.prev` serial)."""
    import paddle_tpu.master as jm
    import paddle_tpu_torch.master as tm
    seen = {}
    for name, pkg in (("jax", jm), ("port", tm)):
        snap = str(tmp_path / name / "master.json")
        os.makedirs(os.path.dirname(snap))
        m = pkg.Master("127.0.0.1:0", snapshot_path=snap, timeout_dur=60,
                       failure_max=1)
        stream, files = [], []

        def keep():
            files.append((open(snap, "rb").read(),
                          open(snap + ".prev", "rb").read()
                          if os.path.exists(snap + ".prev") else None))
        m.set_dataset([f"chunk-{i}" for i in range(7)], chunks_per_task=3)
        keep()
        for step in range(6):
            status, t = m.get_task()
            stream.append((status, t))
            keep()
            if status != "ok":
                continue
            if step % 3 == 0:
                stream.append(m.task_finished(t["task_id"], t["epoch"]))
            elif step % 3 == 1:
                stream.append(m.task_failed(t["task_id"], t["epoch"]))
            else:
                stream.append(m.task_returned(t["task_id"], t["epoch"]))
            keep()
        m.start_new_pass()
        keep()
        stream.append(m.get_task())
        keep()
        seen[name] = (stream, files)
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][1] == seen["jax"][1]
    assert len(seen["jax"][1]) > 10


def test_master_fed_transformer_losses_equal_their_replay(tmp_path):
    """chip_smoke.py's phase 7r on the host at a small size: a one-layer
    Transformer stepped by the Executor on batch ids leased through
    `MasterClient.records` from a quorum-fenced primary / standby pair,
    the primary killed once 3 tasks are done there. The standby takes
    over within the drill's budget, the trainer sees no failure, every id
    is delivered and a single-issue task once, no two masters issue at
    one sample, and the losses are the same bits as the replay of the
    delivered ids through a fresh Executor from the same state."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from paddle_tpu_torch.ops import native
    r = chip_smoke.run_train_base_elastic(
        torch, fluid, native, str(tmp_path), place=fluid.CPUPlace(),
        build_kw=dict(src_vocab_size=64, trg_vocab_size=64, seq_len=16,
                      n_layer=1, n_head=2, d_model=32, d_inner=64),
        batch=2, n_batches=8, kill_after=3)
    assert r["done_at_kill"] >= 3 and r["steps"] >= 8
    assert sorted(set(r["ids"])) == list(range(8))
    assert r["losses"] == r["replay_losses"] and r["bit_equal"]
    assert r["promote_s"] <= r["budget_s"]
    assert r["master_status"]["role"] == "primary"
    assert r["promotions"] >= 1 and r["samples"] > 0
    assert not any(r["launches"].values())      # the host: no kernel
