"""fluid-haven in the port: the replicated, self-healing
parameter-server plane (``paddle_tpu_torch/haven``, ``pserver``, ``ark``)
on the CPU.

Every case of ``tests/test_haven.py`` runs here against the port's
copies, with the same assertions (the replication contract of
docs/FAULT_TOLERANCE.md §Replicated PS plane: bit-identical backup at
every acked seq, failover loss <= the in-flight window, lease-expiry
promotion fenced by epoch, exactly-once replay at a promoted backup,
zero failed pushes across a planned handover, checkpoint x replication
consistency, the ps_replication_* metrics), and the cross-package check:
the port's replicated pair is bit-identical to its unreplicated baseline
AND to the JAX package's pair fed the same records (dense, sparse,
optimizer slots, watermarks). Its fleet case,
``test_fleet_sparse_row_pulls_survive_primary_kill``, runs in
``tests/test_torch_fleet.py`` beside the rest of ``fleet/``.

Every wait is on a condition with a generous timeout (`_wait`), never a
bare sleep race against a lease; servers bind ``127.0.0.1:0``.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ark
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.ark import chaos as ark_chaos
from paddle_tpu_torch.haven import UpdateLog
from paddle_tpu_torch.pserver import ParameterServer, PSClient


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


@pytest.fixture
def observe_on():
    from paddle_tpu_torch.observe import metrics as obs_metrics
    fluid.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    yield obs_metrics.default_registry()
    fluid.set_flag("observe", False)


def _pair(lease_s=0.6, window=512, trainers=1, stall_timeout_s=5.0,
          auto_promote=True, pkg=None):
    PS = ParameterServer if pkg is None else pkg.ParameterServer
    backup = PS("127.0.0.1:0", trainers=trainers).start()
    backup.start_standby(lease_s=lease_s, auto_promote=auto_promote)
    primary = PS("127.0.0.1:0", trainers=trainers).start()
    primary.start_replication(backup.endpoint, lease_s=lease_s,
                              window=window,
                              stall_timeout_s=stall_timeout_s)
    return primary, backup


def _client(primary, backup, **kw):
    kw.setdefault("dedup_pushes", True)
    kw.setdefault("failover_s", 15.0)
    return PSClient([primary.endpoint],
                    replicas={primary.endpoint: [backup.endpoint]}, **kw)


def _wait(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _feed_pair_records(pkg, primary, backup):
    """tests/test_haven.py's record stream (adagrad dense, sgd sparse)
    through one package's client into its pair."""
    rng = np.random.RandomState(7)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(12)]
    rows = [(np.array([1, 3, 5]), rng.randn(3, 4).astype(np.float32))
            for _ in range(6)]
    c = pkg.PSClient([primary.endpoint], dedup_pushes=True)
    ep = primary.endpoint
    c.init_param(ep, "w", np.zeros((3, 4), np.float32), "adagrad", 0.1,
                 {"epsilon": 1e-6})
    c.init_table("tbl", rows=8, width=4, dtype="float32", init_low=-0.5,
                 init_high=0.5, seed=3, opt_type="sgd", lr=0.5, attrs={})
    for g in grads:
        c.push_grad(ep, "w", g)
    for ids, rg in rows:
        c.push_sparse_grad("tbl", ids, rg)
    c.close()
    _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")


# -- update log -----------------------------------------------------------

def test_update_log_watermark_window_and_degradation():
    log = UpdateLog(window=4, stall_timeout_s=0.3)
    log.rebase()   # fresh pair synced at seq 0
    for i in range(4):
        assert log.append("push_grad", {"i": i}) == i + 1
    assert log.lag() == 4
    batch = log.batch()
    assert [s for s, _c, _p, _tr in batch] == [1, 2, 3, 4]
    log.ack(2)
    assert log.lag() == 2
    assert [s for s, _c, _p, _tr in log.batch()] == [3, 4]
    # retransmit: batch() keeps returning unacked records
    assert [s for s, _c, _p, _tr in log.batch()] == [3, 4]
    # window full + more appends: blocked appenders release on ack
    log.append("push_grad", {})
    log.append("push_grad", {})   # lag back to 4 == window
    done = []

    def blocked_append():
        done.append(log.append("push_grad", {}))
    t = threading.Thread(target=blocked_append, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done, "append must block while the window is full"
    log.ack(5)
    t.join(timeout=2.0)
    assert done == [7]
    # stall: window refills and nobody acks -> degrade, not deadlock
    log.append("push_grad", {})
    log.append("push_grad", {})   # lag == 4 == window again
    t0 = time.monotonic()
    assert log.append("push_grad", {}) is None   # degraded after timeout
    assert 0.2 <= time.monotonic() - t0 < 20.0
    assert log.degraded and log.needs_resync
    assert log.append("more", {}) is None        # recording suspended
    # resync at a cut resumes recording; rebase clears the flag
    log.resume(log.head_seq)
    assert log.append("back", {}) is not None
    assert log.needs_resync
    log.rebase()
    assert not log.needs_resync and log.lag() == 0


def test_update_log_lag_is_nonzero_while_resync_pending():
    """Regression pin for a load-sensitive flake (the broken-barrier
    test failed ~1-in-10 on a busy box): `resume()` advances the acked
    watermark at the snapshot CUT, before the `haven_sync` snapshot
    lands — `lag()` must NOT report 0 in that window, or every
    "backup is current" probe (tests' ack-drain waits, the handover
    drain, the lag gauges) races the in-flight install. The floor
    lifts only at `rebase()` (snapshot confirmed); a DEGRADED log
    still reports 0 (solo availability mode is idle, not backlog)."""
    log = UpdateLog(window=8, stall_timeout_s=0.2)
    assert log.needs_resync and log.lag() == 1   # fresh pair: not caught up
    log.append("init_param", {})
    log.append("push_grads_sync", {})
    log.resume(log.head_seq)          # the quiesced cut: acked == head...
    assert log.acked_seq == log.head_seq
    assert log.lag() >= 1             # ...but the snapshot is in flight
    log.rebase(log.head_seq)          # install acknowledged
    assert log.lag() == 0
    log.degrade()                     # degraded: deliberately solo
    assert log.lag() == 0


# -- replication ----------------------------------------------------------

def test_replicated_pair_is_bit_identical_to_unreplicated_baseline():
    """The core contract, both directions: (a) replication is PASSIVE —
    a replicated primary's state is bit-identical to an unreplicated
    server fed the same updates; (b) the backup is bit-identical to the
    primary at the acked watermark (dense, sparse, optimizer slots, and
    the sync watermarks that make failover replays exactly-once)."""
    rng = np.random.RandomState(7)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(12)]
    rows = [(np.array([1, 3, 5]), rng.randn(3, 4).astype(np.float32))
            for _ in range(6)]

    def run(server_factory):
        srv, extra = server_factory()
        ep = srv.endpoint
        c = PSClient([ep], dedup_pushes=True)
        c.init_param(ep, "w", np.zeros((3, 4), np.float32), "adagrad",
                     0.1, {"epsilon": 1e-6})
        c.init_table("tbl", rows=8, width=4, dtype="float32",
                     init_low=-0.5, init_high=0.5, seed=3,
                     opt_type="sgd", lr=0.5, attrs={})
        for g in grads:
            c.push_grad(ep, "w", g)
        for ids, rg in rows:
            c.push_sparse_grad("tbl", ids, rg)
        c.close()
        return srv, extra

    solo, _ = run(lambda: (ParameterServer("127.0.0.1:0").start(), None))
    primary, backup = run(lambda: _pair())
    try:
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        # (a) replication never perturbs the primary
        np.testing.assert_array_equal(primary._dense["w"],
                                      solo._dense["w"])
        np.testing.assert_array_equal(primary._sparse["tbl"].value,
                                      solo._sparse["tbl"].value)
        # (b) the backup IS the primary at the watermark
        np.testing.assert_array_equal(backup._dense["w"],
                                      primary._dense["w"])
        np.testing.assert_array_equal(backup._sparse["tbl"].value,
                                      primary._sparse["tbl"].value)
        for k, v in primary._optim["w"]._acc.items():
            np.testing.assert_array_equal(backup._optim["w"]._acc[k], v)
        assert backup._async_applied == primary._async_applied
    finally:
        solo.stop()
        primary.stop()
        backup.stop()


def test_failover_loss_bounded_by_inflight_window():
    """The loss bound, pinned: freeze the forwarder with exactly K
    unacknowledged updates in the log, kill the primary, promote the
    backup — its state equals the no-fault run truncated at the ACKED
    watermark: everything acknowledged by the backup survives, and what
    is lost is exactly the K in-flight records, K <= window."""
    WINDOW = 8
    rng = np.random.RandomState(11)
    grads = [rng.randn(4).astype(np.float32) for _ in range(20)]

    # no-fault reference: prefix states of an unreplicated server
    solo = ParameterServer("127.0.0.1:0").start()
    sc = PSClient([solo.endpoint])
    sc.init_param(solo.endpoint, "w", np.zeros(4, np.float32), "sgd",
                  0.1, {})
    prefix_states = [solo._dense["w"].copy()]
    for g in grads:
        sc.push_grad(solo.endpoint, "w", g)
        prefix_states.append(solo._dense["w"].copy())
    sc.close()
    solo.stop()

    # a 2 s lease (tests/test_haven.py takes 0.6): the backup must not
    # promote while the first pushes drain, however loaded the host
    primary, backup = _pair(lease_s=2.0, window=WINDOW,
                            stall_timeout_s=30.0)
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 0.1, {})
        for g in grads[:12]:
            c.push_grad(ep, "w", g)
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        # freeze the forwarder (a backup that stopped acking): the next
        # pushes are applied on the primary but stay in-flight
        primary._haven._replicator.stop()
        for g in grads[12:12 + WINDOW - 1]:
            c.push_grad(ep, "w", g)
        inflight = primary._haven.log.lag()
        acked = primary._haven.log.acked_seq
        assert 0 < inflight <= WINDOW
        ark_chaos.kill_server(primary)
        _wait(lambda: backup._haven.role == "primary", timeout=15.0,
              what="lease-expiry promotion")
        # acked seq 1 was init_param; acked - 1 pushes survived
        np.testing.assert_array_equal(backup._dense["w"],
                                      prefix_states[acked - 1])
        assert backup._haven.applied_seq == acked
        lost = (12 + WINDOW - 1) - (acked - 1)
        assert lost == inflight <= WINDOW
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_write_failover_replays_unacked_push_exactly_once(observe_on):
    """A primary SIGKILL mid-push: the client waits out the backup's
    lease-expiry promotion, re-resolves the shard's primary, and
    replays — and a push the dead primary HAD already applied and
    replicated is acknowledged as a duplicate by the promoted backup's
    replicated watermark, never double-applied."""
    primary, backup = _pair(lease_s=0.5)
    c = _client(primary, backup)
    ep = primary.endpoint
    try:
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.full(3, 0.5, np.float32))
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        applied_seq = c._push_seq   # the push the backup already holds

        ark_chaos.kill_server(primary)
        t0 = time.monotonic()
        c.push_grad(ep, "w", np.full(3, 0.5, np.float32))  # fails over
        took = time.monotonic() - t0
        assert backup._haven.role == "primary"
        np.testing.assert_allclose(backup._dense["w"],
                                   np.full(3, -1.0, np.float32))
        assert took < 15.0
        # replay the ALREADY-APPLIED push's exact tag at the promoted
        # backup: the replicated async watermark dedups it
        (status, value), _tx, _rx = c._call_one(
            backup.endpoint, "push_grad",
            {"name": "w", "grad": np.full(3, 0.5, np.float32),
             "seq": applied_seq, "trainer_id": c.trainer_id,
             "session": c._session}, 5.0, False, None)
        assert status == "ok" and "duplicate" in str(value)
        np.testing.assert_allclose(backup._dense["w"],
                                   np.full(3, -1.0, np.float32))
        # reads follow the new primary too
        np.testing.assert_allclose(c.get_param(ep, "w"),
                                   np.full(3, -1.0, np.float32))
        assert observe_on.get("ps_promotions_total").total() == 1
        from paddle_tpu_torch.observe import flight
        promos = flight.get_flight().events("haven_promotion")
        assert promos and promos[-1]["endpoint"] == backup.endpoint
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_standby_redirects_writes_and_serves_bounded_stale_reads():
    primary, backup = _pair()
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.arange(3, dtype=np.float32), "sgd",
                     1.0, {})
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        # reads on the standby: allowed (this is what keeps fleet's
        # serve-time sparse pulls alive through a primary kill)
        raw = PSClient([backup.endpoint])
        np.testing.assert_array_equal(
            raw.get_param(backup.endpoint, "w"),
            np.arange(3, dtype=np.float32))
        # a write addressed AT the standby redirects to the primary and
        # the client follows without surfacing an error
        c2 = PSClient([backup.endpoint],
                      replicas={backup.endpoint: [primary.endpoint]},
                      dedup_pushes=True)
        c2.push_grad(backup.endpoint, "w", np.ones(3, np.float32))
        np.testing.assert_array_equal(primary._dense["w"],
                                      np.arange(3, dtype=np.float32) - 1)
        raw.close()
        c2.close()
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_sync_ps_failover_is_not_trainer_visible():
    """Sync-PS across a primary kill: the trainer's push+barrier loop
    retries internally under the SAME batch id — the promoted backup's
    replicated (trainer, batch, session) watermark dedups, the barrier
    fires on the survivor, and step() never raises."""
    primary, backup = _pair(lease_s=0.5, trainers=1)
    ep = primary.endpoint
    c = _client(primary, backup)
    try:
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        for b in range(3):
            c.push_grads_sync({ep: {"w": np.full(3, 1.0, np.float32)}},
                              batch_id=b, trainer_id=0, session="s")
            c.sync_apply([ep], trainer_id=0)
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        np.testing.assert_allclose(backup._dense["w"], -3.0)

        ark_chaos.kill_server(primary)
        # batch 3 lands entirely on the promoted backup via failover
        c.push_grads_sync({ep: {"w": np.full(3, 1.0, np.float32)}},
                          batch_id=3, trainer_id=0, session="s")
        c.sync_apply([ep], trainer_id=0)
        assert backup._haven.role == "primary"
        np.testing.assert_allclose(backup._dense["w"], -4.0)
        # the replicated sync watermark made batch 0-2 un-replayable:
        # re-pushing an old batch is acknowledged, not re-accumulated
        c.push_grads_sync({ep: {"w": np.full(3, 1.0, np.float32)}},
                          batch_id=2, trainer_id=0, session="s")
        c.sync_apply([ep], trainer_id=0)
        np.testing.assert_allclose(backup._dense["w"], -4.0)
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_broken_barrier_discard_replicates_to_backup():
    """A broken sync barrier discards the primary's incomplete pending
    batch — the discard must REPLICATE (a __sync_reset__ record), or
    the backup's stale pending would dedup the retried batch's pushes
    and the two copies would diverge on the next apply."""
    backup = ParameterServer("127.0.0.1:0", trainers=2).start()
    backup.start_standby(lease_s=0.6)
    primary = ParameterServer("127.0.0.1:0", trainers=2,
                              sync_timeout=0.8).start()
    primary.start_replication(backup.endpoint, lease_s=0.6)
    c = _client(primary, backup)
    ep = primary.endpoint
    try:
        c.init_param(ep, "w", np.zeros(8, np.float32), "sgd", 1.0, {})
        g = np.arange(8, dtype=np.float32)
        # trainer 1 pushes batch 0; trainer 0 never arrives -> broken
        c.push_grads_sync({ep: {"w": g}}, batch_id=0, trainer_id=1,
                          session="t1")
        _wait(lambda: primary._haven.log.lag() == 0, what="push drain")
        assert backup._sync_pending_from == {(1, 0)}
        with pytest.raises(RuntimeError, match="barrier broken"):
            c.sync_apply([ep], trainer_id=1)
        _wait(lambda: primary._haven.log.lag() == 0, what="reset drain")
        assert backup._pending == {} and \
            backup._sync_pending_from == set()
        # the retried batch: BOTH trainers this time, applied once
        errs = []

        def one(tid):
            try:
                c2 = _client(primary, backup)
                c2.push_grads_sync({ep: {"w": g * (tid + 1)}},
                                   batch_id=0, trainer_id=tid,
                                   session=f"t{tid}")
                c2.sync_apply([ep], trainer_id=tid)
                c2.close()
            except Exception as e:          # noqa: BLE001
                errs.append(repr(e))
        ts = [threading.Thread(target=one, args=(i,), daemon=True)
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not errs, errs
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        # applied exactly once, averaged over BOTH contributors, and
        # the backup is bit-identical (not poisoned by the broken
        # batch's stale pending)
        np.testing.assert_allclose(primary._dense["w"],
                                   -(g + g * 2) / 2.0)
        np.testing.assert_array_equal(backup._dense["w"],
                                      primary._dense["w"])
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_sync_bit_identity_with_concurrent_trainers():
    """Three trainers race their sync pushes: the log must record in
    ACCUMULATION order (the record is appended under the pending lock),
    or the backup's pending sum would fold in a different order and
    float non-associativity would break the sync path's bit-identity
    claim."""
    primary, backup = _pair(trainers=3)
    cs = [_client(primary, backup) for _ in range(3)]
    ep = primary.endpoint
    try:
        cs[0].init_param(ep, "w", np.zeros(128, np.float32), "sgd",
                         0.1, {})
        rng = np.random.RandomState(2)
        grads = [rng.randn(128).astype(np.float32) for _ in range(3)]
        for b in range(5):
            errs = []

            def one(i, b=b):
                try:
                    cs[i].push_grads_sync(
                        {ep: {"w": grads[i] * (1.0 + 0.1 * b)}},
                        batch_id=b, trainer_id=i, session=f"s{i}")
                    cs[i].sync_apply([ep], trainer_id=i)
                except Exception as e:      # noqa: BLE001
                    errs.append(repr(e))
            ts = [threading.Thread(target=one, args=(i,), daemon=True)
                  for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            assert not errs, errs
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        np.testing.assert_array_equal(backup._dense["w"],
                                      primary._dense["w"])
    finally:
        for c in cs:
            c.close()
        primary.stop()
        backup.stop()


# -- checkpoint x replication ---------------------------------------------

def test_checkpoint_during_replication_is_watermark_tagged_consistent(
        tmp_path):
    """`save` on a replicating primary commits a consistent cut: the
    sidecar manifest carries haven_seq/haven_epoch, and the shard bytes
    correspond EXACTLY to that seq (pinned by replaying the same update
    stream into an unreplicated server and comparing)."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(4).astype(np.float32) for _ in range(6)]
    primary, backup = _pair()
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 0.1, {})
        for g in grads:
            c.push_grad(ep, "w", g)
        d = str(tmp_path / "shards")
        c.save(d)
        side = primary._shard_path(d) + ark.checkpoint.SIDECAR_SUFFIX
        with open(side) as f:
            meta = json.load(f)
        assert meta["haven_role"] == "primary"
        assert meta["haven_epoch"] == 0
        assert meta["haven_seq"] == primary._haven.log.head_seq == 7
        # the checkpointed bytes equal the state at that exact seq
        solo = ParameterServer("127.0.0.1:0").start()
        try:
            sc = PSClient([solo.endpoint])
            sc.init_param(solo.endpoint, "w", np.zeros(4, np.float32),
                          "sgd", 0.1, {})
            for g in grads:
                sc.push_grad(solo.endpoint, "w", g)
            with np.load(primary._shard_path(d),
                         allow_pickle=False) as z:
                np.testing.assert_array_equal(z["d::w"],
                                              solo._dense["w"])
            sc.close()
        finally:
            solo.stop()
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_recovery_onto_promoted_former_backup_resumes_bit_identically(
        tmp_path):
    """Checkpoint on the primary; kill it; the promoted former-backup
    restores the PRIMARY's shard file (shard_endpoint=) and replays the
    post-checkpoint batches — final state is bit-identical to an
    unreplicated server doing the same restore + replay."""
    rng = np.random.RandomState(5)
    pre = [rng.randn(2, 3).astype(np.float32) for _ in range(4)]
    post = [rng.randn(2, 3).astype(np.float32) for _ in range(5)]
    d = str(tmp_path / "ck")

    primary, backup = _pair(lease_s=0.5)
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros((2, 3), np.float32), "adagrad",
                     0.1, {"epsilon": 1e-6})
        for g in pre:
            c.push_grad(ep, "w", g)
        c.save(d)
        primary_ep = primary.endpoint
        ark_chaos.kill_server(primary)
        _wait(lambda: backup._haven.role == "primary", timeout=15.0,
              what="promotion")
        # restore the dead primary's shard ONTO the promoted backup,
        # then resume: replay the post-checkpoint stream
        c._call(backup.endpoint, "restore", dirname=d,
                shard_endpoint=primary_ep)
        for g in post:
            c.push_grad(ep, "w", g)
        got = np.array(c.get_param(ep, "w"))
    finally:
        c.close()
        primary.stop()
        backup.stop()

    solo = ParameterServer("127.0.0.1:0").start()
    try:
        sc = PSClient([solo.endpoint])
        sc.init_param(solo.endpoint, "w", np.zeros((2, 3), np.float32),
                      "adagrad", 0.1, {"epsilon": 1e-6})
        for g in pre:
            sc.push_grad(solo.endpoint, "w", g)
        solo.recover(d, shard_endpoint=primary_ep)
        for g in post:
            sc.push_grad(solo.endpoint, "w", g)
        np.testing.assert_array_equal(got, solo._dense["w"])
        sc.close()
    finally:
        solo.stop()


# -- handover -------------------------------------------------------------

def test_handover_zero_failed_pushes_and_exact_continuity():
    primary, backup = _pair()
    c = _client(primary, backup)
    ep = primary.endpoint
    fresh = ParameterServer("127.0.0.1:0").start()
    fresh.start_standby(lease_s=0.6, auto_promote=False)
    stop, failures, pushed = threading.Event(), [], [0]

    def pusher():
        while not stop.is_set():
            try:
                c.push_grad(ep, "w", np.full(4, 0.01, np.float32))
                pushed[0] += 1
            except Exception as e:       # noqa: BLE001
                failures.append(repr(e))
            time.sleep(0.002)

    try:
        c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 1.0, {})
        t = threading.Thread(target=pusher, daemon=True)
        t.start()
        time.sleep(0.2)
        res = primary.handover(fresh.endpoint)
        time.sleep(0.3)
        stop.set()
        t.join(timeout=10.0)
        assert not failures, failures
        assert fresh._haven.role == "primary"
        assert fresh._haven.epoch == res["epoch"] == 1
        assert primary._haven.role == "retired"
        # exact continuity: every push applied exactly once, across the
        # old primary, the flip, and the successor
        np.testing.assert_allclose(fresh._dense["w"],
                                   np.full(4, -0.01 * pushed[0]), rtol=0,
                                   atol=1e-4)
        # the successor replicates to the surviving backup
        _wait(lambda: fresh._haven.log.lag() == 0
              and backup._haven.applied_seq > 0, what="successor resync")
        np.testing.assert_array_equal(backup._dense["w"],
                                      fresh._dense["w"])
        assert backup._haven.primary_ep == fresh.endpoint
        # old primary redirects even reads; client follows to successor
        np.testing.assert_array_equal(c.get_param(ep, "w"),
                                      fresh._dense["w"])
    finally:
        stop.set()
        c.close()
        for s in (primary, backup, fresh):
            s.stop()


# -- observability --------------------------------------------------------

def test_torn_handover_leaves_exactly_one_leaseholder(observe_on):
    """Kill the handover at both cut points: before the promote the OLD
    pair stays authoritative (the fresh target never self-promotes);
    after it the SUCCESSOR is authoritative (higher epoch). At every
    observable point exactly one server accepts writes, and no
    acknowledged update is lost."""
    # -- cut BEFORE the promote ------------------------------------------
    primary, backup = _pair()
    c = _client(primary, backup)
    ep = primary.endpoint
    fresh = ParameterServer("127.0.0.1:0").start()
    fresh.start_standby(lease_s=0.6, auto_promote=False)
    try:
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.ones(3, np.float32))
        primary._haven._handover_fault = "pre_promote"
        with pytest.raises(RuntimeError, match="pre_promote"):
            primary.handover(fresh.endpoint)
        primary._haven._handover_fault = None
        roles = [s._haven.role for s in (primary, backup, fresh)]
        assert roles.count("primary") == 1 and roles[0] == "primary"
        c.push_grad(ep, "w", np.ones(3, np.float32))   # still serving
        np.testing.assert_allclose(primary._dense["w"], -2.0)
        time.sleep(1.5)   # fresh must NOT lease-expire its way to power
        assert fresh._haven.role == "backup"
    finally:
        c.close()
        for s in (primary, backup, fresh):
            s.stop()

    # -- cut AFTER the promote -------------------------------------------
    primary, backup = _pair()
    c = _client(primary, backup)
    ep = primary.endpoint
    fresh = ParameterServer("127.0.0.1:0").start()
    fresh.start_standby(lease_s=0.6, auto_promote=False)
    try:
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.ones(3, np.float32))
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        primary._haven._handover_fault = "post_promote"
        with pytest.raises(RuntimeError, match="post_promote"):
            primary.handover(fresh.endpoint)
        # the flip itself committed before the crash point: successor
        # rules, old primary already retired (flip follows the promote
        # ack with no intervening statement)
        roles = {s.endpoint: s._haven.role
                 for s in (primary, backup, fresh)}
        assert list(roles.values()).count("primary") == 1
        assert fresh._haven.role == "primary"
        assert primary._haven.role == "retired"
        # no acknowledged update lost: the successor holds the push
        np.testing.assert_allclose(fresh._dense["w"], -1.0)
        # and writes keep flowing (client follows the redirect)
        c.push_grad(ep, "w", np.ones(3, np.float32))
        np.testing.assert_allclose(fresh._dense["w"], -2.0)
    finally:
        c.close()
        for s in (primary, backup, fresh):
            s.stop()


def test_replication_lag_metrics_and_stall_detector(observe_on):
    from paddle_tpu_torch.observe.health import (HealthEngine,
                                           ReplicationStallDetector)

    primary, backup = _pair()
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.ones(3, np.float32))
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        _wait(lambda: observe_on.get("ps_replication_lag_updates")
              is not None, what="lag gauge")
        assert observe_on.get("ps_replication_lag_updates").value() == 0.0
        assert observe_on.get("ps_replication_lag_us") is not None
    finally:
        c.close()
        primary.stop()
        backup.stop()

    # detector semantics on a synthetic engine: monotone lag growth
    # WHILE pushes land fires; idle lag or a dipping watermark clears
    eng = HealthEngine()
    det = ReplicationStallDetector(window_s=30.0, min_points=4)
    eng.add_detector(det)
    now = time.time()
    for i, lag in enumerate([2, 4, 6, 9]):
        eng.series("ps_replication_lag").append(lag, ts=now - 8 + 2 * i)
        eng.series("ps_push_serves").append(1.0, ts=now - 8 + 2 * i)
    eng.evaluate(now)
    assert eng.active_alert("ps_replication_stall") is not None
    # the watermark catches up: lag dips -> self-clears
    eng.series("ps_replication_lag").append(1.0, ts=now + 1)
    eng.evaluate(now + 1)
    assert eng.active_alert("ps_replication_stall") is None
    # growth with NO pushes (idle primary, e.g. paused trainer): no fire
    eng2 = HealthEngine()
    eng2.add_detector(ReplicationStallDetector(window_s=30.0,
                                               min_points=4))
    for i, lag in enumerate([2, 4, 6, 9]):
        eng2.series("ps_replication_lag").append(lag, ts=now - 8 + 2 * i)
    eng2.evaluate(now)
    assert eng2.active_alert("ps_replication_stall") is None


def test_higher_epoch_sync_demotes_and_demoted_node_can_reelect():
    """Fencing is symmetric across both replication paths: a
    higher-epoch primary's SNAPSHOT demotes a node that still thinks it
    rules (install_snapshot mirrors replay's rule — and sync is the
    path a fresh successor always runs first), and the demoted node
    re-arms its promotion monitor, so it can still take over when its
    NEW primary later dies."""
    primary, backup = _pair(lease_s=0.5)
    c = PSClient([primary.endpoint])
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(3, np.float32), "sgd", 1.0, {})
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        # isolate the pair (stop forwarding): the backup's lease-expiry
        # promotion fires while the old primary stays up
        primary._haven._replicator.stop()
        _wait(lambda: backup._haven.role == "primary", timeout=15.0,
              what="promotion")
        assert backup._haven.epoch == 1
        # the NEW primary adopts the old one as ITS backup: the full
        # sync arrives at epoch 1 > 0 against a node with role=primary
        backup.start_replication(primary.endpoint, lease_s=0.5)
        _wait(lambda: primary._haven.role == "backup", timeout=10.0,
              what="higher-epoch sync demotion")
        assert primary._haven.epoch == 1
        _wait(lambda: backup._haven.log.lag() == 0, what="resync drain")
        # the demoted node's monitor is live again: kill the new
        # primary and the old one re-elects itself at epoch 2
        ark_chaos.kill_server(backup)
        _wait(lambda: primary._haven.role == "primary", timeout=15.0,
              what="re-election after demotion")
        assert primary._haven.epoch == 2
    finally:
        c.close()
        primary.stop()
        backup.stop()


def test_restore_on_primary_forces_full_resync(tmp_path):
    """An out-of-band restore invalidates the log's ability to bring
    the backup current: the pair must full-resync, after which the
    backup again mirrors the (restored) primary exactly."""
    primary, backup = _pair()
    c = _client(primary, backup)
    try:
        ep = primary.endpoint
        c.init_param(ep, "w", np.zeros(4, np.float32), "sgd", 1.0, {})
        c.push_grad(ep, "w", np.ones(4, np.float32))
        d = str(tmp_path / "shard")
        c.save(d)
        c.push_grad(ep, "w", np.ones(4, np.float32))
        _wait(lambda: primary._haven.log.lag() == 0, what="ack drain")
        np.testing.assert_allclose(backup._dense["w"], -2.0)
        c._call(ep, "restore", dirname=d)   # back to the -1.0 state
        np.testing.assert_allclose(primary._dense["w"], -1.0)
        _wait(lambda: not primary._haven.log.needs_resync
              and np.allclose(backup._dense["w"], -1.0),
              what="post-restore resync")
    finally:
        c.close()
        primary.stop()
        backup.stop()


# -- across the packages -------------------------------------------------

def test_replicated_pair_is_bit_identical_to_the_jax_packages_pair():
    """The same records into the port's pair and the JAX package's pair:
    primaries and backups bit-identical across the packages (dense,
    sparse, optimizer slots, the async watermark's applied count), and
    the same replication seq on both sides."""
    from paddle_tpu import pserver as jps
    from paddle_tpu_torch import pserver as tps

    pairs = {name: _pair(pkg=pkg) for name, pkg in
             (("jax", jps), ("port", tps))}
    try:
        for name, pkg in (("jax", jps), ("port", tps)):
            _feed_pair_records(pkg, *pairs[name])
        (jp, jb), (tp, tb) = pairs["jax"], pairs["port"]
        for a, b in ((jp, tp), (jb, tb), (tp, tb)):
            assert a._dense["w"].tobytes() == b._dense["w"].tobytes()
            assert a._sparse["tbl"].value.tobytes() == \
                b._sparse["tbl"].value.tobytes()
            assert sorted(a._optim["w"]._acc) == sorted(b._optim["w"]._acc)
            for k, v in a._optim["w"]._acc.items():
                assert v.tobytes() == b._optim["w"]._acc[k].tobytes()
            assert len(a._async_applied) == len(b._async_applied)
        assert jp._haven.log.head_seq == tp._haven.log.head_seq
        assert jb._haven.applied_seq == tb._haven.applied_seq
    finally:
        for pair in pairs.values():
            for s in pair:
                s.stop()
