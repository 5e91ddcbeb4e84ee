"""Elastic data-sharding master (P9), HA since fluid-elastic.

Mirror of ``paddle_tpu/master/service.py``, copied. Every payload on its
wire is builtins (task rows, ids, epochs): a trainer names its data by
id and makes the batch on its own side.

Capability parity with the reference Go master (reference:
go/master/service.go — partition :106, SetDataset :280, GetTask :368,
TaskFinished :411, TaskFailed :455, timeout re-queue via checkTimeoutFunc
:341, processFailedTask :313 with failureMax, etcd snapshot :207 /
recover :166 — and the etcd-leased election the Go master rides for HA).

Redesign: etcd is replaced by the fluid-quorum arbiter group
(election + fencing) plus an on-disk snapshot in the ark atomic idiom,
and the Go RPC by the same length-prefixed-pickle transport as the
parameter server (pserver/rpc.py). Task semantics are identical: a task
is a lease with a per-issue epoch counter — a trainer that dies mid-task
lets the lease time out and the task is re-issued; a task failing more
than `failure_max` times is discarded with a log line (reference
:323-331).

fluid-elastic HA (the haven idiom simplified — the state is small and
every record is idempotent):

- a PRIMARY (`start_replication`) forwards each task-lifecycle record
  (the moved task's full post-mutation row + which queue it landed in)
  to its STANDBY; the forwarder's batches double as the primary's lease
  renewal, and a full snapshot bootstraps or resyncs a standby that
  fell behind the bounded record log;
- the standby promotes ONLY behind a fencing epoch: with a
  `quorum/` arbiter group armed, on a strict-majority grant
  (a partitioned pair is an election the minority LOSES); without one,
  on primary-lease expiry under the documented crash-stop model;
- exactly-once task accounting across failover: a promoted standby
  KEEPS the replicated pending leases (task-id/epoch pairs intact) and
  restarts their lease clocks, so a surviving trainer's
  `task_finished(task_id, epoch)` still matches and is accepted exactly
  once. Only a task whose holder ALSO died expires and re-issues —
  the failure-budget path, the one documented duplicate-delivery
  source. A deposed primary answers task commands with a redirect
  (its fencing epoch is stale), never a state mutation;
- with no standby and no arbiters configured, the master is the
  legacy solo process, bit for bit.

Snapshots adopt the ark atomic idiom: tmp + `os.replace` + fsync with
an EMBEDDED sha256, and the previous serial is retained at
`<snapshot_path>.prev` — a torn or bit-rotted current snapshot falls
back to the previous serial instead of crashing recovery with a
JSONDecodeError (and with both serials gone, recovery starts empty
with a loud log line, never an exception).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

from .. import flags as _flags
from ..ark import checkpoint as ark_ckpt
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from ..pserver import rpc

logger = logging.getLogger(__name__)

#: commands that issue or settle task leases — only the RULING master
#: (solo, or an unfenced primary) may serve them; a standby or a
#: fenced/deposed primary answers with a redirect naming the ruler it
#: knows of, so a stale client re-resolves instead of mutating dead state
TASK_CMDS = frozenset({"get_task", "task_finished", "task_failed",
                       "task_returned", "set_dataset", "start_new_pass"})

ISSUED_METRIC = "master_tasks_issued_total"
FINISHED_METRIC = "master_tasks_finished_total"
FAILED_METRIC = "master_tasks_failed_total"
REISSUED_METRIC = "master_tasks_reissued_total"
DISCARDED_METRIC = "master_tasks_discarded_total"
RETURNED_METRIC = "master_tasks_returned_total"
PROMOTIONS_METRIC = "master_promotions_total"
STEP_DOWNS_METRIC = "master_step_downs_total"


class DatasetMismatchError(ValueError):
    """`set_dataset` was called with a dataset that differs from the one
    the master's (possibly recovered) state was partitioned from."""


class _Task:
    __slots__ = ("task_id", "payload", "epoch", "num_failure", "deadline")

    def __init__(self, task_id, payload, epoch=0, num_failure=0):
        self.task_id = task_id
        self.payload = payload
        self.epoch = epoch          # bumped on every (re-)issue; stale
        self.num_failure = num_failure
        self.deadline = 0.0         # lease expiry while pending

    def to_dict(self):
        return {"task_id": self.task_id, "payload": self.payload,
                "epoch": self.epoch, "num_failure": self.num_failure}

    @classmethod
    def from_dict(cls, d):
        return cls(d["task_id"], d["payload"], d["epoch"], d["num_failure"])


class Master:
    """Task-queue service. `timeout_dur` is the lease duration
    (reference timeoutDur); `failure_max` the per-task failure budget.
    `pulse_port` (with the observe flag on) starts the process's
    fluid-pulse health endpoint and registers a queue-state check."""

    def __init__(self, endpoint: str, snapshot_path: Optional[str] = None,
                 timeout_dur: float = 20.0, failure_max: int = 3,
                 check_interval: float = 1.0,
                 pulse_port: Optional[int] = None):
        self.endpoint = endpoint
        self.snapshot_path = snapshot_path
        self.timeout_dur = timeout_dur
        self.failure_max = failure_max
        self.check_interval = check_interval
        self._todo: List[_Task] = []          # guarded_by: self._lock
        self._pending: Dict[int, _Task] = {}  # guarded_by: self._lock
        self._done: List[_Task] = []          # guarded_by: self._lock
        self._dataset_fp: Optional[Dict] = None  # guarded_by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._conns: set = set()              # guarded_by: self._conns_lock
        self._conns_lock = threading.Lock()
        self._epoch_pass = 0                  # guarded_by: self._lock
        # -- fluid-elastic HA state (all inert for the solo default) ----
        self.role = "solo"            # solo | primary | standby
        self.fence_epoch = 0
        self.lease_s = 2.0
        # primary whose quorum renew fails
        self._fenced = False          # guarded_by: self._lock
        self._auto_promote = True
        self._standby_endpoint: Optional[str] = None
        self._standby_sock: Optional[socket.socket] = None
        self._primary_endpoint: Optional[str] = None   # standby: my feed
        self._primary_expires = 0.0                    # monotonic
        self._quorum = None
        self._quorum_resource = "master"
        self._quorum_lease = None
        self._quorum_thread: Optional[threading.Thread] = None
        # primary: record sequence head
        self._ha_seq = 0              # guarded_by: self._lock
        # primary: standby's applied seq
        self._ha_acked = 0            # guarded_by: self._lock
        # [(seq, record)], bounded
        self._ha_log: List = []       # guarded_by: self._lock
        self._ha_log_cap = 1024
        self._ha_need_snap = False    # guarded_by: self._lock
        # standby unreachable, quorum held
        self._ha_degraded = False     # guarded_by: self._lock
        self._ha_flush_cond = threading.Condition()
        self._ha_dirty = threading.Event()
        # standby: replay watermark
        self._applied_seq = 0         # guarded_by: self._lock
        self._pulse_port_req = pulse_port
        self.pulse_port: Optional[int] = None
        if snapshot_path and (os.path.exists(snapshot_path)
                              or os.path.exists(snapshot_path + ".prev")):
            self._recover()

    # -- issuing verdict ---------------------------------------------------
    @property
    def issuing(self) -> bool:
        """True while THIS master may issue/settle task leases: a solo
        master always, a primary only while its quorum lease renews (a
        fenced or deposed primary holds). The chaos drills sample this
        across both members — at most one True at every instant."""
        return (self.role in ("solo", "primary")
                and not self._fenced  # race_lint: ignore[unguarded-read] — deliberately lock-free sampled verdict; callers tolerate one-tick staleness, and the chaos drills sample it at rate
                and not self._stop.is_set())

    # -- metrics (observe-gated; zero writes when the flag is off) ---------
    def _meter(self, name, help_, n=1, **labels):
        if _flags.get_flag("observe"):
            _metrics.counter(name, help_).inc(n, **labels)

    def _meter_queues_locked(self):
        if not _flags.get_flag("observe"):
            return
        ep = self.endpoint
        _metrics.gauge("master_tasks_todo",
                       "tasks waiting to be issued").set(
                           float(len(self._todo)), endpoint=ep)
        _metrics.gauge("master_tasks_pending",
                       "tasks out on a live lease").set(
                           float(len(self._pending)), endpoint=ep)
        _metrics.gauge("master_pass",
                       "data-pass counter").set(
                           float(self._epoch_pass), endpoint=ep)

    # -- dataset -----------------------------------------------------------
    @staticmethod
    def _dataset_fingerprint(payloads, chunks_per_task) -> Dict:
        """(count, sha) of the task set — how a recovered master tells
        `set_dataset` re-registration (idempotent no-op) apart from a
        caller holding a DIFFERENT dataset (a pointed error beats
        silently training on the wrong data)."""
        h = hashlib.sha256(str(int(chunks_per_task)).encode())
        for p in payloads:
            h.update(pickle.dumps(p, protocol=4))
        return {"count": len(payloads), "sha": h.hexdigest()}

    def set_dataset(self, payloads: List[Any], chunks_per_task: int = 1):
        """Partition payloads into tasks (reference partition :106).
        Idempotent across restarts (reference SetDataset :280 ignores
        re-registration once initialized) — but only for the SAME
        dataset: a payload-count/sha mismatch against recovered state
        raises instead of silently training on the wrong data."""
        payloads = list(payloads)
        fp = self._dataset_fingerprint(payloads, chunks_per_task)
        with self._lock:
            if self._todo or self._pending or self._done:
                if self._dataset_fp is None or fp == self._dataset_fp:
                    # legacy (unverifiable) state, or the identical
                    # dataset re-registered: the historical no-op
                    return
                raise DatasetMismatchError(
                    f"master {self.endpoint}: set_dataset mismatch — the "
                    f"(recovered) state was partitioned from "
                    f"{self._dataset_fp['count']} payloads (sha "
                    f"{self._dataset_fp['sha'][:12]}…) but the caller "
                    f"registered {fp['count']} (sha {fp['sha'][:12]}…); "
                    f"refusing to train on the wrong data. Delete the "
                    f"snapshot (or start a fresh master) to change "
                    f"datasets")
            tid = 0
            for i in range(0, len(payloads), chunks_per_task):
                self._todo.append(_Task(tid, payloads[i:i + chunks_per_task]))
                tid += 1
            self._dataset_fp = fp
            self._ha_mark_snapshot_locked()
            self._meter_queues_locked()
            self._snapshot_locked()

    # -- task lifecycle ----------------------------------------------------
    def get_task(self):
        with self._lock:
            if not self._todo:
                if not self._pending and self._done:
                    return ("no_more", None)       # pass finished
                return ("none", None)              # wait: leases pending
            t = self._todo.pop(0)
            t.epoch += 1
            t.deadline = time.time() + self.timeout_dur
            self._pending[t.task_id] = t
            self._ha_record_locked(t, "pending")
            issue_seq = self._ha_seq if (
                self.role == "primary"
                and self._standby_endpoint is not None) else 0
            if _flags.get_flag("observe"):
                _metrics.counter(ISSUED_METRIC,
                                 "task leases issued").inc()
                if t.epoch > 1:
                    _metrics.counter(
                        REISSUED_METRIC,
                        "task leases re-issued after a timeout, failure, "
                        "or clean return").inc()
                self._meter_queues_locked()
            self._snapshot_locked()
            reply = ("ok", {"task_id": t.task_id, "epoch": t.epoch,
                            "payload": t.payload})
        if issue_seq and not self._ha_flush(issue_seq):
            # the issue record could not reach the standby AND this
            # primary may no longer rule: the lease must not be handed
            # out (the promoted side would re-issue it blind, breaking
            # exactly-once). The trainer just waits; the stranded
            # pending row times out and re-issues at the ruler.
            return ("none", None)
        return reply

    def task_finished(self, task_id: int, epoch: int):
        with self._lock:
            t = self._pending.get(task_id)
            if t is None or t.epoch != epoch:
                return False                       # stale lease (re-issued)
            del self._pending[task_id]
            self._done.append(t)
            self._ha_record_locked(t, "done")
            self._meter(FINISHED_METRIC, "task leases finished")
            if not self._todo and not self._pending:
                logger.info("master: pass %d complete (%d tasks)",
                            self._epoch_pass, len(self._done))
            self._meter_queues_locked()
            self._snapshot_locked()
            return True

    def task_failed(self, task_id: int, epoch: int):
        with self._lock:
            t = self._pending.get(task_id)
            if t is None or t.epoch != epoch:
                return False
            del self._pending[task_id]
            self._meter(FAILED_METRIC,
                        "task leases reported failed (burns the task's "
                        "failure budget)")
            self._process_failed_locked(t)
            self._meter_queues_locked()
            self._snapshot_locked()
            return True

    def task_returned(self, task_id: int, epoch: int):
        """Clean lease return (fluid-elastic): a trainer shutting down
        mid-task hands the lease back so re-issue is IMMEDIATE, not
        timeout-bound — and without burning `num_failure` (an orderly
        departure is not a failure)."""
        with self._lock:
            t = self._pending.get(task_id)
            if t is None or t.epoch != epoch:
                return False
            del self._pending[task_id]
            self._todo.insert(0, t)   # head: it was already in flight
            self._ha_record_locked(t, "todo")
            self._meter(RETURNED_METRIC,
                        "task leases returned cleanly (trainer shutdown; "
                        "no failure budget burned)")
            self._meter_queues_locked()
            self._snapshot_locked()
            return True

    def _process_failed_locked(self, t: _Task):
        """reference processFailedTask :313: discard past failure_max."""
        t.num_failure += 1
        if t.num_failure > self.failure_max:
            logger.warning("master: task %d failed %d times, discarding",
                           t.task_id, t.num_failure)
            # a discarded task is SILENT DATA LOSS for the pass — always
            # in the black box, and the task_discard detector's evidence
            _flight.note("master_task_discard", task_id=t.task_id,
                         failures=t.num_failure, endpoint=self.endpoint)
            self._meter(DISCARDED_METRIC,
                        "tasks discarded after burning their failure "
                        "budget (records lost for this pass)")
            self._done.append(t)
            self._ha_record_locked(t, "done")
            return
        self._todo.append(t)
        self._ha_record_locked(t, "todo")

    def start_new_pass(self):
        """Re-queue everything for another data pass."""
        with self._lock:
            self._todo.extend(self._done)
            self._done = []
            for t in self._todo:
                t.num_failure = 0
            self._epoch_pass += 1
            self._ha_mark_snapshot_locked()
            self._meter_queues_locked()
            self._snapshot_locked()

    def _check_timeouts(self):
        while not self._stop.wait(self.check_interval):
            if not self.issuing:
                # a standby's replicated pending rows carry no local
                # deadlines, and a fenced primary must not mutate state
                # it may no longer own — only the ruler expires leases
                continue
            now = time.time()
            with self._lock:
                expired = [t for t in self._pending.values()
                           if t.deadline < now]
                for t in expired:
                    logger.info("master: task %d lease expired, re-queueing",
                                t.task_id)
                    del self._pending[t.task_id]
                    self._meter(FAILED_METRIC,
                                "task leases reported failed (burns the "
                                "task's failure budget)")
                    self._process_failed_locked(t)
                if expired:
                    self._meter_queues_locked()
                    self._snapshot_locked()

    # -- persistence (the etcd-snapshot analog, ark atomic idiom) ----------
    def _state_locked(self) -> Dict:
        return {"todo": [t.to_dict() for t in self._todo],
                "pending": [t.to_dict() for t in self._pending.values()],
                "done": [t.to_dict() for t in self._done],
                "pass": self._epoch_pass,
                "dataset_fp": self._dataset_fp}

    def _install_state_locked(self, state: Dict, recovered: bool = False):
        todo = [_Task.from_dict(d) for d in state["todo"]]
        pending = [_Task.from_dict(d) for d in state["pending"]]
        if recovered:
            # cold restart (reference recover :166): the pending leases
            # died with the previous PROCESS — back to todo. (A standby
            # installing a replicated snapshot keeps them pending: their
            # holders are still alive out there.)
            todo, pending = todo + pending, []
        self._todo = todo
        self._pending = {t.task_id: t for t in pending}
        self._done = [_Task.from_dict(d) for d in state["done"]]
        self._epoch_pass = state.get("pass", 0)
        self._dataset_fp = state.get("dataset_fp")

    @staticmethod
    def _state_sha(state: Dict) -> str:
        return hashlib.sha256(
            json.dumps(state, sort_keys=True).encode()).hexdigest()

    def _snapshot_locked(self):
        """Per-mutation durability is the contract (the etcd-write
        analog); the state is small by design. The payload is
        serialized ONCE — the sha is computed over the same canonical
        string that lands in the file, so the write is O(state) not
        O(2*state)."""
        if not self.snapshot_path:
            return
        body = json.dumps(self._state_locked(), sort_keys=True)
        sha = hashlib.sha256(body.encode()).hexdigest()
        # retain the previous serial: a crash mid-write (or bit rot in
        # the current file) falls back to it instead of losing the pass
        if os.path.exists(self.snapshot_path):
            try:
                os.replace(self.snapshot_path, self.snapshot_path + ".prev")
            except OSError:
                pass
        with ark_ckpt.atomic_file(self.snapshot_path, "w") as f:
            # {"sha256": ..., "state": <body>} — body verbatim, so the
            # recovery-side re-dump (sort_keys, default separators)
            # reproduces the hashed bytes exactly
            f.write('{"sha256": "%s", "state": %s}' % (sha, body))

    def _recover(self):
        """Load the newest INTACT serial — current, else `.prev` — and
        never crash: a corrupt corpus logs loudly and starts empty (the
        dataset must be re-registered), it does not take the process
        down with a JSONDecodeError."""
        with self._lock:
            for cand in (self.snapshot_path, self.snapshot_path + ".prev"):
                if not os.path.exists(cand):
                    continue
                try:
                    with open(cand) as f:
                        raw = json.load(f)
                except (ValueError, OSError) as e:
                    logger.warning("master: snapshot %s unreadable (%s); "
                                   "falling back to the previous serial",
                                   cand, e)
                    continue
                if isinstance(raw, dict) and "state" in raw \
                        and "sha256" in raw:
                    state = raw["state"]
                    if self._state_sha(state) != raw["sha256"]:
                        logger.warning(
                            "master: snapshot %s fails its embedded "
                            "sha256 (bit rot); falling back to the "
                            "previous serial", cand)
                        continue
                elif isinstance(raw, dict) and "todo" in raw:
                    state = raw   # legacy pre-elastic snapshot: no sha
                else:
                    logger.warning("master: snapshot %s has an "
                                   "unrecognized shape; skipping", cand)
                    continue
                try:
                    self._install_state_locked(state, recovered=True)
                except (KeyError, TypeError, ValueError) as e:
                    logger.warning("master: snapshot %s is structurally "
                                   "torn (%s); falling back", cand, e)
                    continue
                logger.info("master: recovered %d todo / %d done from %s",
                            len(self._todo), len(self._done), cand)
                return
            logger.warning(
                "master: NO intact snapshot at %s (nor .prev) — starting "
                "empty; the dataset must be re-registered",
                self.snapshot_path)

    # -- fluid-elastic: replication / election / fencing -------------------
    def _arm_quorum(self, quorum_endpoints, quorum_resource):
        from ..quorum import QuorumClient
        self._quorum = QuorumClient(
            list(quorum_endpoints), actor=self.endpoint,
            deadline_s=max(0.25, min(1.0, self.lease_s / 4.0)))
        self._quorum_resource = quorum_resource or "master"

    def start_replication(self, standby_endpoint: str, lease_s: float = 2.0,
                          quorum_endpoints=None,
                          quorum_resource: str = "master") -> "Master":
        """Arm this master as the PRIMARY of an HA pair: every task
        mutation is forwarded to `standby_endpoint` as a sequenced
        record (idle batches at lease/3 double as the lease renewal).
        With `quorum_endpoints`, the primacy itself is a majority-
        granted lease on `quorum_resource` — this master campaigns at
        startup (raising if it loses) and renews at lease/3; a failed
        renewal FENCES the task plane at once and local expiry steps
        the master down."""
        self.lease_s = float(lease_s)
        self._standby_endpoint = standby_endpoint
        if quorum_endpoints:
            self._arm_quorum(quorum_endpoints, quorum_resource)
        with self._lock:
            self.role = "primary"
            if self._quorum is not None:
                lease = self._quorum.campaign(
                    self._quorum_resource, self.endpoint, self.lease_s)
                if lease is None:
                    self.role = "solo"
                    raise RuntimeError(
                        f"master {self.endpoint}: lost the bootstrap "
                        f"election for {self._quorum_resource!r} — another "
                        f"master rules")
                self._quorum_lease = lease
                self.fence_epoch = lease.epoch
            else:
                self.fence_epoch = max(self.fence_epoch, 1)
            self._ha_mark_snapshot_locked()
        threading.Thread(target=self._forward_loop, daemon=True,
                         name=f"master-fwd@{self.endpoint}").start()
        if self._quorum is not None:
            self._start_quorum_loop()
        logger.info("master %s: primary at epoch %d, replicating to %s",
                    self.endpoint, self.fence_epoch, standby_endpoint)
        return self

    def start_standby(self, lease_s: float = 2.0, auto_promote: bool = True,
                      quorum_endpoints=None,
                      quorum_resource: str = "master") -> "Master":
        """Arm this master as a STANDBY: it applies the primary's record
        stream, redirects task commands, and promotes when the primary's
        lease expires — gated on a quorum majority grant when arbiters
        are configured (partition-safe), else on `auto_promote` under
        the documented crash-stop model."""
        self.lease_s = float(lease_s)
        self._auto_promote = bool(auto_promote)
        if quorum_endpoints:
            self._arm_quorum(quorum_endpoints, quorum_resource)
        with self._lock:
            self.role = "standby"
            # boot grace: give a live primary one lease to make contact
            self._primary_expires = time.monotonic() + self.lease_s
        threading.Thread(target=self._standby_monitor, daemon=True,
                         name=f"master-standby@{self.endpoint}").start()
        return self

    def _start_quorum_loop(self):
        if self._quorum_thread is None or not self._quorum_thread.is_alive():
            self._quorum_thread = threading.Thread(
                target=self._quorum_loop, daemon=True,
                name=f"master-quorum@{self.endpoint}")
            self._quorum_thread.start()

    # -- primary side ------------------------------------------------------
    def _ha_record_locked(self, t: _Task, queue: str):
        """One task-lifecycle record: the moved task's full row + its
        destination queue — idempotent by construction (applying twice
        lands the task in the same place)."""
        if self.role != "primary" or self._standby_endpoint is None:
            # a promoted master with no standby of its own (or a solo
            # master) has nobody to feed
            return
        self._ha_seq += 1
        rec = {"task": t.to_dict(), "queue": queue,
               "pass": self._epoch_pass}
        if _flags.get_flag("observe"):
            # fluid-horizon: the record remembers WHICH request caused it
            # (the master_server:* span active in this dispatch), so the
            # standby's apply span joins the trainer's trace across the
            # replication stream
            ctx = _xray.current()
            if ctx is not None:
                rec["trace"] = _xray.to_traceparent(ctx)
        self._ha_log.append((self._ha_seq, rec))
        if len(self._ha_log) > self._ha_log_cap:
            del self._ha_log[: len(self._ha_log) - self._ha_log_cap]
        self._ha_dirty.set()

    def _ha_flush(self, seq: int) -> bool:
        """The exactly-once linchpin: an ISSUED lease must be KNOWN to
        the standby before the trainer may act on it — otherwise a
        failover inside the in-flight window re-issues a task whose
        records are already being processed, and the duplicate is
        invisible to the task-epoch accounting. Blocks until the
        standby acked `seq` (sub-ms on a healthy pair), bounded by one
        lease. On timeout: if this primary STILL rules at the arbiters
        (not fenced), it DEGRADES to solo-forwarding — safe with a
        quorum armed, because the standby cannot win an election while
        our lease renews. WITHOUT arbiters the degrade keeps the pair's
        documented crash-stop model (exactly haven's own): a
        pair-link-only partition can split the pair for its duration,
        because two nodes cannot tell "dead" from "unreachable" — arm a
        quorum (or `auto_promote=False`) where partitions are real. If
        this primary is fenced or deposed, the issue is refused
        (False).
        Settlement records (finish/fail/return) stay asynchronous: a
        lost settlement self-heals through the client's failover replay
        against the preserved pending lease."""
        deadline = time.monotonic() + self.lease_s
        with self._ha_flush_cond:
            while True:
                with self._lock:
                    flushed = (self._ha_acked >= seq or self._ha_degraded)
                if flushed:
                    break
                if self._stop.is_set() or self.role != "primary":
                    return False
                self._ha_dirty.set()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._ha_flush_cond.wait(min(remaining, 0.05))
        with self._lock:
            if self._ha_acked >= seq or self._ha_degraded:
                return True
            if self._fenced or self.role != "primary":
                return False
            # the degrade verdict and the flag flip are one atomic step:
            # an unlocked write here raced _forward_once's locked
            # `_ha_degraded = False` on standby recovery
            self._ha_degraded = True
        logger.warning(
            "master %s: standby unreachable for %.1fs while the quorum "
            "lease still renews — DEGRADING to solo issue (the standby "
            "cannot win an election; it full-resyncs when it returns)",
            self.endpoint, self.lease_s)
        _flight.note("master_ha_degraded", endpoint=self.endpoint,
                     epoch=self.fence_epoch)
        return True

    def _ha_mark_snapshot_locked(self):
        """Whole-state mutations (set_dataset, new pass, recover) ship a
        full snapshot instead of per-task records."""
        if self.role != "primary" or self._standby_endpoint is None:
            return
        self._ha_seq += 1
        self._ha_need_snap = True
        self._ha_log.clear()
        self._ha_dirty.set()

    def _forward_loop(self):
        """Forward pending records (or a resync snapshot) to the standby;
        an idle iteration still sends an empty batch at lease/3 — the
        heartbeat that keeps the standby from promoting."""
        while not self._stop.is_set():
            self._ha_dirty.wait(timeout=self.lease_s / 3.0)
            if self._stop.is_set():
                return
            self._ha_dirty.clear()
            if self.role != "primary":
                continue
            try:
                self._forward_once()
            except (ConnectionError, EOFError, OSError,
                    socket.timeout) as e:
                logger.debug("master-fwd: standby %s unreachable: %s",
                             self._standby_endpoint, e)
                self._drop_standby_sock()

    def _forward_once(self):
        with self._lock:
            oldest = self._ha_log[0][0] if self._ha_log else self._ha_seq + 1
            need_snap = self._ha_need_snap or self._ha_acked < oldest - 1
            payload = {"epoch": self.fence_epoch, "primary": self.endpoint,
                       "lease_s": self.lease_s}
            if need_snap:
                payload["snapshot"] = self._state_locked()
                payload["base_seq"] = self._ha_seq
                payload["records"] = []   # the snapshot IS the head
            else:
                payload["records"] = [(s, r) for s, r in self._ha_log
                                      if s > self._ha_acked]
        sock = self._standby_sock
        if sock is None:
            sock = rpc.connect(self._standby_endpoint,
                               timeout=self.lease_s)
            self._standby_sock = sock
        sock.settimeout(self.lease_s)
        frame = ("m_replicate", payload)
        fctx = None
        if _flags.get_flag("observe"):
            # forwarder thread has no ambient context: each batch is a
            # fresh root span whose id rides the frame, so the standby's
            # master_server:m_replicate span parents here
            fctx = _xray.child_of()
            if fctx is not None:
                frame = ("m_replicate", payload, _xray.to_wire(fctx))
        fts = time.time()
        ft0 = time.monotonic()
        rpc.send_msg(sock, frame)
        status, value = rpc.recv_msg(sock)
        if fctx is not None:
            _xray.record_span("master_fwd:m_replicate", fctx, fts,
                              time.monotonic() - ft0, cat="ha",
                              records=len(payload["records"]),
                              snapshot="snapshot" in payload,
                              status=status)
        sock.settimeout(None)
        if status == "redirect":
            # the standby answers for a RULER at a higher epoch: this
            # primary was deposed while it could not see the quorum
            self._step_down("deposed_by_standby",
                            int((value or {}).get("epoch", 0)))
            return
        if status != "ok":
            logger.debug("master-fwd: standby rejected batch: %s", value)
            return
        if value.get("need_sync"):
            with self._lock:
                self._ha_need_snap = True
                self._ha_dirty.set()
            return
        with self._lock:
            self._ha_acked = max(self._ha_acked,
                                 int(value.get("applied_seq", 0)))
            if need_snap:
                self._ha_need_snap = False
            if self._ha_degraded:
                # the standby is back (and just acked a batch/snapshot):
                # leave solo-degraded mode — issues block on acks again
                logger.info("master %s: standby reachable again — "
                            "leaving degraded solo mode", self.endpoint)
                self._ha_degraded = False
            self._ha_log = [(s, r) for s, r in self._ha_log
                            if s > self._ha_acked]
        with self._ha_flush_cond:
            self._ha_flush_cond.notify_all()

    def _drop_standby_sock(self):
        s, self._standby_sock = self._standby_sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _quorum_loop(self):
        """Primary-side lease renewal at lease/3: a failed round fences
        the task plane at once (issuing False — no new leases, no
        settlements); local lease expiry steps the master down to an
        inert standby. Runs only while this master is primary."""
        while not self._stop.wait(self.lease_s / 3.0):
            if self.role != "primary" or self._quorum is None:
                continue
            lease = self._quorum_lease
            ok = False
            try:
                ok = lease is not None and self._quorum.renew(lease)
            except Exception as e:   # noqa: BLE001 — renewal best-effort
                logger.debug("master-quorum: renew failed: %s", e)
            if ok:
                with self._lock:
                    recovered = self._fenced
                    self._fenced = False
                if recovered:
                    logger.info("master %s: quorum renew recovered — "
                                "unfencing", self.endpoint)
                continue
            with self._lock:
                first = not self._fenced
                self._fenced = True
            if first:
                logger.warning("master %s: quorum renew FAILED — fencing "
                               "the task plane (step-down at local "
                               "expiry)", self.endpoint)
                _flight.note("master_fenced", endpoint=self.endpoint,
                             epoch=self.fence_epoch)
            if lease is None or not lease.live:
                self._step_down("quorum_lost", self.fence_epoch)

    def _step_down(self, reason: str, epoch: int):
        with self._lock:
            if self.role != "primary":
                return
            self.role = "standby"
            self._fenced = False
            self.fence_epoch = max(self.fence_epoch, int(epoch))
            # grace before this deposed node may campaign again
            self._primary_expires = time.monotonic() + self.lease_s
        logger.warning("master %s: STEPPED DOWN (%s) — now a standby at "
                       "epoch %d", self.endpoint, reason, self.fence_epoch)
        _flight.note("master_step_down", endpoint=self.endpoint,
                     reason=reason, epoch=self.fence_epoch)
        self._meter(STEP_DOWNS_METRIC,
                    "primary masters that abdicated", reason=reason)
        # a deposed primary must be able to promote again if the new
        # ruler dies later — the standby monitor does that
        threading.Thread(target=self._standby_monitor, daemon=True,
                         name=f"master-standby@{self.endpoint}").start()

    # -- standby side ------------------------------------------------------
    def _h_m_replicate(self, records=(), epoch=0, primary=None,
                       lease_s=2.0, snapshot=None, base_seq=0):
        epoch = int(epoch)
        with self._lock:
            if epoch < self.fence_epoch or (
                    self.role in ("solo", "primary")
                    and epoch <= self.fence_epoch):
                # a stale predecessor's stream — rejected UNCONDITIONALLY
                # below our fencing epoch, whatever our role or fence
                # state: a deposed primary reconnecting after a blip must
                # never overwrite the newer state this node replicated
                # (or ruled) at a higher epoch
                return ("redirect",
                        {"primary": self.endpoint if self.issuing
                         else self._primary_endpoint,
                         "epoch": self.fence_epoch})
            if self.role in ("solo", "primary"):
                # a RULER at a strictly higher epoch is feeding us: this
                # node was deposed (or is a bare master being adopted) —
                # become its standby
                self.role = "standby"
                self._fenced = False
            self._primary_endpoint = primary
            self._primary_expires = time.monotonic() + float(lease_s)
            self.lease_s = float(lease_s)
            self.fence_epoch = max(self.fence_epoch, epoch)
            if snapshot is not None:
                self._install_state_locked(snapshot)
                self._applied_seq = int(base_seq)
            obs = _flags.get_flag("observe")
            for seq, rec in records:
                seq = int(seq)
                if seq <= self._applied_seq:
                    continue                       # replayed duplicate
                if seq > self._applied_seq + 1:
                    return ("ok", {"need_sync": True,
                                   "applied_seq": self._applied_seq})
                # fluid-horizon: the record carries the traceparent of
                # the request that produced it — the standby's apply
                # span closes the trainer -> primary -> standby chain
                rctx = _xray.parse_traceparent(rec.get("trace")) \
                    if obs else None
                if rctx is not None:
                    with _xray.activate(rctx), \
                            _xray.span("master_apply:"
                                       + str(rec.get("queue")),
                                       cat="ha", seq=seq):
                        self._apply_record_locked(rec)
                else:
                    self._apply_record_locked(rec)
                self._applied_seq = seq
            self._snapshot_locked()
            return ("ok", {"applied_seq": self._applied_seq})

    def _apply_record_locked(self, rec: Dict):
        d = rec["task"]
        tid = d["task_id"]
        self._todo = [t for t in self._todo if t.task_id != tid]
        self._pending.pop(tid, None)
        self._done = [t for t in self._done if t.task_id != tid]
        t = _Task.from_dict(d)
        if rec["queue"] == "todo":
            self._todo.append(t)
        elif rec["queue"] == "pending":
            self._pending[tid] = t    # deadline re-armed at promotion
        else:
            self._done.append(t)
        self._epoch_pass = rec.get("pass", self._epoch_pass)

    def _standby_monitor(self):
        """Promote when the primary's lease expires — behind a quorum
        majority grant when arbiters are armed (a partitioned pair is an
        election this side must WIN, not assume), else on `auto_promote`
        under the crash-stop model."""
        while not self._stop.wait(min(self.lease_s / 3.0, 0.25)):
            if self.role != "standby":
                if self.role == "primary":
                    return   # promoted (or re-promoted); monitor retires
                continue
            if time.monotonic() < self._primary_expires:
                continue
            if self._quorum is not None:
                try:
                    lease = self._quorum.campaign(
                        self._quorum_resource, self.endpoint, self.lease_s,
                        max_rounds=1)
                except Exception as e:   # noqa: BLE001
                    logger.debug("master-standby: campaign failed: %s", e)
                    self._primary_expires = time.monotonic() + self.lease_s
                    continue
                if lease is None:
                    # lost: the primary lives on at the arbiters — back
                    # off a lease period before campaigning again
                    self._primary_expires = time.monotonic() + self.lease_s
                    continue
                self._quorum_lease = lease
                self._promote(lease.epoch, kind="quorum")
                return
            if self._auto_promote and self._primary_endpoint is not None:
                # crash-stop promotion requires that a primary FED this
                # standby at least once: a never-contacted standby (its
                # primary process still booting — the documented
                # standby-first deployment order) must not crown itself
                # over state it never had. Quorum-armed standbys may
                # campaign from boot: the election decides.
                self._promote(self.fence_epoch + 1, kind="lease_expiry")
                return

    def _promote(self, epoch: int, kind: str):
        with self._lock:
            if self.role == "primary":
                return
            self.role = "primary"
            self._fenced = False
            self.fence_epoch = max(self.fence_epoch, int(epoch))
            # exactly-once across failover: the replicated pending
            # leases SURVIVE — task-id/epoch pairs intact, so a
            # surviving trainer's task_finished still matches and is
            # accepted exactly once. Only the lease CLOCKS restart (the
            # old deadlines lived on the dead primary's clock).
            now = time.time()
            for t in self._pending.values():
                t.deadline = now + self.timeout_dur
            n_pending = len(self._pending)
            self._meter_queues_locked()
            self._snapshot_locked()
        logger.warning("master %s: PROMOTED to primary at epoch %d (%s; "
                       "%d pending leases preserved)", self.endpoint,
                       self.fence_epoch, kind, n_pending)
        _flight.note("master_promotion", endpoint=self.endpoint,
                     epoch=self.fence_epoch, promotion=kind,
                     pending=n_pending)
        self._meter(PROMOTIONS_METRIC,
                    "standby masters promoted to primary", kind=kind)
        if self._quorum is not None:
            self._start_quorum_loop()

    def ha_status(self) -> Dict:
        with self._lock:
            ruler = self.endpoint if self.issuing else self._primary_endpoint
            return {"role": self.role, "epoch": self.fence_epoch,
                    "issuing": self.issuing, "fenced": self._fenced,
                    "endpoint": self.endpoint, "primary": ruler,
                    "applied_seq": self._applied_seq,
                    "ha_seq": self._ha_seq, "ha_acked": self._ha_acked,
                    "todo": len(self._todo), "pending": len(self._pending),
                    "done": len(self._done), "pass": self._epoch_pass}

    # -- fluid-pulse -------------------------------------------------------
    def _pulse_check(self):
        st = self.ha_status()
        ok = not (st["role"] in ("solo", "primary") and st["fenced"])
        return (ok, st)

    # -- service loop (same wire protocol as the pserver) ------------------
    def start(self) -> "Master":
        host, port = rpc.parse_endpoint(self.endpoint)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        if port == 0:
            self.endpoint = f"{host}:{self._listener.getsockname()[1]}"
        self._listener.listen(64)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"master@{self.endpoint}").start()
        threading.Thread(target=self._check_timeouts, daemon=True,
                         name="master-timeouts").start()
        if self._pulse_port_req is not None:
            from ..observe import health as _health
            from ..observe import pulse as _pulse
            self.pulse_port = _pulse.start_pulse(self._pulse_port_req)
            _health.get_engine().register_check(
                f"master_queues@{self.endpoint}", self._pulse_check,
                ready=True)
        return self

    def serve_forever(self):
        self.start()
        self._stop.wait()

    def stop(self, resign: bool = False):
        """Hard cut by default, like a killed process: listener AND
        every live connection die now (in-flight requests dropped
        unanswered — the chaos drills depend on SIGKILL semantics), and
        the quorum lease is NOT resigned — it expires at the arbiters,
        exactly as a real corpse's would. A PLANNED shutdown passes
        `resign=True` (tools/torch_master_node.py's SIGTERM handler does) so
        the standby's election can start immediately instead of waiting
        out the lease."""
        if resign and self._quorum is not None \
                and self._quorum_lease is not None:
            try:
                self._quorum.resign(self._quorum_lease)
            except Exception:   # noqa: BLE001 — best-effort courtesy
                pass
        self._stop.set()
        self._ha_dirty.set()
        if self.pulse_port is not None:
            from ..observe import health as _health
            _health.get_engine().unregister_check(
                f"master_queues@{self.endpoint}")
            self.pulse_port = None
        self._drop_standby_sock()
        if self._quorum is not None:
            try:
                self._quorum.close()
            except Exception:   # noqa: BLE001
                pass
        if self._listener is not None:
            for f in ("shutdown", "close"):
                try:
                    (self._listener.shutdown(socket.SHUT_RDWR)
                     if f == "shutdown" else self._listener.close())
                except OSError:
                    pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
            for f in ("shutdown", "close"):
                try:
                    (c.shutdown(socket.SHUT_RDWR) if f == "shutdown"
                     else c.close())
                except OSError:
                    pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            # mconn@ names carry the chaos actor identity (server-side
            # replies attribute to this master's endpoint)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"mconn@{self.endpoint}").start()

    def _dispatch(self, cmd, p):
        if cmd in TASK_CMDS and not self.issuing:
            # a standby knows its feeder; a fenced/deposed primary may
            # not know the new ruler — the client resolves through the
            # arbiters either way
            hint = self._primary_endpoint if self.role == "standby" \
                else None
            return ("redirect", {"primary": hint,
                                 "epoch": self.fence_epoch})
        if cmd == "get_task":
            return ("ok", self.get_task())
        if cmd == "task_finished":
            return ("ok", self.task_finished(**p))
        if cmd == "task_failed":
            return ("ok", self.task_failed(**p))
        if cmd == "task_returned":
            return ("ok", self.task_returned(**p))
        if cmd == "set_dataset":
            return ("ok", self.set_dataset(**p))
        if cmd == "start_new_pass":
            return ("ok", self.start_new_pass())
        if cmd == "stats":
            with self._lock:
                return ("ok", {"todo": len(self._todo),
                               "pending": len(self._pending),
                               "done": len(self._done)})
        if cmd == "ha_status":
            return ("ok", self.ha_status())
        if cmd == "m_replicate":
            return self._h_m_replicate(**p)
        if cmd == "stop":
            return ("ok", None)
        return ("err", f"unknown command {cmd!r}")

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    msg = rpc.recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                if self._stop.is_set():
                    return   # dead process: drop the request unanswered
                try:
                    # (cmd, payload[, meta]): the optional meta dict
                    # carries the caller's traceparent (fluid-horizon) —
                    # legacy 2-tuple frames keep working
                    cmd, p = msg[0], msg[1]
                    meta = msg[2] if len(msg) >= 3 else None
                except (TypeError, IndexError):
                    try:
                        rpc.send_msg(conn, ("err", "MalformedFrame: "
                                            "expected (cmd, payload[, "
                                            "meta])"))
                        continue
                    except (ConnectionError, OSError):
                        return
                wctx = _xray.from_wire(meta) \
                    if meta and _flags.get_flag("observe") else None
                try:
                    if wctx is not None:
                        with _xray.activate(wctx), \
                                _xray.span(f"master_server:{cmd}",
                                           cat="rpc", cmd=cmd,
                                           endpoint=self.endpoint,
                                           role=self.role):
                            reply = self._dispatch(cmd, p)
                    else:
                        reply = self._dispatch(cmd, p)
                except Exception as e:
                    reply = ("err", f"{type(e).__name__}: {e}")
                try:
                    rpc.send_msg(conn, reply)
                except (ConnectionError, OSError):
                    return
                if cmd == "stop":
                    self.stop()
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()
