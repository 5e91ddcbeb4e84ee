"""Sequence-numbered update log with an acknowledged watermark.

Mirror of ``paddle_tpu/haven/log.py``, copied.

The replication contract's loss bound lives here: the primary appends
one record per applied update, the forwarder streams records to the
backup, and the backup's acknowledgement advances `acked_seq`. The
window between `head_seq` and `acked_seq` is the ONLY state a failover
can lose — `append` blocks once `head - acked >= window`, so the bound
is enforced by backpressure, not hoped for (tests pin it by freezing
the forwarder and counting exactly which updates a promoted backup is
missing).

Before a full sync's snapshot cut (a fresh pair's first, or a
resync's) nothing is in flight: the snapshot will hold every update up
to the cut, so `append` only numbers the update and keeps no record,
and the window holds no appender back. The cut is taken under a
quiesce that waits out the in-flight mutators; an appender blocked on
the window would be one of them, and only the forwarder, waiting in
that quiesce, could release it. The backup holds no snapshot yet, so
there is no failover target to lose updates to; `needs_resync` stays
set and `lag()` at least 1 until the snapshot lands.

Degradation beats deadlock: when the backup is gone (no ack moves the
watermark for `stall_timeout_s` while the window is full), the log
DEGRADES — recording stops, the ring clears, and `needs_resync` is set
so the forwarder performs a full snapshot sync when the peer returns.
While degraded there is no failover target anyway, so blocking trainer
pushes would trade availability for nothing.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple


class ReplicationStalled(RuntimeError):
    """The in-flight window filled and no ack arrived within the stall
    timeout — the log has degraded to solo mode."""


class UpdateLog:
    def __init__(self, window: int = 512, stall_timeout_s: float = 5.0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.stall_timeout_s = float(stall_timeout_s)
        self._cond = threading.Condition()
        # list of (seq, cmd, payload, t_monotonic, trace); seqs are
        # contiguous; trace is the recording request's traceparent (or
        # None) — fluid-horizon links the backup's apply span to it
        self._records: List[Tuple[int, str, dict, float, Optional[str]]] = []  # guarded_by: self._cond
        self._head = 0      # guarded_by: self._cond
        self._acked = 0     # guarded_by: self._cond
        self._degraded = False  # guarded_by: self._cond
        # a fresh pair always starts with a sync
        self._needs_resync = True  # guarded_by: self._cond
        # that sync's snapshot cut (or a resync's) is still to be taken:
        # appends are numbered and not recorded (see the module docstring)
        self._before_cut = True  # guarded_by: self._cond

    # -- primary write path ----------------------------------------------
    def append(self, cmd: str, payload: dict,
               trace: Optional[str] = None) -> Optional[int]:
        """Record one applied update; returns its seq, or None when the
        log is degraded (the update is applied locally but will only
        reach the backup via the next full resync). Blocks while the
        in-flight window is full — this backpressure IS the loss bound.
        `trace` (a traceparent string) names the request that caused
        the update, so the backup's replay parents under it."""
        deadline = time.monotonic() + self.stall_timeout_s
        with self._cond:
            if self._degraded:
                return None
            if self._before_cut:
                # the snapshot at the cut will hold this update
                self._head += 1
                return self._head
            while self._head - self._acked >= self.window:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # the backup stopped acking: degrade rather than
                    # wedge the trainers behind a dead replica
                    self._degrade_locked()
                    return None
                self._cond.wait(remaining)
                if self._degraded:
                    return None
            self._head += 1
            self._records.append((self._head, cmd, payload,
                                  time.monotonic(), trace))
            self._cond.notify_all()
            return self._head

    # -- forwarder read path ---------------------------------------------
    def batch(self, max_records: int = 64
              ) -> List[Tuple[int, str, dict, Optional[str]]]:
        """Unacked records in seq order (oldest first), up to
        `max_records`, as (seq, cmd, payload, trace) — the backup's
        replay accepts the legacy 3-tuple shape too, so a mixed-version
        pair keeps streaming. Retransmits everything past the watermark
        — the backup dedups by seq, so a lost ack costs bytes, never
        correctness."""
        with self._cond:
            return [(s, c, p, tr) for s, c, p, _t, tr in
                    self._records[:max_records]]

    def ack(self, seq: int) -> None:
        """The backup applied everything through `seq`: trim and release
        any appender blocked on the window."""
        with self._cond:
            if seq <= self._acked:
                return
            self._acked = min(seq, self._head)
            while self._records and self._records[0][0] <= self._acked:
                self._records.pop(0)
            self._cond.notify_all()

    def wait_pending(self, timeout: Optional[float] = None) -> bool:
        """Block until a record is pending (or degraded/timeout); the
        forwarder's idle sleep, interruptible by the next append."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._records and not self._degraded:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return bool(self._records)

    # -- watermarks / lag --------------------------------------------------
    @property
    def head_seq(self) -> int:
        with self._cond:
            return self._head

    @property
    def acked_seq(self) -> int:
        with self._cond:
            return self._acked

    def lag(self) -> int:
        """Records the backup has NOT caught up on. While a resync is
        pending (`needs_resync`, not degraded) the acked watermark
        cannot express the true backlog — `resume()` advances it at the
        snapshot CUT, before the snapshot lands — so the lag is floored
        at 1 until `rebase()` confirms the install. Without this floor,
        `lag() == 0` (the universal "backup is current" probe: tests,
        the handover drain, the lag gauges) is transiently TRUE during
        the in-flight `haven_sync` RPC of a fresh pair's first full
        sync, a race a loaded box hits for real. A DEGRADED log still
        reports 0: recording is suspended on purpose there (solo
        availability mode), which is idle, not backlog."""
        with self._cond:
            base = self._head - self._acked
            if self._needs_resync and not self._degraded:
                return max(base, 1)
            return base

    def oldest_unacked_age_s(self) -> float:
        with self._cond:
            if not self._records:
                return 0.0
            return max(0.0, time.monotonic() - self._records[0][3])

    # -- degradation / resync ---------------------------------------------
    @property
    def degraded(self) -> bool:
        with self._cond:
            return self._degraded

    @property
    def needs_resync(self) -> bool:
        """Locked read: the replicator loop and the handover drain poll
        this from their own threads."""
        with self._cond:
            return self._needs_resync

    def _degrade_locked(self):
        self._degraded = True
        self._needs_resync = True
        self._before_cut = True
        self._records.clear()
        self._acked = self._head
        self._cond.notify_all()

    def degrade(self):
        with self._cond:
            self._degrade_locked()

    def _advance_locked(self, seq: int):
        self._acked = max(self._acked, min(int(seq), self._head))
        while self._records and self._records[0][0] <= self._acked:
            self._records.pop(0)
        self._degraded = False
        self._cond.notify_all()

    def resume(self, seq: int):
        """Called AT a quiesced snapshot cut at `seq`: recording resumes
        immediately (the snapshot contains everything through the cut,
        and no mutator can slip an update between the cut and this call
        while the quiesce is held), while `needs_resync` stays set until
        the snapshot actually lands on the backup. Records appended
        after the cut are KEPT — they must still stream."""
        with self._cond:
            self._before_cut = False
            self._advance_locked(seq)

    def rebase(self, seq: Optional[int] = None):
        """The snapshot at `seq` (default: head) landed on the backup:
        advance the watermark past it and clear the resync flag."""
        with self._cond:
            self._advance_locked(self._head if seq is None else seq)
            self._needs_resync = False
            self._before_cut = False
