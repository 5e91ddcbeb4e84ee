"""Slot scheduling for generative serving: `SlotScheduler`, the part of
``paddle_tpu/serve/batcher.py`` the decode engine uses (the one-shot
MicroBatcher is not ported yet)."""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from .errors import QueueFullError


class SlotScheduler:
    """Fixed-slot admission for multi-step generative work.

    One-shot inference coalesces a QUEUE into a batch and the batch
    drains atomically; a generative batch never drains atomically —
    sequences finish at wildly different steps. The scheduler therefore
    tracks a fixed array of SLOTS (the decode step's batch rows): a
    finished sequence vacates its slot mid-batch and the next queued
    request is admitted into the hole without stopping the slots still
    running — CONTINUOUS batching. `admission="drain"` is the deliberate
    strawman (refill only when every slot is empty — the classic
    drain-and-refill baseline).

    Admission control: a bounded pending queue with fast-reject
    (QueueFullError) and queued-deadline expiry. The decode
    engine owns WHAT runs in a slot; the scheduler owns which slots run.
    """

    def __init__(self, n_slots: int, max_queue: int = 256,
                 admission: str = "continuous"):
        if admission not in ("continuous", "drain"):
            raise ValueError(
                f"admission must be 'continuous' or 'drain', "
                f"got {admission!r}")
        self.n_slots = int(n_slots)
        self.admission = admission
        self.max_queue = int(max_queue)
        self.cond = threading.Condition()
        self.slots: List[Optional[object]] = [None] * self.n_slots
        self.pending: deque = deque()

    # -- producer side (locked by callers via self.cond) ------------------

    def submit_locked(self, item) -> None:
        if len(self.pending) >= self.max_queue:
            raise QueueFullError(
                f"{len(self.pending)} generations already queued "
                f"(max_queue={self.max_queue}) — retry with backoff")
        self.pending.append(item)
        self.cond.notify_all()

    # -- engine side ------------------------------------------------------

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def expire_locked(self, predicate) -> List[object]:
        """Pop every pending item for which `predicate(item)` is true
        (queued-deadline sweep)."""
        dead = [r for r in self.pending if predicate(r)]
        if dead:
            self.pending = deque(r for r in self.pending
                                 if not predicate(r))
        return dead

    # continuous-admission hysteresis: at full occupancy roughly one slot
    # frees per decode step, and admitting it alone costs a whole
    # single-row prefill step per decode step — measured to HALVE decode
    # throughput at deep-queue saturation. Waiting for a 2-slot admission
    # batch amortizes the prefill without hurting the underutilized case
    # (when fewer requests than this are waiting, admission is immediate).
    ADMIT_BATCH = 2

    def admissible_locked(self) -> List[int]:
        """Free slot indices the policy allows filling right now."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not self.pending or not free:
            return []
        if self.admission == "drain" and self.active_count():
            return []     # the strawman: wait for the whole batch
        want = min(self.ADMIT_BATCH, len(self.pending), self.n_slots)
        if self.admission == "continuous" and len(free) < want:
            return []     # let a small admission batch accumulate
        return free

    def occupy_locked(self, slot: int, state) -> None:
        assert self.slots[slot] is None
        self.slots[slot] = state

    def vacate_locked(self, slot: int) -> None:
        self.slots[slot] = None
        self.cond.notify_all()
