"""Trainer liveness: heartbeat leases + an evicting sync barrier.

Mirror of ``paddle_tpu/ark/liveness.py``, copied.

Capability parity rationale: the reference's sync pserver
(listen_and_serv_op.cc RunSyncLoop) wedges the batch barrier until every
registered trainer arrives — a dead trainer stalls the world until an RPC
deadline fires. TensorFlow (Abadi et al., 2016) and every production PS
design solve this with leases: trainers renew a heartbeat lease, and the
barrier counts only live leaseholders, degrading gracefully to N-1
trainers when one dies instead of blocking on `sync_timeout`.

`LeaseTable` is the server-side liveness record; `EvictingBarrier`
replaces `threading.Barrier` for the sync-apply path — same
`wait/broken/reset` surface (it raises `threading.BrokenBarrierError` so
existing recovery code is unchanged) plus `evict`/`readmit`, with party
membership re-checked while waiting via an `evict_check` callback.
Trainers that never heartbeat hold no lease and are never evicted: the
legacy full-party/sync-timeout behavior is preserved for them.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

BrokenBarrierError = threading.BrokenBarrierError


class LeaseTable:
    """Per-member heartbeat leases: `beat` renews, `expired` lists
    leaseholders past their expiry. A member is only ever evictable
    after it has held a lease — unknown members are not tracked.

    Member ids are integers on the trainer path (trainer_id over the
    pserver RPC) and strings on the fluid-fleet path (replica ids like
    ``"r0@127.0.0.1:4471"`` heartbeating the serving router); `_key`
    keeps the legacy int coercion for numeric ids (np.int64 over the
    wire) while passing strings through untouched."""

    @staticmethod
    def _key(member):
        return member if isinstance(member, str) else int(member)

    def __init__(self):
        self._lock = threading.Lock()
        # member id -> (session, expires_at_monotonic, lease_s)
        self._leases: Dict[object, Tuple[object, float, float]] = {}

    def beat(self, trainer_id, session=None,
             lease_s: float = 3.0) -> None:
        with self._lock:
            self._leases[self._key(trainer_id)] = (
                session, time.monotonic() + float(lease_s), float(lease_s))

    def session_of(self, trainer_id):
        with self._lock:
            rec = self._leases.get(self._key(trainer_id))
            return rec[0] if rec else None

    def live(self) -> Iterable:
        now = time.monotonic()
        with self._lock:
            return [t for t, (_s, exp, _l) in self._leases.items()
                    if exp > now]

    def expired(self) -> Iterable:
        now = time.monotonic()
        with self._lock:
            return [t for t, (_s, exp, _l) in self._leases.items()
                    if exp <= now]

    def forget(self, trainer_id) -> None:
        with self._lock:
            self._leases.pop(self._key(trainer_id), None)

    def snapshot(self) -> Dict[int, Dict]:
        now = time.monotonic()
        with self._lock:
            return {t: {"session": s, "lease_s": l,
                        "expires_in_s": round(exp - now, 3),
                        "live": exp > now}
                    for t, (s, exp, l) in self._leases.items()}


class QuorumLeaseTable(LeaseTable):
    """fluid-quorum opt-in backing for membership leases: before a
    member whose LOCAL lease lapsed is reported expired, the arbiter
    group gets a second opinion. A member that lost its path to the
    table's owner (an asymmetric partition: replica <-> router cut,
    trainer <-> pserver cut) but still renews its own quorum lease at
    the arbiters is ALIVE — evicting it would shrink the world for a
    link failure, the exact false positive the crash-stop model could
    not exclude.

    Members renew their quorum lease themselves (`HeartbeatThread`'s
    `quorum=` option — resource `<prefix><member id>`, holder = the
    member id). Arbiter answers are cached for `status_ttl_s` so the
    eviction poll loop (~10 Hz while a barrier waits) does not hammer
    the group. Without a quorum client this IS a plain `LeaseTable`,
    bit for bit."""

    def __init__(self, quorum=None, resource_prefix: str = "member:",
                 status_ttl_s: float = 1.0):
        super().__init__()
        self.quorum = quorum
        self.resource_prefix = str(resource_prefix)
        self.status_ttl_s = float(status_ttl_s)
        self._q_cache: Dict[object, Tuple[float, bool]] = {}
        self._q_inflight: set = set()

    def _quorum_probe(self, key) -> bool:
        try:
            rec = self.quorum.holder(f"{self.resource_prefix}{key}")
            live = bool(rec and str(rec.get("holder")) == str(key))
        except Exception:   # noqa: BLE001 — unreachable arbiters add no
            live = False    # liveness evidence; the local verdict stands
        with self._lock:
            self._q_cache[key] = (time.monotonic(), live)
            self._q_inflight.discard(key)
            while len(self._q_cache) > 4096:
                self._q_cache.pop(next(iter(self._q_cache)))
        return live

    def _quorum_live(self, member, blocking: bool = True) -> bool:
        """The arbiters' opinion of `member`, cached `status_ttl_s`.
        `blocking=False` (the router's per-request dispatch path) never
        waits on an arbiter fan-out: a stale cached verdict is served
        while ONE background probe per member refreshes it, and an
        unknown member reads False (plain-table behavior) until the
        first probe lands — the holder() deadline must not become a
        recurring p99 spike on the serving hot path. Eviction decisions
        (`expired()`, a poll-loop context) stay blocking."""
        if self.quorum is None:
            return False
        key = self._key(member)
        now = time.monotonic()
        with self._lock:
            hit = self._q_cache.get(key)
            if hit is not None and now - hit[0] < self.status_ttl_s:
                return hit[1]
            if not blocking:
                stale = hit[1] if hit is not None else False
                if key not in self._q_inflight:
                    self._q_inflight.add(key)
                    threading.Thread(
                        target=self._quorum_probe, args=(key,),
                        daemon=True,
                        name=f"quorum-probe:{key}").start()
                return stale
        return self._quorum_probe(key)

    def expired(self) -> Iterable:
        return [t for t in super().expired() if not self._quorum_live(t)]

    def live(self) -> Iterable:
        """Locally-live members PLUS locally-expired ones the arbiters
        still vouch for (the fleet router's membership view: a replica
        the router cannot hear from directly stays a member; whether it
        can take traffic is the readiness poll's separate verdict).
        Non-blocking by design — this sits on the router's dispatch
        path (see `_quorum_live`)."""
        out = list(super().live())
        if self.quorum is not None:
            out += [t for t in super().expired()
                    if self._quorum_live(t, blocking=False)]
        return out

    def snapshot(self) -> Dict[int, Dict]:
        snap = super().snapshot()
        if self.quorum is not None:
            for t, rec in snap.items():
                if not rec["live"]:
                    rec["quorum_live"] = self._quorum_live(t)
        return snap


class EvictingBarrier:
    """A cyclic barrier over `parties` members whose effective party
    count shrinks when members are evicted (and grows back on readmit).

    `wait(timeout, evict_check, poll)` blocks until `arrived >= parties -
    evicted`; while blocked it invokes `evict_check()` every `poll`
    seconds so the owner can expire leases — an eviction that satisfies
    the barrier releases the waiters immediately rather than after
    `timeout`. The completing waiter runs `action` exactly once per
    generation before any waiter is released (threading.Barrier's action
    contract). On timeout the barrier breaks for the current generation:
    all of its waiters raise `threading.BrokenBarrierError` and new
    arrivals are refused until `reset()`."""

    def __init__(self, parties: int, action: Optional[Callable] = None):
        # RLock so evict_check callbacks may call evict()/live_parties
        # re-entrantly from inside wait()
        self._cond = threading.Condition(threading.RLock())
        self._full = int(parties)
        self._action = action
        self._evicted: set = set()
        # fluid-elastic scale-UP: members admitted via join() while a
        # generation is in flight wait here until the generation
        # boundary — the world never grows mid-batch; _joined remembers
        # landed admissions so a replayed join can never double-grow
        self._joining: set = set()
        self._joined: set = set()
        self._arrived = 0
        # members that identified themselves on arrival this generation:
        # evicting one of them must DISCOUNT its arrival, or the barrier
        # would release before the remaining live parties all arrive
        self._arrived_members: list = []
        self._gen = 0
        self._broken = False
        self._gen_status: Dict[int, str] = {}  # gen -> "done" | "broken"

    @property
    def parties(self) -> int:
        return self._full

    @property
    def live_parties(self) -> int:
        with self._cond:
            return self._full - len(self._evicted)

    @property
    def evicted(self) -> frozenset:
        with self._cond:
            return frozenset(self._evicted)

    @property
    def broken(self) -> bool:
        with self._cond:
            return self._broken

    def join(self, member) -> bool:
        """Grow the sync world by a NEW member (fluid-elastic scale-UP):
        admission lands at the NEXT generation boundary, never
        mid-batch — an in-flight generation's threshold is unchanged,
        and the joiner's arrival starts counting only once every member
        of the grown world can arrive too. An idle barrier (no arrivals
        this generation) admits immediately. Joining a member that was
        EVICTED is a readmit (the party count it once held grows back).
        Returns True when membership changed."""
        with self._cond:
            if member in self._evicted:
                self._evicted.discard(member)
                self._cond.notify_all()
                return True
            if member in self._joining or member in self._joined:
                return False               # replayed join: no double-grow
            if self._arrived == 0:
                self._full += 1
                self._joined.add(member)
                self._cond.notify_all()
            else:
                self._joining.add(member)
            return True

    def evict(self, member) -> bool:
        """Shrink the live party count by `member`; returns True when the
        eviction is new. If the member already ARRIVED this generation
        (identified wait), its arrival is discounted too — the shrunken
        threshold must be met by live arrivals only. Waiters re-check
        completion immediately."""
        with self._cond:
            if member in self._joining:
                # admitted-then-died before any generation boundary:
                # land the admission and evict it in ONE move (+1 full,
                # +1 evicted — the live count never moved), so a later
                # heartbeat READMITS it like any evicted member instead
                # of leaving it stranded outside every membership set
                # (where its arrivals would count as ghosts against a
                # threshold that never included it)
                self._joining.discard(member)
                self._full += 1
                self._joined.add(member)
                self._evicted.add(member)
                self._cond.notify_all()
                return True
            if member in self._evicted:
                return False
            if len(self._evicted) + 1 >= self._full:
                # never evict the last live party: an all-dead barrier is
                # a broken barrier, not a 0-party no-op
                return False
            self._evicted.add(member)
            if member in self._arrived_members:
                self._arrived_members.remove(member)
                self._arrived -= 1
            self._cond.notify_all()
            return True

    def readmit(self, member) -> bool:
        with self._cond:
            if member not in self._evicted:
                return False
            self._evicted.discard(member)
            return True

    def reset(self) -> None:
        """Clear a broken state; evictions persist (the dead stay dead
        until they heartbeat back in via `readmit`)."""
        with self._cond:
            self._broken = False
            self._arrived = 0
            self._arrived_members.clear()
            self._cond.notify_all()

    def _finish(self, gen: int, status: str) -> None:
        # caller holds the lock
        self._gen_status[gen] = status
        while len(self._gen_status) > 64:   # bound: waiters are short-lived
            self._gen_status.pop(next(iter(self._gen_status)))
        self._gen += 1
        self._arrived = 0
        self._arrived_members.clear()
        if self._joining:
            # the generation boundary: deferred admissions land now
            self._full += len(self._joining)
            self._joined |= self._joining
            self._joining.clear()
        if status == "broken":
            self._broken = True
        self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None,
             evict_check: Optional[Callable] = None,
             poll: float = 0.1, member=None) -> int:
        """`member`, when given, identifies this arrival so `evict` can
        discount it; anonymous arrivals always count toward the
        threshold (legacy behavior)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            if self._broken:
                raise BrokenBarrierError
            gen = self._gen
            if member is not None and (member in self._evicted
                                       or member in self._joining):
                # a zombie arrival (evicted member not yet readmitted)
                # or a joiner awaiting its admission boundary must not
                # count toward the live threshold; it just waits out
                # the generation
                pass
            else:
                self._arrived += 1
                if member is not None:
                    self._arrived_members.append(member)
            while True:
                if evict_check is not None:
                    evict_check()   # may call self.evict() (RLock)
                status = self._gen_status.get(gen)
                if status == "done":
                    return gen
                if status == "broken":
                    raise BrokenBarrierError
                if self._gen == gen and \
                        self._arrived >= self._full - len(self._evicted):
                    try:
                        if self._action is not None:
                            self._action()
                    except BaseException:
                        self._finish(gen, "broken")
                        raise
                    self._finish(gen, "done")
                    return gen
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self._finish(gen, "broken")
                    raise BrokenBarrierError
                slice_ = poll if evict_check is not None else remaining
                if remaining is not None:
                    slice_ = remaining if slice_ is None \
                        else min(slice_, remaining)
                self._cond.wait(slice_)
