"""Majority-lease client: campaign / renew / resign against an arbiter
group.

The safety argument, end to end:

- **one grant per epoch per node** (node-side, persisted): two
  concurrent campaigns can never both collect a strict majority at one
  epoch, because each node's vote for that epoch is spent exactly once
  and the two vote sets would have to overlap;
- **strictly increasing epochs**: a campaign first polls the reachable
  nodes' persisted maxima and bids max+1, and a node rejects any bid at
  or below its own maximum — so every successful election's epoch
  exceeds every epoch any earlier majority granted (the two majorities
  intersect in at least one node, and that node's persisted maximum
  fences the stale bid);
- **renew fails closed**: `renew()` returns True only with a strict
  majority of acks. A holder that cannot renew must treat its lease as
  dying and stop accepting writes no later than `lease.expires` — the
  arbiters will let a rival campaign through after that instant, never
  before (they refuse campaigns while a live rival record exists).

A failed campaign best-effort resigns the minority of grants it did
collect, so a lost race does not force the real winner to wait out a
stray lease. All calls fan out concurrently with short per-node
deadlines: one blackholed arbiter must not stall a renewal past the
lease (`ark.chaos.NetPartition` drills exactly this).
"""

from __future__ import annotations

import logging
import socket as _socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from .. import flags as _flags
from ..ark import chaos as _chaos
from ..observe import flight as _flight
from ..observe import metrics as _metrics

logger = logging.getLogger(__name__)

GRANTS_METRIC = "quorum_grants_total"
EPOCH_METRIC = "quorum_lease_epoch"
UNREACHABLE_METRIC = "quorum_arbiter_unreachable_total"
LEASE_OK_METRIC = "quorum_lease_ok"
MAJORITY_METRIC = "quorum_majority_acks"


class QuorumUnavailable(RuntimeError):
    """No strict majority of arbiter nodes answered."""


class QuorumLease:
    """A held lease: the resource, this holder's id (by convention the
    server's own endpoint, so `holder` doubles as a routable address for
    `PSClient` re-resolution), the fencing epoch, and the local expiry
    estimate (`granted_at + lease_s` on OUR monotonic clock — the
    conservative side of every arbiter's own expiry, which started
    later)."""

    __slots__ = ("resource", "holder", "epoch", "lease_s", "expires")

    def __init__(self, resource: str, holder: str, epoch: int,
                 lease_s: float, granted_at: float):
        self.resource = resource
        self.holder = holder
        self.epoch = int(epoch)
        self.lease_s = float(lease_s)
        self.expires = granted_at + float(lease_s)

    @property
    def live(self) -> bool:
        return time.monotonic() < self.expires

    def __repr__(self):
        return (f"QuorumLease({self.resource!r} -> {self.holder!r} "
                f"@e{self.epoch}, {'live' if self.live else 'EXPIRED'})")


class QuorumClient:
    """Thin fan-out client over an arbiter group. One socket per node,
    re-connected on failure; every logical operation talks to ALL nodes
    concurrently and counts acks against `majority` (strict: n//2+1)."""

    def __init__(self, endpoints: Sequence[str], deadline_s: float = 1.0,
                 connect_timeout_s: float = 0.5,
                 actor: Optional[str] = None):
        from ..pserver import rpc
        self._rpc = rpc
        # chaos attribution: which logical process OWNS this client.
        # Fan-out worker threads are shared, so without an explicit
        # actor a NetPartition rule against the owner's endpoint could
        # not see its quorum traffic (see ark/chaos.py actor identity).
        self.actor = actor
        self.endpoints = list(endpoints)
        if not self.endpoints:
            raise ValueError("QuorumClient needs at least one arbiter "
                             "endpoint")
        self.majority = len(self.endpoints) // 2 + 1
        self.deadline_s = float(deadline_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._socks: Dict[str, _socket.socket] = {}      # guarded_by: self._lock
        self._ep_locks: Dict[str, threading.Lock] = {}   # guarded_by: self._lock
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self.endpoints)),
            thread_name_prefix="quorum-client")

    # -- transport --------------------------------------------------------
    def _sock(self, ep):
        with self._lock:
            s = self._socks.get(ep)
        if s is None:
            s = self._rpc.connect(ep, timeout=self.connect_timeout_s)
            with self._lock:
                self._socks[ep] = s
        return s

    def _drop(self, ep):
        with self._lock:
            s = self._socks.pop(ep, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _call_node(self, ep: str, cmd: str, payload: dict):
        """One request/reply against one node, bounded by `deadline_s`.
        Every quorum command is idempotent (grants re-ack, renews
        refresh, resigns no-op), so one blind retry on a stale cached
        socket is safe."""
        with _chaos.acting_as(self.actor or _chaos.current_actor()):
            return self._call_node_impl(ep, cmd, payload)

    def _call_node_impl(self, ep: str, cmd: str, payload: dict):
        # ONE in-flight request per node connection: the renewer
        # thread, a concurrent handover resign, and PSClient failover
        # holder() lookups may share this client — without the lock
        # their frames would interleave on the cached socket and each
        # would read the other's reply as its own verdict
        with self._lock:
            ep_lock = self._ep_locks.setdefault(ep, threading.Lock())
        last = None
        with ep_lock:
            for attempt in range(2):
                try:
                    s = self._sock(ep)
                    s.settimeout(self.deadline_s)
                    self._rpc.send_msg(s, (cmd, payload))
                    status, value = self._rpc.recv_msg(s)
                    s.settimeout(None)
                    if status != "ok":
                        raise RuntimeError(f"quorum {ep} {cmd}: {value}")
                    return value
                except (ConnectionError, EOFError, OSError,
                        _socket.timeout) as e:
                    self._drop(ep)
                    last = e
                    if isinstance(e, TimeoutError):
                        # a full deadline elapsed: the node is slow or
                        # blackholed, not a stale socket — a blind
                        # second deadline would stall the whole round
                        break
        if _flags.get_flag("observe"):
            _metrics.counter(
                UNREACHABLE_METRIC,
                "arbiter nodes unreachable per quorum operation").inc(
                    endpoint=ep, cmd=cmd)
        raise QuorumUnavailable(f"arbiter {ep} unreachable for {cmd}: "
                                f"{type(last).__name__}: {last}")

    def _fanout(self, cmd: str, payload: dict) -> Dict[str, object]:
        """cmd against every node concurrently; returns ep -> reply for
        the nodes that answered (unreachable nodes are simply absent)."""
        futs = {ep: self._pool.submit(self._call_node, ep, cmd,
                                      dict(payload))
                for ep in self.endpoints}
        out = {}
        for ep, f in futs.items():
            try:
                out[ep] = f.result()
            except (QuorumUnavailable, RuntimeError) as e:
                logger.debug("quorum node %s: %s", ep, e)
        return out

    # -- operations -------------------------------------------------------
    def campaign(self, resource: str, candidate: str, lease_s: float,
                 max_rounds: int = 3) -> Optional[QuorumLease]:
        """Try to win the lease on `resource`. Returns the lease on a
        strict-majority grant, or None when the election is lost (a
        rival holds it, this side is in a minority partition, or every
        round's epoch bid was stale). Raises QuorumUnavailable only when
        NO node answered at all."""
        epoch_bid = 0
        for _round in range(max_rounds):
            t0 = time.monotonic()
            views = self._fanout("q_epoch", {"resource": resource})
            if not views:
                self._meter_grant("unreachable")
                raise QuorumUnavailable(
                    f"campaign({resource!r}): no arbiter reachable")
            epoch_bid = max(epoch_bid,
                            max(int(v["epoch"]) for v in views.values())
                            ) + 1
            replies = self._fanout(
                "q_campaign", {"resource": resource, "candidate": candidate,
                               "epoch": epoch_bid, "lease_s": lease_s})
            grants = [ep for ep, v in replies.items() if v.get("granted")]
            if len(grants) >= self.majority:
                lease = QuorumLease(resource, candidate, epoch_bid,
                                    lease_s, granted_at=t0)
                self._meter_grant("granted", resource=resource,
                                  epoch=epoch_bid)
                _flight.note("quorum_grant", resource=resource,
                             holder=candidate, epoch=epoch_bid,
                             acks=len(grants))
                return lease
            # lost: release the minority grants so the real winner is
            # not blocked on our stray records, then decide whether a
            # higher bid could still win
            for ep in grants:
                try:
                    self._call_node(ep, "q_resign",
                                    {"resource": resource,
                                     "holder": candidate,
                                     "epoch": epoch_bid})
                except (QuorumUnavailable, RuntimeError):
                    pass
            reasons = {str(v.get("reason")) for v in replies.values()
                       if not v.get("granted")}
            if "held" in reasons or "boot_blackout" in reasons \
                    or not replies:
                # a live rival (or a blacked-out node) — retrying at a
                # higher epoch cannot help until their lease expires
                self._meter_grant(
                    "rejected" if "held" in reasons else "no_majority",
                    resource=resource)
                return None
            # stale_epoch everywhere reachable: re-poll and re-bid
            epoch_bid = max(
                [epoch_bid] + [int(v.get("epoch", 0))
                               for v in replies.values()])
        self._meter_grant("no_majority", resource=resource)
        return None

    def renew(self, lease: QuorumLease) -> bool:
        """Refresh `lease` on a strict majority. True extends
        `lease.expires` from the renewal's START instant (conservative);
        False means FAIL CLOSED — the holder must stop accepting writes
        by `lease.expires` at the latest."""
        t0 = time.monotonic()
        replies = self._fanout(
            "q_renew", {"resource": lease.resource, "holder": lease.holder,
                        "epoch": lease.epoch, "lease_s": lease.lease_s})
        acks = sum(1 for v in replies.values() if v.get("renewed"))
        fenced = any(str(v.get("reason")) == "fenced"
                     for v in replies.values() if not v.get("renewed"))
        if _flags.get_flag("observe"):
            _metrics.gauge(
                MAJORITY_METRIC,
                "arbiter acks on the most recent renew, per resource"
            ).set(float(acks), resource=lease.resource)
        if acks >= self.majority:
            lease.expires = t0 + lease.lease_s
            self._set_lease_ok(lease.resource, True, lease.epoch)
            return True
        self._set_lease_ok(lease.resource, False, lease.epoch)
        _flight.note("quorum_renew_failed", resource=lease.resource,
                     holder=lease.holder, epoch=lease.epoch, acks=acks,
                     fenced=fenced)
        return False

    def resign(self, lease: QuorumLease) -> None:
        self._fanout("q_resign", {"resource": lease.resource,
                                  "holder": lease.holder,
                                  "epoch": lease.epoch})
        self._set_lease_ok(lease.resource, None, lease.epoch)

    def holder(self, resource: str) -> Optional[dict]:
        """Best-effort view of who holds `resource`: the live record at
        the highest lease epoch among the reachable nodes, provided at
        least a majority of nodes answered (a minority view may be
        arbitrarily stale). Used by `PSClient` to find a shard's primary
        without guessing candidate endpoints."""
        replies = self._fanout("q_status", {"resource": resource})
        if len(replies) < self.majority:
            return None
        best = None
        for v in replies.values():
            if v.get("live") and v.get("holder"):
                if best is None or int(v["lease_epoch"]) > best["epoch"]:
                    best = {"holder": v["holder"],
                            "epoch": int(v["lease_epoch"])}
        return best

    def status(self, resource: str) -> List[dict]:
        """Raw per-node status rows (operator/debugging surface)."""
        return [dict(v, endpoint=ep)
                for ep, v in self._fanout("q_status",
                                          {"resource": resource}).items()]

    # -- metrics ----------------------------------------------------------
    def _meter_grant(self, outcome: str, resource: str = "",
                     epoch: int = 0):
        if not _flags.get_flag("observe"):
            return
        _metrics.counter(
            GRANTS_METRIC,
            "quorum campaign outcomes (granted / rejected / no_majority "
            "/ unreachable)").inc(outcome=outcome)
        if outcome == "granted" and resource:
            _metrics.gauge(
                EPOCH_METRIC,
                "fencing epoch of the most recent quorum grant, per "
                "resource").set(float(epoch), resource=resource)

    def _set_lease_ok(self, resource: str, ok=None, epoch: int = 0):
        if not _flags.get_flag("observe"):
            return
        g = _metrics.gauge(
            LEASE_OK_METRIC,
            "1 while a held quorum lease renews against a majority, 0 "
            "while renewal is failing (the quorum_loss detector's "
            "series)")
        if ok is None:
            g.set(1.0, resource=resource)   # resigned: not a loss
        else:
            g.set(1.0 if ok else 0.0, resource=resource)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            socks = list(self._socks.values())
            self._socks.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
