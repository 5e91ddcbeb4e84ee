"""Trainer-side heartbeat: renew a liveness lease on every pserver.

Mirror of ``paddle_tpu/ark/heartbeat.py``, copied.

The server half lives in `pserver/server.py` (`_h_heartbeat` + the
`LeaseTable`-backed `EvictingBarrier`); this is the client half — a
daemon thread that renews the lease at `lease_s / 3` so two consecutive
losses still leave slack before expiry (the classic lease-renewal rule).
Heartbeats ride the normal RPC path with a SHORT deadline: a wedged
pserver must not wedge the heartbeat loop, and a missed beat is counted,
not raised — liveness signaling is best-effort by design.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


class HeartbeatThread:
    """Renews `trainer_id`'s lease on every endpoint until `stop()`.

    `lease_s` is the server-side lease duration; the renewal interval
    defaults to a third of it. Failures are swallowed (and metered when
    `observe` is on): the lease simply expires if the server is gone,
    which is exactly the signal the eviction path wants.

    fluid-fleet reuse: pass `beat=<callable>` instead of a
    client/endpoints pair to renew an arbitrary lease (a serving replica
    renewing its membership lease on the router) on the same
    interval/failure-swallowing contract — the callable does one renewal
    and raises on failure."""

    def __init__(self, client=None, endpoints: Sequence[str] = (),
                 trainer_id: int = 0, session=None, lease_s: float = 3.0,
                 interval: Optional[float] = None, beat=None,
                 quorum=None, quorum_resource: Optional[str] = None,
                 quorum_holder=None):
        if beat is None and client is None:
            raise ValueError("HeartbeatThread needs a client+endpoints "
                             "pair or a beat callable")
        self.client = client
        self.endpoints = list(endpoints)
        self.trainer_id = int(trainer_id)
        self.session = session
        self.lease_s = float(lease_s)
        self.interval = float(interval) if interval else self.lease_s / 3.0
        self._beat = beat
        # fluid-quorum opt-in: each renewal round ALSO asserts this
        # member's own lease at the arbiter group (resource/holder
        # default to the QuorumLeaseTable convention `member:<id>` /
        # `str(id)`; fleet replicas pass their own), so a lease table
        # with quorum backing can tell "member died" from "my link to
        # the member died". Best-effort like every beat — and ordered
        # AFTER the member beats with a failure backoff, so a degraded
        # quorum can never starve the real renewals past the lease.
        self.quorum = quorum
        self.quorum_resource = quorum_resource or f"member:{trainer_id}"
        self.quorum_holder = (str(quorum_holder)
                              if quorum_holder is not None
                              else str(trainer_id))
        self._quorum_lease = None
        self._quorum_retry_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatThread":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"heartbeat[trainer={self.trainer_id}]")
        self._thread.start()
        return self

    def beat_once(self) -> int:
        """One renewal round, all endpoints CONCURRENTLY (the client's
        per-endpoint pool); returns how many acknowledged. With a
        custom `beat` callable, one invocation (miss swallowed + metered
        under endpoint="custom", same contract). Concurrency
        matters: renewed serially, one blackholed pserver's deadline
        would delay renewals to the healthy ones past the lease and get
        this live trainer falsely evicted. Used synchronously at startup
        so the lease exists before the first sync barrier."""
        if self._beat is not None:
            try:
                self._beat()
                return 1
            except Exception as e:
                from .. import flags as _flags
                from ..observe import metrics as _metrics
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "ark_heartbeat_misses_total",
                        "heartbeat renewals that failed").inc(
                            endpoint="custom")
                logger.debug("custom heartbeat failed: %s", e)
                return 0
            finally:
                # quorum lease AFTER the member beat: a degraded
                # arbiter group (blackholed nodes eating their full
                # deadlines) must not delay the renewal the lease-table
                # owner is actually waiting for
                self._quorum_beat()
        futs = {ep: self.client._pool.submit(
                    self.client.heartbeat, ep, trainer_id=self.trainer_id,
                    session=self.session, lease_s=self.lease_s)
                for ep in self.endpoints}
        ok = 0
        for ep, f in futs.items():
            try:
                f.result()
                ok += 1
            except Exception as e:
                from .. import flags as _flags
                from ..observe import flight as _flight
                from ..observe import metrics as _metrics
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "ark_heartbeat_misses_total",
                        "heartbeat renewals that failed").inc(endpoint=ep)
                    _flight.note("heartbeat_miss", endpoint=ep,
                                 trainer_id=self.trainer_id,
                                 error=type(e).__name__)
                logger.debug("heartbeat to %s failed: %s", ep, e)
        self._quorum_beat()   # after the member beats (see __init__)
        return ok

    def _quorum_beat(self) -> None:
        """Renew (or first campaign for) this member's own quorum
        lease. `quorum_holder` identifies the member, so a
        `QuorumLeaseTable` can verify identity; a failed round is
        swallowed, metered, and BACKED OFF for a lease period — on the
        minority side of a partition, renew+campaign rounds wait out
        blackholed arbiters' deadlines, and repeating that every beat
        would stall the loop's real renewals (the false eviction this
        mechanism exists to prevent). The lease simply expires at the
        arbiters in the meantime, which is the honest signal."""
        import time as _time

        if self.quorum is None or _time.monotonic() < self._quorum_retry_at:
            return
        try:
            lease = self._quorum_lease
            if lease is not None and self.quorum.renew(lease):
                return
            self._quorum_lease = self.quorum.campaign(
                self.quorum_resource, self.quorum_holder, self.lease_s,
                max_rounds=1)
            if self._quorum_lease is None:
                self._quorum_retry_at = _time.monotonic() + self.lease_s
        except Exception as e:   # noqa: BLE001 — best-effort by contract
            from .. import flags as _flags
            from ..observe import metrics as _metrics
            self._quorum_retry_at = _time.monotonic() + self.lease_s
            if _flags.get_flag("observe"):
                _metrics.counter(
                    "ark_heartbeat_misses_total",
                    "heartbeat renewals that failed").inc(
                        endpoint="quorum")
            logger.debug("quorum member lease renewal failed: %s", e)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.beat_once()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
