"""Master client: trainers pull task leases and stream records.

Capability parity with the reference Go client (reference:
go/master/client.go — GetTask/TaskFinished RPC, NextRecord :244 which
streams records out of the leased chunks; python ctypes wrapper
python/paddle/v2/master/client.py:29). Mirror of
``paddle_tpu/master/client.py``, copied: the wire carries builtins, and
`records(load_chunk)` makes each record on the trainer's side.

fluid-elastic hardening: every call rides an ark `RetryPolicy`
(bounded exponential backoff + jitter, optional per-call deadline) so
a connection blip or a master restart is not a trainer death, and the
client FAILS OVER — a `redirect` reply (standby / fenced / deposed
master) or transport death of every known endpoint triggers
re-resolution of the RULING master: the configured standbys are polled
via `ha_status`, and with `quorum_endpoints` the arbiters themselves
are asked who holds the master lease (the holder id is the primary's
endpoint by convention), exactly like `PSClient` resolves a shard's
primary. The resolution loop waits out an in-flight promotion up to
`failover_s`.

Replay safety on this plane comes from the task-lease semantics, not
from a wire watermark: `task_finished`/`task_failed`/`task_returned`
are settlement-idempotent (a replayed settle of an already-settled
lease reads as stale and changes nothing), and a `get_task` whose
reply was lost merely strands one lease that times out and re-issues
under the task's failure budget — the documented duplicate-delivery
source. So every command retries through transport failures.
"""

from __future__ import annotations

import socket as _socket
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from .. import flags as _flags
from ..ark.retry import RetryPolicy
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from ..pserver import rpc


class MasterClient:
    def __init__(self, endpoint: str, retry_interval: float = 0.5,
                 retry: Optional[RetryPolicy] = None,
                 deadline: Optional[float] = None,
                 standbys: Sequence[str] = (),
                 quorum_endpoints: Optional[Sequence[str]] = None,
                 quorum_resource: str = "master",
                 failover_s: float = 20.0):
        self.endpoint = endpoint
        self.retry_interval = retry_interval
        self.retry = retry if retry is not None else RetryPolicy()
        self.deadline = deadline if deadline is not None \
            else self.retry.deadline
        self.standbys = list(standbys)
        self.failover_s = float(failover_s)
        self._quorum_eps = list(quorum_endpoints or ())
        self._quorum_resource = quorum_resource
        self._quorum_client = None
        self._primary: Optional[str] = None   # ruling endpoint override
        self._sock = None                     # guarded_by: self._lock
        self._sock_ep: Optional[str] = None   # guarded_by: self._lock
        self._lock = threading.Lock()

    # -- transport ---------------------------------------------------------
    def _close_sock_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._sock_ep = None

    def _call_one(self, ep, cmd, payload, deadline):
        """One logical request against one endpoint, with the retry
        policy's backoff across transport failures. Caller holds no
        lock; socket state is guarded here."""
        policy = self.retry
        deadline_at = None if deadline is None \
            else time.monotonic() + deadline
        attempt = 0
        obs = _flags.get_flag("observe")
        while True:
            # fluid-horizon: one span context PER ATTEMPT (child of the
            # ambient trainer-step/caller span when one is active), sent
            # as the frame's optional third element so the master
            # handler's span parents here — retries are then distinct
            # child spans, not one blurred edge.
            att_ctx = _xray.child_of() if obs else None
            att_ts = time.time() if obs else 0.0
            att_t0 = time.perf_counter() if obs else 0.0
            try:
                # The lock covers exactly one request/response exchange:
                # the send/recv pair must be atomic on the shared socket,
                # but backoff between attempts must not hold it.
                with self._lock:
                    if self._sock is None or self._sock_ep != ep:
                        self._close_sock_locked()
                        remaining = 30.0 if deadline_at is None else \
                            max(0.05, deadline_at - time.monotonic())
                        self._sock = rpc.connect(ep, timeout=remaining)  # race_lint: ignore[blocking-under-lock] — single-connection wire serialization; the lock IS the socket's mutual exclusion
                        self._sock_ep = ep
                    if deadline_at is not None:
                        self._sock.settimeout(
                            max(0.05, deadline_at - time.monotonic()))
                    frame = (cmd, payload) if att_ctx is None else \
                        (cmd, payload, _xray.to_wire(att_ctx))
                    rpc.send_msg(self._sock, frame)  # race_lint: ignore[blocking-under-lock] — request/response pair must be atomic on the shared socket
                    status, value = rpc.recv_msg(self._sock)  # race_lint: ignore[blocking-under-lock] — request/response pair must be atomic on the shared socket
                    if deadline_at is not None:
                        self._sock.settimeout(None)
                    if att_ctx is not None:
                        _xray.record_span(
                            f"master_client:{cmd}", att_ctx, att_ts,
                            time.perf_counter() - att_t0, cat="rpc",
                            cmd=cmd, endpoint=ep, status=status)
                    return status, value
            except (ConnectionError, EOFError, OSError,
                    _socket.timeout) as e:
                if att_ctx is not None:
                    _xray.record_span(
                        f"master_client:{cmd}", att_ctx, att_ts,
                        time.perf_counter() - att_t0, cat="rpc",
                        cmd=cmd, endpoint=ep, error=type(e).__name__)
                with self._lock:
                    self._close_sock_locked()
                out_of_time = deadline_at is not None and \
                    time.monotonic() >= deadline_at
                if attempt >= policy.max_attempts or out_of_time:
                    raise
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "master_client_retries_total",
                        "master RPC attempts replayed after a "
                        "transport failure").inc(cmd=cmd)
                delay = policy.backoff(attempt)
                attempt += 1
                if deadline_at is not None:
                    delay = min(delay, max(
                        0.0, deadline_at - time.monotonic()))
                if delay:
                    time.sleep(delay)

    def _call(self, cmd, _deadline=..., **payload):
        if _deadline is ...:
            _deadline = self.deadline
        for _hop in range(4):
            ep = self._primary or self.endpoint
            try:
                status, value = self._call_one(ep, cmd, payload, _deadline)
            except (ConnectionError, EOFError, OSError, _socket.timeout):
                if self._resolve_master():
                    if _flags.get_flag("observe"):
                        _metrics.counter(
                            "master_client_failovers_total",
                            "master calls replayed at a re-resolved "
                            "ruling master").inc(cmd=cmd)
                    _flight.note("master_failover", cmd=cmd, frm=ep,
                                 to=self._primary or self.endpoint)
                    continue
                raise
            if status == "redirect":
                new = (value or {}).get("primary")
                if new and new != ep:
                    self._primary = None if new == self.endpoint else new
                    continue
                if self._resolve_master():
                    if _flags.get_flag("observe"):
                        _metrics.counter(
                            "master_client_failovers_total",
                            "master calls replayed at a re-resolved "
                            "ruling master").inc(cmd=cmd)
                    continue
                raise RuntimeError(
                    f"master {ep} {cmd}: NotMaster — no reachable ruling "
                    f"master ({value})")
            if status != "ok":
                raise RuntimeError(f"master {ep} {cmd}: {value}")
            return value
        raise RuntimeError(f"master {cmd}: the ruling master keeps moving "
                           f"(redirect loop)")

    # -- ruling-master resolution -----------------------------------------
    def _probe(self, ep):
        """Throwaway-socket ha_status probe (resolution is rare; it must
        not disturb the cached request socket)."""
        s = rpc.connect(ep, timeout=0.5)
        try:
            s.settimeout(1.0)
            rpc.send_msg(s, ("ha_status", {}))
            return rpc.recv_msg(s)
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _quorum_holder(self) -> Optional[str]:
        if not self._quorum_eps:
            return None
        if self._quorum_client is None:
            from ..quorum import QuorumClient
            with self._lock:
                if self._quorum_client is None:
                    self._quorum_client = QuorumClient(self._quorum_eps,
                                                       deadline_s=1.0)
        try:
            rec = self._quorum_client.holder(self._quorum_resource)
        except Exception:   # noqa: BLE001 — resolution is best-effort
            return None
        return rec["holder"] if rec else None

    def _resolve_master(self, wait: bool = True) -> bool:
        """Find who RULES: poll ha_status across every known candidate
        (configured endpoint, standbys, the current mapping, and —
        leading the list — the arbiters' lease holder), adopting the
        first that reports `issuing`. A legacy master that rejects
        `ha_status` as unknown counts as a solo ruler. While some
        candidate still reports `standby` (a promotion may be landing)
        or a quorum route exists, keep polling up to `failover_s`."""
        cands: list = []
        for ep in ([self._primary] if self._primary else []) \
                + [self.endpoint] + self.standbys:
            if ep and ep not in cands:
                cands.append(ep)
        deadline = time.monotonic() + (self.failover_s if wait else 0.0)
        while True:
            hint = self._quorum_holder()
            if hint and hint not in cands:
                cands.insert(0, hint)
            saw_standby = False
            for ep in list(cands):
                try:
                    status, value = self._probe(ep)
                except (ConnectionError, EOFError, OSError,
                        _socket.timeout):
                    continue
                if status == "err" and "unknown command" in str(value):
                    role, is_issuing = "solo", True   # legacy master
                elif status != "ok":
                    continue
                else:
                    role = value.get("role")
                    is_issuing = bool(value.get("issuing"))
                    fed_by = value.get("primary")
                    if fed_by and fed_by not in cands:
                        cands.append(fed_by)
                if is_issuing:
                    self._primary = None if ep == self.endpoint else ep
                    _flight.note("master_resolved", primary=ep)
                    return True
                if role == "standby":
                    saw_standby = True
            if not wait or time.monotonic() >= deadline:
                return False
            if not saw_standby and not self._quorum_eps:
                return False   # nothing out there will ever promote
            time.sleep(0.25)

    # -- typed calls -------------------------------------------------------
    def set_dataset(self, payloads, chunks_per_task=1):
        return self._call("set_dataset", payloads=list(payloads),
                          chunks_per_task=chunks_per_task)

    def get_task(self):
        """Returns (status, task) where status is 'ok' | 'none' |
        'no_more'."""
        return self._call("get_task")

    def task_finished(self, task_id, epoch):
        return self._call("task_finished", task_id=task_id, epoch=epoch)

    def task_failed(self, task_id, epoch):
        return self._call("task_failed", task_id=task_id, epoch=epoch)

    def task_returned(self, task_id, epoch):
        """Hand a live lease back (clean trainer shutdown): the task
        re-queues IMMEDIATELY without burning its failure budget."""
        return self._call("task_returned", task_id=task_id, epoch=epoch)

    def start_new_pass(self):
        return self._call("start_new_pass")

    def stats(self):
        return self._call("stats")

    def ha_status(self):
        return self._call("ha_status")

    def stop_master(self):
        try:
            self._call("stop")
        except (RuntimeError, ConnectionError, OSError):
            pass

    def close(self):
        with self._lock:
            self._close_sock_locked()
        if self._quorum_client is not None:
            try:
                self._quorum_client.close()
            except Exception:   # noqa: BLE001
                pass

    # -- record streaming (reference NextRecord :244) ----------------------
    def records(self, load_chunk: Callable[[Any], Iterable],
                stop_when_drained: bool = True):
        """Generator over records of leased tasks: pulls a task, yields
        every record `load_chunk(payload_item)` produces, then marks the
        task finished — a trainer crash mid-task leaves the lease to
        expire and the task is re-issued elsewhere (the elastic
        property). A CLEAN close of the generator (trainer shutdown,
        `GeneratorExit`) RETURNS the in-flight lease instead of
        stranding it for the full `timeout_dur`, and without burning the
        task's failure budget — re-issue is immediate."""
        while True:
            status, task = self.get_task()
            if status == "no_more":
                if stop_when_drained:
                    return
                time.sleep(self.retry_interval)
                continue
            if status == "none":
                time.sleep(self.retry_interval)
                continue
            try:
                for item in task["payload"]:
                    for rec in load_chunk(item):
                        yield rec
            except GeneratorExit:
                try:
                    self.task_returned(task["task_id"], task["epoch"])
                except Exception:   # noqa: BLE001 — best-effort: the
                    pass            # lease timeout still covers it
                raise
            except Exception:
                self.task_failed(task["task_id"], task["epoch"])
                raise
            self.task_finished(task["task_id"], task["epoch"])
