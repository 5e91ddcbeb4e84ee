"""Host parameter server: sharded dense params + sparse tables, barrierless
async updates.

Capability parity with the reference pserver runtime (reference:
paddle/fluid/operators/listen_and_serv_op.cc — RunSyncLoop :106,
RunAsyncLoop :195 (per-grad update, no barriers);
operators/distributed/request_handler_impl.cc RequestSend/Get/Prefetch;
lookup_sparse_table_op.cc:39 auto-grown uniform-init sparse rows;
checkpoint_notify handling).

Mirror of ``paddle_tpu/pserver/server.py``, copied: a server is a host
service in numpy and never touches a card (a process that serves
`get_pserver_program` imports torch with the port but never initializes
CUDA). The trainer's step runs on the card; only the parameter exchange
crosses the host boundary. Each server
process owns a shard of the dense params (round-robin by name, reference
ps_dispatcher) and a row shard of each sparse table (row id % num_servers,
reference split_ids_op semantics). `push_grad` applies the update
immediately under a per-param lock — the reference's barrierless async SGD
(doc/fluid/design/dist_train/async_update.md).
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

from .. import flags as _flags
from ..wire import codec as _wire_codec
from ..ark import checkpoint as ark_ckpt
from ..ark.liveness import EvictingBarrier, LeaseTable
from ..haven import replication as _haven
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from . import rpc
from .optim import make_optimizer

logger = logging.getLogger(__name__)


class _SparseTable:
    """A row shard of a distributed lookup table.

    Memory contract: the shard is an EAGER dense [rows/n_servers, width]
    array (plus same-shape optimizer accumulators on first push) — 2-3x the
    shard bytes per server. All rows are uniform-initialized up front, which
    matches the reference's lookup_sparse_table numerics (uniform min/max,
    lookup_sparse_table_op.cc:39) without its auto-grow bookkeeping. For
    vocabularies too large for dense shards, the upgrade path is a hashed
    row-dict (the reference's SelectedRows row map) — not needed at the
    scales the in-tree workloads exercise."""

    def __init__(self, local_rows: int, width: int, dtype: str,
                 init_low: float, init_high: float, seed: int):
        rng = np.random.RandomState(seed)
        self.value = rng.uniform(init_low, init_high,
                                 (local_rows, width)).astype(dtype)

    def get(self, local_ids: np.ndarray) -> np.ndarray:
        return self.value[local_ids]


class ParameterServer:
    def __init__(self, endpoint: str, trainers: int = 1,
                 sync_timeout: float = 120.0,
                 pulse_port: Optional[int] = None):
        self.endpoint = endpoint
        self.trainers = trainers
        self.sync_timeout = sync_timeout
        # fluid-pulse opt-in: start()/stop() manage the process's health
        # endpoint and this server's lease-freshness check on it
        # (requires the observe flag — start_pulse refuses otherwise)
        self._pulse_port_req = pulse_port
        self.pulse_port: Optional[int] = None
        self._dense: Dict[str, np.ndarray] = {}
        self._sparse: Dict[str, _SparseTable] = {}
        self._optim: Dict[str, object] = {}
        self._opt_cfg: Dict[str, tuple] = {}   # name -> (opt_type, lr, attrs)
        # sync mode (reference RunSyncLoop, listen_and_serv_op.cc:106):
        # per-batch gradient accumulation + a barrier whose action applies
        # the aggregated update ONCE before any trainer proceeds
        self._pending: Dict[str, np.ndarray] = {}  # guarded_by: self._pending_lock
        self._pending_lock = threading.Lock()
        # exactly-once sync accounting: per-trainer highest APPLIED batch
        # id (keyed under that trainer's session nonce, so a restarted
        # trainer whose ids restart at 0 gets a fresh watermark instead of
        # silent drops), plus the (trainer, batch) pairs accumulated into
        # the CURRENT pending batch — retried pushes for an already-applied
        # or already-accumulated batch are acknowledged but NOT
        # re-accumulated (closes the double-advance window on partial
        # barrier failure across servers)
        # trainer -> batch id
        self._sync_applied: Dict[int, int] = {}  # guarded_by: self._pending_lock
        # trainer -> nonce
        self._sync_sessions: Dict[int, object] = {}  # guarded_by: self._pending_lock
        self._sync_pending_from: set = set()  # guarded_by: self._pending_lock
        # exactly-once ASYNC accounting (fluid-haven): tagged barrierless
        # pushes carry a per-trainer monotone seq under a session nonce —
        # the async twin of the sync watermark above, which is what makes
        # a push replayed at a PROMOTED backup safe to ack-and-drop
        # trainer -> push seq
        self._async_applied: Dict[int, int] = {}  # guarded_by: self._async_lock
        self._async_sessions: Dict[int, object] = {}  # guarded_by: self._async_lock
        self._async_lock = threading.Lock()
        # fluid-haven replication state (armed by start_replication /
        # start_standby; None = the legacy solo server, zero new cost)
        self._haven = None
        # liveness (ark): heartbeat leases + an evicting barrier — a dead
        # leaseholder is evicted once its lease expires, degrading the
        # sync world to N-1 instead of wedging until sync_timeout.
        # Trainers that never heartbeat hold no lease and keep the legacy
        # full-party/sync-timeout behavior.
        self._lease = LeaseTable()
        self._sync_barrier = EvictingBarrier(trainers,
                                             action=self._apply_pending)
        # fluid-elastic scale-UP: trainer ids the sync world knows. A
        # heartbeat from a NEVER-SEEN id is a replacement/extra trainer
        # joining a running job — the barrier grows at the next
        # generation boundary (EvictingBarrier.join), never mid-batch.
        self._known_members: set = set(range(trainers))  # guarded_by: self._members_lock
        self._members_lock = threading.Lock()
        self._locks: Dict[str, threading.Lock] = {}
        self._global_lock = threading.Lock()
        self._barrier = threading.Barrier(trainers) if trainers > 1 else None
        self._listener: Optional[socket.socket] = None
        self._threads = []
        # live accepted sockets (for hard cut)
        self._conns: set = set()   # guarded_by: self._conns_lock
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ParameterServer":
        host, port = rpc.parse_endpoint(self.endpoint)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        if port == 0:  # ephemeral port support for tests
            self.endpoint = f"{host}:{self._listener.getsockname()[1]}"
        self._listener.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"pserver@{self.endpoint}")
        t.start()
        self._threads.append(t)
        logger.info("pserver listening on %s", self.endpoint)
        if self._pulse_port_req is not None:
            from ..observe import health as _health
            from ..observe import pulse as _pulse
            self.pulse_port = _pulse.start_pulse(self._pulse_port_req)
            _health.get_engine().register_check(
                f"pserver_leases@{self.endpoint}", self._pulse_lease_check,
                ready=True)
        return self

    def _pulse_lease_check(self):
        """fluid-pulse /healthz check: heartbeat-lease freshness. Unready
        when a leaseholder's lease RECENTLY expired without the barrier
        evicting it yet — the window where a dead trainer may still
        count toward the sync world. Bounded: eviction only runs while
        someone waits on the barrier, so a trainer that departed for
        good (job finished, crash with no sync traffic) would otherwise
        hold this server at 503 forever; past 3 lease periods it is
        reported as `departed` detail, not unhealth. Expired-and-evicted
        trainers are detail too (the world already degraded around
        them)."""
        snap = self._lease.snapshot()
        evicted = self._sync_barrier.evicted
        stale, departed = [], []
        for t, rec in snap.items():
            if rec["live"] or t in evicted:
                continue
            expired_for = -rec["expires_in_s"]
            (stale if expired_for <= 3.0 * rec["lease_s"]
             else departed).append(t)
        detail = {
            "leases": {str(t): {k: v for k, v in rec.items()
                                if k != "session"}
                       for t, rec in snap.items()},
            "evicted": sorted(evicted),
            "stale": sorted(stale),
            "departed": sorted(departed),
            "live_parties": self._sync_barrier.live_parties,
        }
        return (not stale, detail)

    def serve_forever(self):
        self.start()
        self._stop.wait()

    def stop(self):
        """Hard cut, like a killed process: the listener AND every live
        connection close immediately (in-flight requests are dropped
        unanswered, waiting clients see EOF/RST), and the endpoint's
        port frees up so a restarted server can bind it."""
        self._stop.set()
        if self._haven is not None:
            # a killed process's forwarder/monitor threads die with it
            self._haven.close()
        if self.pulse_port is not None:
            from ..observe import health as _health
            _health.get_engine().unregister_check(
                f"pserver_leases@{self.endpoint}")
            self.pulse_port = None
        if self._listener is not None:
            # shutdown BEFORE close: the accept-loop thread blocked in
            # accept() holds a kernel reference — close() alone leaves
            # the port in LISTEN until that accept returns
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
                # linger-0 + shutdown + close: the RST close (not a FIN
                # close that parks the port in FIN_WAIT_2 for 60s) and
                # the shutdown wakes the conn thread blocked in recv so
                # the socket actually dies now
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
            # connection threads are daemonic and untracked (tracking them
            # would leak one Thread object per reconnect on a long-lived
            # server); the SOCKETS are tracked so stop() can hard-cut
            # them. The psconn@ name is load-bearing: ark's chaos
            # injector keys client-vs-server fault targeting on it.
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"psconn@{self.endpoint}").start()

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    msg, rx = rpc.recv_msg(conn, with_size=True)
                except (ConnectionError, EOFError, OSError):
                    return
                if self._stop.is_set():
                    # a stopped server must behave like a dead process:
                    # drop the request unanswered rather than serving one
                    # last reply per open connection (crash-recovery tests
                    # depend on stop() being a hard cut)
                    return
                # fluid-xray frame: (cmd, payload[, meta]) — the optional
                # meta dict carries the client attempt's traceparent.
                # Legacy 2-tuple frames (no meta) keep working unchanged;
                # frames LONGER than we understand (a future peer) keep
                # the fields we know rather than killing the connection,
                # and anything shorter gets a named error reply.
                try:
                    cmd, payload = msg[0], msg[1]
                    meta = msg[2] if len(msg) >= 3 else None
                except (TypeError, IndexError):
                    rpc.send_msg(conn, ("err", "MalformedFrame: expected "
                                        "(cmd, payload[, meta])"))
                    continue
                obs = _flags.get_flag("observe")
                t0 = time.perf_counter() if obs else 0.0
                wctx = _xray.from_wire(meta) if obs and meta else None
                try:
                    if wctx is not None:
                        # adopt the remote parent for the handler body so
                        # the server span (and anything the handler emits)
                        # lands in the CLIENT's trace
                        with _xray.activate(wctx), \
                                _xray.span(f"rpc_server:{cmd}", cat="rpc",
                                           cmd=cmd,
                                           endpoint=self.endpoint):
                            reply = self._dispatch(cmd, payload)
                    else:
                        reply = self._dispatch(cmd, payload)
                except Exception as e:  # surface server errors to the client
                    reply = ("err", f"{type(e).__name__}: {e}")
                    if obs:
                        _flight.note("rpc_handler_error", cmd=cmd,
                                     error=f"{type(e).__name__}: {e}"[:200])
                # handler latency measured BEFORE the reply send: sendall
                # blocks on a slow-reading client and that network stall
                # must not masquerade as handler time
                handler_s = time.perf_counter() - t0 if obs else 0.0
                tx = rpc.send_msg(conn, reply)
                if obs:
                    _metrics.counter(
                        "pserver_server_requests_total",
                        "RPCs served, by command").inc(cmd=cmd)
                    _metrics.counter(
                        "pserver_server_bytes_received_total",
                        "wire bytes received by the server").inc(rx, cmd=cmd)
                    _metrics.counter(
                        "pserver_server_bytes_sent_total",
                        "wire bytes sent in replies").inc(tx, cmd=cmd)
                    _metrics.histogram(
                        "pserver_server_handler_seconds",
                        "server-side handler latency (excludes socket "
                        "wait)").observe(handler_s, cmd=cmd)
                    if reply[0] == "err":
                        _metrics.counter(
                            "pserver_server_errors_total",
                            "handler errors surfaced to clients").inc(
                                cmd=cmd)
                if cmd == "stop":
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, cmd, p):
        handler = getattr(self, f"_h_{cmd}", None)
        if handler is None:
            raise ValueError(f"unknown pserver command {cmd!r}")
        hv = self._haven
        if hv is None:   # legacy solo server: zero haven cost
            return handler(**p)
        # fluid-haven serve gate: a standby backup redirects mutations to
        # the primary (reads pass, bounded-stale); a retired server
        # redirects everything to its successor; a quiescing primary
        # HOLDS mutators so a snapshot/handover cut is consistent.
        with hv.admit(cmd) as verdict:
            if verdict is not None:
                return verdict
            reply = handler(**p)
            # replicate the applied update to the backup — but never a
            # deduplicated replay (the backup saw the original record).
            # push_grads_sync records itself under the pending lock.
            if cmd in _haven.DISPATCH_RECORDED_CMDS and \
                    reply[0] == "ok" and \
                    not (isinstance(reply[1], str)
                         and reply[1].startswith("duplicate")):
                hv.record(cmd, p)
            return reply

    def _lock(self, name):
        with self._global_lock:
            return self._locks.setdefault(name, threading.Lock())

    # -- dense params -----------------------------------------------------
    def _h_init_param(self, name, value, opt_type, lr, attrs):
        """Idempotent: first writer wins (trainer 0 pushes startup values,
        reference BCastParamsToDevices / pserver startup program analog)."""
        with self._lock(name):
            if name not in self._dense:
                self._dense[name] = np.array(value, copy=True)
                self._optim[name] = make_optimizer(opt_type, lr, attrs)
                self._opt_cfg[name] = (opt_type, float(lr), dict(attrs or {}))
        return ("ok", None)

    def _h_get_param(self, name):
        with self._lock(name):
            if name not in self._dense:
                return ("err", f"param {name!r} not initialized")
            return ("ok", self._dense[name].copy())

    def _async_seen(self, seq, trainer_id, session) -> bool:
        """fluid-haven exactly-once for tagged BARRIERLESS pushes: the
        async twin of the sync watermark. `seq` increases monotonically
        per trainer session; a push at or below the watermark was
        already applied (possibly by the pre-failover primary, already
        replicated here) and is acknowledged without re-applying — the
        rule that lets a client replay un-acked pushes at a promoted
        backup. Untagged pushes (seq None) keep legacy apply-always.

        Check-only: the watermark COMMITS via `_async_mark` after the
        apply succeeds — a push that failed to decode or apply must not
        burn its seq, or the client's replay would be acked as a
        duplicate of an update that never landed (silent loss). The
        trade-off (a retry of a partially-applied multi-param push
        re-applies its prefix) only arises from server-side apply bugs,
        where loud double-apply beats silent drop."""
        if seq is None:
            return False
        with self._async_lock:
            if session is not None and \
                    self._async_sessions.get(trainer_id) != session:
                self._async_sessions[trainer_id] = session
                self._async_applied.pop(trainer_id, None)
            return seq <= self._async_applied.get(trainer_id, -1)

    def _async_mark(self, seq, trainer_id):
        if seq is None:
            return
        with self._async_lock:
            if seq > self._async_applied.get(trainer_id, -1):
                self._async_applied[trainer_id] = seq

    def _h_push_grad(self, name, grad, seq=None, trainer_id=0,
                     session=None):
        """Barrierless: apply immediately (RunAsyncLoop semantics).
        fluid-wire: the grad may arrive as a codec-tagged payload — it is
        DEQUANTIZED here, before the optimizer applies (the server-side
        half of the wire contract); raw arrays pass through unchanged, so
        legacy clients interoperate."""
        g = _wire_codec.maybe_decode(grad)  # decode outside the lock
        if self._async_seen(seq, trainer_id, session):
            return ("ok", "duplicate: push already applied")
        with self._lock(name):
            self._optim[name].dense(self._dense[name], g)
        self._async_mark(seq, trainer_id)
        return ("ok", None)

    def _h_get_params(self, names):
        out = {}
        for n in names:
            with self._lock(n):
                if n not in self._dense:
                    return ("err", f"param {n!r} not initialized")
                out[n] = self._dense[n].copy()
        return ("ok", out)

    def _h_push_grads(self, grads, seq=None, trainer_id=0, session=None):
        # decode EVERY tensor before applying ANY (and outside the
        # locks): a malformed frame must reject the whole push — a
        # partial apply would be re-applied by the caller's retry
        decoded = [(n, _wire_codec.maybe_decode(g))
                   for n, g in grads.items()]
        if self._async_seen(seq, trainer_id, session):
            return ("ok", "duplicate: push already applied")
        for n, dec in decoded:
            with self._lock(n):
                self._optim[n].dense(self._dense[n], dec)
        self._async_mark(seq, trainer_id)
        return ("ok", None)

    # -- wire negotiation (fluid-wire) ------------------------------------
    def _h_wire_caps(self):
        """Advertise the payload codecs this server decodes. A quantizing
        client calls this once per endpoint; a LEGACY server answers with
        an unknown-command error instead, which the client reads as
        'negotiate down to raw' — mixed versions interoperate, never
        corrupt."""
        return ("ok", {"codecs": list(_wire_codec.CODECS), "version": 1})

    # -- sparse tables ----------------------------------------------------
    def _h_init_table(self, name, local_rows, width, dtype, init_low,
                      init_high, seed, opt_type, lr, attrs):
        with self._lock(name):
            if name not in self._sparse:
                self._sparse[name] = _SparseTable(local_rows, width, dtype,
                                                  init_low, init_high, seed)
                self._optim[name] = make_optimizer(opt_type, lr, attrs)
                self._opt_cfg[name] = (opt_type, float(lr), dict(attrs or {}))
        return ("ok", None)

    def _h_prefetch(self, name, local_ids, codec=None):
        """Row fetch by LOCAL ids (client did the id%N sharding split,
        reference prefetch op + split_ids_op). `codec` (fluid-wire,
        negotiated clients only) returns the rows as a quantized tagged
        payload — embedding-row pulls are the recsys bandwidth hog."""
        with self._lock(name):
            rows = self._sparse[name].get(np.asarray(local_ids))
        if codec and codec != "raw" and rows.dtype == np.float32:
            return ("ok", _wire_codec.encode_tensor(rows, codec, name=name))
        return ("ok", rows)

    def _h_push_sparse_grad(self, name, local_ids, row_grads, seq=None,
                            trainer_id=0, session=None):
        # decode BEFORE the watermark advances (see _h_push_grad)
        rows = _wire_codec.maybe_decode(row_grads)
        if self._async_seen(seq, trainer_id, session):
            return ("ok", "duplicate: push already applied")
        with self._lock(name):
            table = self._sparse[name]
            self._optim[name].sparse(table.value, np.asarray(local_ids),
                                     rows)
        self._async_mark(seq, trainer_id)
        return ("ok", None)

    # -- sync-mode barrier (reference RunSyncLoop batch barrier) -----------
    def _h_batch_barrier(self):
        if self._barrier is not None:
            self._barrier.wait()
        return ("ok", None)

    # -- sync mode: per-batch accumulate + barrier-apply -------------------
    # (reference RunSyncLoop, listen_and_serv_op.cc:106: kRequestSend from
    # every trainer, then the optimize blocks run once on the aggregated
    # gradients, then kRequestGet unblocks)
    def _h_push_grads_sync(self, grads, batch_id=None, trainer_id=0,
                           session=None):
        """Accumulate this trainer's gradients for the CURRENT batch; the
        update is applied at the sync_apply barrier, not here.

        `batch_id` is a per-trainer monotonically increasing tag (the
        client keeps it stable across retries of the same batch): a push
        for a batch this server already APPLIED from this trainer — the
        partial-failure retry case where another server's barrier broke
        but this one completed — is acknowledged without re-accumulating,
        as is a duplicate (trainer, batch) push within the pending batch
        (e.g. a client resend on a dropped connection). `session` is a
        per-trainer-process nonce: a RESTARTED trainer restarts its ids
        at 0 under a new session, which resets its watermark — its pushes
        must accumulate, not be dropped as stale duplicates. Untagged
        pushes keep the legacy accumulate-always behavior."""
        # fluid-wire: dequantize tagged payloads BEFORE taking the pending
        # lock — the decode is O(gradient bytes) and must not serialize
        # concurrent trainers' pushes (the rare deduplicated replay just
        # wastes one decode). The pending sum stays full-precision f32.
        decoded = {n: _wire_codec.maybe_decode(g) for n, g in grads.items()}
        with self._pending_lock:
            if batch_id is not None:
                if session is not None and \
                        self._sync_sessions.get(trainer_id) != session:
                    self._sync_sessions[trainer_id] = session
                    self._sync_applied.pop(trainer_id, None)
                    # purge the dead session's pending markers so the new
                    # session's first push is ACCUMULATED, not dropped as
                    # a duplicate. (Its gradient bytes, if any, are
                    # already summed into _pending and cannot be
                    # subtracted — same as legacy; the barrier timeout
                    # normally clears that batch before a restart rejoins)
                    self._sync_pending_from = {
                        (t, b) for t, b in self._sync_pending_from
                        if t != trainer_id}
                if batch_id <= self._sync_applied.get(trainer_id, -1):
                    return ("ok", "duplicate: batch already applied")
                key = (trainer_id, batch_id)
                if key in self._sync_pending_from:
                    return ("ok", "duplicate: push already accumulated")
                self._sync_pending_from.add(key)
            for n, g in decoded.items():
                self._pending[n] = (g if n not in self._pending
                                    else self._pending[n] + g)
            if self._haven is not None:
                # fluid-haven: record INSIDE the pending lock (not at
                # dispatch-return) so the log order equals the
                # accumulation order — with 3+ concurrent trainers a
                # post-lock record could log in a different order than
                # the pending sum folded, and float non-associativity
                # would break the backup's bit-identity. The record
                # carries the ORIGINAL (possibly codec-tagged) grads.
                self._haven.record(
                    "push_grads_sync",
                    {"grads": grads, "batch_id": batch_id,
                     "trainer_id": trainer_id, "session": session})
        return ("ok", None)

    def _apply_pending(self, n_contrib=None, replicated=False):
        """Barrier action: runs exactly once per batch, in one of the
        waiting connection threads, before any trainer is released. The
        aggregated gradient is AVERAGED over trainers (each trainer's
        grad is the mean over its local shard, so the applied update
        equals single-process training on the combined batch — the
        ParallelExecutor CoeffNumDevice convention).

        fluid-haven: a replicating primary records the apply as one
        synthesized record carrying the contributor count, INSIDE the
        pending lock so it orders exactly between this batch's pushes
        and the next batch's; the backup replays it with the same
        divisor (`n_contrib` set, `replicated=True`) instead of
        re-deriving one from its own barrier (it has none). The
        sync_apply DISPATCH is not a counted mutator (a barrier wait
        must never hold a quiesce hostage) — the actual state mutation
        enters the gate here instead."""
        if self._haven is not None and not replicated:
            with self._haven.mutator():
                if self._haven.role != "primary":
                    # the shard was handed over while this apply waited
                    # out the quiesce: applying here would ack a batch
                    # the successor still holds pending — break the
                    # barrier instead; the trainers' retry re-pushes
                    # (deduped by the snapshotted watermarks) and the
                    # SUCCESSOR's barrier applies the batch exactly once
                    raise RuntimeError(
                        "sync barrier broken: shard handed over "
                        "mid-batch; retry the step at the new primary")
                return self._apply_pending_impl(n_contrib, replicated)
        return self._apply_pending_impl(n_contrib, replicated)

    def _apply_pending_impl(self, n_contrib=None, replicated=False):
        with self._pending_lock:
            pending, self._pending = self._pending, {}
            # distinct trainers whose gradients are actually summed into
            # this batch — the correct mean divisor. A trainer that
            # PUSHED and then died before the barrier still contributed;
            # dividing by the (smaller) live count would over-weight the
            # update by N/(N-1). Untagged legacy pushes leave no keys —
            # fall back to the live party count there.
            contributors = {t for t, _b in self._sync_pending_from}
            for t, b in self._sync_pending_from:
                if b > self._sync_applied.get(t, -1):
                    self._sync_applied[t] = b
            self._sync_pending_from.clear()
            if n_contrib is None:
                n_contrib = len(contributors) or \
                    self._sync_barrier.live_parties
            if not replicated and self._haven is not None and pending:
                self._haven.record_sync_apply(n_contrib)
        for n, g in pending.items():
            with self._lock(n):
                self._optim[n].dense(self._dense[n],
                                     g / max(n_contrib, 1))

    # -- liveness (ark): heartbeat leases + eviction -----------------------
    def _h_heartbeat(self, trainer_id, session=None, lease_s=3.0):
        """Renew `trainer_id`'s liveness lease. A previously-evicted
        trainer that heartbeats again (a restart rejoining) is
        readmitted — the barrier's party count grows back and its fresh
        session nonce resets its sync watermark on first push."""
        self._lease.beat(trainer_id, session=session, lease_s=lease_s)
        key = trainer_id if isinstance(trainer_id, str) else int(trainer_id)
        if self._sync_barrier.readmit(key):
            logger.info("pserver %s: trainer %s readmitted after "
                        "heartbeat (lease %.1fs)", self.endpoint,
                        trainer_id, lease_s)
            # lease transitions go to the black box unconditionally —
            # they are rare and exactly what a postmortem wants
            _flight.note("lease_readmit", trainer_id=key,
                         endpoint=self.endpoint)
            if _flags.get_flag("observe"):
                _metrics.counter(
                    "pserver_trainers_readmitted_total",
                    "evicted trainers readmitted after a fresh "
                    "heartbeat").inc()
        else:
            with self._members_lock:
                is_new = key not in self._known_members
                if is_new:
                    self._known_members.add(key)
            if is_new and self._sync_barrier.join(key):
                # fluid-elastic: a NEW leaseholder grows the sync world
                # at the next barrier epoch (never mid-batch); its first
                # pull reads the current params, its fresh session nonce
                # starts a fresh sync watermark
                logger.info(
                    "pserver %s: NEW trainer %s admitted to the sync "
                    "world (grows to %d at the next barrier epoch, "
                    "lease %.1fs)", self.endpoint, key,
                    self._sync_barrier.live_parties, lease_s)
                _flight.note("lease_admit", trainer_id=key,
                             endpoint=self.endpoint)
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "pserver_trainers_admitted_total",
                        "new trainers admitted to a running sync world "
                        "on first heartbeat").inc()
        return ("ok", {"live_trainers": self._sync_barrier.live_parties,
                       "leases": self._lease.snapshot()})

    def _evict_expired(self):
        """Barrier-wait callback: evict leaseholders whose lease expired
        so the sync world degrades to the live N-1 instead of wedging
        until sync_timeout. Only ever called while some trainer is
        waiting — an idle server expires no one."""
        for tid in self._lease.expired():
            if self._sync_barrier.evict(tid):
                logger.warning(
                    "pserver %s: trainer %s lease expired — evicted from "
                    "the sync barrier (world degrades to %d live "
                    "trainers)", self.endpoint, tid,
                    self._sync_barrier.live_parties)
                _flight.note("lease_evict", trainer_id=tid,
                             endpoint=self.endpoint,
                             live_parties=self._sync_barrier.live_parties)
                if _flags.get_flag("observe"):
                    _metrics.counter(
                        "pserver_trainers_evicted_total",
                        "trainers evicted on lease expiry").inc()
                    # an eviction span on the timeline: zero-duration mark
                    # in whatever trace the waiting arrival activated
                    with _xray.span("lease_evict", cat="ark",
                                    trainer_id=tid,
                                    endpoint=self.endpoint):
                        pass

    def _h_sync_apply(self, trainer_id=None):
        try:
            self._sync_barrier.wait(timeout=self.sync_timeout,
                                    evict_check=self._evict_expired,
                                    member=trainer_id)
        except threading.BrokenBarrierError:
            # recover rather than poison the long-lived server: the FIRST
            # recovering thread (the one that still observes the barrier
            # broken, under the lock) discards the incomplete batch's
            # accumulated gradients and resets the barrier; later
            # recoverers skip both, so gradients a fast trainer already
            # RE-pushed for the retry are never wiped. The partial-failure
            # case (one server's barrier trips, another's completes) is
            # closed by the batch-id tags on push_grads_sync: the healthy
            # shard rejects the retried batch's pushes as already-applied,
            # so its barrier fires on an EMPTY pending set and the retried
            # batch cannot double-advance it.
            with self._pending_lock:
                if self._sync_barrier.broken:
                    self._pending.clear()
                    self._sync_pending_from.clear()
                    self._sync_barrier.reset()
                    if self._haven is not None:
                        # fluid-haven: the discard must replicate — the
                        # backup's replayed pending holds the broken
                        # batch's pushes, and without the reset the
                        # retried batch would dedup against them and
                        # the copies would silently diverge
                        self._haven.record(_haven.SYNC_RESET_RECORD, {})
            return ("err", "sync barrier broken (a trainer died or timed "
                           "out mid-batch); batch discarded, barrier "
                           "reset — retry the step")
        return ("ok", None)

    # -- checkpoint (reference checkpoint_notify -> save block) ------------
    def _shard_path(self, dirname, endpoint=None):
        ep = endpoint or self.endpoint
        return os.path.join(dirname, f"pserver_{ep.replace(':', '_')}.npz")

    def _h_save(self, dirname):
        """Snapshot values AND optimizer state (accumulators + config) so
        a crashed server can be restarted from its shard and training
        resumes with identical update dynamics (reference checkpoint_notify
        -> save block on the pserver, request_handler_impl.cc).

        Joins the ark atomic/manifest protocol: the npz lands via tmp +
        os.replace (a crash mid-save never tears an existing shard) and a
        sha256 sidecar manifest commits after it, so `recover()` and
        `ark.verify_checkpoint` can prove the shard intact. When
        `dirname` is a checkpoint stage dir (trainer-driven
        `save_checkpoint(shard_saver=...)`), the shard commits as part of
        the same all-or-nothing serial.

        fluid-haven: on a replicating server the snapshot is taken under
        a brief quiesce (in-flight mutators drain, new ones are held) so
        the shard is a consistent cut, and the sidecar manifest is
        tagged with the replication watermark (`haven_seq`) + fencing
        epoch — the checkpoint names exactly which prefix of the update
        stream it contains."""
        if self._haven is not None:
            with self._haven.quiesce():
                st = self._haven.status()
                return self._save_impl(
                    dirname,
                    haven_seq=(st["head_seq"] if st["role"] == "primary"
                               else st["applied_seq"]),
                    haven_epoch=st["epoch"], haven_role=st["role"])
        return self._save_impl(dirname)

    def _save_impl(self, dirname, **sidecar_extra):
        import json

        os.makedirs(dirname, exist_ok=True)
        # snapshot each param under its own lock so a checkpoint racing
        # concurrent pushes is internally consistent per-param (the async
        # mode has no global consistent cut — same as the reference)
        arrays, meta = {}, {}
        for kind, names in (("dense", list(self._dense)),
                            ("sparse", list(self._sparse))):
            for n in names:
                with self._lock(n):
                    val = (self._dense[n] if kind == "dense"
                           else self._sparse[n].value)
                    arrays[f"{'d' if kind == 'dense' else 's'}::{n}"] = \
                        val.copy()
                    # optimizer state through its own API (one source of
                    # truth for what constitutes state), arrays flattened
                    # into the npz
                    st = self._optim[n].state()
                    for k, a in st["acc"].items():
                        arrays[f"o::{n}::{k}"] = np.array(a, copy=True)
                opt_type, _, _ = self._opt_cfg[n]
                meta[n] = {"kind": kind, "opt_type": opt_type,
                           "lr": st["lr"], "attrs": st["attrs"]}
        path = self._shard_path(dirname)
        with ark_ckpt.atomic_file(path) as f:
            np.savez(f, __meta__=np.array(json.dumps(meta)), **arrays)
        ark_ckpt.write_sidecar_manifest(path, endpoint=self.endpoint,
                                        kind="pserver_shard",
                                        **sidecar_extra)
        return ("ok", path)

    def recover(self, dirname,
                shard_endpoint: Optional[str] = None) -> "ParameterServer":
        """Restore this server's shard from `dirname` (written by a prior
        save on the SAME endpoint). Values, sparse tables, and optimizer
        accumulators all come back, so resumed training continues the
        exact update sequence — the crash-restart leg of the reference's
        checkpoint/notify protocol (trainer.py:986 resume path).

        fluid-haven: `shard_endpoint` names the PEER whose shard file to
        load — how a promoted former-backup (or a fresh process on a new
        port) recovers the checkpoint its dead primary wrote."""
        import json

        path = self._shard_path(dirname, endpoint=shard_endpoint)
        # checksum gate BEFORE deserializing: a torn/bit-rotted shard is
        # refused loudly, never half-loaded (no sidecar = pre-ark shard,
        # loaded as before)
        ark_ckpt.verify_sidecar(path)
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            for name, m in meta.items():
                with self._lock(name):
                    if m["kind"] == "dense":
                        self._dense[name] = z[f"d::{name}"].copy()
                    else:
                        tbl = _SparseTable.__new__(_SparseTable)
                        tbl.value = z[f"s::{name}"].copy()
                        self._sparse[name] = tbl
                    opt = make_optimizer(m["opt_type"], m["lr"], m["attrs"])
                    prefix = f"o::{name}::"
                    opt.load_state({"lr": m["lr"], "attrs": m["attrs"],
                                    "acc": {k[len(prefix):]: z[k].copy()
                                            for k in z.files
                                            if k.startswith(prefix)}})
                    self._optim[name] = opt
                    self._opt_cfg[name] = (m["opt_type"], m["lr"],
                                           m["attrs"])
        return self

    def _h_restore(self, dirname, shard_endpoint=None):
        self.recover(dirname, shard_endpoint=shard_endpoint)
        if self._haven is not None:
            # the shard state changed out-of-band: the update log can no
            # longer bring the backup current — force a full resync
            self._haven.mark_resync()
        return ("ok", sorted(self._dense) + sorted(self._sparse))

    # -- fluid-haven: replication / election / handoff ---------------------
    def _arm_quorum(self, quorum_endpoints, quorum_resource,
                    quorum_lease_s, lease_s):
        """fluid-quorum opt-in shared by both haven roles: build the
        arbiter client (attributed to THIS server for chaos partition
        rules) and attach it as the shard's election source. Both
        members of a pair must name the same resource."""
        from ..quorum import QuorumClient
        lease = float(quorum_lease_s or lease_s)
        client = QuorumClient(
            list(quorum_endpoints), actor=self.endpoint,
            # short per-node deadline: a renewal round must resolve well
            # inside lease/3 even with one arbiter blackholed
            deadline_s=max(0.25, min(1.0, lease / 4.0)))
        self._haven.arm_quorum(client, quorum_resource or "ps-shard-0",
                               lease_s=lease)

    def start_replication(self, backup_endpoint: str, lease_s: float = 2.0,
                          window: int = 512, stall_timeout_s: float = 5.0,
                          quorum_endpoints=None,
                          quorum_resource: Optional[str] = None,
                          quorum_lease_s: Optional[float] = None
                          ) -> "ParameterServer":
        """Arm this server as the PRIMARY of a replicated pair: every
        applied update is forwarded to `backup_endpoint` as a
        sequence-numbered record; the forwarder's batches double as the
        primary's lease renewal on the backup. The first batch performs
        a full snapshot sync, so the backup may start empty.

        `quorum_endpoints` (fluid-quorum, a 3/5-node arbiter group)
        upgrades the pair's failure model to partition-tolerant: this
        primary must win — and keep renewing — a majority-granted lease
        on `quorum_resource`, failing closed when it cannot."""
        from ..haven import HavenState
        if self._haven is None:
            self._haven = HavenState(self, role="primary", lease_s=lease_s,
                                     window=window,
                                     stall_timeout_s=stall_timeout_s)
        self._haven.lease_s = float(lease_s)
        if quorum_endpoints:
            self._arm_quorum(quorum_endpoints, quorum_resource,
                             quorum_lease_s, lease_s)
        self._haven.start_replication(backup_endpoint)
        return self

    def start_standby(self, lease_s: float = 2.0,
                      auto_promote: bool = True,
                      quorum_endpoints=None,
                      quorum_resource: Optional[str] = None,
                      quorum_lease_s: Optional[float] = None
                      ) -> "ParameterServer":
        """Arm this server as a standby BACKUP: it replays the primary's
        record stream, serves bounded-stale reads, redirects writes, and
        (with `auto_promote`) promotes itself when the primary's lease
        expires. A handover target passes `auto_promote=False` so a torn
        handover can never elect two primaries.

        With `quorum_endpoints` configured, self-promotion additionally
        requires a majority-granted quorum lease — `auto_promote=True`
        is then safe even on partition-risky networks (the standby of a
        merely-partitioned pair loses the election instead of
        split-braining)."""
        from ..haven import HavenState
        if self._haven is None:
            self._haven = HavenState(self, role="backup", lease_s=lease_s)
        self._haven.lease_s = float(lease_s)
        if quorum_endpoints:
            self._arm_quorum(quorum_endpoints, quorum_resource,
                             quorum_lease_s, lease_s)
        self._haven.start_standby(auto_promote=auto_promote)
        return self

    def handover(self, new_endpoint: str, timeout: float = 30.0) -> dict:
        """Planned live shard handoff to a fresh standby process (see
        HavenState.handover): drain, snapshot+tail stream, lease flip,
        retire — zero failed trainer pushes across the flip."""
        from ..haven import HavenState
        if self._haven is None:   # solo server moving hosts
            self._haven = HavenState(self, role="primary")
        return self._haven.handover(new_endpoint, timeout=timeout)

    def _h_haven_role(self):
        if self._haven is None:
            return ("ok", {"role": "solo", "epoch": -1,
                           "endpoint": self.endpoint,
                           "primary": self.endpoint})
        return ("ok", self._haven.status())

    def _ensure_standby(self, auto_promote=True):
        if self._haven is None:
            # a bare server adopted by a primary arms itself on first
            # contact (lease_s refreshed from the primary's batches)
            self.start_standby(auto_promote=auto_promote)
        return self._haven

    def _h_haven_replicate(self, records, epoch, primary, lease_s=2.0):
        return self._ensure_standby().replay(records, epoch, primary,
                                             lease_s)

    def _h_haven_sync(self, snapshot, lease_s=2.0):
        return self._ensure_standby().install_snapshot(snapshot,
                                                       lease_s=lease_s)

    def _h_haven_promote(self, epoch, backup=None, predecessor=None):
        hv = self._ensure_standby(auto_promote=False)
        hv.promote(kind="handover", epoch=epoch, backup=backup,
                   predecessor=predecessor)
        return ("ok", {"epoch": hv.epoch, "role": hv.role})

    def _h_stats(self):
        return ("ok", {"dense": sorted(self._dense),
                       "sparse": sorted(self._sparse),
                       "endpoint": self.endpoint})

    def _h_stop(self):
        self.stop()
        return ("ok", None)
