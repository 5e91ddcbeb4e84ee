"""Trainer-side parameter-server client + async train-step driver.

Capability parity with the reference trainer-side distributed ops
(reference: paddle/fluid/operators/send_op.cc:28, recv_op.cc, prefetch op,
operators/distributed/grpc_client.cc AsyncSendVar :66 / AsyncGetVar :122 /
AsyncPrefetchVar; split_ids/merge_ids ops for the sparse path;
python/paddle/fluid/transpiler/distribute_transpiler.py:316
`_replace_lookup_table_op_with_prefetch`).

Mirror of ``paddle_tpu/pserver/client.py``, copied (numpy only). The
send/recv/prefetch ops are HOST-side phases around the Executor's step,
which runs on the card:

    pull params -> [fwd+bwd on the card] -> push grads     (async, P3)
    prefetch rows -> [step on the gathered sub-table] -> push row grads (P5)

The step itself is the plain Program — exactly the split the reference
makes between compute ops and distributed ops, relocated to the host
boundary. Every payload is numpy: the trainer copies a card tensor to
the host before it reaches this client, and the server's restricted
unpickler admits nothing else.
"""

from __future__ import annotations

import socket as _socket
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import flags as _flags
from .. import wire as _wire
from ..ark.retry import RetryPolicy
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from . import rpc


class PSClient:
    """Connection pool + typed calls to a set of parameter servers.

    Fault tolerance (ark): every call rides a bounded exponential-backoff
    retry loop (`retry=RetryPolicy(...)`, jittered; `ark.NO_RETRY`
    restores fail-fast), honors an optional per-call wall `deadline`
    (seconds; None keeps the legacy block-forever behavior needed by the
    sync barrier), transparently reconnects sockets that went stale
    across a pserver restart, and — for read-only commands — fails over
    to replica endpoints (`replicas={primary: [backup, ...]}`) when the
    primary is gone.

    Wire compression (fluid-wire): `comm_quant="int8"|"bf16"` sends
    gradient pushes as codec-tagged payloads (wire/codec.py) with
    per-tensor client-side error feedback, and moves sparse-table rows
    quantized in both directions. The codec is NEGOTIATED per endpoint
    (one `wire_caps` RPC, cached): a legacy server that answers with an
    unknown-command error gets raw payloads — never corrupted frames —
    mirroring the xray 2-tuple/3-tuple interop posture. Default None
    keeps the wire byte-identical to pre-wire traffic."""

    def __init__(self, endpoints: Sequence[str],
                 retry: Optional[RetryPolicy] = None,
                 deadline: Optional[float] = None,
                 replicas: Optional[Dict[str, Sequence[str]]] = None,
                 wire_trace: bool = True,
                 comm_quant: Optional[str] = None,
                 read_only: bool = False,
                 dedup_pushes: bool = False,
                 trainer_id: int = 0,
                 failover_s: float = 20.0,
                 quorum_endpoints: Optional[Sequence[str]] = None,
                 quorum_resources: Optional[Dict[str, str]] = None):
        # fluid-fleet: a serving replica's sparse read path holds a
        # PSClient purely to PULL rows — read_only=True makes a mutating
        # call (a stray push_grad from a serving process would corrupt
        # live training state) unrepresentable rather than a code-review
        # promise. wire_caps stays allowed: negotiation is how the pull
        # path gets its codec.
        self.read_only = bool(read_only)
        # fluid-xray: with `wire_trace` (and the `observe` flag on) each
        # request frame carries a traceparent meta element so the server's
        # handler span joins this client's trace. False restores the bare
        # 2-tuple frame for legacy servers that reject a third element.
        self.wire_trace = bool(wire_trace)
        cq = None if comm_quant in (None, "raw") else str(comm_quant)
        if cq is not None and cq not in _wire.CODECS:
            raise _wire.WireCodecError(
                f"comm_quant must be one of {_wire.CODECS} or None, got "
                f"{comm_quant!r}")
        self.comm_quant = cq
        self._feedback = _wire.ErrorFeedback()
        self._wire_ok: Dict[str, bool] = {}   # endpoint -> negotiated?
        # endpoint -> monotonic time before which an unreachable
        # negotiation verdict is not retried (raw in the meantime)
        self._wire_retry_at: Dict[str, float] = {}
        self.endpoints = list(endpoints)
        self.retry = retry if retry is not None else RetryPolicy()
        self.deadline = deadline if deadline is not None \
            else self.retry.deadline
        self.replicas = {ep: list(reps)
                         for ep, reps in (replicas or {}).items()}
        # fluid-haven: logical endpoint -> CURRENT primary. Writes (and
        # reads) are routed through this map; it moves on a redirect
        # reply or a successful `_resolve_primary` poll after a primary
        # death. `failover_s` bounds how long a write waits for the
        # backup's lease-expiry promotion before giving up.
        self._primaries: Dict[str, str] = {}
        self.failover_s = float(failover_s)
        # fluid-quorum: when the shard's election runs through an
        # arbiter group, the client can ask the ARBITERS who rules
        # (`quorum_resources` maps a logical endpoint to its lease
        # resource; the holder id is the primary's endpoint by
        # convention) — failover then finds a primary living at an
        # endpoint no configured candidate names, without waiting out
        # the haven_role poll grid. Lazy: no arbiter RPC until the
        # first failover needs one.
        self._quorum_eps = list(quorum_endpoints or ())
        self._quorum_resources = dict(quorum_resources or {})
        self._quorum_client = None
        # fluid-haven exactly-once for BARRIERLESS pushes: when armed,
        # push_grad(s)/push_sparse_grad carry (trainer, seq, session) so
        # the server's async watermark makes them replay-safe — the rule
        # that lets a push retried at a promoted backup never
        # double-apply. Off by default: the wire stays byte-identical.
        self.dedup_pushes = bool(dedup_pushes)
        self.trainer_id = int(trainer_id)
        import uuid
        self._session = uuid.uuid4().hex
        self._push_seq = 0
        self._push_seq_lock = threading.Lock()
        self._socks = {}
        self._lock = threading.Lock()
        self._ep_locks: Dict[str, threading.Lock] = {}
        # persistent pool: the parallel get/push run on every training step
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self.endpoints)),
            thread_name_prefix="psclient")

    def _drop_sock(self, endpoint):
        with self._lock:
            old = self._socks.pop(endpoint, None)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass

    @staticmethod
    def _stale(sock) -> bool:
        """A cached socket whose peer restarted delivers EOF/RST on next
        use; probe with a non-blocking MSG_PEEK so the reconnect happens
        BEFORE the request is sent — otherwise a non-replayable command
        is poisoned by a server that never saw it. The protocol is
        strict request/reply, so any readable byte here is itself a
        desync; only BlockingIOError (nothing to read) means healthy."""
        try:
            sock.setblocking(False)
            try:
                return sock.recv(1, _socket.MSG_PEEK) is not None
            finally:
                sock.setblocking(True)
        except (BlockingIOError, InterruptedError):
            try:
                sock.setblocking(True)
            except OSError:
                return True
            return False
        except OSError:
            return True

    def _sock(self, endpoint, connect_timeout=None):
        with self._lock:
            sock = self._socks.get(endpoint)
        if sock is not None and self._stale(sock):
            self._drop_sock(endpoint)
            sock = None
        if sock is None:
            sock = rpc.connect(endpoint,
                               timeout=(connect_timeout
                                        if connect_timeout is not None
                                        else 30.0))
            with self._lock:
                self._socks[endpoint] = sock
        return sock

    # RPCs safe to REPLAY after the request may have reached the server:
    # reads, first-wins initialization, and batch-id-tagged sync pushes
    # (the server's (trainer, batch, session) watermark acknowledges a
    # duplicate without re-accumulating). Other mutating commands
    # (push_grad, sync_apply, batch_barrier ...) are never replayed past
    # a fully-sent request — a duplicate grad push double-steps the param
    # and a duplicate barrier arrival releases it early. They DO retry
    # send-phase failures: the frame is length-prefixed, so a request
    # whose send failed was never dispatched by the server.
    _IDEMPOTENT = frozenset({"get_param", "get_params", "prefetch",
                             "init_param", "init_table", "stats",
                             "heartbeat", "save", "restore", "wire_caps",
                             # fluid-haven: replicate dedups by seq, sync
                             # replaces state wholesale, promote fences
                             # by epoch, role is a read
                             "haven_role", "haven_replicate",
                             "haven_sync", "haven_promote"})

    # strictly read-only commands: the ONLY ones allowed to fail over to
    # a replica endpoint. Idempotent-but-mutating commands (save,
    # init_param, ...) must not — a `save` answered by a replica would
    # commit the WRONG shard into a checkpoint that verifies clean, and
    # a heartbeat lease belongs to one specific server.
    _READ_ONLY = frozenset({"get_param", "get_params", "prefetch",
                            "stats"})

    @classmethod
    def _replayable(cls, cmd, payload) -> bool:
        if cmd in cls._IDEMPOTENT:
            return True
        if cmd == "push_grads_sync":
            return payload.get("batch_id") is not None
        # fluid-haven: tagged barrierless pushes dedup server-side on
        # (trainer, seq, session) — replay-safe, including at a
        # promoted backup after a primary failover
        return cmd in ("push_grad", "push_grads", "push_sparse_grad") \
            and payload.get("seq") is not None

    # commands that legitimately block for a long time (barriers): a
    # default deadline would break them, so only an explicit per-call
    # deadline applies
    _NO_DEFAULT_DEADLINE = frozenset({"sync_apply", "batch_barrier"})

    # commands a read_only client may issue: the read set plus the
    # negotiation/introspection commands that mutate nothing server-side
    # (haven_role is how a serve-time client re-resolves a shard's
    # primary after a redirect)
    _READ_ONLY_ALLOWED = frozenset({"get_param", "get_params", "prefetch",
                                    "stats", "wire_caps", "haven_role"})

    def _phys(self, endpoint: str) -> str:
        """The physical endpoint currently serving logical `endpoint` —
        identity until a haven failover/redirect moves the mapping."""
        return self._primaries.get(endpoint, endpoint)

    def _resolve_primary(self, endpoint, wait: bool = True) -> bool:
        """Re-resolve which member of `endpoint`'s replica group is the
        PRIMARY by polling `haven_role` on every member; with `wait`,
        keep polling up to `failover_s` so a backup's lease-expiry
        promotion has time to land. Returns True when the mapping
        moved.

        Eligibility is deliberately asymmetric: the ORIGINAL endpoint
        counts as the writer whatever it answers (haven primary, solo,
        or a pre-haven server that rejects the command — it IS its
        shard's only writer), but a REPLICA member only wins with an
        explicit `role == "primary"` — a legacy read-replica listed for
        read failover must never be adopted as a write target. Waiting
        is justified only while some member reports `role == "backup"`
        (a standby that may still promote); against a plain dead server
        with legacy replicas this returns immediately."""
        cands = []
        for ep in [self._phys(endpoint), endpoint,
                   *self.replicas.get(endpoint, ())]:
            if ep not in cands:
                cands.append(ep)
        hinted = self._quorum_holder(endpoint)
        if hinted and hinted not in cands:
            # the arbiters' view leads the poll: the quorum holder is
            # the primary by construction (it may live at an endpoint
            # no configured candidate names), but it is still VERIFIED
            # below via haven_role — a stale minority view must not
            # route writes on its own
            cands.insert(0, hinted)
        deadline = time.monotonic() + (self.failover_s if wait else 0.0)
        while True:
            best, saw_standby, hints = None, False, []
            for ep in cands:
                try:
                    (status, value), _tx, _rx = self._call_one(
                        ep, "haven_role", {}, 1.0, False, None)
                except (ConnectionError, EOFError, OSError):
                    continue
                if status == "ok":
                    role = value.get("role")
                    epoch = value.get("epoch", -1)
                    # a standby/retired member ADVERTISES its primary:
                    # after a handover to a brand-new endpoint no
                    # configured candidate may be the primary at all —
                    # the hint is the only road to it
                    hint = value.get("primary")
                    if hint and hint not in cands and hint not in hints:
                        hints.append(hint)
                elif status == "err" and \
                        "unknown pserver command" in str(value):
                    role, epoch = "solo", -1   # pre-haven server
                else:
                    continue
                if role == "backup":
                    saw_standby = True
                    continue
                if role == "primary" or \
                        (role == "solo" and ep == endpoint):
                    if best is None or epoch > best[1]:
                        best = (ep, epoch)
            if best is None and hints:
                cands.extend(hints)
                continue   # poll the advertised primary immediately
            if best is not None:
                new = best[0]
                changed = new != self._phys(endpoint)
                if changed:
                    if new == endpoint:
                        self._primaries.pop(endpoint, None)
                    else:
                        self._primaries[endpoint] = new
                    _flight.note("haven_resolved", endpoint=endpoint,
                                 primary=new, epoch=best[1])
                return changed
            if not wait or not saw_standby \
                    or time.monotonic() >= deadline:
                return False
            time.sleep(0.25)

    def _quorum_holder(self, endpoint) -> Optional[str]:
        """Ask the arbiter group who holds `endpoint`'s shard lease
        (None without a quorum route, on a minority view, or when no
        arbiter answers)."""
        resource = self._quorum_resources.get(endpoint)
        if resource is None or not self._quorum_eps:
            return None
        if self._quorum_client is None:
            from ..quorum import QuorumClient
            with self._lock:
                if self._quorum_client is None:
                    self._quorum_client = QuorumClient(self._quorum_eps,
                                                       deadline_s=1.0)
        try:
            rec = self._quorum_client.holder(resource)
        except Exception:   # noqa: BLE001 — resolution is best-effort
            return None
        return rec["holder"] if rec else None

    def _call(self, endpoint, cmd, _deadline=..., **payload):
        """One logical RPC with retry/backoff/deadline; `_deadline=...`
        (unset) follows the client default, None disables, a float
        overrides.

        fluid-haven routing: the call targets the shard's CURRENT
        primary (`self._primaries`). A `redirect` reply (standby backup
        or retired server) moves the mapping and retries — the redirect
        preceded dispatch, so ANY command is safe to reissue. A
        transport failure of every member extends the old read-only
        failover rule to WRITES: for replay-safe commands (reads,
        first-wins inits, batch-tagged sync pushes, seq-tagged async
        pushes) the client re-resolves the primary — polling
        `haven_role` while the backup's lease-expiry promotion lands —
        and replays there; the server-side (trainer, batch/seq, nonce)
        watermarks make the replay exactly-once even when the dead
        primary had already applied and replicated it."""
        if self.read_only and cmd not in self._READ_ONLY_ALLOWED:
            raise RuntimeError(
                f"PSClient(read_only=True) refuses mutating command "
                f"{cmd!r} — the serve-time sparse read path may only "
                f"{sorted(self._READ_ONLY_ALLOWED)}")
        if _deadline is ...:
            _deadline = (None if cmd in self._NO_DEFAULT_DEADLINE
                         else self.deadline)
        obs = _flags.get_flag("observe")
        t0 = time.perf_counter() if obs else 0.0
        # fluid-xray call context: ONE span for the logical call (child of
        # the ambient trace, or the root of a fresh one). Every attempt —
        # retries AND replica failovers — parents to it, so retries share
        # the trace id with a new span per attempt, and a failover keeps
        # the same parent span.
        call_ctx = _xray.child_of() if obs else None
        ts_wall = time.time() if obs else 0.0
        served_ep, call_outcome = endpoint, "failed"
        status, value, tx, rx = "err", "unresolved", 0, 0
        try:
            for _hop in range(4):
                primary = self._phys(endpoint)
                candidates = [primary]
                if cmd in self._READ_ONLY:
                    candidates += [
                        ep for ep in ([endpoint]
                                      + self.replicas.get(endpoint, []))
                        if ep not in candidates]
                last_err = None
                reply = None
                for i, ep in enumerate(candidates):
                    try:
                        reply, tx, rx = self._call_one(
                            ep, cmd, payload, _deadline, obs, call_ctx)
                        served_ep = ep
                        break
                    except (ConnectionError, EOFError, OSError) as e:
                        last_err = e
                        if i + 1 < len(candidates) and obs:
                            _metrics.counter(
                                "pserver_client_failovers_total",
                                "reads rerouted to a replica "
                                "endpoint").inc(cmd=cmd, frm=ep)
                            _flight.note("rpc_failover", cmd=cmd, frm=ep,
                                         to=candidates[i + 1],
                                         error=type(e).__name__)
                        continue
                if reply is None:
                    # every member transport-failed: a replay-safe call
                    # against a haven pair waits out the promotion and
                    # replays at the re-resolved primary
                    if self.replicas.get(endpoint) and \
                            self._replayable(cmd, payload) and \
                            self._resolve_primary(
                                endpoint, wait=cmd != "heartbeat"):
                        if obs:
                            _metrics.counter(
                                "pserver_client_primary_failovers_total",
                                "calls replayed at a re-resolved shard "
                                "primary").inc(cmd=cmd)
                        _flight.note("haven_failover", cmd=cmd,
                                     frm=primary,
                                     to=self._phys(endpoint))
                        continue
                    if obs:
                        _flight.note("rpc_outcome", cmd=cmd,
                                     endpoint=endpoint, outcome="failed",
                                     error=type(last_err).__name__)
                    raise last_err
                status, value = reply
                if status == "redirect":
                    new = (value or {}).get("primary")
                    moved = False
                    if new and new != self._phys(endpoint):
                        self._primaries[endpoint] = new
                        moved = True
                    elif self.replicas.get(endpoint) or not new:
                        moved = self._resolve_primary(endpoint)
                    if moved:
                        if obs:
                            _metrics.counter(
                                "pserver_client_primary_failovers_total",
                                "calls replayed at a re-resolved shard "
                                "primary").inc(cmd=cmd)
                        _flight.note("haven_redirect", cmd=cmd,
                                     frm=served_ep,
                                     to=self._phys(endpoint))
                        continue
                    status, value = "err", \
                        f"NotPrimary: no reachable primary ({value})"
                call_outcome = "ok" if status == "ok" else "err_reply"
                break
            else:
                status, value = "err", ("redirect loop: the shard's "
                                        "primary keeps moving")
        finally:
            # attribute the logical call to the endpoint that actually
            # served it (after a failover that is the replica, not the
            # dead primary) and tag how it ended — a postmortem timeline
            # read top-down must not show a failed/rerouted call as a
            # clean success on the primary
            if call_ctx is not None:
                _xray.record_span(f"ps_call:{cmd}", call_ctx, ts_wall,
                                  time.perf_counter() - t0, cat="rpc",
                                  cmd=cmd, endpoint=served_ep,
                                  outcome=call_outcome)
        if obs:
            _metrics.counter(
                "pserver_client_requests_total",
                "client RPCs by command (push/pull counts)").inc(cmd=cmd)
            _metrics.counter(
                "pserver_client_bytes_sent_total",
                "wire bytes sent to pservers").inc(tx, cmd=cmd)
            _metrics.counter(
                "pserver_client_bytes_received_total",
                "wire bytes received from pservers").inc(rx, cmd=cmd)
            _metrics.histogram(
                "pserver_client_rpc_seconds",
                "client-observed RPC latency").observe(
                    time.perf_counter() - t0, cmd=cmd)
        if status != "ok":
            if obs:
                _flight.note("rpc_outcome", cmd=cmd, endpoint=endpoint,
                             outcome="err_reply", error=str(value)[:200])
            raise RuntimeError(f"pserver {endpoint} {cmd}: {value}")
        return value

    def _call_one(self, endpoint, cmd, payload, deadline, obs,
                  call_ctx=None):
        """The per-endpoint retry loop. Failure phases:

        - connect/send: the length-prefixed frame never reached the
          server complete, so it was never dispatched — ANY command is
          safe to retry;
        - recv (incl. a deadline timeout): the server may have applied
          the request — only replayable commands retry.

        fluid-xray: every ATTEMPT gets its own span (a fresh child of
        `call_ctx`, so retries and failovers share one trace id with a
        distinct span id per attempt); the attempt's context rides the
        frame as a traceparent meta element, making the server handler
        span its child.
        """
        policy = self.retry
        replay_ok = self._replayable(cmd, payload)
        deadline_at = None if deadline is None \
            else time.monotonic() + deadline
        with self._lock:
            ep_lock = self._ep_locks.setdefault(endpoint, threading.Lock())
        attempt = 0
        with ep_lock:  # one in-flight request per connection
            while True:
                phase = "connect"
                att_ctx = call_ctx.child() if call_ctx is not None else None
                att_ts = time.time() if obs else 0.0
                att_t0 = time.perf_counter() if obs else 0.0

                def _att_span(outcome):
                    if att_ctx is not None:
                        _xray.record_span(
                            f"rpc_client:{cmd}", att_ctx, att_ts,
                            time.perf_counter() - att_t0, cat="rpc",
                            cmd=cmd, endpoint=endpoint, attempt=attempt,
                            outcome=outcome)
                try:
                    # the connect itself honors the remaining deadline:
                    # rpc.connect's default 30 s would otherwise wedge a
                    # short-deadline call (heartbeats!) on a blackholed
                    # endpoint for 30 s per attempt
                    remaining = None if deadline_at is None else \
                        max(0.01, deadline_at - time.monotonic())
                    sock = self._sock(endpoint, connect_timeout=remaining)
                    if deadline_at is not None:
                        sock.settimeout(
                            max(0.01, deadline_at - time.monotonic()))
                    phase = "send"
                    frame = (cmd, payload)
                    if att_ctx is not None and self.wire_trace:
                        frame = (cmd, payload, _xray.to_wire(att_ctx))
                    tx = rpc.send_msg(sock, frame)
                    phase = "recv"
                    reply, rx = rpc.recv_msg(sock, with_size=True)
                    if deadline_at is not None:
                        sock.settimeout(None)
                    _att_span("ok")
                    return reply, tx, rx
                except (ConnectionError, EOFError, OSError):
                    _att_span(f"fail_{phase}")
                    self._drop_sock(endpoint)
                    safe = phase != "recv" or replay_ok
                    out_of_time = deadline_at is not None and \
                        time.monotonic() >= deadline_at
                    if not safe or attempt >= policy.max_attempts \
                            or out_of_time:
                        if obs:
                            _metrics.counter(
                                "pserver_client_gave_up_total",
                                "RPCs abandoned after exhausting retries "
                                "(or unsafe to replay)").inc(
                                    cmd=cmd, phase=phase)
                            _flight.note("rpc_gave_up", cmd=cmd,
                                         endpoint=endpoint, phase=phase,
                                         attempts=attempt + 1)
                        raise
                    if obs:
                        _metrics.counter(
                            "pserver_client_retries_total",
                            "RPC attempts replayed after a transport "
                            "failure").inc(cmd=cmd, phase=phase)
                        _flight.note("rpc_retry", cmd=cmd,
                                     endpoint=endpoint, phase=phase,
                                     attempt=attempt)
                    delay = policy.backoff(attempt)
                    attempt += 1
                    if deadline_at is not None:
                        delay = min(delay,
                                    max(0.0, deadline_at - time.monotonic()))
                    if delay:
                        time.sleep(delay)

    # -- wire codec (fluid-wire) ------------------------------------------
    def _codec_for(self, endpoint) -> Optional[str]:
        """The codec to use toward `endpoint`: `comm_quant` when the
        server advertises it (one cached `wire_caps` RPC per endpoint),
        else None (raw). A legacy server answers `wire_caps` with an
        unknown-command error reply — negotiate down to raw instead of
        feeding tagged payloads to handlers that would misread them."""
        if self.comm_quant is None:
            return None
        ok = self._wire_ok.get(endpoint)
        if ok is None:
            if self._wire_retry_at.get(endpoint, 0.0) > time.monotonic():
                return None   # recent unreachable verdict: raw, no probe
            outcome = "ok"
            try:
                # short-deadline probe: with the endpoint down, the probe
                # must not burn the full retry/backoff budget in front of
                # every call that could itself fail over to a replica
                caps = self._call(endpoint, "wire_caps", _deadline=2.0)
                ok = self.comm_quant in (caps or {}).get("codecs", ())
                if not ok:
                    outcome = "unsupported_codec"
            except RuntimeError as e:
                if "unknown pserver command" not in str(e):
                    raise
                ok, outcome = False, "legacy_raw"
            except (ConnectionError, EOFError, OSError):
                # the endpoint is unreachable right now: degrade THIS call
                # to raw instead of raising — negotiation must never cost
                # availability. In particular a READ against a dead
                # primary still reaches its replica: the prefetch itself
                # fails over (wire_caps deliberately does NOT — a
                # replica's caps must not be attributed to the primary's
                # endpoint key). Unlike legacy_raw/unsupported_codec this
                # verdict is NOT cached: a transient failure (pserver
                # restart mid-session — ark reconnects through those)
                # must not silently disable compression for the rest of
                # the session. A short cooldown amortizes the probe so a
                # long outage doesn't pay it in front of every call.
                ok, outcome = None, "unreachable"
                self._wire_retry_at[endpoint] = time.monotonic() + 30.0
            if ok is not None:
                self._wire_ok[endpoint] = ok
            if _flags.get_flag("observe"):
                _metrics.counter(
                    "pserver_wire_negotiations_total",
                    "wire-codec negotiations per endpoint (legacy servers "
                    "degrade to raw)").inc(endpoint=endpoint,
                                           codec=self.comm_quant,
                                           outcome=outcome)
        return self.comm_quant if ok else None

    def wire_state(self):
        """Error-feedback residuals as npz-compatible arrays — merge into
        an ark checkpoint's `arrays` and hand back to
        `restore_wire_state` after resume to keep pushes bit-identical
        to the uninterrupted run under `comm_quant` (the residual is
        trainer-local, so the server-side shard snapshot cannot carry
        it; see docs/COMMUNICATION.md §Checkpointing)."""
        return self._feedback.state_dict()

    def restore_wire_state(self, state) -> None:
        self._feedback.load_state_dict(state)

    @staticmethod
    def _account_wire(cmd, raw_nbytes, enc_nbytes):
        """Raw vs on-wire tensor bytes per command: compression ratio is
        a first-class metric (observe-gated like every runtime emitter)."""
        if not _flags.get_flag("observe"):
            return
        _metrics.counter(
            _wire.RAW_BYTES_METRIC,
            "tensor payload bytes before the wire codec, per command").inc(
                raw_nbytes, cmd=cmd)
        _metrics.counter(
            _wire.ENCODED_BYTES_METRIC,
            "tensor payload bytes after the wire codec (on-wire), per "
            "command").inc(enc_nbytes, cmd=cmd)

    def _push_grads_one(self, endpoint, cmd, grads, extra=None):
        """Encode (negotiated codec + error feedback) and send one
        per-endpoint grads dict. Residuals commit only after the call
        returns — transport retries resend the SAME encoded bytes and a
        caller-level retry re-encodes from the unchanged residual, so a
        replayed frame can never double-apply feedback (wire/feedback.py
        replay contract, drilled by chaos `quant_flaky_rpc`)."""
        codec = self._codec_for(endpoint)
        # sync pushes carry a (session, batch) identity: the residual
        # commit dedups on it, exactly like the server's accumulation
        tag = None
        if extra and extra.get("batch_id") is not None:
            tag = (extra.get("session"), extra.get("trainer_id"),
                   extra["batch_id"])
        wire_grads, commits = {}, []
        raw_b = enc_b = 0
        for name, g in grads.items():
            g = np.asarray(g)
            raw_b += g.nbytes
            if codec is None or g.dtype != np.float32:
                wire_grads[name] = g
                enc_b += g.nbytes
            else:
                payload, commit = self._feedback.encode(
                    (endpoint, name), g, codec, name=name, tag=tag)
                wire_grads[name] = payload
                enc_b += _wire.payload_nbytes(payload)
                commits.append(commit)
        self._account_wire(cmd, raw_b, enc_b)
        out = self._call(endpoint, cmd, grads=wire_grads, **(extra or {}))
        for commit in commits:
            commit()
        return out

    def _push_tag(self) -> Optional[dict]:
        """(seq, trainer, session) identity for ONE tagged barrierless
        push (fluid-haven). The seq is assigned once per logical push
        and stays stable across transport retries AND primary
        failovers, so the server-side async watermark acknowledges a
        replay without re-applying. Seqs are monotone per endpoint
        because a trainer issues its pushes sequentially (the
        per-endpoint fanout parallelism never races two pushes to one
        endpoint)."""
        if not self.dedup_pushes:
            return None
        with self._push_seq_lock:
            self._push_seq += 1
            return {"seq": self._push_seq, "trainer_id": self.trainer_id,
                    "session": self._session}

    # -- dense ------------------------------------------------------------
    def init_param(self, endpoint, name, value, opt_type, lr, attrs):
        self._call(endpoint, "init_param", name=name,
                   value=np.asarray(value), opt_type=opt_type, lr=lr,
                   attrs=attrs)

    def get_param(self, endpoint, name) -> np.ndarray:
        return self._call(endpoint, "get_param", name=name)

    def push_grad(self, endpoint, name, grad):
        grad = np.asarray(grad)
        tag = self._push_tag() or {}
        codec = self._codec_for(endpoint)
        if codec is None or grad.dtype != np.float32:
            self._account_wire("push_grad", grad.nbytes, grad.nbytes)
            self._call(endpoint, "push_grad", name=name, grad=grad, **tag)
            return
        payload, commit = self._feedback.encode((endpoint, name), grad,
                                                codec, name=name)
        self._account_wire("push_grad", grad.nbytes,
                           _wire.payload_nbytes(payload))
        self._call(endpoint, "push_grad", name=name, grad=payload, **tag)
        commit()

    def _fanout_each(self, calls: Dict[str, object]) -> Dict[str, object]:
        """Run one thunk per endpoint, endpoints in parallel (reference
        AsyncSendVar/AsyncGetVar handle overlap, grpc_client.cc:66/:122).
        Single-endpoint calls skip the pool."""
        if len(calls) <= 1:
            return {ep: fn() for ep, fn in calls.items()}
        futs = {ep: self._pool.submit(fn) for ep, fn in calls.items()}
        return {ep: f.result() for ep, f in futs.items()}

    def _fanout(self, cmd: str, payload_by_ep: Dict[str, dict]
                ) -> Dict[str, object]:
        return self._fanout_each(
            {ep: (lambda ep=ep, payload=payload:
                  self._call(ep, cmd, **payload))
             for ep, payload in payload_by_ep.items()})

    def get_params_parallel(self, by_ep: Dict[str, List[str]]
                            ) -> Dict[str, Dict[str, np.ndarray]]:
        return self._fanout("get_params",
                            {ep: {"names": names}
                             for ep, names in by_ep.items()})

    def push_grads_parallel(self, by_ep: Dict[str, Dict[str, np.ndarray]]):
        self._fanout_each(
            {ep: (lambda ep=ep, grads=grads, tag=self._push_tag():
                  self._push_grads_one(ep, "push_grads", grads, tag))
             for ep, grads in by_ep.items()})

    # -- sparse -------------------------------------------------------------
    def init_table(self, name, rows, width, dtype, init_low, init_high,
                   seed, opt_type, lr, attrs):
        """Create the row shard on every server (id % n_servers sharding)."""
        n = len(self.endpoints)
        for i, ep in enumerate(self.endpoints):
            local_rows = (rows - i + n - 1) // n  # rows with id % n == i
            self._call(ep, "init_table", name=name, local_rows=local_rows,
                       width=width, dtype=dtype, init_low=init_low,
                       init_high=init_high, seed=seed + i, opt_type=opt_type,
                       lr=lr, attrs=attrs)

    def prefetch_rows(self, name, ids: np.ndarray) -> np.ndarray:
        """Fetch rows for GLOBAL ids: split by id % n (reference
        split_ids_op), prefetch each shard, merge back in input order
        (reference merge_ids_op). ids must be non-empty (callers skip
        empty batches). With `comm_quant` negotiated, the reply rows
        arrive quantized (the embedding-row pull is the DeepFM-shape
        bandwidth hog) and are decoded here."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            raise ValueError(
                f"prefetch_rows({name!r}): empty ids — skip the prefetch "
                f"for empty batches instead")
        n = len(self.endpoints)
        out: Optional[np.ndarray] = None
        for i, ep in enumerate(self.endpoints):
            mask = (ids % n) == i
            if not mask.any():
                continue
            local = ids[mask] // n
            codec = self._codec_for(ep)
            kwargs = dict(name=name, local_ids=local)
            if codec is not None:
                kwargs["codec"] = codec
            try:
                reply = self._call(ep, "prefetch", **kwargs)
            except RuntimeError as e:
                # degrade-on-evidence: prefetch is read-only and may have
                # FAILED OVER to a replica that never negotiated — a
                # pre-wire replica rejects the codec kwarg with a
                # TypeError reply. Retry bare (raw is correct against
                # every version) instead of surfacing a hard failure from
                # a healthy replica, and DROP the cached verdict rather
                # than pinning the endpoint raw: the reply may have come
                # from the replica, and a replica's (lack of) caps must
                # not be attributed to the primary's endpoint key. The
                # next call re-negotiates wire_caps against the primary
                # itself — a healthy wire-aware primary gets compression
                # back, a genuinely legacy peer caches legacy_raw there.
                if "codec" not in kwargs or \
                        "keyword argument" not in str(e) or \
                        "codec" not in str(e):
                    raise
                self._wire_ok.pop(ep, None)
                del kwargs["codec"]
                reply = self._call(ep, "prefetch", **kwargs)
            rows = _wire.maybe_decode(reply)
            self._account_wire("prefetch", rows.nbytes,
                               _wire.payload_nbytes(reply))
            if out is None:
                out = np.empty((ids.shape[0], rows.shape[1]), rows.dtype)
            out[mask] = rows
        return out

    def push_sparse_grad(self, name, ids: np.ndarray, row_grads: np.ndarray):
        """Scatter row gradients to their shards; with `comm_quant`
        negotiated the rows travel int8/bf16 (no error feedback on the
        sparse path: the touched-row set changes every batch, so there is
        no per-tensor residual stream to carry — abs-max per chunk keeps
        the row update error at half an lsb)."""
        ids = np.asarray(ids).reshape(-1)
        n = len(self.endpoints)
        for i, ep in enumerate(self.endpoints):
            mask = (ids % n) == i
            if not mask.any():
                continue
            sub = np.asarray(row_grads)[mask]
            codec = self._codec_for(ep)
            payload = sub
            if codec is not None and sub.dtype == np.float32:
                payload = _wire.encode_tensor(sub, codec, name=name)
            self._account_wire("push_sparse_grad", sub.nbytes,
                               _wire.payload_nbytes(payload))
            self._call(ep, "push_sparse_grad", name=name,
                       local_ids=ids[mask] // n, row_grads=payload,
                       **(self._push_tag() or {}))

    # -- sync mode (reference RunSyncLoop) ----------------------------------
    def push_grads_sync(self, by_ep: Dict[str, Dict[str, np.ndarray]],
                        batch_id: Optional[int] = None, trainer_id: int = 0,
                        session: Optional[str] = None):
        """Batched per-endpoint sends whose updates are DEFERRED to the
        sync_apply barrier (reference kRequestSend accumulation).
        `batch_id` must increase monotonically per trainer and stay STABLE
        across retries of the same batch — the server uses it to reject
        duplicate accumulation when a partially-failed batch is retried.
        `session` identifies the trainer PROCESS; a restarted trainer
        sends a fresh nonce so its restarted id sequence is accepted."""
        extra = {} if batch_id is None else {
            "batch_id": int(batch_id), "trainer_id": int(trainer_id),
            "session": session}
        self._fanout_each(
            {ep: (lambda ep=ep, grads=grads:
                  self._push_grads_one(ep, "push_grads_sync", grads,
                                       dict(extra)))
             for ep, grads in by_ep.items()})

    def sync_apply(self, endpoints: Sequence[str],
                   trainer_id: Optional[int] = None):
        """Per-batch barrier on every server: blocks until ALL trainers
        have pushed and the aggregated update is applied (reference
        batch-barrier + optimize blocks, then kRequestGet unblocks).
        `trainer_id` identifies this arrival to the evicting barrier so
        a later eviction of THIS trainer discounts its arrival (ark
        liveness); untagged arrivals keep the legacy anonymous count."""
        payload = {} if trainer_id is None else \
            {"trainer_id": int(trainer_id)}
        self._fanout("sync_apply", {ep: dict(payload) for ep in endpoints})

    # -- control ------------------------------------------------------------
    def heartbeat(self, endpoint, trainer_id, session=None,
                  lease_s: float = 3.0):
        """Renew this trainer's liveness lease on `endpoint` (ark).
        Short deadline: a wedged server must not wedge the heartbeat
        loop — the whole point is detecting exactly that."""
        return self._call(endpoint, "heartbeat",
                          _deadline=min(lease_s, 2.0),
                          trainer_id=int(trainer_id), session=session,
                          lease_s=float(lease_s))

    def barrier(self):
        for ep in self.endpoints:
            self._call(ep, "batch_barrier")

    def save(self, dirname):
        return [self._call(ep, "save", dirname=dirname)
                for ep in self.endpoints]

    def stop_all(self):
        for ep in self.endpoints:
            try:
                self._call(ep, "stop")
            except (RuntimeError, ConnectionError, OSError):
                pass

    def close(self):
        self._pool.shutdown(wait=False)
        if self._quorum_client is not None:
            try:
                self._quorum_client.close()
            except Exception:
                pass
        with self._lock:
            for s in self._socks.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._socks.clear()
