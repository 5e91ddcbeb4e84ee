"""fluid-fleet replica: the RPC front of one InferenceServer.

Mirror of ``paddle_tpu/fleet/replica.py``, copied; the replies of
`infer` go through `core.executor.host_array`, so no card tensor is
pickled, and the simulated device time queues its sleep outside the
lock that serializes it.

One serving process = one ``InferenceServer`` (registry + batchers +
engines, exactly as fluid-serve built it) + one ``ReplicaServer`` that
exposes it on a TCP endpoint the router can dispatch to:

    infer / generate       the request path (replies carry the VERSION
                           that executed the request — the router's
                           skew gate is built on this tag)
    readyz                 the same per-model verdict the pulse /readyz
                           HTTP endpoint serves (version, warmed, queue
                           depth/saturation) — the RPC fallback for
                           deployments without the observe flag
    prepare_swap /         the replica half of the coordinated swap:
    commit_swap /          stage+warm now, flip on the router's word,
    abort_swap             roll back if any peer failed
    fleet_stats            serving stats + the observatory's unexpected-
                           recompile count, so a fleet drill can gate
                           "zero steady-state recompiles" across every
                           replica process

Membership: the replica heartbeats the router's control endpoint on the
ark lease-renewal rule (``HeartbeatThread(beat=...)``, renew at a third
of the lease) — a SIGKILLed replica simply stops renewing and the
router's ``LeaseTable`` expires it; an explicit ``leave`` is sent on
clean stop. ``stop()`` is a hard cut (listener + live connections RST),
mirroring ``ParameterServer.stop`` so chaos drills can treat it as a
process death.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Optional

import numpy as np

from .. import flags as _flags
from ..ark.heartbeat import HeartbeatThread
from ..core.executor import host_array as _host_array
from ..observe import steplog as _steplog
from ..observe import xray as _xray
from ..pserver import rpc as _rpc
from ..serve.errors import ServeError
from ..serve.server import InferenceServer
from ..torrent.prefill import prefill_and_stream
from ..torrent.stream import KVStreamReceiver
from . import wire as _wire

logger = logging.getLogger(__name__)

_ROLES = ("prefill", "decode", "both")


class ReplicaServer(_wire.HardCutServer):
    def __init__(self, server: InferenceServer, endpoint: str = "127.0.0.1:0",
                 replica_id: Optional[str] = None,
                 router_endpoint: Optional[str] = None,
                 lease_s: float = 3.0,
                 simulate_device_ms: float = 0.0,
                 quorum=None,
                 quorum_member_prefix: str = "fleet-member:",
                 role: str = "both"):
        """`quorum` (fluid-quorum, a `QuorumClient`) makes this
        replica's membership partition-safe: each heartbeat round also
        renews its OWN lease at the arbiter group under
        `<quorum_member_prefix><replica_id>` with the replica id as the
        holder — exactly what a router armed with
        `RouterConfig(quorum=..., quorum_member_prefix=...)` verifies,
        so a replica that lost its path to the router (but not to the
        arbiters) is not falsely evicted from membership.

        `simulate_device_ms` is a REHEARSAL-RIG knob (CPU containers,
        often single-core): it sleeps that long per served request,
        standing in for the device time a real replica spends off
        the host CPU. It is what lets the multi-replica loadgen measure
        ROUTER/RPC scaling on a 1-core rig — the drill records it, and
        it must be 0 in any real deployment.

        `role` is the fluid-torrent pool assignment this replica
        advertises (heartbeat + readiness): "prefill" and "decode"
        replicas take only their half of disaggregated traffic from
        `FleetRouter.generate_torrent`; "both" (default) is eligible for
        everything, including classic co-located `generate`. The role is
        a ROUTING hint, not an enforcement boundary — every handler
        stays available, so an operator can drain a pool by re-roling
        without stranding in-flight work."""
        super().__init__()
        if role not in _ROLES:
            raise ValueError(f"role must be one of {_ROLES}, got {role!r}")
        self.server = server
        self.replica_id = replica_id or f"r-{uuid.uuid4().hex[:8]}"
        self.session = uuid.uuid4().hex
        self.role = role
        self.router_endpoint = router_endpoint
        self.lease_s = float(lease_s)
        self.simulate_device_s = max(0.0, float(simulate_device_ms)) / 1e3
        # ONE simulated device per replica: concurrent requests must
        # SERIALIZE their simulated device time (a card runs one batch
        # at a time) or a single replica would show no throughput
        # ceiling and the scaling drill would measure nothing
        self._device_lock = threading.Lock()
        self._device_free_at = 0.0  # guarded_by: self._device_lock
        self.endpoint = endpoint
        self.quorum = quorum
        self.quorum_member_prefix = str(quorum_member_prefix)
        self._heartbeat: Optional[HeartbeatThread] = None
        self._router_pool: Optional[_wire.ConnPool] = None
        # fluid-torrent: the decode half's staging table, and the
        # prefill half's connection pools to decode replicas
        self._kv_recv = KVStreamReceiver(self._torrent_admit)
        self._torrent_lock = threading.Lock()
        # guarded_by: self._torrent_lock — decode endpoint -> ConnPool
        self._torrent_pools = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaServer":
        self.endpoint = self._bind_and_accept(
            self.endpoint, f"fleet-replica@{self.endpoint}")
        logger.info("fleet replica %s listening on %s", self.replica_id,
                    self.endpoint)
        if self.router_endpoint:
            self._router_pool = _wire.ConnPool(self.router_endpoint,
                                              max_idle=1)
            self._heartbeat = HeartbeatThread(
                beat=self._beat_router, lease_s=self.lease_s,
                quorum=self.quorum,
                quorum_resource=(f"{self.quorum_member_prefix}"
                                 f"{self.replica_id}"),
                quorum_holder=self.replica_id)
            # synchronous first beat: membership exists before the first
            # request could be routed here
            self._heartbeat.beat_once()
            self._heartbeat.start()
        return self

    def _beat_router(self):
        _wire.call(self._router_pool, "replica_heartbeat", {
            "replica_id": self.replica_id,
            "endpoint": self.endpoint,
            "session": self.session,
            "pulse_port": self.server.pulse_port,
            "lease_s": self.lease_s,
            "role": self.role,
        }, deadline_s=min(self.lease_s, 2.0))

    def kill(self):
        """SIGKILL analog for in-process chaos tests: the RPC front dies
        NOW — no leave, no heartbeat-stop courtesy; the router learns of
        the death the hard way (transport failover + lease expiry),
        which is exactly what the test wants to observe."""
        self._do_stop(leave=False)

    def stop(self):
        """Hard cut of the transport, but a CLEAN membership exit: the
        router is told to leave, so planned shutdowns (deploys, scale-
        down) never cost a failover."""
        self._do_stop(leave=True)

    def _do_stop(self, leave: bool):
        if self._stop.is_set():
            return
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._router_pool is not None:
            if leave:
                try:
                    _wire.call(self._router_pool, "replica_leave",
                               {"replica_id": self.replica_id},
                               deadline_s=1.0)
                except Exception:
                    pass   # lease expiry covers an unreachable router
            self._router_pool.close()
        with self._torrent_lock:
            pools = list(self._torrent_pools.values())
            self._torrent_pools.clear()
        for p in pools:
            p.close()
        self._hard_cut()

    def close(self):
        """Clean shutdown: stop the RPC front, then the serving stack."""
        self.stop()
        self.server.close()

    # -- connection handling (accept/teardown: wire.HardCutServer) ---------

    def _serve_conn(self, conn):
        while not self._stop.is_set():
            try:
                msg = _rpc.recv_msg(conn)
            except (ConnectionError, EOFError, OSError):
                return
            if self._stop.is_set():
                return   # a stopped replica behaves like a dead one
            try:
                cmd, payload = msg[0], msg[1]
                meta = msg[2] if len(msg) >= 3 else None
            except (TypeError, IndexError):
                _rpc.send_msg(conn, ("err", "MalformedFrame: expected "
                                     "(cmd, payload[, meta])"))
                continue
            obs = _flags.get_flag("observe")
            wctx = _xray.from_wire(meta) if obs and meta else None
            try:
                if wctx is not None:
                    with _xray.activate(wctx), \
                            _xray.span(f"replica:{cmd}", cat="fleet",
                                       cmd=cmd,
                                       replica=self.replica_id):
                        reply = self._dispatch(cmd, payload)
                else:
                    reply = self._dispatch(cmd, payload)
            except ServeError as e:
                # named + classified: the router re-raises the SAME
                # class and keys failover on its retriable bit
                reply = _wire.serve_error_reply(e)
            except Exception as e:
                reply = ("err", f"{type(e).__name__}: {e}")
            try:
                _rpc.send_msg(conn, reply)
            except (ConnectionError, OSError):
                return
            if cmd == "stop":
                return

    def _dispatch(self, cmd, p):
        handler = getattr(self, f"_h_{cmd}", None)
        if handler is None:
            raise ValueError(f"unknown fleet replica command {cmd!r}")
        return handler(**p)

    # -- request path ------------------------------------------------------

    def _h_infer(self, model, feed, deadline_ms=None):
        fut = self.server.submit(
            model, {k: np.asarray(v) for k, v in feed.items()},
            deadline_ms=deadline_ms)
        # queued-deadline enforcement lives in the batcher; the slack
        # covers a batch already executing when the deadline strikes
        timeout = None if deadline_ms is None else deadline_ms / 1e3 + 30.0
        outs = fut.result(timeout=timeout)
        if self.simulate_device_s:
            self._simulated_device_time()
        # host numpy only: the wire's restricted unpickler admits no
        # card tensor
        return ("ok", {"outs": [_host_array(o) for o in outs],
                       "version": getattr(fut, "version_id", None),
                       "version_key": getattr(fut, "version_key", None),
                       "replica_id": self.replica_id})

    def _h_generate(self, model, prompt, max_new_tokens=16,
                    deadline_ms=None):
        res = self.server.generate(model, prompt,
                                   max_new_tokens=max_new_tokens,
                                   deadline_ms=deadline_ms)
        if self.simulate_device_s:
            self._simulated_device_time()
        ver_key = None
        try:
            cur = self.server.registry.get(model)
            if cur.version_id == res.version_id:
                ver_key = cur.version_key
        except Exception:
            pass
        return ("ok", {"tokens": list(res.tokens),
                       "version": res.version_id,
                       "version_key": ver_key,
                       "ttft_us": res.ttft_us,
                       # engine-observed TTFT rides FleetResult.outs so
                       # fleet callers (torrent_bench's co-located arm)
                       # can compare first-token latency across modes
                       "outs": {"ttft_us": res.ttft_us,
                                "finish_reason": res.finish_reason},
                       "replica_id": self.replica_id})

    def _simulated_device_time(self):
        """Spend `simulate_device_s` on the one simulated device: take the
        next free slot under the lock, sleep to its end outside it, so
        concurrent requests serialize their device time as a queue
        without a sleep under the lock."""
        with self._device_lock:
            start = max(time.monotonic(), self._device_free_at)
            self._device_free_at = end = start + self.simulate_device_s
        time.sleep(max(0.0, end - time.monotonic()))

    # -- fluid-torrent (disaggregated generation halves) -------------------

    def _torrent_pool(self, endpoint: str) -> _wire.ConnPool:
        with self._torrent_lock:
            pool = self._torrent_pools.get(endpoint)
            if pool is None:
                pool = self._torrent_pools[endpoint] = _wire.ConnPool(
                    endpoint, max_idle=2)
            return pool

    def _torrent_admit(self, model, prompt, first_token, kv, max_new,
                       trace):
        """KVStreamReceiver admit hook: inject the wire-delivered
        payload into this replica's decode engine. The kv_begin record's
        trace context (the ORIGINATING routed request) is activated
        around the submit so the decode engine's serve_generate span
        stitches into the same trace as the prefill half."""
        wctx = (_xray.from_wire(trace)
                if _flags.get_flag("observe") and trace else None)
        if wctx is not None:
            with _xray.activate(wctx):
                return self.server.submit_prefilled(
                    model, prompt, first_token, kv,
                    max_new_tokens=max_new)
        return self.server.submit_prefilled(
            model, prompt, first_token, kv, max_new_tokens=max_new)

    def _h_torrent_prefill(self, model, prompt, seq_id, decode_endpoint,
                           max_new_tokens=16, deadline_ms=None):
        """Prefill half: run the prompt here, stream its KV blocks to
        `decode_endpoint`'s `torrent_kv` handler. The router dispatches
        this least-loaded over the prefill pool; a KVTransferError reply
        means the DECODE side is gone — the router re-pins and retries,
        it does not shed this to another prefill replica."""
        trace = None
        if _flags.get_flag("observe") and _xray.current() is not None:
            trace = _xray.to_wire(_xray.current())
        pool = self._torrent_pool(decode_endpoint)

        def send(records):
            value = _wire.call(pool, "torrent_kv", {"records": records},
                               deadline_s=min(
                                   self.lease_s * 2, 10.0))
            return int(value["acked"])

        out = prefill_and_stream(
            self.server, model, prompt, int(max_new_tokens), seq_id,
            send, deadline_ms=deadline_ms, trace=trace)
        # no simulate_device_s sleep here: torrent rehearsals price
        # device time with the serve engine's phase-shaped knobs
        # (simulate_prefill_us_per_token / simulate_decode_step_us),
        # which already ran inside prefill_and_stream — sleeping again
        # under _device_lock would double-charge the prefill
        # the summary rides FleetResult.outs (torrent_prefill is a
        # control reply, not a fetch list)
        return ("ok", {"outs": out, "replica_id": self.replica_id})

    def _h_torrent_kv(self, records):
        """Decode half, transfer plane: apply one record batch, reply
        the contiguous acked watermark (the sender's resume point)."""
        return ("ok", self._kv_recv.handle(records))

    def _h_torrent_collect(self, model, seq_id, deadline_ms=None):
        """Decode half, result plane: block until the injected
        generation finishes, reply its tokens (shaped like generate so
        the router's FleetResult mapping is shared). Collecting releases
        the staging — collect-once semantics."""
        fut = self._kv_recv.future(seq_id)
        timeout = 60.0 if deadline_ms is None else deadline_ms / 1e3 + 30.0
        res = fut.result(timeout=timeout)
        self._kv_recv.release(seq_id)
        ver_key = None
        try:
            cur = self.server.registry.get(model)
            if cur.version_id == res.version_id:
                ver_key = cur.version_key
        except Exception:
            pass
        return ("ok", {"tokens": list(res.tokens),
                       "finish_reason": res.finish_reason,
                       "version": res.version_id,
                       "version_key": ver_key,
                       "ttft_us": res.ttft_us,
                       "replica_id": self.replica_id})

    def _h_torrent_cancel(self, seq_id):
        """Drop a transfer's staging/future (router released the
        session). The generation itself, if already admitted, runs to
        completion on the engine — cancel severs the collect path."""
        self._kv_recv.release(seq_id)
        return ("ok", {"released": True})

    # -- readiness / stats -------------------------------------------------

    def readiness(self) -> dict:
        """The per-model verdict, shaped like the pulse /readyz check's
        detail — one fact set whichever transport polls it."""
        ok, detail = self.server._pulse_queue_check()
        return {"status": "ok" if ok else "unready",
                "replica_id": self.replica_id,
                "session": self.session,
                "models": detail,
                "role": self.role,
                "pulse_port": self.server.pulse_port}

    def _h_readyz(self):
        return ("ok", self.readiness())

    def _h_ping(self):
        return ("ok", {"replica_id": self.replica_id,
                       "session": self.session})

    def _h_fleet_stats(self):
        sparse = {}
        for name in self.server.registry.names():
            try:
                plan = self.server.registry.get(name).sparse_plan
            except Exception:
                continue
            if plan is not None:
                sparse[name] = plan.stats()
        return ("ok", {
            "replica_id": self.replica_id,
            "stats": self.server.stats(),
            "sparse": sparse,
            # the cross-process observatory gate: a fleet drill sums
            # this over every replica and requires ZERO growth after
            # warmup — steady-state recompiles anywhere fail the fleet
            "unexpected_recompiles":
                len(_steplog.observatory().unexpected()),
        })

    # -- coordinated swap --------------------------------------------------

    def _h_prepare_swap(self, model, dirname=None):
        ver = self.server.prepare_swap(model, dirname)
        return ("ok", {"version": ver.version_id,
                       "version_key": ver.version_key,
                       "warmed": bool(ver.warmed)})

    def _h_commit_swap(self, model):
        ver = self.server.commit_swap(model)
        return ("ok", {"version": ver.version_id,
                       "version_key": ver.version_key})

    def _h_abort_swap(self, model):
        return ("ok", {"aborted": self.server.abort_swap(model)})

    def _h_stop(self):
        # reply first (the dispatcher sends, then the conn thread exits),
        # then die hard on a helper thread so the caller gets its ack
        threading.Thread(target=self.stop, daemon=True).start()
        return ("ok", None)
