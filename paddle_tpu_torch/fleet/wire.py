"""fluid-fleet transport: pooled, framed RPC between router and replicas.

Mirror of ``paddle_tpu/fleet/wire.py``, copied.

Rides the pserver rpc framing (length-prefixed restricted-pickle frames,
`pserver/rpc.py`) so the fleet speaks the wire the repo already hardens
— but with a CONNECTION POOL per peer instead of PSClient's one-socket-
per-endpoint: serving requests to one replica must overlap (a router
thread per client request checks a socket out, so N concurrent requests
to a replica ride N sockets), where the training client's per-endpoint
lock was the right call for ordered push/pull streams.

Reply taxonomy (the retriable-vs-terminal classification the router's
failover policy keys on):

    ("ok", value)                     success
    ("err_serve", {type, msg,         a serve.errors.ServeError — the
                   retriable})        name maps back to the class, so
                                      QueueFullError raised on a replica
                                      IS QueueFullError at the router
    ("err", "Type: msg")              anything else (a bug — terminal)

Transport failures (ConnectionError/EOFError/OSError) surface as-is;
the caller decides whether another peer can answer.
"""

from __future__ import annotations

import socket as _socket
import struct as _struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import flags as _flags
from ..observe import xray as _xray
from ..pserver import rpc as _rpc
from ..serve import errors as serve_errors

#: name -> class for reconstructing serve errors across the wire
SERVE_ERRORS: Dict[str, type] = {
    c.__name__: c
    for c in (serve_errors.ServeError, serve_errors.ModelNotFoundError,
              serve_errors.ModelUnavailableError,
              serve_errors.BadRequestError, serve_errors.QueueFullError,
              serve_errors.DeadlineExceededError,
              serve_errors.CacheExhaustedError,
              serve_errors.KVTransferError)
}


def serve_error_reply(e: serve_errors.ServeError) -> Tuple[str, dict]:
    """The ("err_serve", ...) reply for a ServeError raised in a replica
    handler."""
    return ("err_serve", {"type": type(e).__name__, "msg": str(e),
                          "retriable": bool(getattr(e, "retriable",
                                                    False))})


def raise_serve_error(payload: dict):
    """Rebuild (and raise) the replica-side ServeError at the caller."""
    cls = SERVE_ERRORS.get(payload.get("type"), serve_errors.ServeError)
    raise cls(payload.get("msg", "remote serve error"))


class HardCutServer:
    """The pserver accept-loop + hard-teardown idiom, factored ONCE for
    both fleet sides (FleetRouter's control endpoint and ReplicaServer):
    bind an ephemeral-capable listener, spawn a daemon thread per
    accepted connection, track live sockets, and on `_hard_cut()` die
    like a killed process — listener shut down, every live connection
    RST-closed (SO_LINGER 0) so blocked peers see the death NOW instead
    of a FIN_WAIT_2 hang. Subclasses implement `_serve_conn(conn)` (the
    per-connection request/reply loop; the accept plumbing handles
    tracking and close)."""

    def __init__(self):
        self._listener: Optional[_socket.socket] = None
        self._conns: set = set()  # guarded_by: self._conns_lock
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    def _bind_and_accept(self, endpoint: str, thread_name: str) -> str:
        """Bind `endpoint` (port 0 = ephemeral), start the accept loop;
        returns the bound host:port."""
        host, port = _rpc.parse_endpoint(endpoint)
        self._listener = _socket.socket(_socket.AF_INET,
                                        _socket.SOCK_STREAM)
        self._listener.setsockopt(_socket.SOL_SOCKET,
                                  _socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        bound = f"{host}:{self._listener.getsockname()[1]}"
        self._listener.listen(64)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=thread_name).start()
        return bound

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._conn_entry, args=(conn,),
                             daemon=True).start()

    def _conn_entry(self, conn):
        try:
            self._serve_conn(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _serve_conn(self, conn):   # pragma: no cover - abstract
        raise NotImplementedError

    def _hard_cut(self):
        """Kill the transport NOW (listener + every live connection)."""
        self._stop.set()
        if self._listener is not None:
            for f in ("shutdown", "close"):
                try:
                    (self._listener.shutdown(_socket.SHUT_RDWR)
                     if f == "shutdown" else self._listener.close())
                except OSError:
                    pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.setsockopt(_socket.SOL_SOCKET, _socket.SO_LINGER,
                             _struct.pack("ii", 1, 0))
            except OSError:
                pass
            for f in ("shutdown", "close"):
                try:
                    (c.shutdown(_socket.SHUT_RDWR) if f == "shutdown"
                     else c.close())
                except OSError:
                    pass


class ConnPool:
    """A small stack of idle sockets to one endpoint. checkout() hands a
    connected socket out (reusing an idle one when available); checkin()
    returns it; a socket that saw a transport error is closed, never
    pooled. Idle sockets beyond `max_idle` are closed on checkin."""

    def __init__(self, endpoint: str, max_idle: int = 8,
                 connect_timeout: float = 5.0):
        self.endpoint = endpoint
        self.max_idle = int(max_idle)
        self.connect_timeout = float(connect_timeout)
        self._lock = threading.Lock()
        self._idle: List = []
        self._closed = False

    def checkout(self):
        with self._lock:
            if self._closed:
                raise ConnectionError(
                    f"pool to {self.endpoint} is closed")
            if self._idle:
                return self._idle.pop()
        return _rpc.connect(self.endpoint, timeout=self.connect_timeout)

    def checkin(self, sock, broken: bool = False):
        if sock is None:
            return
        if broken:
            try:
                sock.close()
            except OSError:
                pass
            return
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            try:
                s.close()
            except OSError:
                pass


def call(pool: ConnPool, cmd: str, payload: Optional[dict] = None,
         deadline_s: Optional[float] = None):
    """One request/reply over a pooled socket. Returns the reply VALUE;
    raises the mapped ServeError for ("err_serve", ...), RuntimeError
    for ("err", ...), and lets transport errors propagate (the socket is
    discarded either way on failure).

    fluid-xray: with the observe flag on, the frame carries a fresh
    child of the ambient traceparent as the optional third element, and
    the call records that child as a `fleet_call:<cmd>` span — the
    replica handler's `replica:<cmd>` span parents under it, so the
    stitched fleet timeline has no orphaned hop (exactly the pserver
    client's per-attempt `rpc_client` shape)."""
    sock = pool.checkout()
    broken = True
    ctx = _xray.child_of() if _flags.get_flag("observe") else None
    ts_wall, t0 = time.time(), time.perf_counter()
    status = "transport_error"
    try:
        if deadline_s is not None:
            sock.settimeout(deadline_s)
        frame = (cmd, payload or {})
        if ctx is not None:
            frame = (cmd, payload or {}, _xray.to_wire(ctx))
        _rpc.send_msg(sock, frame)
        status, value = _rpc.recv_msg(sock)
        if deadline_s is not None:
            sock.settimeout(None)
        broken = False
        if status == "ok":
            return value
        if status == "err_serve":
            raise_serve_error(value)
        raise RuntimeError(f"fleet peer {pool.endpoint} {cmd}: {value}")
    finally:
        if ctx is not None:
            _xray.record_span(
                f"fleet_call:{cmd}", ctx, ts_wall,
                time.perf_counter() - t0, cat="fleet", cmd=cmd,
                endpoint=pool.endpoint, status=status)
        pool.checkin(sock, broken=broken)
