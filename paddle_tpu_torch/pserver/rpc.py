"""Socket RPC for the host parameter-server runtime.

Capability parity with the reference's gRPC transport (reference:
paddle/fluid/operators/distributed/grpc_client.cc:66-329,
grpc_server.cc:82-415, send_recv.proto.in:20-40 `VariableMessage`).

Mirror of ``paddle_tpu/pserver/rpc.py``, copied. Collectives cover every
*synchronous* distribution mode, but the barrierless parameter-server mode (RunAsyncLoop,
listen_and_serv_op.cc:195) and the distributed sparse lookup table have no
collective analog — they need a host-side service. The reference vendors
gRPC+protobuf for this; here the wire format is length-prefixed pickles of
(cmd, payload) tuples over TCP — numpy arrays serialize zero-copy via
pickle protocol 5 buffers, and the stdlib socket layer keeps the runtime
dependency-free.

fluid-xray frame extension: a request frame MAY carry a third element,
a meta dict — today `{"traceparent": "00-<trace>-<span>-01"}` (W3C
trace context, observe/xray.py) — so client and server spans of one
call share a trace id across processes. The server accepts both the
2- and 3-tuple shapes (a legacy client without the field still
interoperates); a client talking to a legacy SERVER sends the plain
2-tuple (`PSClient(wire_trace=False)`, and no meta is ever attached
while the `observe` flag is off). Replies stay (status, value) 2-tuples.

fluid-wire payload extension: tensor values inside a payload MAY be
codec-tagged dicts instead of bare ndarrays (wire/codec.py — int8
per-chunk abs-max or bf16, `{"__wire__": 1, "codec": ..., "data": ...}`)
so gradient pushes and sparse-row pulls travel 2-4x smaller. The frame
layer here is codec-agnostic: tagged payloads are plain containers of
numpy arrays, already admitted by the restricted unpickler below. Raw
ndarrays remain the default wire shape — a client only sends tagged
payloads to a server that advertised them via the `wire_caps` command
(legacy servers answer unknown-command and the client degrades to raw,
the same interop posture as the xray meta element).
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
from typing import Any, Tuple

_HDR = struct.Struct("!Q")  # 8-byte big-endian length prefix


class RPCConnectionError(ConnectionError):
    """The peer closed or reset the connection mid-frame. Carries the
    endpoint and the read progress so a half-delivered message surfaces
    as a diagnosable transport failure, not a bare struct.error or
    short-read EOFError (reference grpc_client.cc surfaces the endpoint
    in every failed-RPC log line for the same reason)."""


def _peer_of(sock: socket.socket) -> str:
    try:
        host, port = sock.getpeername()[:2]
        return f"{host}:{port}"
    except OSError:
        return "<disconnected>"


# test-only fault injection point (ark/chaos.py). The hook receives
# (direction, sock, wire_bytes_or_None) and returns the bytes to send
# (possibly delayed/modified), or None when it consumed or discarded the
# message itself. None hook (default) costs one attribute read per call.
_fault_hook = None


def set_fault_hook(fn) -> None:
    global _fault_hook
    _fault_hook = fn


def get_fault_hook():
    return _fault_hook

# Trust boundary: like the reference's INSECURE gRPC channels
# (grpc_client.cc creates no credentials), this transport assumes a trusted
# cluster network. Defense in depth: deserialization goes through a
# restricted unpickler that only reconstructs numpy arrays/scalars and plain
# containers, so a stray connection cannot smuggle a __reduce__ payload into
# arbitrary code execution.
_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy", "int32"), ("numpy", "int64"),
    ("numpy", "float32"), ("numpy", "float64"), ("numpy", "bool_"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"pserver wire protocol forbids {module}.{name}")


def send_msg(sock: socket.socket, obj: Any) -> int:
    """Send one length-prefixed message; returns the wire byte count so
    observing callers can account traffic without re-serializing."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _HDR.pack(len(payload)) + payload
    if _fault_hook is not None:
        data = _fault_hook("send", sock, data)
        if data is None:   # injected drop/truncate consumed the message
            return _HDR.size + len(payload)
    sock.sendall(data)
    return _HDR.size + len(payload)


def recv_msg(sock: socket.socket, with_size: bool = False) -> Any:
    """Receive one message. `with_size=True` returns (obj, wire_bytes)
    for telemetry callers; the default keeps the legacy single-value
    return."""
    if _fault_hook is not None:
        _fault_hook("recv", sock, None)
    header = _recv_exact(sock, _HDR.size, what="header")
    (n,) = _HDR.unpack(header)
    obj = _RestrictedUnpickler(
        io.BytesIO(_recv_exact(sock, n, what="payload"))).load()
    if with_size:
        return obj, _HDR.size + n
    return obj


def _recv_exact(sock: socket.socket, n: int, what: str = "message") -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise RPCConnectionError(
                f"peer {_peer_of(sock)} closed connection mid-{what}: "
                f"got {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    host, port = endpoint.rsplit(":", 1)
    return host or "127.0.0.1", int(port)


def connect(endpoint: str, timeout: float = 30.0) -> socket.socket:
    host, port = parse_endpoint(endpoint)
    sock = socket.create_connection((host, port), timeout=timeout)
    # the timeout above guards only the CONNECT; replies may legitimately
    # take longer (barrier with skewed trainers, large gets) and a timeout
    # mid-exchange would desynchronize the length-prefixed stream. Dead
    # peers are detected by TCP keepalive instead of a read timeout.
    sock.settimeout(None)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10),
                     ("TCP_KEEPCNT", 6)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
