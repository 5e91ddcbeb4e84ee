"""Seed-deterministic fault injection for the pserver wire protocol.

Mirror of ``paddle_tpu/ark/chaos.py``, copied.

The chaos harness proves the recovery paths actually recover: it wraps
`pserver.rpc.send_msg`/`recv_msg` through the module's fault hook and
injects the failure modes a flaky network or a dying process produces —

    drop      the request/reply vanishes (blackhole; the peer never sees
              it, the caller blocks until its deadline)
    delay     the message is late by a uniform draw from `delay_s`
    truncate  the connection dies MID-FRAME: a prefix of the wire bytes
              is delivered, then the socket closes (exercises the
              `RPCConnectionError` bytes-read/expected path)
    close     the connection dies cleanly before the message

plus process-level helpers: `kill_server` is a SIGKILL-equivalent hard
cut of an in-process `ParameterServer` (its `stop()` already drops
in-flight requests unanswered by contract), and `restart_server` brings
a fresh server up on the same endpoint, optionally recovering its shard
from a checkpoint.

Every decision comes from one `random.Random(seed)` stream, so a failing
chaos run replays byte-identically. Faults are injected on ONE side
(default the client's) selected by thread name — pserver connection
threads are named `psconn@<endpoint>` — so a drill can separately attack
requests and replies.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
from typing import Optional, Set, Tuple

logger = logging.getLogger(__name__)


def _rpc():
    # lazy: pserver.client imports ark.retry, so a module-level import
    # here would close an import cycle through the two packages
    from ..pserver import rpc
    return rpc


def _is_server_thread() -> bool:
    return threading.current_thread().name.startswith("psconn@")


# -- actor identity (fluid-quorum / NetPartition) -------------------------
#
# A partition is defined between ACTORS (logical processes), not
# sockets. The sender of a message is identified, in order: an explicit
# thread-local set via `acting_as(endpoint)` (how a pooled client
# thread inherits its owner's identity), else the `...@<endpoint>`
# suffix every server-owned thread already carries (psconn@/qconn@
# connection threads, haven-fwd@/haven-monitor@/quorum-renew@ loops).
# Threads with neither (a trainer's own threads) are the anonymous
# actor None, which partition rules can target with the "*" wildcard.

_thread_actor = threading.local()


def set_thread_actor(endpoint: Optional[str]) -> None:
    _thread_actor.endpoint = endpoint


@contextlib.contextmanager
def acting_as(endpoint: Optional[str]):
    """Attribute every message this thread sends inside the context to
    `endpoint` — how a client owned by server X marks its outbound
    traffic as X's even from a shared worker pool."""
    prev = getattr(_thread_actor, "endpoint", None)
    _thread_actor.endpoint = endpoint
    try:
        yield
    finally:
        _thread_actor.endpoint = prev


def current_actor() -> Optional[str]:
    ep = getattr(_thread_actor, "endpoint", None)
    if ep is not None:
        return ep
    name = threading.current_thread().name
    if "@" in name:
        return name.rsplit("@", 1)[1]
    return None


class ChaosMonkey:
    """Install with `with ChaosMonkey(seed=..., p_drop=0.1): ...` (or
    `.start()` / `.stop()`). Probabilities are per-message; `side`
    selects whose sends are attacked: "client" (requests), "server"
    (replies), or "both". Counters on the instance record what fired so
    tests can assert the fault actually happened."""

    def __init__(self, seed: int = 0, p_drop: float = 0.0,
                 p_delay: float = 0.0, p_truncate: float = 0.0,
                 p_close: float = 0.0,
                 delay_s: Tuple[float, float] = (0.005, 0.05),
                 side: str = "client"):
        if side not in ("client", "server", "both"):
            raise ValueError(f"side must be client/server/both, got {side!r}")
        self.rng = random.Random(seed)
        self.p_drop, self.p_delay = p_drop, p_delay
        self.p_truncate, self.p_close = p_truncate, p_close
        self.delay_s = delay_s
        self.side = side
        self.injected = {"drop": 0, "delay": 0, "truncate": 0, "close": 0}
        self._lock = threading.Lock()
        self._installed = False

    # -- hook ------------------------------------------------------------
    def _applies(self) -> bool:
        on_server = _is_server_thread()
        return (self.side == "both"
                or (self.side == "server") == on_server)

    def _hook(self, direction: str, sock, data: Optional[bytes]):
        """rpc fault hook: returns the (possibly modified) bytes to send,
        or None when the hook consumed/discarded the message itself.
        For `recv` only delay/close apply (data is None)."""
        if not self._applies():
            return data
        with self._lock:   # one deterministic decision stream
            r = self.rng.random()
            p = 0.0
            for fault in ("drop", "delay", "truncate", "close"):
                p += getattr(self, f"p_{fault}")
                if r < p:
                    break
            else:
                return data
            # drop/truncate/close are SEND faults: the connection (or
            # message) dies before the request leaves, which the caller
            # may safely replay. Attacking the other direction (replies
            # lost AFTER the server applied the request — the genuinely
            # ambiguous failure) is side="server": the server's reply IS
            # its send.
            if direction == "recv" and fault != "delay":
                return data
            self.injected[fault] += 1
            if fault == "delay":
                lo, hi = self.delay_s
                pause = lo + (hi - lo) * self.rng.random()
            elif fault == "truncate" and data is not None:
                cut = 1 + int(self.rng.random() * max(len(data) - 1, 1))
        if fault == "delay":
            time.sleep(pause)
            return data
        if fault == "close":
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                f"chaos: connection closed before {direction}")
        if fault == "drop":
            logger.debug("chaos: dropped a %d-byte message", len(data))
            return None   # blackhole: caller believes it sent
        # truncate: deliver a strict prefix, then kill the connection —
        # the peer's _recv_exact dies mid-frame with RPCConnectionError
        try:
            sock.sendall(data[:cut])
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        logger.debug("chaos: truncated %d-byte message at %d", len(data), cut)
        return None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ChaosMonkey":
        if self._installed:
            return self
        rpc = _rpc()
        if rpc.get_fault_hook() is not None:
            raise RuntimeError("another fault hook is already installed")
        rpc.set_fault_hook(self._hook)
        self._installed = True
        return self

    def stop(self) -> None:
        if self._installed:
            _rpc().set_fault_hook(None)
            self._installed = False

    def __enter__(self) -> "ChaosMonkey":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def total_injected(self) -> int:
        return sum(self.injected.values())


class NetPartition:
    """Pair-wise DIRECTIONAL network partition over the rpc fault hook
    (fluid-quorum). A rule `(src, dst)` blackholes every request the
    actor `src` initiates toward the listening endpoint `dst`: the wire
    bytes are consumed at send time, so the sender believes it sent and
    then waits out its own deadline — exactly what a partition looks
    like from inside a process. Because the cut is at request
    initiation, the reply path of a blocked request needs no separate
    rule (the request never arrived); reply-only loss — the genuinely
    ambiguous failure — stays `ChaosMonkey(side="server")`'s job.

    `src` is an actor name (see `current_actor()`: an explicit
    `acting_as` scope, else the thread's `...@<endpoint>` suffix); `"*"`
    matches any actor including the anonymous one. `dst` is the target's
    listening endpoint as the client dials it; `"*"` matches all.

    `p < 1.0` drops each matched message by an independent draw from one
    `random.Random(seed)` stream — a flaky (not severed) link, replayed
    byte-identically per seed. Default p=1.0 is a full cut.

        with NetPartition(seed=7) as net:
            net.isolate(primary_ep, backup_ep)       # both directions
            net.block(primary_ep, arbiter2_ep)       # one direction
            ...
            net.heal()                               # all traffic flows
    """

    def __init__(self, seed: int = 0, p: float = 1.0):
        self.rng = random.Random(seed)
        self.p = float(p)
        self._rules: Set[Tuple[str, str]] = set()
        self._lock = threading.Lock()
        self._installed = False
        self.dropped = 0

    # -- rules -----------------------------------------------------------
    def block(self, src: str, dst: str) -> "NetPartition":
        with self._lock:
            self._rules.add((src, dst))
        return self

    def isolate(self, a: str, b: str) -> "NetPartition":
        """Cut the pair in both request directions."""
        return self.block(a, b).block(b, a)

    def heal(self, src: Optional[str] = None,
             dst: Optional[str] = None) -> None:
        """Remove matching rules (no args: remove ALL — full heal)."""
        with self._lock:
            if src is None and dst is None:
                self._rules.clear()
            else:
                self._rules = {(s, d) for s, d in self._rules
                               if not ((src is None or s == src)
                                       and (dst is None or d == dst))}

    def blocks(self, src: Optional[str], dst: str) -> bool:
        with self._lock:
            for s, d in self._rules:
                if (s == "*" or s == src) and (d == "*" or d == dst):
                    return True
        return False

    # -- hook ------------------------------------------------------------
    def _hook(self, direction: str, sock, data: Optional[bytes]):
        if direction != "send" or data is None:
            return data
        try:
            host, port = sock.getpeername()[:2]
        except OSError:
            return data
        dst = f"{host}:{port}"
        if not self.blocks(current_actor(), dst):
            return data
        with self._lock:
            if self.p < 1.0 and self.rng.random() >= self.p:
                return data
            self.dropped += 1
        logger.debug("partition: dropped %d bytes %s -> %s", len(data),
                     current_actor(), dst)
        return None   # blackhole: the caller believes it sent

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "NetPartition":
        if self._installed:
            return self
        rpc = _rpc()
        if rpc.get_fault_hook() is not None:
            raise RuntimeError("another fault hook is already installed")
        rpc.set_fault_hook(self._hook)
        self._installed = True
        return self

    def stop(self) -> None:
        if self._installed:
            _rpc().set_fault_hook(None)
            self._installed = False

    def __enter__(self) -> "NetPartition":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- process-level faults -------------------------------------------------

def kill_server(server) -> str:
    """SIGKILL-equivalent death of an in-process ParameterServer: the
    listener closes and every in-flight request is dropped unanswered
    (`_serve_conn` checks the stop event before replying). Returns the
    endpoint so `restart_server` can reuse it."""
    from ..observe import flight as _flight

    ep = server.endpoint
    _flight.note("chaos_kill", endpoint=ep)
    server.stop()
    return ep


def kill_master(master) -> str:
    """SIGKILL-equivalent death of an in-process data `Master`
    (fluid-elastic): listener and every live connection die now,
    in-flight requests dropped unanswered, and its quorum lease is NOT
    resigned — it expires at the arbiters like a real dead process's
    would. Returns the endpoint."""
    from ..observe import flight as _flight

    ep = master.endpoint
    _flight.note("chaos_kill_master", endpoint=ep)
    master.stop()
    return ep


def restart_server(endpoint: str, trainers: int = 1,
                   sync_timeout: float = 120.0,
                   recover_dir: Optional[str] = None):
    """Bring a fresh ParameterServer up on `endpoint`, recovering its
    shard (values + optimizer slots + sparse tables) from `recover_dir`
    when given — the crash/restart leg of the drill."""
    from ..observe import flight as _flight
    from ..pserver.server import ParameterServer

    srv = ParameterServer(endpoint, trainers=trainers,
                          sync_timeout=sync_timeout).start()
    if recover_dir is not None:
        srv.recover(recover_dir)
    _flight.note("chaos_restart", endpoint=endpoint,
                 recovered=recover_dir is not None)
    return srv
