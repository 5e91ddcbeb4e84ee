"""One arbiter node of the fluid-quorum majority-lease service.

A node is deliberately tiny: per-resource volatile lease records
(holder, epoch, expiry on the node's monotonic clock) plus ONE durable
fact — the highest epoch this node ever granted, per resource. The
durable fact is what makes elections fenceable across arbiter crashes:

- a node grants a campaign only at an epoch STRICTLY above its
  persisted maximum, and persists the new maximum BEFORE replying, so a
  reply implies durability (`ark.atomic_file`: tmp + `os.replace` +
  fsync, with a sha256 sidecar so bit rot is refused loudly instead of
  silently restarting the node at epoch 0);
- each node grants each epoch at most once, so two concurrent campaigns
  for one resource can never BOTH collect a strict majority at the same
  epoch — node grants partition the group, and only one side can hold
  more than half;
- a restarted node has lost its volatile lease records, so it observes
  a **boot blackout**: campaigns are refused until the longest lease it
  might have granted before the crash has provably expired (the granted
  `lease_s` is persisted next to the epoch). Renewals at exactly the
  persisted epoch stay allowed through the blackout — the holder of the
  newest promise is re-asserting a lease this node already granted, and
  accepting it re-establishes the record instead of leaving the
  restarted node an easy vote for a rival.

Transport: the pserver RPC framing (`pserver/rpc.py`) — length-prefixed
restricted pickles, the same fault-hook seam `ark.chaos` injects into,
so a drill partitions arbiters with the identical machinery it uses on
pservers. Connection threads are named `qconn@<endpoint>` (the chaos
actor convention: the trailing `@<endpoint>` identifies the sender).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Dict, Optional

from ..ark import checkpoint as ark_ckpt

logger = logging.getLogger(__name__)

EPOCH_FILE = "quorum_epochs.json"


class QuorumStore:
    """The durable half of a node: resource -> (max granted epoch, the
    lease_s granted with it). Every mutation commits via the ark atomic
    idiom before the caller may act on it."""

    def __init__(self, data_dir: str, node_id: str):
        self.path = os.path.join(data_dir, f"{node_id}_{EPOCH_FILE}")
        self._lock = threading.Lock()
        self._epochs: Dict[str, Dict] = {}  # guarded_by: self._lock
        self._load()

    @staticmethod
    def _payload_sha(epochs: Dict[str, Dict]) -> str:
        import hashlib
        canon = json.dumps(epochs, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        # checksum gate BEFORE trusting: a bit-rotted epoch file silently
        # parsed as {} would restart this node at epoch 0 — the one
        # regression the whole design exists to prevent. The checksum is
        # EMBEDDED in the same atomically-replaced file (a crash cannot
        # tear it: os.replace commits payload + sha as one unit, and a
        # grant whose persist never committed was never acknowledged);
        # the external sidecar is advisory operator tooling — written as
        # a second step, it CAN go stale across a crash between the
        # replace and the sidecar write, so a stale sidecar over a
        # self-verifying payload is healed, not fatal.
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except ValueError as e:
            raise ark_ckpt.CheckpointError(
                f"{self.path} is not parseable ({e}) — refusing to "
                f"restart this arbiter at a regressed epoch") from e
        if isinstance(raw, dict) and "epochs" in raw and "sha256" in raw:
            if self._payload_sha(raw["epochs"]) != raw["sha256"]:
                raise ark_ckpt.CheckpointError(
                    f"{self.path} fails its embedded checksum — bit rot; "
                    f"refusing to restart this arbiter at a regressed "
                    f"epoch")
            self._epochs = {r: dict(rec)  # race_lint: ignore[unguarded-write] — __init__-only load path, pre-publication
                            for r, rec in raw["epochs"].items()}
            try:
                ark_ckpt.verify_sidecar(self.path)
            except ark_ckpt.CheckpointError:
                ark_ckpt.write_sidecar_manifest(self.path,
                                                kind="quorum_epochs")
        else:
            # legacy flat-mapping format: the sidecar is the only
            # verifier
            ark_ckpt.verify_sidecar(self.path)
            self._epochs = {r: dict(rec) for r, rec in raw.items()}  # race_lint: ignore[unguarded-write] — __init__-only load path, pre-publication

    def _commit_locked(self) -> None:
        doc = {"sha256": self._payload_sha(self._epochs),
               "epochs": self._epochs}
        with ark_ckpt.atomic_file(self.path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        ark_ckpt.write_sidecar_manifest(self.path, kind="quorum_epochs")

    def epoch(self, resource: str) -> int:
        with self._lock:
            return int(self._epochs.get(resource, {}).get("epoch", 0))

    def lease_s(self, resource: str) -> float:
        with self._lock:
            return float(self._epochs.get(resource, {}).get("lease_s", 0.0))

    def advance(self, resource: str, epoch: int, lease_s: float) -> None:
        """Persist a new maximum BEFORE the grant reply leaves."""
        with self._lock:
            cur = self._epochs.get(resource, {})
            if epoch <= int(cur.get("epoch", 0)):
                raise ValueError(
                    f"epoch must advance: {epoch} <= {cur.get('epoch', 0)}")
            self._epochs[resource] = {
                "epoch": int(epoch),
                "lease_s": max(float(lease_s), float(cur.get("lease_s",
                                                             0.0)))}
            self._commit_locked()

    def resources(self):
        with self._lock:
            return sorted(self._epochs)


class _Lease:
    __slots__ = ("holder", "epoch", "expires", "lease_s")

    def __init__(self, holder: str, epoch: int, lease_s: float):
        self.holder = holder
        self.epoch = int(epoch)
        self.lease_s = float(lease_s)
        self.expires = time.monotonic() + float(lease_s)

    @property
    def live(self) -> bool:
        return time.monotonic() < self.expires

    def renew(self, lease_s: float) -> None:
        self.lease_s = float(lease_s)
        self.expires = time.monotonic() + float(lease_s)


class QuorumNode:
    """One arbiter. `endpoint` may use port 0 (resolved after
    `start()`); `data_dir` holds the persisted epoch file. Thread-based
    like `ParameterServer`, so tests and drills run a 3/5-node group
    in-process where the chaos fault hook can reach every message."""

    def __init__(self, endpoint: str, data_dir: str,
                 node_id: Optional[str] = None):
        import uuid

        from ..pserver import rpc
        self._rpc = rpc
        self.endpoint = endpoint
        # the node id keys the persisted epoch file, so it must be
        # UNIQUE per node within a data_dir: an ephemeral endpoint
        # (":0") cannot name one before bind — every such node would
        # share "q0" and clobber each other's persisted maxima, the
        # exact regression the file prevents. Port-0 nodes therefore
        # get a fresh identity per process; pass node_id explicitly
        # whenever a RESTART must find the same epoch file (tests and
        # tools/torch_quorum_node.py do).
        port = endpoint.rsplit(":", 1)[-1]
        self.node_id = node_id or (f"q{port}" if port != "0"
                                   else f"q0-{uuid.uuid4().hex[:8]}")
        os.makedirs(data_dir, exist_ok=True)
        self.store = QuorumStore(data_dir, self.node_id)
        self._leases: Dict[str, _Lease] = {}  # guarded_by: self._lock
        self._lock = threading.Lock()
        # boot blackout, PER RESOURCE: campaigns for a resource are
        # refused until the longest lease this node had granted on it
        # BEFORE this boot has provably expired (the volatile record
        # died with the old process). Snapshotted at boot: a resource
        # first granted AFTER boot has a live in-memory record and
        # needs no blackout, and one this node never granted (lease_s
        # 0) boots instantly — a restarted arbiter must not block the
        # bootstrap of brand-new shards.
        self._boot_at = time.monotonic()
        self._boot_lease_s = {r: self.store.lease_s(r)
                              for r in self.store.resources()}
        self._listener: Optional[socket.socket] = None
        self._conns: set = set()              # guarded_by: self._conns_lock
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "QuorumNode":
        host, port = self._rpc.parse_endpoint(self.endpoint)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        if port == 0:
            self.endpoint = f"{host}:{self._listener.getsockname()[1]}"
        self._listener.listen(32)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"quorum@{self.endpoint}").start()
        logger.info("quorum node %s listening on %s (boot blackout "
                    "up to %.1fs per pre-boot resource)", self.node_id,
                    self.endpoint,
                    max(self._boot_lease_s.values(), default=0.0))
        return self

    def _blackout_remaining(self, resource: str) -> float:
        return (self._boot_at + self._boot_lease_s.get(resource, 0.0)
                - time.monotonic())

    def stop(self) -> None:
        """Hard cut, like `ParameterServer.stop()`: the listener and
        every live connection die now, in-flight requests unanswered."""
        self._stop.set()
        if self._listener is not None:
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

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"qconn@{self.endpoint}").start()

    def _serve_conn(self, conn) -> None:
        rpc = self._rpc
        try:
            while not self._stop.is_set():
                try:
                    msg = rpc.recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                if self._stop.is_set():
                    return   # a stopped node behaves like a dead process
                try:
                    cmd, payload = msg[0], msg[1]
                except (TypeError, IndexError):
                    rpc.send_msg(conn, ("err", "MalformedFrame"))
                    continue
                try:
                    handler = getattr(self, f"_h_{cmd}", None)
                    if handler is None:
                        raise ValueError(f"unknown quorum command {cmd!r}")
                    reply = handler(**payload)
                except Exception as e:   # surface to the client
                    reply = ("err", f"{type(e).__name__}: {e}")
                rpc.send_msg(conn, reply)
                if cmd == "stop":
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    # -- handlers ---------------------------------------------------------
    def _h_q_hello(self):
        return ("ok", {"node_id": self.node_id, "endpoint": self.endpoint,
                       "version": 1})

    def _h_q_epoch(self, resource):
        return ("ok", {"epoch": self.store.epoch(resource)})

    def _h_q_campaign(self, resource, candidate, epoch, lease_s):
        """Grant `candidate` the lease on `resource` at exactly `epoch`,
        iff (a) the epoch strictly exceeds every epoch this node ever
        granted, (b) no OTHER holder's lease is currently live here, and
        (c) the node is past its boot blackout. Re-granting the SAME
        (candidate, epoch) is acknowledged idempotently — a retried
        campaign RPC whose first reply was lost must not read as a
        rejection."""
        epoch, lease_s = int(epoch), float(lease_s)
        with self._lock:
            cur_max = self.store.epoch(resource)
            rec = self._leases.get(resource)
            if rec is not None and rec.epoch == epoch \
                    and rec.holder == candidate and epoch == cur_max:
                rec.renew(lease_s)   # idempotent re-grant (lost reply)
                return ("ok", {"granted": True, "epoch": epoch,
                               "node_id": self.node_id})
            if epoch <= cur_max:
                return ("ok", {"granted": False, "reason": "stale_epoch",
                               "epoch": cur_max, "node_id": self.node_id})
            if rec is not None and rec.live and rec.holder != candidate:
                return ("ok", {"granted": False, "reason": "held",
                               "epoch": cur_max, "holder": rec.holder,
                               "expires_in_s": round(
                                   rec.expires - time.monotonic(), 3),
                               "node_id": self.node_id})
            remaining = self._blackout_remaining(resource)
            if remaining > 0 and (rec is None or rec.holder != candidate):
                # restarted node: a lease it granted on THIS resource
                # before the crash may still be live somewhere — refuse
                # to be an easy vote until it provably expired
                return ("ok", {"granted": False, "reason": "boot_blackout",
                               "epoch": cur_max,
                               "retry_in_s": round(remaining, 3),
                               "node_id": self.node_id})
            # durability BEFORE the reply: a crash between these two
            # statements loses the grant (candidate counts a missing
            # vote) but can never regress the promise
            self.store.advance(resource, epoch, lease_s)
            self._leases[resource] = _Lease(candidate, epoch, lease_s)
            return ("ok", {"granted": True, "epoch": epoch,
                           "node_id": self.node_id})

    def _h_q_renew(self, resource, holder, epoch, lease_s):
        """Refresh the lease iff `epoch` is still the newest this node
        promised AND no rival holds a live record. A restarted node with
        no volatile record accepts a renew at exactly its persisted
        epoch — the holder is re-asserting a promise this node made."""
        epoch, lease_s = int(epoch), float(lease_s)
        with self._lock:
            cur_max = self.store.epoch(resource)
            if epoch < cur_max:
                return ("ok", {"renewed": False, "reason": "fenced",
                               "epoch": cur_max, "node_id": self.node_id})
            if epoch > cur_max:
                # a holder claiming an epoch this node never granted: it
                # won elsewhere; re-establish durability here first so
                # this node can never later grant that epoch to a rival
                self.store.advance(resource, epoch, lease_s)
            rec = self._leases.get(resource)
            if rec is not None and rec.live and rec.holder != holder \
                    and rec.epoch >= epoch:
                return ("ok", {"renewed": False, "reason": "held",
                               "epoch": rec.epoch, "holder": rec.holder,
                               "node_id": self.node_id})
            if rec is None or rec.holder != holder or rec.epoch != epoch:
                self._leases[resource] = _Lease(holder, epoch, lease_s)
            else:
                rec.renew(lease_s)
            return ("ok", {"renewed": True, "epoch": epoch,
                           "node_id": self.node_id})

    def _h_q_resign(self, resource, holder, epoch):
        """Clear the volatile record iff it matches; the persisted epoch
        never regresses. Idempotent."""
        with self._lock:
            rec = self._leases.get(resource)
            if rec is not None and rec.holder == holder \
                    and rec.epoch == int(epoch):
                del self._leases[resource]
                return ("ok", {"resigned": True, "node_id": self.node_id})
        return ("ok", {"resigned": False, "node_id": self.node_id})

    def _h_q_status(self, resource):
        with self._lock:
            rec = self._leases.get(resource)
            out = {"epoch": self.store.epoch(resource),
                   "node_id": self.node_id,
                   "holder": rec.holder if rec else None,
                   "lease_epoch": rec.epoch if rec else 0,
                   "live": bool(rec and rec.live),
                   "expires_in_s": round(rec.expires - time.monotonic(), 3)
                   if rec else 0.0}
        return ("ok", out)

    def _h_stop(self):
        self.stop()
        return ("ok", None)
