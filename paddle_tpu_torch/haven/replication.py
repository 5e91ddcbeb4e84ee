"""fluid-haven: primary/backup replication of a pserver shard.

Mirror of ``paddle_tpu/haven/replication.py``, copied.

Replication unit — **logical update records**: the primary forwards each
applied mutating command (`push_grad`, `push_grads`, `push_grads_sync`,
`push_sparse_grad`, `init_param`, `init_table`, plus a synthesized
`__sync_apply__` carrying the barrier's contributor count) to its backup
as the ORIGINAL wire payload, and the backup replays it through the
identical handler path. Chosen over the two alternatives the design
space offers:

- *post-optimizer state* would ship state-sized bytes per update
  (params + optimizer accumulators, 2-3x the shard) where a record is
  gradient-sized;
- *re-encoded logical gradients* would quantize a second time — the
  backup would drift from the primary by one extra rounding per update.

Forwarding the trainer's own (possibly codec-tagged, fluid-wire)
payload keeps the replication hop exactly as compressed as the trainer
hop, and because decoding is deterministic the backup is BIT-IDENTICAL
to the primary at every acknowledged seq. The dedup watermarks
((trainer, batch, session) for sync, (trainer, seq, session) for async)
replicate for free — the backup runs the same handler — so a client
replaying un-acknowledged pushes at a promoted backup can never
double-apply. On the barrierless async path, records are logged in
handler-completion order; concurrent multi-tenant pushes may therefore
replay in a different per-param interleaving than the primary applied —
the same commutation error class as async staleness itself, and zero on
the sync path or with a single writer.

Election rides `ark.LeaseTable`: every replication batch (including
idle heartbeats at lease/3) renews the primary's lease ON the backup;
a standby whose primary's lease expires promotes itself. Promotions and
handovers carry a fencing **epoch** — a record stream from a lower
epoch than the receiver's is answered with a redirect naming the real
primary, so a deposed primary steps down instead of split-braining.

Failure model — CRASH-STOP by default, PARTITION-TOLERANT with a
quorum. A bare 2-node pair cannot distinguish "peer died" from "peer
unreachable": the isolated backup promotes on lease expiry while the
primary keeps serving clients that can still reach it, and every
update the deposed primary acknowledges solo is discarded when the
partition heals and the first contact fences it (`haven_fenced`) —
run `start_standby(auto_promote=False)` there. Arming a fluid-quorum
arbiter group (`quorum_endpoints=` on both members) upgrades the
failure model, and `auto_promote=True` becomes the safe default:

- the standby promotes ONLY on a quorum-granted lease (a strict
  majority of arbiters at a fencing epoch above every epoch any
  earlier majority granted), so a replication-link partition alone can
  never split-brain the pair;
- the primary renews its quorum lease at lease/3 and FAILS CLOSED: a
  renew round that cannot reach a majority fences the write path
  (mutators HELD, not acked) immediately, and local lease expiry steps
  the node down to an unsynced standby BEFORE the arbiters would let a
  rival win — at every observable point at most one member accepts
  writes, with margin (arbiter-side expiry trails the holder's local
  expiry);
- a deposed primary's `has_synced` is cleared at step-down: its solo
  tail (updates acked after the partition cut replication — bounded by
  the in-flight window) is divergent history, so healing rejoins it as
  a resyncing standby and nothing the backup acknowledged is ever
  lost.

`tools/chaos_drill.py --scenario ps_partition` proves the claim under
async and sync PS with `ark.chaos.NetPartition`.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import flags as _flags
from ..ark.liveness import LeaseTable
from ..observe import flight as _flight
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from .log import UpdateLog

logger = logging.getLogger(__name__)

#: commands a standby backup must redirect to the primary (role gate)
MUTATING_CMDS = frozenset({
    "init_param", "init_table", "push_grad", "push_grads",
    "push_grads_sync", "push_sparse_grad", "sync_apply", "batch_barrier",
    "heartbeat", "restore",
})

#: the subset COUNTED as in-flight mutators for `quiesce()` — only the
#: handlers that mutate shard state for their whole duration. The
#: blocking barrier commands are deliberately NOT here: a sync_apply
#: parked in the barrier would hold quiesce for sync_timeout while the
#: held pushes starve the barrier (and held heartbeats would get
#: healthy trainers evicted). Their actual state mutation runs in
#: `_apply_pending`, which enters the gate via `mutator()` itself.
COUNTED_CMDS = frozenset({
    "init_param", "init_table", "push_grad", "push_grads",
    "push_grads_sync", "push_sparse_grad", "restore",
})

#: the subset that is replicated as update records (sync_apply is
#: replicated from inside the barrier action instead — one synthesized
#: record per batch, carrying the contributor count; restore triggers a
#: full resync; barriers and trainer heartbeats are primary-local)
RECORDED_CMDS = frozenset({
    "init_param", "init_table", "push_grad", "push_grads",
    "push_grads_sync", "push_sparse_grad",
})

#: the subset the DISPATCH wrapper records after a successful reply.
#: push_grads_sync records itself inside the pending lock instead — the
#: log order must equal the accumulation order, or concurrent trainers'
#: pending sums would fold in a different order on the backup (float
#: non-associativity would break sync-path bit-identity)
DISPATCH_RECORDED_CMDS = RECORDED_CMDS - frozenset({"push_grads_sync"})

#: read-side commands a standby backup serves (bounded-stale by the
#: replication window) — this is what keeps fluid-fleet's serve-time
#: sparse row pulls alive through a primary kill, no promotion needed
READ_CMDS = frozenset({"get_param", "get_params", "prefetch"})

#: commands every role answers (control/introspection plane)
CONTROL_CMDS = frozenset({"stats", "wire_caps", "haven_role",
                          "haven_replicate", "haven_sync", "haven_promote",
                          "save", "stop"})

#: the synthesized record replaying a sync barrier's exactly-once apply
SYNC_APPLY_RECORD = "__sync_apply__"

#: the synthesized record replaying a broken-barrier recovery: the
#: primary discarded its incomplete pending batch — the backup must
#: discard too, or the retried batch's pushes would dedup against the
#: stale pending set and the two copies would diverge
SYNC_RESET_RECORD = "__sync_reset__"

LAG_UPDATES_METRIC = "ps_replication_lag_updates"
LAG_US_METRIC = "ps_replication_lag_us"
PROMOTIONS_METRIC = "ps_promotions_total"
STEP_DOWNS_METRIC = "ps_step_downs_total"


class HavenState:
    """Per-server replication state: role, fencing epoch, the update
    log (primary) or applied watermark (backup), the serve gate, and
    the promotion machinery. Attached to a `ParameterServer` as
    `server._haven` by `start_replication()` / `start_standby()`."""

    def __init__(self, server, role: str = "primary",
                 lease_s: float = 2.0, window: int = 512,
                 stall_timeout_s: float = 5.0):
        self.server = server
        self.role = role                 # primary | backup | retired
        self.epoch = 0
        self.lease_s = float(lease_s)
        self.peer: Optional[str] = None          # primary -> its backup
        self.primary_ep: Optional[str] = None    # backup -> its primary
        self.redirect_to: Optional[str] = None   # retired -> successor
        self.auto_promote = True
        self.log = UpdateLog(window=window, stall_timeout_s=stall_timeout_s)
        self.applied_seq = 0             # backup-side replay watermark
        self.has_synced = False
        self.primary_lease = LeaseTable()
        self._state_lock = threading.RLock()
        self._replay_lock = threading.Lock()
        # serve gate: counts in-flight mutators; `quiesce` holds new ones
        self._gate = threading.Condition()
        self._active = 0  # guarded_by: self._gate
        self._held = False  # guarded_by: self._gate
        self._replicator: Optional[Replicator] = None
        self._monitor: Optional[threading.Thread] = None
        # fluid-quorum (arm_quorum): the arbiter client, the shard's
        # lease resource, the held lease + its renewal thread, and the
        # fail-closed fence (mutators held while a renew round cannot
        # reach a majority)
        self.quorum = None
        self.resource: Optional[str] = None
        self.quorum_lease_s: Optional[float] = None
        self._qlease = None  # guarded_by: self._state_lock
        self._renewer: Optional[threading.Thread] = None
        self._fenced = False  # guarded_by: self._gate
        self._stop = threading.Event()
        # test hook: raise at a named handover cut point ("pre_promote" /
        # "post_promote") to drill the torn-handoff contract
        self._handover_fault: Optional[str] = None

    # -- serve gate --------------------------------------------------------
    def _verdict(self, cmd: str):
        """None = serve it; otherwise the redirect reply."""
        role = self.role
        if role == "primary" or cmd in CONTROL_CMDS:
            return None
        if role == "backup":
            if cmd in READ_CMDS:
                return None
            return ("redirect", {"primary": self.primary_ep,
                                 "epoch": self.epoch})
        # retired: even reads redirect — a frozen shard must not serve
        # stale params to a trainer that missed the flip
        return ("redirect", {"primary": self.redirect_to or self.primary_ep,
                             "epoch": self.epoch})

    @contextlib.contextmanager
    def admit(self, cmd: str):
        """Dispatch-time gate: yields None to serve, or the redirect
        reply. State-mutating commands are counted in-flight (and held
        while a quiesce is cutting) so snapshots/handovers see a stable
        state; barrier waits and heartbeats pass uncounted (see
        COUNTED_CMDS)."""
        entered = False
        with self._gate:
            # _fenced: a quorum-armed primary whose renew round failed
            # holds (not fails) mutators — a transient blip resumes
            # them, a real deposition flips the role and the redirect
            # verdict below releases them toward the new primary
            while (self._held or self._fenced) and cmd in COUNTED_CMDS:
                self._gate.wait(timeout=1.0)
            verdict = self._verdict(cmd)
            if verdict is None and cmd in COUNTED_CMDS:
                self._active += 1
                entered = True
        try:
            yield verdict
        finally:
            if entered:
                with self._gate:
                    self._active -= 1
                    self._gate.notify_all()

    @contextlib.contextmanager
    def mutator(self):
        """Out-of-dispatch state mutation (the sync barrier's
        `_apply_pending`, backup-side record replay/snapshot install):
        same held/counted contract as a COUNTED command, so a quiesced
        cut never observes it mid-write."""
        with self._gate:
            while self._held or self._fenced:
                self._gate.wait(timeout=1.0)
            self._active += 1
        try:
            yield
        finally:
            with self._gate:
                self._active -= 1
                self._gate.notify_all()

    @contextlib.contextmanager
    def quiesce(self):
        """Block new mutators and wait out in-flight ones: inside the
        context the shard state is a consistent cut at `log.head_seq`
        (the watermark a checkpoint or snapshot is tagged with)."""
        with self._gate:
            while self._held:
                self._gate.wait()
            self._held = True
            while self._active:
                self._gate.wait(timeout=0.5)
        try:
            yield
        finally:
            with self._gate:
                self._held = False
                self._gate.notify_all()

    # -- primary: recording ------------------------------------------------
    def record(self, cmd: str, payload: dict) -> None:
        """Append one applied update to the log (primary role only).
        A degraded log (backup gone past the stall timeout) drops the
        record and flags the pair for a full resync — availability over
        replication once there is no failover target left."""
        # local snapshot: a concurrent step-down/demotion may null the
        # forwarder between the check and the kick (kicking a stopped
        # forwarder is a harmless event set)
        rep = self._replicator
        if self.role != "primary" or rep is None:
            return
        trace = None
        if _flags.get_flag("observe"):
            # fluid-horizon: remember WHICH request produced this update
            # (the rpc_server:* span active in the dispatching handler),
            # so the backup's replay span joins the trainer's trace
            # across the replication stream
            ctx = _xray.current()
            if ctx is not None:
                trace = _xray.to_traceparent(ctx)
        was = self.log.degraded
        if self.log.append(cmd, payload, trace=trace) is None and not was:
            _flight.note("haven_degraded", endpoint=self.server.endpoint,
                         head_seq=self.log.head_seq)
            logger.warning("haven %s: replication degraded (backup %s "
                           "unresponsive) — recording suspended until "
                           "resync", self.server.endpoint, self.peer)
        rep.kick()

    def record_sync_apply(self, n_contrib: int) -> None:
        """Called from inside `_apply_pending` (under the pending lock)
        so the apply record orders exactly between the batch's pushes
        and the next batch's."""
        self.record(SYNC_APPLY_RECORD, {"n_contrib": int(n_contrib)})

    def mark_resync(self) -> None:
        """State changed out-of-band (a restore): the log can no longer
        bring the backup up to date — force a full snapshot sync."""
        self.log.degrade()
        rep = self._replicator
        if rep is not None:
            rep.kick()

    # -- quorum (fluid-quorum) ---------------------------------------------
    def arm_quorum(self, client, resource: str,
                   lease_s: Optional[float] = None) -> "HavenState":
        """Attach a fluid-quorum arbiter group: elections for this shard
        now require a majority-granted lease on `resource`, and this
        node fails closed when it cannot renew. Both members of a pair
        must name the SAME resource. No quorum armed = the plain
        crash-stop behavior, bit for bit."""
        self.quorum = client
        self.resource = str(resource)
        self.quorum_lease_s = float(lease_s) if lease_s else self.lease_s
        return self

    def _quorum_acquire(self, kind: str) -> Optional[int]:
        """Campaign for the shard lease; returns the fencing epoch on a
        majority grant (and arms the renewal loop), None when the
        election is lost. Raises QuorumUnavailable when no arbiter
        answered at all."""
        lease = self.quorum.campaign(self.resource, self.server.endpoint,
                                     self.quorum_lease_s)
        if lease is None:
            return None
        with self._state_lock:
            self._qlease = lease
        self._set_fenced(False)
        self._ensure_renewer()
        _flight.note("quorum_lease_acquired",
                     endpoint=self.server.endpoint,
                     resource=self.resource, epoch=lease.epoch, via=kind)
        return lease.epoch

    def _set_fenced(self, fenced: bool, reason: str = "") -> None:
        with self._gate:
            if self._fenced == fenced:
                return
            self._fenced = fenced
            self._gate.notify_all()
        if fenced:
            logger.warning("haven %s: FENCED (%s) — mutators held until "
                           "the quorum lease renews or expires",
                           self.server.endpoint, reason)
            _flight.note("haven_fence", endpoint=self.server.endpoint,
                         reason=reason)
        else:
            _flight.note("haven_unfence", endpoint=self.server.endpoint)

    def _ensure_renewer(self) -> None:
        if self._renewer is None or not self._renewer.is_alive():
            self._renewer = threading.Thread(
                target=self._renew_loop, daemon=True,
                name=f"quorum-renew@{self.server.endpoint}")
            self._renewer.start()

    def _renew_loop(self) -> None:
        """Lease renewal at lease/3. The loop follows the LEASE, not
        the role (a just-elected standby holds its grant for a moment
        before promote() flips the role — exiting on role would leave
        the new primary's lease to silently expire); it ends when the
        lease is dropped (step-down, demotion, handover, resign).

        Fail closed on the primary: the FIRST renew round that cannot
        reach a majority fences the write path; recovery before local
        expiry unfences; local expiry steps the node down (the
        arbiters' own expiry — which started later — is what then lets
        a rival win, so the fence always precedes the rival's grant)."""
        while not self._stop.is_set():
            with self._state_lock:
                lease = self._qlease
            if lease is None:
                return
            interval = max(lease.lease_s / 3.0, 0.05)
            if self._stop.wait(interval):
                return
            with self._state_lock:
                lease = self._qlease
            if lease is None:
                return
            try:
                ok = self.quorum.renew(lease)
            except Exception:   # noqa: BLE001 — unreachable == failed
                ok = False
            if ok:
                with self._gate:
                    fenced = self._fenced
                if fenced:
                    self._set_fenced(False)
                continue
            if self.role == "primary":
                self._set_fenced(True, reason="quorum renew failed")
                if not lease.live:
                    self._quorum_step_down("lease_expired")
                    return
            elif not lease.live:
                # a non-primary holder (the adopt->promote window never
                # closed, e.g. promote() raised): drop the dead lease
                with self._state_lock:
                    if self._qlease is lease:
                        self._qlease = None
                return

    def _quorum_step_down(self, reason: str) -> None:
        """Deposed (or presumed deposed): stop accepting writes for
        good, become an UNSYNCED standby — `has_synced` is cleared
        because any update acknowledged solo since the last backup ack
        is divergent history; the new primary's first contact performs
        a full resync (the healed-partition rejoin contract)."""
        with self._state_lock:
            if self.role != "primary":
                return
            self.role = "backup"
            self.primary_ep = None   # learned from the winner's sync
            self.has_synced = False
            self._qlease = None
        logger.warning("haven %s: STEPPED DOWN (%s) — resyncing standby",
                       self.server.endpoint, reason)
        _flight.note("haven_step_down", endpoint=self.server.endpoint,
                     reason=reason)
        _metrics.counter(
            STEP_DOWNS_METRIC,
            "quorum-armed primaries that stepped down").inc(reason=reason)
        self._set_fenced(False)
        self._stop_replicator()
        self._ensure_monitor()

    # -- backup: replay ----------------------------------------------------
    def replay(self, records: List[Tuple[int, str, dict]], epoch: int,
               primary: str, lease_s: float):
        """`haven_replicate` body: fence by epoch, renew the primary's
        lease, apply in-order records past the watermark (seq dedup
        makes retransmits free), ack the new watermark."""
        with self._state_lock:
            if epoch < self.epoch:
                return ("redirect", {"primary": self.current_primary(),
                                     "epoch": self.epoch})
            if self.role == "primary":
                if epoch <= self.epoch:
                    # a deposed primary still streaming at our epoch:
                    # tell it who rules now
                    return ("redirect",
                            {"primary": self.server.endpoint,
                             "epoch": self.epoch})
                self._demote(primary, epoch)
            self.epoch = max(self.epoch, int(epoch))
            self.primary_ep = primary
        self.primary_lease.beat("primary", lease_s=float(lease_s))
        if not self.has_synced:
            # never apply records onto a shard that missed its snapshot
            return ("ok", {"acked": self.applied_seq, "epoch": self.epoch,
                           "need_resync": True})
        need_resync = False
        obs = _flags.get_flag("observe")
        with self._replay_lock, self.mutator():
            # mutator(): a backup-side save/snapshot quiesce must not
            # observe a half-replayed record
            for seq, cmd, payload, *rest in records:
                if seq <= self.applied_seq:
                    continue
                if seq != self.applied_seq + 1:
                    need_resync = True
                    break
                # fluid-horizon: a 4-tuple record carries the causing
                # request's traceparent — the apply span closes the
                # trainer -> primary -> backup chain (3-tuples from a
                # legacy primary replay untraced)
                rctx = _xray.parse_traceparent(rest[0]) \
                    if obs and rest else None
                if rctx is not None:
                    with _xray.activate(rctx), \
                            _xray.span(f"haven_apply:{cmd}", cat="ha",
                                       seq=seq, cmd=cmd):
                        self._apply_record(cmd, payload)
                else:
                    self._apply_record(cmd, payload)
                self.applied_seq = seq
        reply = {"acked": self.applied_seq, "epoch": self.epoch}
        if need_resync or not self.has_synced:
            reply["need_resync"] = True
        return ("ok", reply)

    def _apply_record(self, cmd: str, payload: dict) -> None:
        srv = self.server
        if cmd == SYNC_APPLY_RECORD:
            srv._apply_pending(n_contrib=payload["n_contrib"],
                               replicated=True)
            return
        if cmd == SYNC_RESET_RECORD:
            with srv._pending_lock:
                srv._pending.clear()
                srv._sync_pending_from.clear()
            return
        handler = getattr(srv, f"_h_{cmd}")
        handler(**payload)

    def _demote(self, primary: str, epoch: int) -> None:
        # a higher-epoch primary exists (handover flipped the crown
        # while we thought we ruled): step back down to standby — and
        # re-arm the promotion monitor, or this node could never take
        # over again when its NEW primary dies
        logger.warning("haven %s: demoted by primary %s (epoch %d > %d)",
                       self.server.endpoint, primary, epoch, self.epoch)
        _flight.note("haven_demotion", endpoint=self.server.endpoint,
                     new_primary=primary, epoch=epoch)
        self.role = "backup"
        self._qlease = None   # the rival's higher epoch fenced our lease
        self._stop_replicator()
        self._set_fenced(False)
        self._ensure_monitor()

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Full shard state at the current watermark. Caller holds
        `quiesce()` (or knows the server is idle) so the cut is
        consistent."""
        srv = self.server
        dense = {n: v.copy() for n, v in srv._dense.items()}
        sparse = {n: t.value.copy() for n, t in srv._sparse.items()}
        optim = {}
        for n, opt in srv._optim.items():
            opt_type, _lr, _attrs = srv._opt_cfg[n]
            st = opt.state()
            optim[n] = {"opt_type": opt_type, "lr": st["lr"],
                        "attrs": dict(st["attrs"]),
                        "acc": {k: np.array(a, copy=True)
                                for k, a in st["acc"].items()}}
        with srv._pending_lock:
            sync = {"applied": dict(srv._sync_applied),
                    "sessions": dict(srv._sync_sessions),
                    "pending_from": sorted(srv._sync_pending_from),
                    "pending": {n: g.copy()
                                for n, g in srv._pending.items()}}
        with srv._async_lock:
            marks = {"applied": dict(srv._async_applied),
                     "sessions": dict(srv._async_sessions)}
        return {"seq": self.log.head_seq, "epoch": self.epoch,
                "dense": dense, "sparse": sparse, "optim": optim,
                "sync": sync, "async_marks": marks,
                "primary": self.server.endpoint}

    def install_snapshot(self, snap: dict, lease_s: Optional[float] = None):
        """`haven_sync` body: replace the whole shard state with the
        primary's consistent cut and align the replay watermark."""
        from ..pserver.optim import make_optimizer
        from ..pserver.server import _SparseTable

        with self._state_lock:
            if snap["epoch"] < self.epoch:
                return ("redirect", {"primary": self.current_primary(),
                                     "epoch": self.epoch})
            if self.role == "primary":
                if snap["epoch"] <= self.epoch:
                    return ("redirect",
                            {"primary": self.server.endpoint,
                             "epoch": self.epoch})
                # a legitimately higher-epoch primary syncing us (the
                # same demotion rule replay() applies — and sync is the
                # path a fresh successor's forwarder always runs FIRST)
                self._demote(snap.get("primary"), int(snap["epoch"]))
            self.epoch = max(self.epoch, int(snap["epoch"]))
            self.primary_ep = snap.get("primary")
        srv = self.server
        with self._replay_lock, self.mutator():
            srv._dense = {n: np.array(v, copy=True)
                          for n, v in snap["dense"].items()}
            sparse = {}
            for n, v in snap["sparse"].items():
                t = _SparseTable.__new__(_SparseTable)
                t.value = np.array(v, copy=True)
                sparse[n] = t
            srv._sparse = sparse
            optim, cfg = {}, {}
            for n, rec in snap["optim"].items():
                opt = make_optimizer(rec["opt_type"], rec["lr"],
                                     rec["attrs"])
                opt.load_state({"lr": rec["lr"], "attrs": rec["attrs"],
                                "acc": {k: np.array(a, copy=True)
                                        for k, a in rec["acc"].items()}})
                optim[n] = opt
                cfg[n] = (rec["opt_type"], float(rec["lr"]),
                          dict(rec["attrs"]))
            srv._optim = optim
            srv._opt_cfg = cfg
            with srv._pending_lock:
                srv._sync_applied = dict(snap["sync"]["applied"])
                srv._sync_sessions = dict(snap["sync"]["sessions"])
                srv._sync_pending_from = {tuple(x) for x in
                                          snap["sync"]["pending_from"]}
                srv._pending = {n: np.array(g, copy=True)
                                for n, g in snap["sync"]["pending"].items()}
            with srv._async_lock:
                srv._async_applied = dict(snap["async_marks"]["applied"])
                srv._async_sessions = dict(snap["async_marks"]["sessions"])
            self.applied_seq = int(snap["seq"])
            self.has_synced = True
        self.primary_lease.beat("primary",
                                lease_s=float(lease_s or self.lease_s))
        _flight.note("haven_synced", endpoint=srv.endpoint,
                     seq=self.applied_seq, epoch=self.epoch)
        return ("ok", {"acked": self.applied_seq, "epoch": self.epoch})

    # -- promotion ---------------------------------------------------------
    def promote(self, kind: str = "lease_expiry", epoch: Optional[int] = None,
                backup: Optional[str] = None,
                predecessor: Optional[str] = None) -> bool:
        """Standby -> primary. `kind` is "lease_expiry" (self-election on
        a dead primary), "quorum" (the monitor won a majority-granted
        lease), or "handover" (the `predecessor` handed us the crown,
        with `epoch` fenced one above its own and optionally the
        surviving `backup` to replicate to)."""
        if self.quorum is not None:
            with self._state_lock:
                have = self._qlease is not None and self._qlease.live
            if not have:
                # every road to primary goes through the arbiters: a
                # handover target (the predecessor resigned first) and
                # an operator promote() both campaign here; a monitor
                # election arrives with the lease already adopted
                won = self._quorum_acquire(kind)
                if won is None:
                    raise RuntimeError(
                        f"promote({kind}): quorum election lost for "
                        f"{self.resource!r} — a rival holds the lease "
                        f"or this side has no majority")
                epoch = max(int(epoch or 0), won)
        with self._state_lock:
            if self.role == "primary":
                return False
            predecessor = predecessor or self.primary_ep
            self.role = "primary"
            self.epoch = int(epoch) if epoch is not None else self.epoch + 1
            self.redirect_to = None
            new_epoch = self.epoch
        logger.warning("haven %s: PROMOTED to primary (epoch %d, %s, "
                       "succeeding %s)", self.server.endpoint, new_epoch,
                       kind, predecessor)
        # the promotion event goes to the black box unconditionally —
        # it is exactly what a postmortem on the survivor wants (the
        # predecessor names WHOSE death/handover this was)
        _flight.note("haven_promotion", endpoint=self.server.endpoint,
                     epoch=new_epoch, promotion=kind,
                     predecessor=predecessor,
                     applied_seq=self.applied_seq)
        _metrics.counter(
            PROMOTIONS_METRIC,
            "backup shards promoted to primary").inc(kind=kind)
        if _flags.get_flag("observe"):
            _metrics.gauge(LAG_UPDATES_METRIC,
                           "update-log records not yet acknowledged by "
                           "the backup").set(0.0)
        if backup:
            self.start_replication(backup)
        return True

    def _monitor_loop(self):
        from ..quorum import QuorumUnavailable

        poll = max(self.lease_s / 3.0, 0.05)
        while not self._stop.wait(poll):
            if self.role != "backup" or not self.auto_promote \
                    or not self.has_synced:
                continue
            if "primary" not in self.primary_lease.expired():
                continue
            if self.quorum is None:
                self.promote(kind="lease_expiry")
                return
            # quorum-gated election: promote ONLY on a majority grant.
            # A rejection ("held": the primary is alive to a majority —
            # only OUR link to it is down; or no majority: WE are the
            # minority side) fails closed and keeps polling — the
            # split-brain the crash-stop model could not exclude.
            old_primary = self.primary_ep
            try:
                won = self._quorum_acquire("lease_expiry")
            except QuorumUnavailable:
                continue
            if won is None:
                continue
            # adopt the deposed primary as OUR backup: when the
            # partition heals, the forwarder's first contact resyncs it
            # (its has_synced was cleared at step-down)
            self.promote(kind="quorum", epoch=won, backup=old_primary)
            return

    def _ensure_monitor(self):
        """(Re)arm the promotion monitor: the loop exits after a
        promotion, so a node demoted back to standby needs a fresh
        thread or it could never self-elect again."""
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name=f"haven-monitor@{self.server.endpoint}")
            self._monitor.start()

    # -- wiring ------------------------------------------------------------
    def start_standby(self, auto_promote: bool = True) -> "HavenState":
        self.role = "backup"
        self.auto_promote = bool(auto_promote)
        self._ensure_monitor()
        return self

    def start_replication(self, backup_endpoint: str) -> "HavenState":
        if self.quorum is not None:
            with self._state_lock:
                have = self._qlease is not None and self._qlease.live
            if not have:
                won = self._quorum_acquire("bootstrap")
                if won is None:
                    raise RuntimeError(
                        f"start_replication: quorum election lost for "
                        f"{self.resource!r} — another primary holds the "
                        f"lease (resign it or wait out its expiry)")
                with self._state_lock:
                    self.epoch = max(self.epoch, won)
        self.role = "primary"
        self.peer = backup_endpoint
        self._stop_replicator()
        self._replicator = Replicator(self, backup_endpoint).start()
        return self

    def _stop_replicator(self):
        rep, self._replicator = self._replicator, None
        if rep is not None:
            rep.stop()

    def current_primary(self) -> Optional[str]:
        if self.role == "primary":
            return self.server.endpoint
        return self.redirect_to or self.primary_ep

    def status(self) -> dict:
        with self._gate:
            # the observable lease-holder property: a primary whose gate
            # is HELD (mid-handover quiesce) or FENCED (quorum renew
            # failing) cannot acknowledge a write — at most one member
            # of a group is ever `accepting`
            accepting = self.role == "primary" and not self._held \
                and not self._fenced
            fenced = self._fenced
        out = {"role": self.role, "epoch": self.epoch,
               "endpoint": self.server.endpoint,
               "primary": self.current_primary(),
               "peer": self.peer,
               "accepting": accepting,
               "fenced": fenced,
               "head_seq": self.log.head_seq,
               "acked_seq": self.log.acked_seq,
               "applied_seq": self.applied_seq,
               "lag": self.log.lag(),
               "degraded": self.log.degraded}
        if self.quorum is not None:
            with self._state_lock:
                ql = self._qlease
            out["quorum"] = {"resource": self.resource,
                            "lease_epoch": ql.epoch if ql else 0,
                            "lease_live": bool(ql and ql.live)}
        return out

    # -- handover ----------------------------------------------------------
    def handover(self, new_endpoint: str, timeout: float = 30.0) -> dict:
        """Planned live migration of this primary shard to a fresh
        process at `new_endpoint` (already started, standing by with
        `start_standby(auto_promote=False)`):

        1. quiesce — in-flight mutators drain, new ones are HELD (not
           failed), so no trainer push dies across the flip;
        2. drain — the existing backup acks through the head seq
           (no acknowledged update can be lost by the flip);
        3. sync — full snapshot to the fresh process;
        4. flip — `haven_promote` hands it epoch+1 (and the surviving
           backup to replicate to); exactly one lease-holder exists at
           every observable point because the old primary holds its
           gate until the promote is acknowledged;
        5. retire — this server answers everything with a redirect to
           the successor and stops forwarding.

        A crash before step 4 leaves the OLD pair authoritative (the
        fresh standby never promotes — `auto_promote=False`); a crash
        after it leaves the successor authoritative (higher epoch).
        Either way exactly one shard accepts writes."""
        from ..pserver.client import PSClient

        if self.role != "primary":
            raise RuntimeError(f"handover: role is {self.role!r}, only a "
                               f"primary can hand over its shard")
        t0 = time.monotonic()
        old_backup = self.peer
        client = PSClient([new_endpoint])
        try:
            with self.quiesce():
                # 2. drain the existing backup through head (bounded)
                rep = self._replicator
                if rep is not None:
                    rep.kick()
                    # a needs_resync pair skips the drain: the old
                    # backup is being replaced wholesale by the
                    # successor's full snapshot anyway, and the
                    # forwarder's own resync would block on THIS
                    # quiesce (lag now honestly reports >=1 while a
                    # resync is pending)
                    while self.log.lag() > 0 and not self.log.degraded \
                            and not self.log.needs_resync:
                        if time.monotonic() - t0 > timeout:
                            raise RuntimeError(
                                "handover: backup failed to drain the "
                                "update log in time")
                        time.sleep(0.01)
                snap = self.snapshot()
                snap["epoch"] = self.epoch   # successor fences at +1
                if self._handover_fault == "pre_promote":
                    raise RuntimeError("haven test fault: pre_promote")
                client._call(new_endpoint, "haven_sync", snapshot=snap,
                             lease_s=self.lease_s)
                if self.quorum is not None:
                    # hand the arbiters over too, under the still-held
                    # gate: resign so the successor's campaign (inside
                    # its haven_promote) is not rejected as "held". A
                    # crash between resign and promote self-heals — the
                    # next renew round re-asserts this node's lease at
                    # its persisted epoch (the restart-renew rule).
                    with self._state_lock:
                        ql, self._qlease = self._qlease, None
                    if ql is not None:
                        self.quorum.resign(ql)
                try:
                    reply = client._call(
                        new_endpoint, "haven_promote",
                        epoch=self.epoch + 1, backup=old_backup,
                        predecessor=self.server.endpoint)
                except BaseException:
                    if self.quorum is not None:
                        # the successor never took the crown but we
                        # already resigned: re-campaign NOW (our
                        # persisted epoch makes us the favorite) or
                        # fail closed — a primary without a quorum
                        # lease must not keep accepting writes
                        won = None
                        try:
                            won = self._quorum_acquire("handover_abort")
                        except Exception:   # noqa: BLE001
                            pass
                        if won is None:
                            self._quorum_step_down("handover_abort")
                        else:
                            with self._state_lock:
                                self.epoch = max(self.epoch, won)
                    raise
                # 5. retire IMMEDIATELY after the promote ack, under the
                # still-held gate — no statement may intervene, so there
                # is no instant where both this server and the successor
                # would accept writes (the first mutator released after
                # the gate sees the redirect)
                with self._state_lock:
                    self.role = "retired"
                    self.redirect_to = new_endpoint
                    self.epoch = int(reply.get("epoch", self.epoch + 1))
                if self._handover_fault == "post_promote":
                    raise RuntimeError("haven test fault: post_promote")
                self._stop_replicator()
            _flight.note("haven_handover", endpoint=self.server.endpoint,
                         successor=new_endpoint, epoch=self.epoch,
                         seq=snap["seq"],
                         wall_s=round(time.monotonic() - t0, 3))
            return {"successor": new_endpoint, "epoch": self.epoch,
                    "seq": snap["seq"]}
        finally:
            client.close()

    def close(self):
        self._stop.set()
        self._stop_replicator()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        if self._renewer is not None:
            self._renewer.join(timeout=2.0)
            self._renewer = None
        # NOTE: close() is also the SIGKILL analog (server.stop() calls
        # it), so the held quorum lease is deliberately NOT resigned —
        # a killed primary's lease must expire at the arbiters, exactly
        # the window the failover budget prices in. Planned exits hand
        # over or resign explicitly.
        if self.quorum is not None:
            try:
                self.quorum.close()
            except Exception:   # noqa: BLE001
                pass


class Replicator:
    """The primary-side forwarder: one daemon thread streaming update
    records to the backup over the normal rpc framing, renewing the
    primary's lease on the backup every batch (idle batches are the
    heartbeat), feeding the lag gauges from the ack watermark, and
    performing full snapshot syncs when the pair needs one."""

    MAX_RECORDS = 64

    def __init__(self, haven: HavenState, backup_endpoint: str):
        self.haven = haven
        self.backup = backup_endpoint
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._client = None

    def start(self) -> "Replicator":
        from ..ark.retry import RetryPolicy
        from ..pserver.client import PSClient

        self._client = PSClient(
            [self.backup],
            retry=RetryPolicy(max_attempts=2, base_delay=0.02,
                              max_delay=0.2),
            deadline=max(self.haven.lease_s, 2.0))
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"haven-fwd@{self.haven.server.endpoint}")
        self._thread.start()
        return self

    def kick(self):
        self._kick.set()

    def _gauges(self):
        if not _flags.get_flag("observe"):
            return
        log = self.haven.log
        _metrics.gauge(
            LAG_UPDATES_METRIC,
            "update-log records not yet acknowledged by the backup"
        ).set(float(log.lag()))
        _metrics.gauge(
            LAG_US_METRIC,
            "age of the oldest unacknowledged update record"
        ).set(round(log.oldest_unacked_age_s() * 1e6, 1))

    def _full_sync(self) -> bool:
        hv = self.haven
        # cheap reachability probe BEFORE the expensive quiesced
        # deep-copy: while the backup is down, the degraded loop must
        # not stall every trainer mutator and snapshot the whole shard
        # once per backoff just to fail the connect
        self._client._call(self.backup, "haven_role",
                           _deadline=max(hv.lease_s, 2.0))
        with hv.quiesce():
            snap = hv.snapshot()
            # recording resumes AT the cut, inside the quiesce: an
            # update applied after the cut but before the snapshot lands
            # must be a log record, or it would be lost to the backup
            hv.log.resume(snap["seq"])
        reply = self._client._call(self.backup, "haven_sync",
                                   snapshot=snap, lease_s=hv.lease_s)
        hv.log.rebase(snap["seq"])
        _flight.note("haven_resync", endpoint=hv.server.endpoint,
                     backup=self.backup, seq=snap["seq"])
        logger.info("haven %s: full sync -> %s at seq %d",
                    hv.server.endpoint, self.backup, snap["seq"])
        return bool(reply)

    def _loop(self):
        hv = self.haven
        beat = max(hv.lease_s / 3.0, 0.05)
        backoff = 0.05
        while not self._stop.is_set():
            try:
                if hv.log.needs_resync:
                    self._full_sync()
                self._kick.clear()
                if not hv.log.wait_pending(timeout=beat):
                    if self._stop.is_set():
                        return
                records = hv.log.batch(self.MAX_RECORDS)
                reply = self._client._call(
                    self.backup, "haven_replicate", records=records,
                    epoch=hv.epoch, primary=hv.server.endpoint,
                    lease_s=hv.lease_s)
                if reply.get("need_resync"):
                    hv.log.degrade()
                    self._gauges()
                    continue
                hv.log.ack(int(reply["acked"]))
                self._gauges()
                backoff = 0.05
            except RuntimeError as e:
                if self._stop.is_set():
                    return
                if "NotPrimary" in str(e) or "redirect" in str(e):
                    # fenced by a higher epoch (the backup promoted, or
                    # a handover flipped) — step down, don't split-brain
                    logger.warning("haven %s: fenced by %s (%s) — "
                                   "retiring", hv.server.endpoint,
                                   self.backup, e)
                    with hv._state_lock:
                        if hv.role == "primary":
                            hv.role = "retired"
                            hv.redirect_to = self.backup
                    _flight.note("haven_fenced",
                                 endpoint=hv.server.endpoint,
                                 by=self.backup)
                    return
                # any other err reply is a backup-side fault, not a
                # fencing verdict: log, back off, keep the pair alive
                logger.warning("haven %s: replicate error from %s: %s",
                               hv.server.endpoint, self.backup, e)
                self._kick.wait(timeout=backoff)
                backoff = min(backoff * 2.0, max(beat, 0.5))
            except (ConnectionError, EOFError, OSError):
                if self._stop.is_set():
                    return
                # transport trouble: keep trying — the window's
                # backpressure (then degradation) bounds the exposure.
                # The lag gauges must keep moving HERE too: a silent
                # backup with light push traffic (window never fills)
                # is exactly what the ps_replication_stall detector
                # watches, and a stale gauge feeds its series nothing
                self._gauges()
                self._kick.wait(timeout=backoff)
                backoff = min(backoff * 2.0, max(beat, 0.5))

    def stop(self):
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._client is not None:
            try:
                self._client.close()
            except Exception:
                pass
            self._client = None
