"""fluid-torrent KV streaming: ordered, resumable, dedup-by-seq.

Mirror of ``paddle_tpu/torrent/stream.py``, copied.

A transfer is a short seq-numbered record stream:

    kv_begin   — transfer metadata: model, seq_id, nonce, prompt, the
                 prefill's first token, block geometry, kv_dtype, and
                 the originating request's trace context
    kv_block   — one cache var's one block row. fp32 residency encodes
                 the row with the wire int8 codec (lossy, ~4x smaller);
                 int8 residency ships the already-quantized bytes plus
                 the per-block scale VERBATIM (lossless)
    kv_commit  — all rows sent: the receiver assembles the payload and
                 admits it into its decode engine

The sender drives a haven `UpdateLog`: every record is appended once,
`batch()` always re-returns everything past the acked watermark, and
`ack()` trims — so after a torn connection the sender just batches
again and the stream resumes from the last acked seq. The receiver
applies records in seq order, drops duplicates (a lost ack costs bytes,
never correctness), and replies its contiguous-applied watermark.

Failure taxonomy: a transport error mid-stream is retriable against the
SAME receiver (resume-from-watermark); a receiver that lost its staging
state (process restart) or saw a NEWER nonce for the seq_id raises
KVTransferError — the router's cue to re-prefill somewhere else.

Transport-agnostic: the sender takes a `send(records) -> acked_seq`
callable and the receiver exposes `handle(records) -> reply`; the fleet
tier wires them over its RPC frames (fleet/replica.py `torrent_kv`).
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from ..haven.log import UpdateLog
from ..observe import metrics as _metrics
from ..serve.errors import KVTransferError
from ..wire import codec as _codec

RECORD_BEGIN = "kv_begin"
RECORD_BLOCK = "kv_block"
RECORD_COMMIT = "kv_commit"


def build_records(model: str, seq_id: str, nonce: str, prompt,
                  first_token: int, max_new: int, kv: dict,
                  trace: Optional[dict] = None):
    """Flatten a prefill's extracted KV payload (serve/decode.py
    `_extract_kv` shape) into the transfer's (cmd, payload) records.
    Block rows are keyed (var, ordinal) so the receiver can reassemble
    position order regardless of arrival batching."""
    kv_dtype = str(kv.get("kv_dtype", "fp32"))
    n_blocks = int(kv["n_blocks"])
    cache_vars = sorted(kv["cache"])
    recs = [(RECORD_BEGIN, {
        "model": model, "seq_id": seq_id, "nonce": nonce,
        "prompt": [int(t) for t in prompt],
        "first_token": int(first_token), "max_new": int(max_new),
        "prompt_len": int(kv["prompt_len"]), "n_blocks": n_blocks,
        "cache_vars": cache_vars, "kv_dtype": kv_dtype,
        "trace": trace,
    })]
    scales = kv.get("scales") or {}
    for cname in cache_vars:
        rows = np.asarray(kv["cache"][cname])
        for j in range(n_blocks):
            payload = {"seq_id": seq_id, "nonce": nonce, "var": cname,
                       "ordinal": j}
            if kv_dtype == "int8":
                # already quantized on the card: ship the bytes + the block
                # scale verbatim — the decode replica's residency is
                # bit-identical to the prefill replica's
                payload["data"] = np.array(rows[j])
                payload["scale"] = float(np.asarray(scales[cname])[j])
            else:
                payload["data"] = _codec.encode_tensor(
                    rows[j], "int8", name=f"{cname}[{j}]")
            recs.append((RECORD_BLOCK, payload))
    recs.append((RECORD_COMMIT, {
        "seq_id": seq_id, "nonce": nonce, "n_records": len(recs) + 1}))
    return recs


def _record_nbytes(cmd: str, payload: dict) -> int:
    if cmd != RECORD_BLOCK:
        return 0
    n = _codec.payload_nbytes(payload["data"])
    if "scale" in payload:
        n += 4
    return n


class KVStreamSender:
    """One transfer's sending half, bound to one UpdateLog.

    Appends every record up front (the window must cover the whole
    transfer — KV streams are short; a model whose transfer outgrows the
    window should raise it, not block), then `pump()` drives
    batch→send→ack to completion with resume-from-watermark on transport
    errors."""

    def __init__(self, model: str, seq_id: str, prompt, first_token: int,
                 max_new: int, kv: dict, nonce: Optional[str] = None,
                 trace: Optional[dict] = None, window: int = 4096):
        self.model = model
        self.seq_id = seq_id
        self.nonce = nonce or uuid.uuid4().hex[:12]
        records = build_records(model, seq_id, self.nonce, prompt,
                                first_token, max_new, kv, trace=trace)
        if len(records) > window:
            raise KVTransferError(
                f"transfer of {len(records)} records exceeds the "
                f"UpdateLog window {window} — raise the window")
        self._log = UpdateLog(window=window)
        # a transfer needs no snapshot phase: clear the fresh log's
        # resync flag so lag() reads the true backlog
        self._log.rebase(0)
        for cmd, payload in records:
            self._log.append(cmd, payload)
        self.total_records = len(records)
        self.bytes_sent = 0
        self.resumes = 0
        self._m_bytes = _metrics.counter(
            "torrent_kv_transfer_bytes_total",
            "KV block bytes shipped prefill->decode (retransmits "
            "included), per model")
        self._m_resumes = _metrics.counter(
            "torrent_kv_stream_resumes_total",
            "KV streams resumed from the acked watermark after a "
            "transport error, per model")

    @property
    def done(self) -> bool:
        return self._log.acked_seq >= self._log.head_seq

    def pump(self, send: Callable[[list], int], max_records: int = 16,
             max_retries: int = 3):
        """Drive the transfer to completion. `send` ships one batch of
        (seq, cmd, payload, trace) records and returns the receiver's
        acked watermark; it raises on transport failure. Transport
        errors resume from the watermark (`batch()` re-returns the
        unacked tail) up to `max_retries` consecutive times, then
        surface as KVTransferError. A watermark that refuses to advance
        (receiver superseded/reset without raising) also fails the
        transfer — progress is the invariant, not politeness."""
        failures = 0
        while not self.done:
            batch = self._log.batch(max_records)
            try:
                acked = int(send(batch))
            except KVTransferError:
                # the receiver itself rejected the transfer (superseded
                # nonce, lost staging): resuming cannot help
                raise
            except Exception as e:          # noqa: BLE001 — transport
                failures += 1
                self.resumes += 1
                self._m_resumes.inc(model=self.model)
                if failures > max_retries:
                    raise KVTransferError(
                        f"KV stream for seq {self.seq_id!r} failed "
                        f"{failures} times at seq "
                        f"{self._log.acked_seq}/{self._log.head_seq}: "
                        f"{e!r}") from e
                continue
            nbytes = sum(_record_nbytes(c, p) for _s, c, p, _t in batch)
            self.bytes_sent += nbytes
            if nbytes:
                self._m_bytes.inc(nbytes, model=self.model)
            if acked <= self._log.acked_seq:
                raise KVTransferError(
                    f"KV stream for seq {self.seq_id!r} stalled: "
                    f"receiver acked {acked}, watermark already at "
                    f"{self._log.acked_seq}")
            failures = 0
            self._log.ack(acked)


class _Staging:
    """One in-flight transfer on the receiving side."""

    __slots__ = ("seq_id", "nonce", "meta", "blocks", "applied_seq",
                 "committed")

    def __init__(self, seq_id, nonce, meta, applied_seq):
        self.seq_id = seq_id
        self.nonce = nonce
        self.meta = meta
        # var -> ordinal -> (data, scale|None)
        self.blocks: Dict[str, Dict[int, tuple]] = {}
        self.applied_seq = applied_seq
        self.committed = False


class KVStreamReceiver:
    """The decode replica's staging table: applies record batches in seq
    order (dedup by seq), assembles the KV payload at commit, and admits
    it via the injected `admit` callable (the fleet tier passes
    `InferenceServer.submit_prefilled`). A NEWER nonce for a seq_id
    supersedes the old staging — the router's re-prefill retry path —
    and batches still arriving for the old nonce get KVTransferError."""

    def __init__(self, admit: Callable[..., Future]):
        self._admit = admit
        self._lock = threading.Lock()
        self._staging: Dict[str, _Staging] = {}  # guarded_by: self._lock
        self._futures: Dict[str, Future] = {}    # guarded_by: self._lock
        self._m_blocks = _metrics.counter(
            "torrent_kv_blocks_streamed_total",
            "KV cache block rows applied from the wire, per model")

    def handle(self, records: List) -> dict:
        """Apply one batch; returns {"acked": <contiguous watermark>}.
        Records below the watermark are duplicates (dropped); a gap
        stops the batch (the sender re-streams from the reply)."""
        admit_now = None
        with self._lock:
            acked = 0
            for rec in records:
                seq, cmd, payload = rec[0], rec[1], rec[2]
                seq = int(seq)
                if cmd == RECORD_BEGIN:
                    st = self._staging.get(payload["seq_id"])
                    if st is not None and st.nonce == payload["nonce"]:
                        acked = st.applied_seq   # duplicate begin
                        continue
                    # fresh (or superseding) transfer
                    st = _Staging(payload["seq_id"], payload["nonce"],
                                  payload, seq)
                    self._staging[payload["seq_id"]] = st
                    acked = seq
                    continue
                st = self._staging.get(payload.get("seq_id"))
                if st is None or st.nonce != payload.get("nonce"):
                    raise KVTransferError(
                        f"transfer {payload.get('seq_id')!r} nonce "
                        f"{payload.get('nonce')!r} has no staging here "
                        f"(superseded or receiver restarted) — "
                        f"re-prefill")
                if seq <= st.applied_seq:
                    acked = st.applied_seq       # duplicate
                    continue
                if seq != st.applied_seq + 1:
                    acked = st.applied_seq       # gap: stop, re-stream
                    break
                if cmd == RECORD_BLOCK:
                    st.blocks.setdefault(payload["var"], {})[
                        int(payload["ordinal"])] = (
                        payload["data"], payload.get("scale"))
                    self._m_blocks.inc(model=st.meta["model"])
                elif cmd == RECORD_COMMIT:
                    admit_now = st
                else:
                    raise KVTransferError(
                        f"unknown KV stream record kind {cmd!r}")
                st.applied_seq = seq
                acked = seq
        if admit_now is not None:
            self._commit(admit_now)
        return {"acked": acked}

    def _commit(self, st: _Staging):
        """Assemble the staged rows into the serve-layer payload shape
        and admit. Runs outside the staging lock — admit() may block on
        the engine's admission queue."""
        meta = st.meta
        n_blocks = int(meta["n_blocks"])
        kv_dtype = str(meta["kv_dtype"])
        cache: Dict[str, np.ndarray] = {}
        scales: Dict[str, np.ndarray] = {}
        for cname in meta["cache_vars"]:
            got = st.blocks.get(cname, {})
            missing = [j for j in range(n_blocks) if j not in got]
            if missing:
                raise KVTransferError(
                    f"transfer {st.seq_id!r} committed with missing "
                    f"blocks {missing} for {cname!r}")
            if kv_dtype == "int8":
                cache[cname] = np.stack(
                    [np.asarray(got[j][0]) for j in range(n_blocks)])
                scales[cname] = np.array(
                    [float(got[j][1]) for j in range(n_blocks)],
                    np.float32)
            else:
                cache[cname] = np.stack(
                    [_codec.maybe_decode(got[j][0])
                     for j in range(n_blocks)])
        kv = {"cache": cache, "prompt_len": int(meta["prompt_len"]),
              "n_blocks": n_blocks, "kv_dtype": kv_dtype}
        if kv_dtype == "int8":
            kv["scales"] = scales
        fut = self._admit(
            meta["model"], meta["prompt"], meta["first_token"], kv,
            meta["max_new"], meta.get("trace"))
        with self._lock:
            st.committed = True
            self._futures[st.seq_id] = fut

    def future(self, seq_id: str) -> Future:
        """The committed generation's Future (KVTransferError when no
        transfer for seq_id committed here)."""
        with self._lock:
            fut = self._futures.get(seq_id)
        if fut is None:
            raise KVTransferError(
                f"no committed generation for seq {seq_id!r} on this "
                f"replica")
        return fut

    def release(self, seq_id: str):
        """Drop a transfer's staging and future (EOS collected, or the
        router released the session)."""
        with self._lock:
            self._staging.pop(seq_id, None)
            self._futures.pop(seq_id, None)

    def stats(self) -> dict:
        with self._lock:
            return {"staging": len(self._staging),
                    "futures": len(self._futures)}
