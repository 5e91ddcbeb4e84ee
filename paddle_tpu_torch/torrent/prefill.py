"""fluid-torrent prefill driver: local prefill -> wire stream.

Mirror of ``paddle_tpu/torrent/prefill.py``, copied.

The prefill replica's half of a disaggregated generation, run by its
fleet replica's `torrent_prefill` handler: run the prompt through this
server's prefill-only path, then pump the extracted KV payload through a
KVStreamSender to the decode replica the router pinned. Returns the
summary the router needs to finish orchestrating (first token, local
TTFT, bytes shipped).

Failure split (the router's cue): serve-side errors (backpressure, bad
request) raise their own ServeError types; a transfer that cannot reach
or resume on the decode replica raises KVTransferError — the router
releases the pin and re-prefills against a fresh decode replica, which
is safe because greedy decoding is deterministic.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

from .. import flags as _flags
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from ..serve.errors import ServeError
from .stream import KVStreamSender

_m_prefills = _metrics.counter(
    "torrent_prefills_total",
    "disaggregated prefill halves by outcome, per model")


def prefill_and_stream(server, model: str, prompt, max_new: int,
                       seq_id: str, send: Callable[[list], int],
                       deadline_ms: Optional[float] = None,
                       trace: Optional[dict] = None,
                       max_records: int = 16,
                       max_retries: int = 3) -> dict:
    """Run the prefill half on `server` and stream the KV payload via
    `send` (fleet-provided, one batch per call). Returns
    {first_token, ttft_us, prompt_len, n_blocks, records, bytes,
    stream_us, nonce}."""
    cm = (_xray.span("torrent:prefill", cat="torrent", model=model,
                     seq=seq_id)
          if _flags.get_flag("observe") else contextlib.nullcontext())
    t0 = time.monotonic()
    with cm:
        try:
            r = server.submit_prefill(
                model, prompt, deadline_ms=deadline_ms).result()
            sender = KVStreamSender(
                model, seq_id, prompt, r.tokens[0], max_new, r.kv,
                trace=trace)
            sender.pump(send, max_records=max_records,
                        max_retries=max_retries)
        except ServeError as e:
            _m_prefills.inc(model=model, outcome=type(e).__name__)
            raise
        _m_prefills.inc(model=model, outcome="ok")
        return {"first_token": int(r.tokens[0]),
                "ttft_us": float(r.ttft_us),
                "prompt_len": int(r.kv["prompt_len"]),
                "n_blocks": int(r.kv["n_blocks"]),
                "records": sender.total_records,
                "bytes": sender.bytes_sent,
                "stream_us": (time.monotonic() - t0) * 1e6,
                "nonce": sender.nonce}
