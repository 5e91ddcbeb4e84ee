"""fluid-torrent: disaggregated LLM serving (see docs/TORRENT.md).

Mirror of ``paddle_tpu/torrent/__init__.py``, copied.

Real generative traffic has two phases with opposite hardware appetites:
prefill is compute-bound (one big causal-attention pass over the
prompt), decode is memory-bound (one whole-cache read per token).
Co-locating them on one card makes TTFT and tokens/s fight — a long
prompt's prefill stalls every decoding sequence behind it. fluid-torrent
splits the phases across replica POOLS:

- a **prefill replica** runs the prompt's prefill step only
  (`InferenceServer.submit_prefill`), extracts the prompt's paged KV
  block rows, and streams them over the wire to a decode replica;
- a **decode replica** injects the rows at its own block ids
  (`InferenceServer.submit_prefilled`) and runs the rest of the
  generation — pure decode steps, the batch never stalls on a prefill.

The wire transfer (`torrent.stream`) reuses two proven idioms: the
fluid-wire int8 tensor codec for block payloads (KV blocks tolerate the
same quantization the EQuARX-style gradient path does — and an
int8-resident cache ships its bytes verbatim, losslessly), and the
fluid-haven `UpdateLog` seq-numbered-record window for ordered,
RESUMABLE transfer — a torn connection re-streams from the last acked
seq, the receiver dedups by seq, and a superseded transfer is detected
by nonce.

`fleet.FleetRouter.generate_torrent` orchestrates the pair: prefill
stays least-loaded with full retry/failover; the generating sequence
pins to its decode replica (session affinity keyed on sequence id,
released on EOS/cancel/replica death). Because decoding is greedy and
deterministic, a dead decode replica costs a re-prefill, never a wrong
token.
"""

from __future__ import annotations

from .prefill import prefill_and_stream  # noqa: F401
from .stream import (RECORD_BEGIN, RECORD_BLOCK,  # noqa: F401
                     RECORD_COMMIT, KVStreamReceiver, KVStreamSender,
                     build_records)
