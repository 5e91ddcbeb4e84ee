"""fluid-wire: quantized + compressed communication for distributed
training (gradient AllReduce and parameter-server wire traffic).

Mirror of ``paddle_tpu/wire/``: the host codecs and the error feedback
are copied (numpy only), the `comm_quant_dequant` rule is written in
torch (``graph.py``). Grounded in EQuARX (PAPERS.md — quantized
AllReduce, ~2x collective speedup at negligible quality loss) and the TF
system paper's compressed parameter-server traffic. Two prongs, one
numerical contract (docs/COMMUNICATION.md):

- **Host wire codecs** (`wire.codec`, `wire.feedback`): float32 tensors
  travel as codec-tagged payloads — per-chunk abs-max int8 (~4x) or bf16
  (2x) — with per-tensor client-side error feedback on gradient pushes.
  The parameter-server client that sends them is
  `pserver.PSClient(comm_quant=)`.

- **In-graph gradient quantization** (`wire.graph`): a
  `comm_quant_dequant` op (abs-max idiom of ops/quantize.py + persistent
  error-feedback residual) inserted before each optimizer op, so a step
  over a mesh stays one Program and the whole gradient is quantized at
  the collective boundary. Select with `BuildStrategy.comm_quant` or
  `DistributeTranspilerConfig.comm_quant`.

Compression is a first-class metric: `pserver_wire_bytes_raw` /
`pserver_wire_bytes_encoded` counters per command (surfaced by
`tools/torch_telemetry_dump.py --format table`).
"""

from __future__ import annotations

from typing import List

from . import codec, feedback, graph  # noqa: F401  (graph registers the op)
from .codec import (CODECS, DEFAULT_CHUNK, NonFiniteTensorError,  # noqa: F401
                    WireCodecError, compression_ratio, decode_tensor,
                    encode_tensor, encode_with_dequant, is_encoded,
                    maybe_decode, payload_nbytes)
from .feedback import ErrorFeedback  # noqa: F401
from .graph import apply_comm_quant  # noqa: F401

# counters shared by client/server/tools (one place to get the names right)
RAW_BYTES_METRIC = "pserver_wire_bytes_raw"
ENCODED_BYTES_METRIC = "pserver_wire_bytes_encoded"


def wire_table(registry=None) -> List[str]:
    """Human-readable per-command compression table from the metrics
    registry (what `tools/torch_telemetry_dump.py --format table` prints).
    Empty when no wire traffic was recorded."""
    if registry is None:
        from ..observe import metrics as _metrics
        registry = _metrics.default_registry()
    raw = registry.get(RAW_BYTES_METRIC)
    enc = registry.get(ENCODED_BYTES_METRIC)
    if raw is None or enc is None:
        return []
    rows = []
    for labels, r in sorted(raw.items(), key=lambda kv: str(kv[0])):
        rows.append((labels.get("cmd", "?"), r, enc.value(**labels)))
    return _wire_lines(rows)


def wire_table_from_snapshot(snapshot) -> List[str]:
    """Same table from a registry SNAPSHOT dict (fluid-pulse: what a
    live `/status` scrape carries), so `tools/torch_telemetry_dump.py --url`
    prints the identical table for a remote process."""
    raw = (snapshot.get(RAW_BYTES_METRIC) or {}).get("values") or {}
    enc = (snapshot.get(ENCODED_BYTES_METRIC) or {}).get("values") or {}
    if not raw or not enc:
        return []
    rows = []
    for labelstr, r in sorted(raw.items()):
        labels = dict(p.split("=", 1) for p in labelstr.split(",")
                      if "=" in p)
        rows.append((labels.get("cmd", "?"), r, enc.get(labelstr, 0.0)))
    return _wire_lines(rows)


def _wire_lines(rows) -> List[str]:
    lines = []
    total_raw = total_enc = 0.0
    for cmd, r, e in rows:
        total_raw += r
        total_enc += e
        lines.append(f"  {cmd:<20} {r:>14,.0f} -> {e:>14,.0f} bytes  "
                     f"({compression_ratio(r, e):.2f}x)")
    if lines:
        lines.insert(0, "wire bytes (raw -> on-wire, per command):")
        lines.append(f"  {'TOTAL':<20} {total_raw:>14,.0f} -> "
                     f"{total_enc:>14,.0f} bytes  "
                     f"({compression_ratio(total_raw, total_enc):.2f}x)")
    return lines
