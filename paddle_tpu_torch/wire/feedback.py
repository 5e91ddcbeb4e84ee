"""Per-tensor error feedback for quantized gradient communication.

Mirror of ``paddle_tpu/wire/feedback.py``, copied (numpy only).

The EF-SGD idea (and EQuARX's quality story): quantization error is not
discarded, it is CARRIED — the residual `r_t = g_t' - Q(g_t')` (where
`g_t' = g_t + r_{t-1}`) is added into the next step's gradient before
encoding, so quantization noise cancels over steps instead of
accumulating into a bias. With abs-max int8 this keeps sync-PS training
inside the unquantized loss band (pinned by tests/test_wire.py).

Replay safety contract (the `quant_flaky_rpc` chaos drill): the residual
is updated ONCE per logical push, only after the frame is known
delivered. `encode()` returns `(payload, commit)` — the caller invokes
`commit()` after its RPC succeeds. Transport-level retries resend the
SAME already-encoded bytes; a caller-level retry after a failed call
re-encodes from the UNCHANGED residual and produces bit-identical bytes
(the gradient and residual are both unchanged), so a frame that was
secretly applied server-side is deduplicated by the batch-id watermark
and the residual is never double-applied.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from . import codec as _codec


class ErrorFeedback:
    """Residual store keyed by an opaque key (the client uses
    (endpoint, var name) so replica/endpoint moves never mix streams)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._residual: Dict[Any, np.ndarray] = {}
        self._committed: Dict[Any, Any] = {}   # key -> last committed tag

    def encode(self, key, arr, codec: str, name: str = "<tensor>",
               chunk: int = _codec.DEFAULT_CHUNK, tag: Any = None
               ) -> Tuple[Any, Callable[[], None]]:
        """Encode `arr + residual[key]`; returns (payload, commit).
        `commit()` stores the new residual — call it only once the frame
        was delivered (see the module docstring's replay contract).

        `tag` identifies the LOGICAL push (the sync path passes
        (session, batch_id)): committing the same tag twice is a no-op.
        This closes the caller-level-retry window — a batch whose push
        landed and committed but whose barrier reply was lost gets
        re-pushed by the retrying caller; the server deduplicates the
        frame by batch id, and the dedup here keeps the retry's
        never-applied quantization error out of the residual stream."""
        arr = np.asarray(arr, dtype=np.float32)
        with self._lock:
            r = self._residual.get(key)
        compensated = arr + r if r is not None else arr
        payload, deq = _codec.encode_with_dequant(compensated, codec,
                                                  name=name, chunk=chunk)
        new_r = compensated - deq if _codec.is_encoded(payload) else None

        def commit():
            if new_r is None:
                return
            with self._lock:
                if tag is not None and self._committed.get(key) == tag:
                    return   # replay of an already-committed logical push
                self._residual[key] = new_r
                if tag is not None:
                    self._committed[key] = tag

        return payload, commit

    def residual(self, key) -> Optional[np.ndarray]:
        with self._lock:
            return self._residual.get(key)

    # -- checkpoint integration (ark bit-identical resume) -----------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Residual streams as flat npz-compatible arrays, keyed
        `"<endpoint>|<name>"`. The residual is TRAINER-LOCAL state: a
        resume that restores params/slots/RNG but not the residuals
        produces pushes that differ from the uninterrupted run by up to
        one quantum per tensor — quality-neutral (error feedback is
        noise cancellation, not correctness), but not bit-identical.
        Callers that need ark's bit-identical-resume guarantee under
        `comm_quant` merge this into the checkpoint `arrays` and feed it
        back through `load_state_dict` after restore (the commit-tag
        dedup window is per-process and deliberately NOT serialized: a
        resumed process re-pushes its batch from scratch)."""
        with self._lock:
            return {f"{ep}|{name}": r.copy()
                    for (ep, name), r in self._residual.items()}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        with self._lock:
            for flat, r in state.items():
                ep, _, name = flat.partition("|")
                self._residual[(ep, name)] = np.asarray(r, np.float32)

    def clear(self):
        with self._lock:
            self._residual.clear()
            self._committed.clear()
