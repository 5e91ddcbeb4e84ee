"""Serving error taxonomy (copy of ``paddle_tpu/serve/errors.py``).

Every error a request can hit carries a `retriable` class attribute so
clients (and the load generator) can tell backpressure from bugs without
string matching:

- retriable=True  — transient serving-side condition: the queue was full
  (admission control fast-reject), the deadline expired while queued, or
  the model was mid-(re)load. Retry with backoff.
- retriable=False — the request or deployment is wrong: unknown model,
  malformed feed, corrupt model dir. Retrying cannot help.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base of every serving-path error."""

    retriable = False


class ModelNotFoundError(ServeError):
    """No model registered under the requested name."""


class ModelUnavailableError(ServeError):
    """The model exists but has no servable version right now (initial
    load in flight, or the registry is shutting down)."""

    retriable = True


class BadRequestError(ServeError):
    """The feed doesn't fit the model: wrong feed names, disagreeing
    batch dims, a static-dim mismatch, or more rows than the ladder's
    largest bucket."""


class QueueFullError(ServeError):
    """Admission control fast-reject: the model's request queue is at
    capacity. The request was NOT enqueued; retry with backoff."""

    retriable = True


class DeadlineExceededError(ServeError):
    """The request's deadline expired before its batch ran. The request
    was dropped without executing."""

    retriable = True


class KVTransferError(ServeError):
    """A wire-streamed KV transfer could not complete — the receiving
    decode replica is gone, lost its staging state, or the transfer was
    superseded by a newer attempt. The generation itself is intact on the
    client's side of the contract: re-prefill on any replica (greedy
    decoding is deterministic, so a re-prefill reproduces the same
    tokens) and stream again."""

    retriable = True


class CacheExhaustedError(ServeError):
    """Admission control: the paged KV cache cannot reserve enough blocks
    to guarantee the generation completes. The request was NOT admitted;
    blocks free as running sequences finish — retry with backoff."""

    retriable = True
