"""Bounded retry/backoff policy for host RPCs.

Mirror of ``paddle_tpu/ark/retry.py``, copied.

Capability parity with the reference gRPC client's retry knobs (reference:
paddle/fluid/operators/distributed/grpc_client.cc — `FLAGS_rpc_retry_times`
/ retry_time_ backoff in AsyncSendVar; TensorFlow's whitepaper makes the
same point: retried RPCs are half of user-visible fault tolerance, the
other half being checkpoints).

The policy is a small immutable config; `PSClient` consults it per call.
Backoff is bounded exponential with jitter: attempt k sleeps
`min(max_delay, base_delay * 2**k)` scaled by a uniform factor in
`[1 - jitter, 1 + jitter]`. A seeded policy draws its jitter from a
private `random.Random(seed)` so chaos tests replay identical schedules.
"""

from __future__ import annotations

import random
from typing import Optional


class RetryPolicy:
    """How many times to retry a failed RPC and how long to wait between
    attempts. `max_attempts` counts RETRIES (0 disables retrying); the
    original call is always made. `deadline` is the default per-call wall
    budget in seconds (None = no deadline: a call may block indefinitely,
    the pre-ark behavior)."""

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.5,
                 deadline: Optional[float] = None,
                 seed: Optional[int] = None):
        if max_attempts < 0:
            raise ValueError(f"max_attempts must be >= 0, got {max_attempts}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self._rng = random.Random(seed) if seed is not None else random

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number `attempt` (0-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_delay={self.base_delay}, max_delay={self.max_delay}, "
                f"jitter={self.jitter}, deadline={self.deadline})")


#: retrying disabled — the pre-ark fail-fast behavior, used by tests that
#: assert on first-failure semantics
NO_RETRY = RetryPolicy(max_attempts=0, deadline=None)
