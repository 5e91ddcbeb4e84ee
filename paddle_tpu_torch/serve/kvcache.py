"""The paged KV cache block allocator (copy of
``paddle_tpu/serve/kvcache.py``).

The cache ARRAYS live in the model version's scope as persistable
``*@KV_CACHE`` vars ([num_blocks, block_size, heads, head_dim]) and are
updated in place by the prefill/decode steps (ops/paged_attention.py).
This module owns the HOST side: which physical block belongs to which slot, the free list,
and the block-table array the steps consume.

Design points:

- **Block 0 is reserved (trash).** Inactive slots and prefill padding
  lanes scatter there so every device-side scatter is static; the
  allocator simply never hands block 0 out.
- **Reserve at admission, allocate on append.** Admission reserves the
  worst-case block count for the whole generation (prompt + max new
  tokens), so a running sequence can never strand mid-decode on an empty
  free list — `CacheExhaustedError` is only ever thrown at the admission
  door, where it is retriable backpressure. Physical blocks are popped
  lazily (`ensure`) as the sequence actually grows, and both blocks and
  unused reservation return to the pool on `free_slot` — finish-early
  sequences release capacity immediately.
- **Static block-table array.** One [max_slots, max_blocks_per_seq]
  int32 array, zeroed rows for vacant slots, handed to every step — the
  decode step's feed shapes never change.

Occupancy is published as ``serve_kv_blocks_in_use`` (allocated +
reserved, i.e. what admission actually sees) next to
``serve_kv_blocks_capacity``.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from ..observe import metrics as _metrics
from .errors import CacheExhaustedError


def block_residency_nbytes(sig: dict) -> int:
    """Device bytes one cache block costs across every cache var of a
    decode signature — the unit the capacity planner divides a byte
    budget by. The int8 residency pays 1 byte per position plus one
    float32 per-block scale per cache var, against 4 bytes per position
    for fp32: at the tiny LM's (block_size 4, 2 heads, head_dim 8)
    geometry that is 68 against 256 bytes, so ~3.8x more blocks (and
    therefore concurrent sequences) per card at a fixed budget."""
    per_pos = int(sig["block_size"]) * int(sig["num_heads"]) \
        * int(sig["head_dim"])
    n_caches = len(sig["cache_vars"])
    if sig.get("kv_dtype") == "int8":
        return n_caches * (per_pos + 4)    # int8 values + f32 block scale
    return n_caches * per_pos * 4


def blocks_for_budget(sig: dict, budget_bytes: int) -> int:
    """Allocatable blocks (excluding the trash block) a device byte
    budget affords under `sig`'s residency layout."""
    per_block = block_residency_nbytes(sig)
    return max(int(budget_bytes) // per_block - 1, 0)


class PagedKVCache:
    """Host-side allocator for one model version's paged KV cache."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, max_slots: int, model: str = "",
                 version: str = ""):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_slots = int(max_slots)
        self.model = model
        # gauges are labeled (model, version): during a hot swap the OLD
        # version's cache keeps real blocks while in-flight sequences
        # drain — sharing one label would let the new cache's zeros mask
        # a live near-exhaustion incident (and the drain-time frees
        # would clobber the new cache's counts). close() zeroes this
        # version's series when it retires.
        self.version = version
        self._lock = threading.Lock()
        # pop() order ascending (1, 2, ...) — deterministic placement, so
        # block-table contents (and therefore device scatters) replay
        # identically for identical request sequences
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._reserved_total = 0
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_reserved = [0] * max_slots
        self.block_tables = np.zeros((max_slots, max_blocks_per_seq),
                                     np.int32)
        self._m_in_use = _metrics.gauge(
            "serve_kv_blocks_in_use",
            "paged KV blocks allocated+reserved, per model")
        self._m_capacity = _metrics.gauge(
            "serve_kv_blocks_capacity",
            "allocatable paged KV blocks (excl. trash block), per model")
        self._m_capacity.set(self.capacity, model=model, version=version)
        self._m_in_use.set(0, model=model, version=version)

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def _publish_locked(self):
        used = sum(len(b) for b in self._slot_blocks) + self._reserved_total
        self._m_in_use.set(used, model=self.model, version=self.version)

    def in_use(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._slot_blocks) \
                + self._reserved_total

    def available(self) -> int:
        with self._lock:
            return len(self._free) - self._reserved_total

    # -- admission / growth ----------------------------------------------

    def reserve(self, slot: int, n_tokens: int):
        """Reserve the worst-case block count for a generation of
        `n_tokens` total tokens. Raises CacheExhaustedError (retriable)
        without reserving anything when the pool can't cover it."""
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_seq:
            raise CacheExhaustedError(
                f"sequence of {n_tokens} tokens needs {need} blocks but "
                f"max_blocks_per_seq is {self.max_blocks_per_seq} — raise "
                f"max_context or reject upstream")
        with self._lock:
            have = len(self._free) - self._reserved_total
            # delta accounting: re-reserving a slot that already holds
            # blocks/reservation (a grow) only charges the difference —
            # and never double-counts the old reservation in the total
            delta = need - len(self._slot_blocks[slot]) \
                - self._slot_reserved[slot]
            if delta > have:
                raise CacheExhaustedError(
                    f"model {self.model!r}: KV cache exhausted — need "
                    f"{need} blocks, {have} available of "
                    f"{self.capacity} (in flight sequences free blocks "
                    f"as they finish; retry with backoff)")
            if delta > 0:
                self._slot_reserved[slot] += delta
                self._reserved_total += delta
            self._publish_locked()

    def ensure(self, slot: int, n_tokens: int) -> np.ndarray:
        """Grow `slot`'s block list to cover `n_tokens` positions,
        drawing from its reservation. Returns the (shared) block-table
        array. Callers must have reserved enough at admission — running
        out here is a bug, not backpressure."""
        need = self.blocks_for(n_tokens)
        with self._lock:
            blocks = self._slot_blocks[slot]
            while len(blocks) < need:
                if self._slot_reserved[slot] <= 0 or not self._free:
                    raise RuntimeError(
                        f"model {self.model!r} slot {slot}: block demand "
                        f"exceeded its admission reservation "
                        f"({len(blocks)} allocated, "
                        f"{self._slot_reserved[slot]} reserved) — "
                        f"admission accounting bug")
                b = self._free.pop()
                self._slot_reserved[slot] -= 1
                self._reserved_total -= 1
                self.block_tables[slot, len(blocks)] = b
                blocks.append(b)
            self._publish_locked()
            return self.block_tables

    def slot_blocks(self, slot: int) -> List[int]:
        """Snapshot of the physical blocks allocated to `slot`, in
        position order."""
        with self._lock:
            return list(self._slot_blocks[slot])

    def free_slot(self, slot: int):
        """Return the slot's blocks and any unused reservation to the
        pool and zero its block-table row (vacant rows point at the trash
        block, where inactive-lane scatters land)."""
        with self._lock:
            blocks = self._slot_blocks[slot]
            # ascending free list keeps placement deterministic after
            # recycling too
            self._free.extend(reversed(blocks))
            self._free.sort(reverse=True)
            self._reserved_total -= self._slot_reserved[slot]
            self._slot_reserved[slot] = 0
            self._slot_blocks[slot] = []
            self.block_tables[slot, :] = 0
            self._publish_locked()

    def close(self):
        """Zero THIS version's gauge series when it retires."""
        self._m_in_use.set(0, model=self.model, version=self.version)
        self._m_capacity.set(0, model=self.model, version=self.version)
