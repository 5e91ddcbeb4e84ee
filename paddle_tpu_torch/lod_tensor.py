"""Variable-length feed construction (mirror of
``paddle_tpu/lod_tensor.py``; reference python/paddle/fluid/lod_tensor.py:
create_lod_tensor :21, create_random_int_lodtensor :90).

The reference packs ragged data into one flat [sum_T, ...] buffer with
offset tables. Both packages feed a padded dense array and one length
vector a level instead: the pair these helpers return goes straight into
``exe.run(feed={name: pair})``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def create_lod_tensor(data, recursive_seq_lens: Sequence[Sequence[int]],
                      place=None):
    """The padded feed pair of ragged data.

    data: a flat array [sum_T, feat...] (the reference layout) or a
    nested Python list. recursive_seq_lens: one list of lengths a level,
    outermost first: [[2, 1], [3, 2, 4]] means 2 samples, the first
    holding sequences of 3 and 2 tokens, the second one of 4.

    Returns (padded, lengths) for 1 level, and
    (padded, (outer_counts, inner_lengths)) for 2.
    """
    levels = [list(lv) for lv in recursive_seq_lens]
    if not levels or len(levels) > 2:
        raise ValueError("recursive_seq_lens must have 1 or 2 levels")
    total = int(np.sum(levels[-1]))
    if isinstance(data, list):
        # the reference's nested list form: flatten outer list levels (by
        # token count, so that rectangular nesting is not misread as a
        # flattened feature matrix) until one row a token remains
        while (len(data) != total and data
               and isinstance(data[0], (list, tuple))):
            data = [x for sub in data for x in sub]
        if len(data) != total:
            raise ValueError(
                f"data holds {len(data)} tokens but recursive_seq_lens "
                f"sums to {total}")
    arr = np.asarray(data)
    if len(levels) == 1:
        lens = np.asarray(levels[0], np.int32)
        feat = list(arr.shape[1:])
        T = max(1, int(lens.max()))
        padded = np.zeros([len(lens), T] + feat, arr.dtype)
        off = 0
        for b, L in enumerate(lens):
            padded[b, :L] = arr[off:off + L]
            off += L
        return padded, lens

    outer = np.asarray(levels[0], np.int32)           # sequences a sample
    flat_inner = list(levels[1])                      # tokens a sequence
    if len(flat_inner) != int(outer.sum()):
        raise ValueError(
            f"level-1 has {len(flat_inner)} entries but level-0 sums to "
            f"{int(outer.sum())}")
    B = len(outer)
    S = max(1, int(outer.max()))
    inner = np.zeros((B, S), np.int32)
    k = 0
    for b, n in enumerate(outer):
        for s_i in range(n):
            inner[b, s_i] = flat_inner[k]
            k += 1
    T = max(1, int(inner.max()))
    feat = list(arr.shape[1:])
    padded = np.zeros([B, S, T] + feat, arr.dtype)
    off = 0
    for b in range(B):
        for s_i in range(int(outer[b])):
            L = int(inner[b, s_i])
            padded[b, s_i, :L] = arr[off:off + L]
            off += L
    return padded, (outer, inner)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """Random int64 ids in [low, high] under the given lengths (reference
    lod_tensor.py:90), drawn from numpy's global generator."""
    total = int(np.sum(recursive_seq_lens[-1]))
    data = np.random.randint(low, high + 1,
                             [total] + list(base_shape)).astype(np.int64)
    return create_lod_tensor(data, recursive_seq_lens, place)

