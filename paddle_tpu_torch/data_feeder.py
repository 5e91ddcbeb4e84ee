"""DataFeeder: rows of Python values -> a feed dict (mirror of
``paddle_tpu/data_feeder.py``; reference
python/paddle/fluid/data_feeder.py:81).

A variable-length column becomes a `(padded, lengths)` pair, which the
executor feeds as `name` and `name@SEQLEN` (``core/executor.py``).
"""

from __future__ import annotations

import numpy as np

from .core import ir, types


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        program = program or ir.default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable, pad_to: int = 0):
        """`iterable` is a batch: a list of rows, each a tuple with one
        entry a feed var. Returns {name: array | (array, lengths)}; with
        `pad_to` the time axis is at least that long, so that steps keep
        one shape."""
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in rows]
            dtype = types.np_dtype(var.dtype)
            if var.lod_level == 0:
                out[var.name] = self._dense(col, var, dtype)
            elif var.lod_level >= 2:
                out[var.name] = self._nested(col, var, dtype, pad_to)
            else:
                lens = np.array([len(s) for s in col], np.int32)
                maxlen = max(int(lens.max()), 1)
                if pad_to:
                    maxlen = max(maxlen, pad_to)
                feat = list(np.asarray(col[0], dtype=dtype).shape[1:])
                padded = np.zeros([len(col), maxlen] + feat, dtype=dtype)
                for b, seq in enumerate(col):
                    s = np.asarray(seq, dtype=dtype)
                    if s.ndim == 1 and len(var.shape) >= 3 \
                            and var.shape[-1] == 1:
                        s = s.reshape(-1, 1)
                    padded[b, : len(seq)] = s
                out[var.name] = (padded, lens)
        return out

    @staticmethod
    def _dense(col, var, dtype):
        arr = np.asarray(col, dtype=dtype)
        shape = [d for d in var.shape if d != -1]
        if arr.ndim == 1 and len(shape) > 0 and int(np.prod(shape)) > 1:
            arr = arr.reshape([len(col)] + shape)
        # classification labels: [N] -> [N, 1] when the var is 2-D
        if arr.ndim == 1 and len(var.shape) == 2 and var.shape[-1] == 1:
            arr = arr.reshape(-1, 1)
        return arr

    @staticmethod
    def _nested(col, var, dtype, pad_to):
        """Each sample a list of sequences -> (padded [B, S, T, ...],
        (outer counts [B], inner lengths [B, S]))."""
        outer = np.array([len(doc) for doc in col], np.int32)
        S = max(1, int(outer.max()))
        inner = np.zeros((len(col), S), np.int32)
        T = 1
        feat = None
        for b, doc in enumerate(col):
            for s_i, seq in enumerate(doc):
                a = np.asarray(seq, dtype=dtype)
                inner[b, s_i] = a.shape[0]
                T = max(T, a.shape[0])
                if feat is None and a.ndim > 1:
                    feat = list(a.shape[1:])
        if pad_to:
            T = max(T, pad_to)
        feat = feat or ([1] if len(var.shape) >= 4
                        and var.shape[-1] == 1 else [])
        padded = np.zeros([len(col), S, T] + feat, dtype=dtype)
        for b, doc in enumerate(col):
            for s_i, seq in enumerate(doc):
                a = np.asarray(seq, dtype=dtype)
                if a.ndim == 1 and feat == [1]:
                    a = a.reshape(-1, 1)
                padded[b, s_i, : a.shape[0]] = a
        return padded, (outer, inner)
