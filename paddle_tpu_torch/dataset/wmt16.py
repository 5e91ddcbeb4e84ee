"""WMT'16 En-De NMT readers (reference: python/paddle/dataset/wmt16.py).
Samples: (src_ids, trg_ids, trg_next_ids) with <s>/<e>/<unk> conventions.

A copy of ``paddle_tpu/dataset/wmt16.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

START_ID, END_ID, UNK_ID = 0, 1, 2


def _synthetic(n, seed, src_vocab, trg_vocab):
    """Copy-task surrogate: target is source mapped into the trg vocab —
    a real seq2seq learning signal without the corpus."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(4, 24))
        src = rng.randint(3, src_vocab, length)
        trg = (src % (trg_vocab - 3)) + 3
        trg_in = np.concatenate([[START_ID], trg])
        trg_next = np.concatenate([trg, [END_ID]])
        yield (src.astype(np.int64).tolist(),
               trg_in.astype(np.int64).tolist(),
               trg_next.astype(np.int64).tolist())


def train(src_dict_size=30000, trg_dict_size=30000):
    def reader():
        yield from _synthetic(4096, 0, src_dict_size, trg_dict_size)

    return reader


def test(src_dict_size=30000, trg_dict_size=30000):
    def reader():
        yield from _synthetic(512, 1, src_dict_size, trg_dict_size)

    return reader


def get_dict(lang, dict_size, reverse=False):
    d = {f"{lang}{i}": i for i in range(dict_size)}
    return {v: k for k, v in d.items()} if reverse else d
