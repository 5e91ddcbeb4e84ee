"""WMT14 en->fr translation readers (reference:
python/paddle/dataset/wmt14.py). Samples: (src_ids, trg_ids, trg_ids_next)
with <s>/<e>/<unk> conventions (reference reader_creator :78-110: src gets
START+words+END, trg gets START+words, trg_next gets words+END).

Synthetic fallback: "translation" pairs where the target is a deterministic
permutation of the source sequence, so seq2seq models can fit it.

A copy of ``paddle_tpu/dataset/wmt14.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID, END_ID, UNK_IDX = 0, 1, 2


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); reverse=True gives id->word (reference :151)."""
    words = [START, END, UNK] + [f"w{i}" for i in range(dict_size - 3)]
    d = {w: i for i, w in enumerate(words)}
    if reverse:
        d = {i: w for w, i in d.items()}
    return d, dict(d)


def _reader(dict_size, n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            n = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, size=n).tolist()
            trg = [int(dict_size - 1 - (w - 3) % (dict_size - 3))
                   for w in src]  # deterministic mapping
            src_ids = [START_ID] + src + [END_ID]
            trg_ids = [START_ID] + trg
            trg_ids_next = trg + [END_ID]
            yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size):
    return _reader(dict_size, 1000, seed=0)


def test(dict_size):
    return _reader(dict_size, 100, seed=1)


def gen(dict_size):
    return _reader(dict_size, 100, seed=2)
