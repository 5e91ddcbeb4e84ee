"""IMDB sentiment readers (reference: python/paddle/dataset/imdb.py).
Samples: (word_id_sequence, label in {0,1}).

A copy of ``paddle_tpu/dataset/imdb.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

from . import common


def word_dict(vocab_size=5147):
    return {f"w{i}": i for i in range(vocab_size)}


def _synthetic(n, seed, vocab=5147):
    """Learnable surrogate: positive samples draw from the upper half of the
    vocab, negative from the lower — a linear classifier can separate."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 64))
        if label:
            ids = rng.randint(vocab // 2, vocab, length)
        else:
            ids = rng.randint(0, vocab // 2, length)
        yield ids.astype(np.int64).tolist(), label


def train(word_idx=None):
    vocab = len(word_idx) if word_idx else 5147

    def reader():
        yield from _synthetic(2048, 0, vocab)

    return reader


def test(word_idx=None):
    vocab = len(word_idx) if word_idx else 5147

    def reader():
        yield from _synthetic(512, 1, vocab)

    return reader
