"""PTB-style n-gram LM readers (reference: python/paddle/dataset/imikolov.py,
the word2vec book-test corpus). Samples: n-gram tuples of word ids.

A copy of ``paddle_tpu/dataset/imikolov.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(2074)}


def _synthetic(n, seed, vocab, ngram):
    """Markov-chain surrogate: next word = (sum of context) % vocab + noise,
    so an embedding model has structure to learn."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ctx = rng.randint(0, vocab, ngram - 1)
        nxt = (ctx.sum() + rng.randint(0, 3)) % vocab
        yield tuple(int(c) for c in ctx) + (int(nxt),)


def train(word_idx, n):
    return lambda: _synthetic(8192, 0, len(word_idx), n)


def test(word_idx, n):
    return lambda: _synthetic(1024, 1, len(word_idx), n)
