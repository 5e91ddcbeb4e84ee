"""NLTK movie-review sentiment readers (reference:
python/paddle/dataset/sentiment.py). Samples: (word_id_list, label in {0,1});
reference quirk preserved: train()/test() return generators directly, not
reader creators (:115-128). Synthetic corpus keyed by class-specific word
distributions so classifiers can actually learn.

A copy of ``paddle_tpu/dataset/sentiment.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

WORD_DICT_LEN = 300
NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000


def get_word_dict():
    """word -> id, sorted by (synthetic) frequency (reference :53)."""
    return {f"word{i}": i for i in range(WORD_DICT_LEN)}


def _samples(lo, hi):
    rng = np.random.RandomState(42)
    for i in range(NUM_TOTAL_INSTANCES):
        label = i % 2
        n = int(rng.randint(5, 40))
        # polarity signal: each class draws from a shifted word range
        base = 10 if label == 0 else 150
        words = rng.randint(base, base + 120, size=n).tolist()
        if lo <= i < hi:
            yield words, label


def train():
    return _samples(0, NUM_TRAINING_INSTANCES)


def test():
    return _samples(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES)
