"""Oxford-102 flowers classification readers (reference:
python/paddle/dataset/flowers.py). Samples: (image f32 [3,224,224], label
int in [0,102)). Synthetic fallback: class-colored blobs at the reference
resolution so input pipelines and models see the real shapes.

A copy of ``paddle_tpu/dataset/flowers.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

N_CLASSES = 102
SIZE = 224


def _reader(n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            label = int(rng.randint(0, N_CLASSES))
            img = rng.rand(3, SIZE, SIZE).astype(np.float32) * 0.1
            # class signature: channel means keyed by the label
            img[0] += (label % 7) / 7.0
            img[1] += (label % 11) / 11.0
            img[2] += (label % 13) / 13.0
            yield img, label

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(64, seed=0)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(16, seed=1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(16, seed=2)
