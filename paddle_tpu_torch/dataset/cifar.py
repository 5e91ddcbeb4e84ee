"""CIFAR-10/100 readers (reference: python/paddle/dataset/cifar.py).
Samples: (image[3072] float32 in [0,1], label int).

A copy of ``paddle_tpu/dataset/cifar.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np


def _synthetic(n, seed, classes):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    for i in range(n):
        c = int(labels[i])
        img = 0.1 * rng.rand(3, 32, 32).astype(np.float32)
        img[c % 3, (c * 3) % 28:(c * 3) % 28 + 4, :] += 0.8
        yield np.clip(img, 0, 1).reshape(-1), c


def train10():
    return lambda: _synthetic(4096, 0, 10)


def test10():
    return lambda: _synthetic(512, 1, 10)


def train100():
    return lambda: _synthetic(4096, 0, 100)


def test100():
    return lambda: _synthetic(512, 1, 100)
