"""UCI housing regression readers (reference:
python/paddle/dataset/uci_housing.py). Samples: (features[13] f32, [price]).

A copy of ``paddle_tpu/dataset/uci_housing.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

from . import common

URL = "http://paddlemodels.bj.bcebos.com/uci_housing/housing.data"


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(13, 1).astype(np.float32)
    x = rng.randn(n, 13).astype(np.float32)
    y = x @ w + 0.1 * rng.randn(n, 1).astype(np.float32)
    return x, y


def _reader(n, seed):
    def reader():
        x, y = _synthetic(n, seed)
        for xi, yi in zip(x, y):
            yield xi, yi

    return reader


def train():
    return _reader(404, 0)


def test():
    return _reader(102, 1)
