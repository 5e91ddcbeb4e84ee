"""MNIST readers (reference: python/paddle/dataset/mnist.py).

train()/test() yield (image[784] float32 in [-1,1], label int) like the
reference. Real download when permitted; deterministic synthetic digits
otherwise (zero-egress default).

A copy of ``paddle_tpu/dataset/mnist.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

URL_PREFIX = "https://ossci-datasets.s3.amazonaws.com/mnist/"
TRAIN_IMAGE = "train-images-idx3-ubyte.gz"
TRAIN_LABEL = "train-labels-idx1-ubyte.gz"
TEST_IMAGE = "t10k-images-idx3-ubyte.gz"
TEST_LABEL = "t10k-labels-idx1-ubyte.gz"


def _parse(image_path, label_path):
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    images = images.astype(np.float32) / 127.5 - 1.0
    return images, labels.astype(np.int64)


def _synthetic(n, seed):
    """Deterministic learnable surrogate: class-dependent bright blob."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int64)
    images = 0.1 * rng.randn(n, 784).astype(np.float32)
    img = images.reshape(n, 28, 28)
    for i in range(n):
        c = int(labels[i])
        img[i, 2 * c: 2 * c + 4, 2 * c: 2 * c + 4] += 1.5
    return np.clip(images, -1, 1), labels


def _reader(image_name, label_name, synth_n, seed):
    def reader():
        if common.can_download():
            try:
                ip = common.download(URL_PREFIX + image_name, "mnist", None)
                lp = common.download(URL_PREFIX + label_name, "mnist", None)
                images, labels = _parse(ip, lp)
            except RuntimeError:
                images, labels = _synthetic(synth_n, seed)
        else:
            images, labels = _synthetic(synth_n, seed)
        for x, y in zip(images, labels):
            yield x, int(y)

    return reader


def train():
    return _reader(TRAIN_IMAGE, TRAIN_LABEL, 8192, 0)


def test():
    return _reader(TEST_IMAGE, TEST_LABEL, 1024, 1)
