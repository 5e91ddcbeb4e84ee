"""PASCAL VOC2012 segmentation readers (reference:
python/paddle/dataset/voc2012.py). Samples: (image f32 [3,H,W] in [0,1],
label mask int32 [H,W] with 21 classes). Synthetic fallback: images with a
colored rectangle whose mask is the ground truth.

A copy of ``paddle_tpu/dataset/voc2012.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

N_CLASSES = 21
H = W = 32  # synthetic resolution (reference images are full-size JPEG)


def _reader(n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            img = rng.rand(3, H, W).astype(np.float32) * 0.2
            mask = np.zeros((H, W), np.int32)
            cls = int(rng.randint(1, N_CLASSES))
            y0, x0 = rng.randint(0, H // 2, size=2)
            h, w = rng.randint(4, H // 2, size=2)
            img[:, y0:y0 + h, x0:x0 + w] += cls / N_CLASSES
            mask[y0:y0 + h, x0:x0 + w] = cls
            yield img, mask

    return reader


def train():
    return _reader(120, seed=0)


def test():
    return _reader(30, seed=1)


def val():
    return _reader(30, seed=2)
