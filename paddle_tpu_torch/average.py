"""WeightedAverage (reference: python/paddle/fluid/average.py). A copy of
``paddle_tpu/average.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, complex, np.ndarray)) or \
        np.isscalar(var)


class WeightedAverage:
    """Running weighted average of scalar batch statistics (reference
    average.py:30)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            value = np.asarray(value)
        if not np.isscalar(weight):
            weight = float(np.asarray(weight).reshape(-1)[0])
        value = float(np.asarray(value).reshape(-1)[0]) \
            if not np.isscalar(value) else float(value)
        if self.numerator is None:
            self.numerator, self.denominator = 0.0, 0.0
        self.numerator += value * weight
        self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator == 0:
            raise ValueError(
                "WeightedAverage: there is no data to be averaged")
        return self.numerator / self.denominator
