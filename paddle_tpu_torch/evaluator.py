"""Graph-building Evaluator API (reference:
python/paddle/fluid/evaluator.py — deprecated there in favor of
fluid.metrics, kept for source compatibility).

Mirror of ``paddle_tpu/evaluator.py``. Each evaluator appends its
per-batch metric ops to the current program at construction time and
accumulates host-side across `eval()` epochs via the matching
``metrics`` class. `ChunkEvaluator`, `EditDistance` and `DetectionMAP`
build the `chunk_eval`, `edit_distance` and `detection_map` ops, which
are not ported yet (ROADMAP Queue 1 item 6): constructing one raises."""

from __future__ import annotations

import numpy as np

from . import layers
from . import metrics as _metrics
from .annotations import deprecated

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP", "Accuracy"]


class Evaluator:
    """Base: `metrics` holds the per-batch fetch variables; feed their
    fetched values to `update`; `eval()` returns the accumulated result."""

    def __init__(self, name=None):
        self._acc = None
        self.metrics = []

    def reset(self, executor=None, reset_program=None):
        self._acc.reset()

    def update(self, *batch_values):
        self._acc.update(*[np.asarray(v) for v in batch_values])

    def eval(self, executor=None, eval_program=None):
        return self._acc.eval()


class Accuracy(Evaluator):
    @deprecated("2018", "fluid.metrics.Accuracy")
    def __init__(self, input, label, k=1, **kwargs):
        super().__init__(**kwargs)
        self._acc = _metrics.Accuracy()
        acc = layers.accuracy(input=input, label=label, k=k)
        self.metrics.append(acc)

    def update(self, acc_value, weight):
        self._acc.update(float(np.asarray(acc_value).reshape(-1)[0]),
                         int(weight))


def _needs_item6_op(name, op):
    class _Evaluator(Evaluator):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"evaluator.{name} builds the `{op}` op, which is not "
                f"ported yet (ROADMAP Queue 1 item 6)")
    _Evaluator.__name__ = _Evaluator.__qualname__ = name
    return _Evaluator


ChunkEvaluator = _needs_item6_op("ChunkEvaluator", "chunk_eval")
EditDistance = _needs_item6_op("EditDistance", "edit_distance")
DetectionMAP = _needs_item6_op("DetectionMAP", "detection_map")
