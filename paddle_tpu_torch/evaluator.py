"""Graph-building Evaluator API (reference:
python/paddle/fluid/evaluator.py — deprecated there in favor of
fluid.metrics, kept for source compatibility).

Mirror of ``paddle_tpu/evaluator.py``. Each evaluator appends its
per-batch metric ops to the current program at construction time and
accumulates host-side across `eval()` epochs via the matching
``metrics`` class: `Accuracy` over `accuracy`, `ChunkEvaluator` over
`chunk_eval`, `EditDistance` over `edit_distance` and `DetectionMAP`
over `detection_map` in its padded layout (``ops/detection.py``)."""

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


class ChunkEvaluator(Evaluator):
    @deprecated("2018", "fluid.metrics.ChunkEvaluator")
    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super().__init__(**kwargs)
        self._acc = _metrics.ChunkEvaluator()
        precision, recall, f1, ninfer, nlabel, ncorrect = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self.metrics.extend([ninfer, nlabel, ncorrect])

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self._acc.update(num_infer_chunks, num_label_chunks,
                         num_correct_chunks)


class EditDistance(Evaluator):
    @deprecated("2018", "fluid.metrics.EditDistance")
    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__(**kwargs)
        self._acc = _metrics.EditDistance()
        dist, seq_num = layers.edit_distance(input=input, label=label,
                                             ignored_tokens=ignored_tokens)
        self.metrics.extend([dist, seq_num])

    def update(self, distances, seq_num):
        self._acc.update(distances, seq_num)


class DetectionMAP(Evaluator):
    @deprecated("2018", "fluid.metrics.DetectionMAP")
    def __init__(self, input, gt_label, gt_box=None, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral", **kwargs):
        super().__init__(**kwargs)
        self._acc = _metrics.DetectionMAP()
        # padded static-shape contract (ops/detection.py _detection_map):
        # input [B,D,6] detections, gt_label [B,G,6] padded ground truth
        m = layers.detection_map(input, gt_label, class_num=class_num,
                                 background_label=background_label,
                                 overlap_threshold=overlap_threshold,
                                 evaluate_difficult=evaluate_difficult,
                                 ap_version=ap_version)
        self.metrics.append(m)

    def update(self, value, weight):
        self._acc.update(value, weight)
