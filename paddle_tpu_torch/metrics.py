"""Python-side metric accumulators (reference:
python/paddle/fluid/metrics.py — MetricBase, CompositeMetric, Accuracy,
ChunkEvaluator, EditDistance, Auc).

A copy of ``paddle_tpu/metrics.py``."""

from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for attr, v in list(self.__dict__.items()):
            if attr.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, attr, 0)
            elif isinstance(v, (np.ndarray,)):
                setattr(self, attr, np.zeros_like(v))

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy metric")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated into EditDistance metric")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Host-side streaming AUC over threshold buckets."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        idx = np.clip((pos_prob * self._num_thresholds).astype(int), 0,
                      self._num_thresholds)
        for i, lab in zip(idx, labels):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / max(tp[-1], 1.0)
        fpr = fp / max(fp[-1], 1.0)
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
            else float(np.trapz(tpr, fpr))


class Precision(MetricBase):
    """Binary precision tp/(tp+fp) (reference metrics.py Precision):
    update with sigmoid scores (rounded at 0.5) and {0,1} labels."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    """Binary recall tp/(tp+fn) (reference metrics.py Recall)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class DetectionMAP(MetricBase):
    """Accumulator over per-batch mAP values produced by
    layers.detection_map — EXACT reference semantics (metrics.py
    DetectionMAP.update accumulates the bare value and divides by the
    accumulated weight, so with the documented usage weight=batch_size the
    result is sum(batch_mAP)/sum(batch_size), NOT a weighted mean; ported
    scripts get the reference's numbers). Pass weight=1 per batch for a
    plain mean."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0])
        self.weight += float(np.asarray(weight).reshape(-1)[0])

    def eval(self):
        if self.weight == 0:
            raise ValueError("DetectionMAP: no batches accumulated")
        return self.value / self.weight
