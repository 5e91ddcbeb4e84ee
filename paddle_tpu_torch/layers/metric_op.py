"""Metric layers (mirror of ``paddle_tpu/layers/metric_op.py``; the
slice's subset: `accuracy`)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of `input` logits/probs vs integer `label`."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    correct = correct or helper.create_variable_for_type_inference(dtype="int32")
    total = total or helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out.name], "Indices": [topk_indices.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc_out.name], "Correct": [correct.name],
                              "Total": [total.name]})
    return acc_out
