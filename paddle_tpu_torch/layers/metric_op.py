"""Metric layers (mirror of ``paddle_tpu/layers/metric_op.py``):
`accuracy` and the streaming `auc`."""

from __future__ import annotations

from .. import initializer as init
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


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    """Streaming AUC (reference metric_op.py `auc`): the `auc` op adds
    each batch into two persistable float32 histograms of
    `num_thresholds` + 1 buckets, zero at startup, and outputs the AUC
    over everything they hold. Returns (auc, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="float32", persistable=True)
    stat_neg = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="float32", persistable=True)
    for v in (stat_pos, stat_neg):
        helper.set_variable_initializer(v, init.ConstantInitializer(0.0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("auc",
                     inputs={"Predict": [input.name], "Label": [label.name],
                             "StatPos": [stat_pos.name],
                             "StatNeg": [stat_neg.name]},
                     outputs={"AUC": [auc_out.name],
                              "StatPosOut": [stat_pos.name],
                              "StatNegOut": [stat_neg.name]},
                     attrs={"num_thresholds": num_thresholds, "curve": curve})
    return auc_out, [stat_pos, stat_neg]
