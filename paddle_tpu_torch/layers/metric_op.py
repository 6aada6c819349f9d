"""Metric layers: the subset of paddle_tpu/layers/metric_op.py the ported
slices build (reference: python/paddle/fluid/layers/metric_op.py)."""

from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference metric_op.py accuracy): top_k + accuracy
    ops."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference("int64")
    if total is None:
        total = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC with persistable histogram state
    (reference metric_op.py auc)."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_or_get_global_variable(
        f"{helper.name}.stat_pos", [num_thresholds + 1], "float32",
        initializer=Constant(0.0))
    stat_neg = helper.create_or_get_global_variable(
        f"{helper.name}.stat_neg", [num_thresholds + 1], "float32",
        initializer=Constant(0.0))
    auc_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    return auc_out, [stat_pos, stat_neg]
