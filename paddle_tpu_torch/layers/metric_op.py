"""Metric layers: the subset of paddle_tpu/layers/metric_op.py the ported
slices build (reference: python/paddle/fluid/layers/metric_op.py)."""

from __future__ import annotations

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
