"""Comparison layers: the subset of paddle_tpu/layers/control_flow.py
the ported slices build (reference: python/paddle/fluid/layers/
control_flow.py).  Each writes into `cond` when it is given."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def less_equal(x, y, cond=None):
    helper = LayerHelper("less_equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_equal", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond
