"""Tensor layer functions: the subset of paddle_tpu/layers/tensor.py
the ported slices build (reference: python/paddle/fluid/layers/tensor.py).
"""

from __future__ import annotations

from ..core.desc import normalize_dtype
from ..layer_helper import LayerHelper


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant", outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": normalize_dtype(dtype),
               "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": normalize_dtype(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    """Sum a list of same-shape vars (the `sum` op)."""
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = normalize_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype})
    return out


def range(start, end, step, dtype, num=None):
    """Static-length arange: `num` is given, or derived from Python
    scalar bounds (the reference's rule; the op needs it)."""
    helper = LayerHelper("range")
    dtype = normalize_dtype(dtype)
    pys = [start, end, step]
    if num is None:
        if all(isinstance(v, (int, float)) for v in pys):
            num = max(0, int((end - start + (step - (1 if step > 0 else -1)))
                             // step))
        else:
            raise ValueError("range with tensor bounds requires num=")
    vals = [fill_constant([1], dtype, v) if isinstance(v, (int, float))
            else v for v in pys]
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range",
                     inputs={"Start": [vals[0]], "End": [vals[1]],
                             "Step": [vals[2]]},
                     outputs={"Out": [out]}, attrs={"num": int(num)})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out
