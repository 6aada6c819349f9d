"""Tensor layer functions: the subset of paddle_tpu/layers/tensor.py
the ported slices build (reference: python/paddle/fluid/layers/tensor.py).
"""

from __future__ import annotations

from ..core.desc import normalize_dtype
from ..core.program import Variable
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
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    # elementwise over sequences: the result keeps the operands' ragged
    # lengths (the SRL book model sums per-feature projections and
    # feeds the result onward to length-aware LSTM/CRF layers).  Only
    # level-1 raggedness is defined here — a nested operand must fail
    # loudly, not silently drop its .seq_len2 (CLAUDE.md invariant).
    from .sequence import _propagate_seq_len, seq_len_var

    for x in input:
        if getattr(x, "lod_level", 0) and x.lod_level > 1:
            raise NotImplementedError(
                "sums over lod_level=2 operands: the summed result's "
                "nested lengths are ambiguous; pool the inner level "
                "first (sequence_pool)")
    src = next((x for x in input if seq_len_var(x) is not None), None)
    if src is not None:
        _propagate_seq_len(src, out)
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


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(
            input.dtype if isinstance(input, Variable) else "float32")
    if isinstance(input, Variable):
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    else:
        import numpy as np

        arr = np.asarray(input)
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
                   "values": arr.reshape(-1).tolist()})
    return output


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def where(condition, x, y):
    """x where condition, else y (the `where_op` op; IfElse merges its
    branches with it)."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where_op",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.global_block().create_var(
        name=helper.name, dtype=dtype, persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """reference layers/tensor.py create_global_var — persistable var
    initialized in the startup program."""
    from ..initializer import Constant

    helper = LayerHelper("global_var", name=name)
    var = helper.create_or_get_global_variable(
        name=name or helper.name, shape=shape, dtype=dtype,
        persistable=persistable, initializer=Constant(float(value)))
    return var


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(x, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(axis)})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="isfinite", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
