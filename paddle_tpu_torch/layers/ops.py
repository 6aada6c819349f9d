"""Generated single-input layer wrappers (reference: paddle_tpu/layers/
ops.py, fluid's layer_function_generator): one layer per unary op.  Only
the unary ops the ported slices run are here so far."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = ["sigmoid", "tanh", "sqrt", "square", "gelu"]


def _make_unary(op_type: str):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} activation (see ops registry)."
    return layer


_this = globals()
for _op in _UNARY_OPS:
    _this[_op] = _make_unary(_op)

__all__ = list(_UNARY_OPS)
