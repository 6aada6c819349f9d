"""Sequence layer functions: the port of paddle_tpu/layers/sequence.py
(reference: python/paddle/fluid/layers/nn.py sequence_* family).  Ragged inputs are padded (N, T, ...) vars with a
companion `<name>.seq_len` var; these wrappers wire the companion through
ops and propagate it to outputs that stay sequences.
"""

from __future__ import annotations

from ..core.program import Variable, default_main_program
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def seq_len_var(x: Variable):
    """The companion length var of a sequence variable, if any."""
    block = default_main_program().current_block()
    name = f"{x.name}.seq_len"
    return block.var(name) if block.has_var(name) else None


def _propagate_seq_len(src: Variable, dst: Variable):
    sl = seq_len_var(src)
    if sl is None:
        return
    block = default_main_program().current_block()
    new = block.create_var(name=f"{dst.name}.seq_len", shape=sl.shape,
                           dtype=sl.dtype, stop_gradient=True)
    block.append_op(type="assign", inputs={"X": [sl]},
                    outputs={"Out": [new]})


def _emit_companion(out_var: Variable, length_var: Variable,
                    suffix: str = "seq_len"):
    """Materialize a length companion (`<out>.seq_len` /
    `<out>.seq_len2`) from an op's Length output."""
    block = default_main_program().current_block()
    sl = block.create_var(name=f"{out_var.name}.{suffix}",
                          shape=length_var.shape, dtype="int32",
                          stop_gradient=True)
    block.append_op(type="assign", inputs={"X": [length_var]},
                    outputs={"Out": [sl]})
    return sl


def _require_level1(x: Variable, api: str):
    """Layer-level rejection for APIs without nested (lod_level=2)
    support — fails loudly at graph-build time instead of running
    level-1 semantics on the sub-sequence axis (only sequence_pool
    removes a nesting level)."""
    if seq_len2_var(x) is not None:
        raise NotImplementedError(
            f"{api} does not support nested (lod_level=2) inputs; pool "
            f"the inner level first (sequence_pool)")


def _seq_inputs(x: Variable, slot="X"):
    ins = {slot: [x]}
    sl = seq_len_var(x)
    if sl is not None:
        ins["SeqLen"] = [sl]
    sl2 = seq_len2_var(x)
    if sl2 is not None:
        ins["SeqLen2"] = [sl2]
    return ins


def seq_len2_var(x: Variable):
    """The level-2 (nested) length companion, if any (lod_level=2
    inputs: data padded (B, S1, S2, ...) with seq_len (B,) counting
    sub-sequences and seq_len2 (B, S1) counting their items)."""
    block = default_main_program().current_block()
    name = f"{x.name}.seq_len2"
    return block.var(name) if block.has_var(name) else None


# ---------------------------------------------------------------------------
# RNNs
# ---------------------------------------------------------------------------

def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 use_pallas=False, unroll=1):
    """reference layers/nn.py dynamic_lstm — input must be (N, T, 4*hidden)
    (the x-projection fc is applied by the caller, as in fluid); size is
    4*hidden.

    `use_pallas` and `unroll` are recorded as the reference records them.
    Without peepholes and with the default activations the recurrence
    runs through the fused kernels whatever `use_pallas` says
    (ops/rnn.py); `use_pallas=True` with peepholes or other activations
    raises when the op runs."""
    helper = LayerHelper("lstm", name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr, shape=[hidden, 4 * hidden],
                                dtype=dtype)
    bias_size = 7 * hidden if use_peepholes else 4 * hidden
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr) or ParamAttr(),
                                shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    ins = _seq_inputs(input, "Input")
    ins.update({"Weight": [w], "Bias": [b]})
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(
        type="dynamic_lstm", inputs=ins,
        outputs={"Hidden": [hidden_out], "Cell": [cell_out],
                 "LastH": [last_h], "LastC": [last_c]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "use_pallas": use_pallas, "unroll": unroll})
    _propagate_seq_len(input, hidden_out)
    _propagate_seq_len(input, cell_out)
    return hidden_out, cell_out


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  unroll=1):
    """LSTM with recurrent projection (reference layers/nn.py
    dynamic_lstmp) — input (N, T, 4*hidden) pre-projected by the caller's
    fc; size is 4*hidden, proj_size the projection width.  Returns
    (projection (N, T, proj_size), cell (N, T, hidden))."""
    helper = LayerHelper("lstmp", name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr, shape=[proj_size, 4 * hidden],
                                dtype=dtype)
    w_proj = helper.create_parameter(param_attr, shape=[hidden, proj_size],
                                     dtype=dtype)
    bias_size = 7 * hidden if use_peepholes else 4 * hidden
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr) or ParamAttr(),
                                shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    proj_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    ins = _seq_inputs(input, "Input")
    ins.update({"Weight": [w], "ProjWeight": [w_proj], "Bias": [b]})
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(
        type="lstmp", inputs=ins,
        outputs={"Projection": [proj_out], "Cell": [cell_out],
                 "LastH": [last_h], "LastC": [last_c]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation, "unroll": unroll})
    _propagate_seq_len(input, proj_out)
    _propagate_seq_len(input, cell_out)
    return proj_out, cell_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32",
                name=None, unroll=1):
    """reference layers/nn.py dynamic_gru — input (N, T, 3*size)."""
    helper = LayerHelper("gru", name=name)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr) or ParamAttr(),
                                shape=[1, 3 * size], dtype=dtype,
                                is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    ins = _seq_inputs(input, "Input")
    ins.update({"Weight": [w], "Bias": [b]})
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(
        type="dynamic_gru", inputs=ins,
        outputs={"Hidden": [hidden_out], "LastH": [last_h]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation, "unroll": unroll})
    _propagate_seq_len(input, hidden_out)
    return hidden_out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step (reference layers/nn.py lstm_unit): fc([x, h]) →
    lstm_unit op."""
    from . import nn as nn_layers
    from .tensor import concat as concat_layer

    helper = LayerHelper("lstm_unit", name=name)
    size = cell_t_prev.shape[-1]
    # fluid computes the gate projection with one fc over [x, h]
    xh = concat_layer([x_t, hidden_t_prev], axis=1)
    gates = nn_layers.fc(xh, size=4 * size, param_attr=param_attr,
                         bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    helper = LayerHelper("gru_unit")
    hidden_dim = size // 3
    w = helper.create_parameter(param_attr, shape=[hidden_dim, 3 * hidden_dim],
                                dtype=input.dtype)
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr) or ParamAttr(),
                                shape=[1, 3 * hidden_dim], dtype=input.dtype,
                                is_bias=True)
    out_h = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset_h = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden], "Weight": [w],
                "Bias": [b]},
        outputs={"Hidden": [out_h], "Gate": [gate],
                 "ResetHiddenPrev": [reset_h]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return out_h, reset_h, gate


# ---------------------------------------------------------------------------
# sequence_* family
# ---------------------------------------------------------------------------

def sequence_pool(input, pool_type, is_test=False):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="sequence_pool",
                     inputs=_seq_inputs(input),
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    if seq_len2_var(input) is not None:
        # pooling a nested sequence removes the innermost level: the
        # output is a level-1 sequence carrying the level-1 lengths
        _propagate_seq_len(input, out)
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    _require_level1(input, "add_position_encoding")
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="add_position_encoding", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"alpha": alpha, "beta": beta})
    _propagate_seq_len(input, out)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    _require_level1(input, "row_conv")
    helper = LayerHelper("row_conv", act=act)
    f = helper.create_parameter(
        param_attr, shape=[future_context_size, input.shape[-1]],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [f]},
                     outputs={"Out": [out]})
    _propagate_seq_len(input, out)
    return helper.append_activation(out)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", name=name, act=act,
                         bias_attr=bias_attr)
    d = input.shape[-1]
    f = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = _seq_inputs(input)
    ins["Filter"] = [f]
    helper.append_op(type="sequence_conv", inputs=ins,
                     outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    _propagate_seq_len(input, out)
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


# ---------------------------------------------------------------------------
# The rest of the sequence family (ops/sequence.py)
# ---------------------------------------------------------------------------

def lod_reset(x, y=None, target_lod=None):
    """Re-segment a token stream (reference layers/nn.py lod_reset:5900).
    The new segmentation fixes the padded output's shape, so it is
    static: `target_lod` a list of offsets, or `y` a Python list of
    lengths.  A tensor y is refused, as in the reference package."""
    if target_lod is None:
        if isinstance(y, (list, tuple)):
            off = [0]
            for ln in y:
                off.append(off[-1] + int(ln))
            target_lod = off
        else:
            raise ValueError(
                "lod_reset needs a static target_lod (list of offsets) "
                "or a python-list y of lengths; a runtime tensor lod "
                "would make the padded output shape dynamic")
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_reset", inputs=_seq_inputs(x),
                     outputs={"Out": [out], "Length": [length]},
                     attrs={"target_lod": [int(v) for v in target_lod]})
    _emit_companion(out, length)
    return out


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_softmax", inputs=_seq_inputs(input),
                     outputs={"Out": [out]})
    _propagate_seq_len(input, out)
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """reference layers/nn.py sequence_expand.  With a nested y
    (lod_level=2: seq_len and seq_len2 companions), each x sequence
    broadcasts across y's sub-sequence slots and the output is nested
    itself (reference sequence_expand_op.h, ref_level 0 over a 2-level
    lod)."""
    _require_level1(x, "sequence_expand")
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    xl = seq_len_var(x)
    if xl is not None:
        ins["SeqLen"] = [xl]
    yl, yl2 = seq_len_var(y), seq_len2_var(y)
    if yl2 is None:
        helper.append_op(type="sequence_expand", inputs=ins,
                         outputs={"Out": [out]})
        _propagate_seq_len(y, out)
        return out
    if yl is not None:
        ins["YLen"] = [yl]
    ins["YLen2"] = [yl2]
    length = helper.create_variable_for_type_inference("int32")
    outputs = {"Out": [out], "Length": [length]}
    # a dense (N, D) x expands to a level-1 output (S1 repeated items), a
    # sequence x (N, Tx, ...) to a nested one
    x_is_seq = len(x.shape) >= 3
    if x_is_seq:
        length2 = helper.create_variable_for_type_inference("int32")
        outputs["Length2"] = [length2]
    helper.append_op(type="sequence_expand", inputs=ins, outputs=outputs)
    _emit_companion(out, length)
    if x_is_seq:
        _emit_companion(out, length2, "seq_len2")
    return out


def sequence_expand_as(x, y, name=None):
    _require_level1(x, "sequence_expand_as")
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    _propagate_seq_len(y, out)
    return out


def sequence_concat(input, name=None):
    """reference layers/nn.py sequence_concat: out_i = the i-th sequence
    of every input, concatenated.  Ragged level-1 inputs pack their
    valid prefixes back to back; nested (lod_level=2) inputs
    concatenate each row's sub-sequence lists (reference
    lod_tensor.h:76-104)."""
    items = list(input) if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(items[0].dtype)
    nested = [seq_len2_var(i) is not None for i in items]
    ins = {"X": items}
    lens = [seq_len_var(i) for i in items]
    length = helper.create_variable_for_type_inference("int32")
    outputs = {"Out": [out], "Length": [length]}
    if any(nested):
        if not all(nested):
            raise NotImplementedError(
                "sequence_concat: mixing nested (lod_level=2) and flat "
                "inputs is not supported; expand the flat input first")
        ins["SeqLen"] = lens
        ins["SeqLen2"] = [seq_len2_var(i) for i in items]
        length2 = helper.create_variable_for_type_inference("int32")
        outputs["Length2"] = [length2]
    elif all(ln is not None for ln in lens):
        ins["SeqLen"] = lens
    elif any(ln is not None for ln in lens):
        raise ValueError(
            "sequence_concat: every ragged input needs its .seq_len "
            "companion (mixing ragged and dense inputs is ambiguous)")
    helper.append_op(type="sequence_concat", inputs=ins, outputs=outputs)
    if "SeqLen" in ins:
        # only ragged or nested outputs carry companions
        _emit_companion(out, length)
    if any(nested):
        _emit_companion(out, length2, "seq_len2")
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_reverse", inputs=_seq_inputs(x),
                     outputs={"Y": [out]})
    _propagate_seq_len(x, out)
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    ins = _seq_inputs(x)
    ins["PadValue"] = [pad_value]
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length]},
                     attrs={"padded_length": maxlen if maxlen else -1})
    return out, length


def _seq_op(op_type, x, ins, attrs=None, propagate=False, name=None,
            out_slot="Out"):
    """One level-1 sequence op of one output `out_slot`, shaped like x."""
    _require_level1(x, op_type)
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs=ins, outputs={out_slot: [out]},
                     attrs=attrs or {})
    if propagate:
        _propagate_seq_len(x, out)
    return out


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", x, {"X": [x], "Length": [length]},
                   name=name)


def sequence_slice(input, offset, length, name=None):
    return _seq_op("sequence_slice", input, {"X": [input],
                                             "Offset": [offset],
                                             "Length": [length]}, name=name)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _seq_op("sequence_enumerate", input, {"X": [input]},
                   {"win_size": win_size, "pad_value": pad_value},
                   propagate=True, name=name)


def sequence_erase(input, tokens, name=None):
    return _seq_op("sequence_erase", input, {"X": [input]},
                   {"tokens": list(tokens)}, propagate=True, name=name)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    def as_list(v, n):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": as_list(filter_size, 2),
                            "strides": as_list(stride, 2),
                            "paddings": as_list(padding, 4)})
    return out


def sequence_scatter(input, index, updates, name=None):
    """reference layers/nn.py sequence_scatter: index and updates are
    per-sequence (padded), index's .seq_len companion giving the
    counts."""
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "Ids": [index], "Updates": [updates]}
    sl = seq_len_var(index)
    if sl is not None:
        ins["IdsLen"] = [sl]
    helper.append_op(type="sequence_scatter", inputs=ins,
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim, name=None):
    """reference layers/nn.py sequence_reshape."""
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="sequence_reshape", inputs=_seq_inputs(input),
                     outputs={"Out": [out], "OutLen": [out_len]},
                     attrs={"new_dim": int(new_dim)})
    _emit_companion(out, out_len)
    return out
