"""Composite neural-net layers: the subset of paddle_tpu/layers/nn.py
that the ported slices build (reference: python/paddle/fluid/layers/
nn.py).  Each function is the reference's, unchanged: it creates output
vars + parameters via LayerHelper and appends OpDescs to the default main
program; shapes/dtypes are inferred by running the op on "meta" tensors
(core/shape_inference.py).  The rest of the reference's layers are still
to be ported (ROADMAP queue A item 6).
"""

from __future__ import annotations

import numpy as np

from ..initializer import Constant, Normal, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (reference layers/nn.py fc) — mul + sum +
    bias + activation."""
    helper = LayerHelper("fc", name=name, act=act, bias_attr=bias_attr,
                         input=input)
    inputs = input if isinstance(input, list) else [input]
    dtype = inputs[0].dtype

    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        param_shape = [
            int(np.prod([abs(d) for d in in_shape[num_flatten_dims:]])),
            size,
        ]
        w = helper.create_parameter(param_attr, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul", inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims,
                   "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    result = helper.append_activation(pre_act)
    if num_flatten_dims >= 2 and not isinstance(input, list):
        # sequence-preserving projection: keep the seq_len companion
        from .sequence import _propagate_seq_len

        _propagate_seq_len(input, result)
    return result


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference layers/nn.py embedding → lookup_table op.  is_sparse /
    is_distributed are recorded for parity (the table is dense)."""
    helper = LayerHelper("embedding", name=None)
    w = helper.create_parameter(param_attr, shape=size, dtype=dtype,
                                default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table", inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": bool(is_sparse)})
    from .sequence import _propagate_seq_len

    _propagate_seq_len(input, out)
    return out


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None,
                   out_dtype=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape, dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=norm_shape,
            dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(dtype)
    m = helper.create_variable_for_type_inference(dtype)
    v = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [m], "Variance": [v]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(y)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, label_smooth_eps=0.0):
    """label_smooth_eps > 0 folds label smoothing into the hard-label CE,
    mathematically identical to one_hot -> label_smooth -> soft-label CE."""
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    sm = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Loss": [loss], "Softmax": [sm]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index,
                            "label_smooth_eps": float(label_smooth_eps)})
    if return_softmax:
        return loss, sm
    return loss


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    ins = {"X": [label]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=ins,
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        attrs = {"reduce_all": False,
                 "dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def batched_gather(input, index, name=None):
    """Per-row gather: input (N, A, ...) gathered at index (N, S) →
    (N, S, ...) (used by rpn_target_assign; see ops/basic.py)."""
    helper = LayerHelper("batched_gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="batched_gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def flash_attention(q, k, v, bias=None, scale=None, causal=False,
                    use_pallas=None, sequence_parallel=False,
                    layout="nhtd", n_head=None, name=None):
    """Fused multi-head attention over (N, H, T, D) tensors (see
    ops/attention.py).  layout="nthd" + n_head takes the head-major
    head-grouped (N, T, H*D) contract instead — what the attn_qkv
    projection emits directly, so nothing transposes at the kernel
    boundary.  use_pallas and sequence_parallel are recorded as the
    reference records them; the port routes by device
    (ops/kernels/flash_attention.py)."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        ins["Bias"] = [bias]
    attrs = {"causal": causal, "use_pallas": use_pallas,
             "sequence_parallel": sequence_parallel,
             "layout": layout}
    if n_head is not None:
        attrs["n_head"] = int(n_head)
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="flash_attention", inputs=ins,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def fused_vocab_softmax_ce(hidden, weight, label, epsilon=0.0,
                           use_pallas=False, block_t=None, block_v=None,
                           name=None):
    """Per-token label-smoothed CE of `hidden @ weight` computed without
    materialising the (tokens, vocab) logits (ops/kernels/vocab_ce.py).
    hidden (..., D), weight (D, V) parameter, label int ids with
    hidden's leading shape.  use_pallas, block_t and block_v are recorded
    as the reference records them; the port routes by device."""
    helper = LayerHelper("fused_vocab_softmax_ce", name=name)
    loss = helper.create_variable_for_type_inference("float32")
    attrs = {"epsilon": float(epsilon), "use_pallas": bool(use_pallas)}
    if block_t is not None:
        attrs["block_t"] = int(block_t)
    if block_v is not None:
        attrs["block_v"] = int(block_v)
    helper.append_op(
        type="fused_vocab_softmax_ce",
        inputs={"Hidden": [hidden], "W": [weight], "Label": [label]},
        outputs={"Loss": [loss]},
        attrs=attrs)
    return loss


def paged_attention(q, k_cache, v_cache, page_table, lengths, n_head,
                    scale=None, use_pallas=None, k_scale=None,
                    v_scale=None, name=None):
    """Decode-step ragged paged attention (ops/paged_kv.py): one query
    token per slot (Q (S, H*D) head-grouped) attends over that slot's
    K/V pages of the shared (P, page, H*D) pools, addressed through the
    (S, max_pages) page table and masked to `lengths`.  use_pallas is
    recorded as the reference records it; the port routes by device
    (ops/kernels/paged_attention.py).  k_scale/v_scale: (P, page, 1)
    sidecar pools for int8 caches."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
           "PageTable": [page_table], "Lengths": [lengths]}
    if k_scale is not None:
        ins["KScale"] = [k_scale]
        ins["VScale"] = [v_scale]
    attrs = {"n_head": int(n_head), "use_pallas": use_pallas}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="paged_attention", inputs=ins,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def _paged_write(op_type, k, v, k_cache, v_cache, page_table, extra_ins,
                 k_scale, v_scale, name):
    helper = LayerHelper(op_type, name=name)
    kc_out = helper.create_variable_for_type_inference(k_cache.dtype)
    vc_out = helper.create_variable_for_type_inference(v_cache.dtype)
    ins = {"K": [k], "V": [v], "KCache": [k_cache], "VCache": [v_cache],
           "PageTable": [page_table]}
    ins.update(extra_ins)
    outs = {"KCacheOut": [kc_out], "VCacheOut": [vc_out]}
    if k_scale is not None:
        ins["KScale"] = [k_scale]
        ins["VScale"] = [v_scale]
        ks_out = helper.create_variable_for_type_inference(k_scale.dtype)
        vs_out = helper.create_variable_for_type_inference(v_scale.dtype)
        outs["KScaleOut"] = [ks_out]
        outs["VScaleOut"] = [vs_out]
    helper.append_op(type=op_type, inputs=ins, outputs=outs)
    if k_scale is not None:
        return kc_out, vc_out, ks_out, vs_out
    return kc_out, vc_out


def paged_kv_write(k, v, k_cache, v_cache, page_table, write_pos,
                   active=None, k_scale=None, v_scale=None, name=None):
    """Commit ONE token's K/V per slot into the paged pools at
    `write_pos` (the decode-step write; ops/paged_kv.py).  Functional:
    returns the updated pools (+ scale sidecars for int8 caches);
    inactive slots (active 0) write nothing."""
    extra = {"WritePos": [write_pos]}
    if active is not None:
        extra["Active"] = [active]
    return _paged_write("paged_kv_write", k, v, k_cache, v_cache,
                        page_table, extra, k_scale, v_scale, name)


def paged_kv_prefill_write(k, v, k_cache, v_cache, page_table, seq_len,
                           k_scale=None, v_scale=None, name=None):
    """Commit a whole prompt's K/V (S, T, H*D) into the paged pools
    (the prefill-on-join write; ops/paged_kv.py).  Positions past
    seq_len[s] — all of them for a non-joining slot with seq_len 0 —
    are dropped."""
    return _paged_write("paged_kv_prefill_write", k, v, k_cache,
                        v_cache, page_table, {"SeqLen": [seq_len]},
                        k_scale, v_scale, name)


def speculative_accept(drafts, predictions, draft_len, active=None,
                       name=None):
    """Greedy longest-accepted-prefix acceptance (ops/paged_kv.py):
    Drafts (S, k) vs the verify run's argmax Predictions (S, k+1),
    ragged per-slot draft lengths riding the DraftLen (S,) companion.
    Returns (accepted (S,) int32 [-1 for inactive slots], tokens
    (S, k+1) int32 [-1 padding]): accepted+1 committed tokens per
    active slot, the sequential engine's stream."""
    helper = LayerHelper("speculative_accept", name=name)
    accepted = helper.create_variable_for_type_inference("int32")
    tokens = helper.create_variable_for_type_inference("int32")
    ins = {"Drafts": [drafts], "Predictions": [predictions],
           "DraftLen": [draft_len]}
    if active is not None:
        ins["Active"] = [active]
    helper.append_op(type="speculative_accept", inputs=ins,
                     outputs={"Accepted": [accepted],
                              "Tokens": [tokens]})
    return accepted, tokens


def add_position_encoding_at(x, position, alpha=1.0, beta=1.0,
                             name=None):
    """X (S, D) + sinusoidal encoding at one position per row — the
    decode-step twin of add_position_encoding (same formula), so a
    decoded token sees exactly the encoding its position would have had
    inside a prefill."""
    helper = LayerHelper("add_position_encoding_at", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="add_position_encoding_at",
                     inputs={"X": [x], "Position": [position]},
                     outputs={"Out": [out]},
                     attrs={"alpha": float(alpha), "beta": float(beta)})
    return out


# ---------------------------------------------------------------------------
# Conv / pool / norm
# ---------------------------------------------------------------------------

def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """reference layers/nn.py conv2d — NCHW, or NHWC with
    data_format="NHWC" (filters stay OIHW); filters drawn from
    Normal(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", name=name, act=act, bias_attr=bias_attr)
    dtype = input.dtype
    groups = groups or 1
    c_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[c_axis]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan_in = (num_channels // groups) * int(np.prod(filter_size))
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype,
                                default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format})
    pre_act = helper.append_bias_op(pre_bias, dim_start=c_axis)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None,
           data_format="NCHW"):
    """reference layers/nn.py pool2d; `ceil_mode` is accepted and, as in
    the reference, not passed to the op."""
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "exclusive": exclusive,
               "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """reference layers/nn.py batch_norm — Scale/Bias parameters and the
    persistable moving Mean/Variance ({name}.mean / {name}.var, Constant
    0 and 1), which the op's MeanOut/VarianceOut write back."""
    helper = LayerHelper("batch_norm", name=name, act=act)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    shape = [c]
    scale_var = helper.create_parameter(
        param_attr, shape=shape, dtype=dtype,
        default_initializer=Constant(1.0))
    bias_var = helper.create_parameter(
        ParamAttr._to_attr(bias_attr) or ParamAttr(), shape=shape,
        dtype=dtype, is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or f"{helper.name}.mean", shape, dtype,
        initializer=Constant(0.0))
    variance = helper.create_or_get_global_variable(
        moving_variance_name or f"{helper.name}.var", shape, dtype,
        initializer=Constant(1.0))
    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale_var], "Bias": [bias_var],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y)
