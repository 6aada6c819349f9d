"""Composite neural-net layers: the subset of paddle_tpu/layers/nn.py
that the ported slices build (reference: python/paddle/fluid/layers/
nn.py).  Each function is the reference's, unchanged: it creates output
vars + parameters via LayerHelper and appends OpDescs to the default main
program; shapes/dtypes are inferred by running the op on "meta" tensors
(core/shape_inference.py).
"""

from __future__ import annotations

import numpy as np

from ..core.desc import normalize_dtype
from ..core.program import Variable
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


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_floordiv", x, y, axis, act, name)


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


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name)


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


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
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


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


# ---------------------------------------------------------------------------
# Structured-prediction / sampling losses (ops/structured.py)
# ---------------------------------------------------------------------------

def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """is_sparse is accepted for parity: the NCE weight's gradient stays
    dense (only the sampled rows receive a nonzero gradient)."""
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_total_classes, dim],
                                dtype=input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(),
            shape=[num_total_classes], dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    if custom_dist is not None:
        import numpy as _np

        from .tensor import assign as _assign

        dist = _assign(_np.asarray(custom_dist, dtype="float32"))
        inputs["CustomDistProbs"] = [dist]
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples or 10),
               "sampler": sampler_id, "seed": seed})
    return cost


def linear_chain_crf(input, label, param_attr=None):
    """input: padded emissions (B, T, N) with a `.seq_len` companion."""
    from .sequence import seq_len_var

    helper = LayerHelper("linear_chain_crf")
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, shape=[num_tags + 2, num_tags], dtype=input.dtype)
    sl = seq_len_var(input)
    if sl is None:
        raise ValueError("linear_chain_crf input needs a .seq_len "
                         "companion (declare data with lod_level=1)")
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition],
                "Label": [label], "SeqLen": [sl]},
        outputs={"LogLikelihood": [ll], "Alpha": [alpha]})
    return ll


def crf_decoding(input, param_attr, label=None):
    from .sequence import _propagate_seq_len, seq_len_var

    helper = LayerHelper("crf_decoding")
    if isinstance(param_attr, Variable):
        transition = param_attr
    else:
        attr = ParamAttr._to_attr(param_attr)
        block = helper.main_program.global_block()
        if attr.name and block.has_var(attr.name):
            transition = block.var(attr.name)
        else:
            # decode-only program: declare the (trained) transition param
            # so the scope value binds by name, as fluid does when the
            # decode net is built separately from the train net
            num_tags = input.shape[-1]
            transition = helper.create_parameter(
                attr, shape=[num_tags + 2, num_tags], dtype=input.dtype)
    sl = seq_len_var(input)
    if sl is None:
        raise ValueError("crf_decoding input needs a .seq_len companion")
    path = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [transition], "SeqLen": [sl]}
    if label is not None:
        ins["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [path]})
    _propagate_seq_len(input, path)
    return path


def switch_moe(input, num_experts, d_inner, top_k=1,
               capacity_factor=1.25, act="relu", param_attr=None,
               bias_attr=None, name=None):
    """Mixture-of-Experts FFN block (ops/moe.py): per-expert weights
    (E, D, H)/(E, H, D) under the `moe_gate`/`moe_expert` name prefixes
    the reference's expert sharding rules key on.  Returns (out,
    aux_loss, fraction): add `aux_weight * aux_loss` to the objective
    for load balancing; fetch `fraction` (E,) for per-expert routing
    observability.  One device: the reference's ep mesh is ROADMAP A
    step 10."""
    for attr in (param_attr, bias_attr):
        if isinstance(attr, ParamAttr) and attr.name:
            raise ValueError(
                "switch_moe: a NAMED ParamAttr cannot apply to its "
                "multiple parameters (name collision) and would break "
                "the moe_expert/moe_gate prefix the ep sharding rules "
                "key on; use name= to disambiguate layers instead")
    d = int(input.shape[-1])
    # user names APPEND to the moe_gate/moe_expert prefixes — the
    # prefixes are what the ep sharding rules key on, so a named layer
    # must still match them
    gate_h = LayerHelper("moe_gate",
                         name=name and f"moe_gate_{name}")
    dtype = input.dtype
    gate_w = gate_h.create_parameter(param_attr, shape=[d, num_experts],
                                     dtype=dtype)
    eh = LayerHelper("moe_expert",
                     name=name and f"moe_expert_{name}")
    # explicit per-expert fans: the default rank-3 fan computation
    # treats (E, D, H) as a conv kernel and under-initializes ~sqrt(E)x
    w1 = eh.create_parameter(param_attr, shape=[num_experts, d, d_inner],
                             dtype=dtype,
                             default_initializer=Xavier(
                                 fan_in=d, fan_out=d_inner))
    b1 = eh.create_parameter(bias_attr, shape=[num_experts, d_inner],
                             dtype=dtype, is_bias=True)
    w2 = eh.create_parameter(param_attr, shape=[num_experts, d_inner, d],
                             dtype=dtype,
                             default_initializer=Xavier(
                                 fan_in=d_inner, fan_out=d))
    b2 = eh.create_parameter(bias_attr, shape=[num_experts, d],
                             dtype=dtype, is_bias=True)
    out_v = eh.create_variable_for_type_inference(dtype)
    aux = eh.create_variable_for_type_inference("float32")
    frac = eh.create_variable_for_type_inference("float32")
    eh.append_op(
        type="moe_ffn",
        inputs={"X": [input], "GateW": [gate_w], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out_v], "AuxLoss": [aux], "Fraction": [frac]},
        attrs={"top_k": top_k, "capacity_factor": capacity_factor,
               "act": act})
    out_v.desc.shape = tuple(input.shape)
    aux.desc.shape = (1,)
    frac.desc.shape = (num_experts,)
    return out_v, aux, frac


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    helper = LayerHelper("mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mod", x, y, axis, act, name)


def greater_equal(x, y):
    return elementwise_op("greater_equal", x, y, out_dtype="bool")


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name, act=act,
                         bias_attr=bias_attr)
    dtype = input.dtype
    if filter_size is None:
        raise ValueError("filter_size required (output_size-only inference "
                         "not yet supported)")
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    num_channels = input.shape[1]
    filter_shape = [num_channels, num_filters // (groups or 1)] + \
        list(filter_size)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups or 1})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """reference layers/nn.py conv3d_transpose — NCDHW, filter
    (C_in, C_out/groups, kD, kH, kW)."""
    helper = LayerHelper("conv3d_transpose", name=name, act=act,
                         bias_attr=bias_attr)
    dtype = input.dtype
    if filter_size is None:
        raise ValueError("filter_size required (output_size-only inference "
                         "not yet supported)")
    if isinstance(filter_size, int):
        filter_size = [filter_size] * 3
    num_channels = input.shape[1]
    filter_shape = [num_channels, num_filters // (groups or 1)] + \
        list(filter_size)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _triple(stride), "paddings": _triple(padding),
               "dilations": _triple(dilation), "groups": groups or 1})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1)
    return helper.append_activation(pre_act)


def cos_sim(X, Y):
    """reference layers/nn.py:1187 — row-wise cosine similarity,
    Y's batch dim broadcastable."""
    helper = LayerHelper("cos_sim")
    o = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [o], "XNorm": [xn], "YNorm": [yn]})
    return o


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """reference layers/nn.py pad_constant_like — pad y up to x's shape
    at the high edges."""
    helper = LayerHelper("pad_constant_like", name=name)
    o = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type="pad_constant_like",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [o]},
                     attrs={"pad_value": float(pad_value)})
    return o


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Distillation CTR loss (public Paddle op; absent from the 1.2
    reference tree — see ops/nn.py for the label encoding)."""
    helper = LayerHelper("teacher_student_sigmoid_loss")
    o = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="teacher_student_sigmoid_loss",
        inputs={"X": [input], "Label": [label]}, outputs={"Y": [o]},
        attrs={"soft_max_up_bound": float(soft_max_up_bound),
               "soft_max_lower_bound": float(soft_max_lower_bound)})
    return o


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", name=name, act=act, bias_attr=bias_attr)
    dtype = input.dtype
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size] * 3
    filter_shape = [num_filters, input.shape[1] // groups] + list(filter_size)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _triple(stride), "paddings": _triple(padding),
               "dilations": _triple(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1)
    return helper.append_activation(pre_act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", name=name, act=act)
    dtype = input.dtype
    c = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        s = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr._to_attr(bias_attr) or
                                    ParamAttr(), shape=[c], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    y = helper.create_variable_for_type_inference(dtype)
    m = helper.create_variable_for_type_inference(dtype)
    v = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [m], "Variance": [v]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(y)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        ins["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        ins["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=ins,
                     outputs={"Out": [loss], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    loss = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [loss], "Residual": [residual]},
                     attrs={"delta": delta})
    return loss


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [loss]}, attrs={"epsilon": epsilon})
    return loss


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="kldiv_loss",
                     inputs={"X": [x], "Target": [target]},
                     outputs={"Loss": [loss]},
                     attrs={"reduction": reduction})
    return loss


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="flatten", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    helper = LayerHelper("interpolate", name=name)
    if out_shape is None:
        h = int(input.shape[2] * scale)
        w = int(input.shape[3] * scale)
    else:
        h, w = out_shape
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="interpolate", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": int(h), "out_w": int(w),
                            "interp_method": resample.lower(),
                            "align_corners": bool(align_corners),
                            "align_mode": int(align_mode)})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "NEAREST")


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, shape=alpha_shape,
                                    dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="space_to_depth", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"blocksize": blocksize})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler", inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, input_dim_idx=0,
                                   output_dim_idx=0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random_batch_size_like",
        inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": normalize_dtype(dtype),
               "min": min, "max": max, "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": normalize_dtype(dtype),
                            "mean": mean, "std": std})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": normalize_dtype(dtype),
                            "min": min, "max": max})
    return out


def _triple(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v, v]


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both", name=None):
    """In-graph tensor dump (reference layers/control_flow.py Print):
    the op prints on the host in the reference's format and passes its
    input through (ops/misc.py)."""
    helper = LayerHelper("print", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or "",
                            "summarize": int(summarize)})
    out.desc.shape = tuple(input.shape)
    return out


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Call a python function from inside the program (reference
    layers/nn.py py_func → py_func_op.cc; here a host call on numpy
    copies of the inputs).  `out` is a Variable or list of Variables
    with declared shapes/dtypes.  backward_func is not supported, as in
    the reference: use it on stop-gradient paths (metrics, logging,
    data munging)."""
    from ..ops.misc import register_py_func

    if backward_func is not None:
        raise NotImplementedError(
            "py_func backward_func: the host callback is opaque to "
            "autograd; compute gradients in-graph instead")
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    handle = register_py_func(func)
    helper.append_op(
        type="py_func", inputs={"X": list(xs)},
        outputs={"Out": list(outs)},
        attrs={"handle": handle,
               "out_shapes": [list(o.shape) for o in outs],
               "out_dtypes": [str(o.dtype) for o in outs]})
    return out


def random_crop(x, shape, seed=None):
    """Per-instance random crop (reference layers/nn.py random_crop:6814).
    Randomness comes from the program RNG state rather than a threaded
    Seed tensor; `seed` is accepted for API parity and ignored."""
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="random_crop", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return out


def conv_shift(x, y, name=None):
    """Circular convolution (reference conv_shift_op.cc, Neural Turing
    Machine shift weighting): X (B, M), Y (B, N) with N odd -> (B, M)."""
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="conv_shift", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# The structured, CTC and metric layers (ops/structured.py)
# ---------------------------------------------------------------------------

def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    helper = LayerHelper("hierarchical_sigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_classes - 1, dim],
                                dtype=input.dtype)
    inputs = {"X": [input], "Label": [label], "W": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(
            ParamAttr._to_attr(bias_attr) or ParamAttr(),
            shape=[num_classes - 1], dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    cost = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [cost], "PreOut": [pre_out]},
                     attrs={"num_classes": int(num_classes)})
    return cost


def _seq_len_pair(a, b, api, what):
    from .sequence import seq_len_var

    la, lb = seq_len_var(a), seq_len_var(b)
    if la is None or lb is None:
        raise ValueError(f"{api} needs .seq_len companions on {what}")
    return la, lb


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    """input/label: padded id sequences (B, T) with .seq_len companions."""
    hl, rl = _seq_len_pair(input, label, "edit_distance",
                           "both input and label")
    helper = LayerHelper("edit_distance", name=name)
    dist = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="edit_distance",
        inputs={"Hyps": [input], "Refs": [label], "HypsLen": [hl],
                "RefsLen": [rl]},
        outputs={"Out": [dist], "SequenceNum": [seq_num]},
        attrs={"normalized": bool(normalized),
               "ignored_tokens": list(ignored_tokens or [])})
    return dist, seq_num


def warpctc(input, label, blank=0, norm_by_times=False):
    """input: padded logits (B, T, C) with .seq_len; label: padded ids
    (B, U) with .seq_len."""
    ll, ul = _seq_len_pair(input, label, "warpctc", "logits and label")
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input], "Label": [label], "LogitsLen": [ll],
                "LabelLen": [ul]},
        outputs={"Loss": [loss]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """argmax over the classes, then ctc_align (reference layers/nn.py
    ctc_greedy_decoder:3704).  input: (B, T, C) probabilities with
    .seq_len."""
    from . import tensor as tensor_layers
    from .sequence import seq_len_var

    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = tensor_layers.argmax(input, axis=-1)
    sl = seq_len_var(input)
    decoded = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    ins = {"Input": [ids]}
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op(type="ctc_align", inputs=ins,
                     outputs={"Output": [decoded], "OutLen": [out_len]},
                     attrs={"blank": int(blank), "merge_repeated": True})
    return decoded, out_len


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"seed": seed})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_len=None):
    """Chunk-level P/R/F1 of sequence tagging (reference layers/nn.py
    chunk_eval; the IOB scheme, as the reference package implements
    it).  input/label: (B, T) padded tag ids with a .seq_len companion
    on `input` (or pass seq_len=)."""
    from .sequence import seq_len_var

    if chunk_scheme != "IOB":
        raise NotImplementedError(
            f"chunk_scheme {chunk_scheme!r}: only IOB is implemented "
            f"(reference chunk_eval_op.h also supports IOE/IOBES)")
    helper = LayerHelper("chunk_eval")
    sl = seq_len if seq_len is not None else seq_len_var(input)
    if sl is None:
        raise ValueError("chunk_eval needs a .seq_len companion or "
                         "seq_len= argument")
    slots = ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"]
    outs = {s: [helper.create_variable_for_type_inference(
        "float32" if i < 3 else "int64")] for i, s in enumerate(slots)}
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label], "SeqLen": [sl]},
        outputs=outs,
        attrs={"num_chunk_types": int(num_chunk_types),
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return tuple(outs[s][0] for s in slots)


def mean_iou(input, label, num_classes):
    """Mean IoU over the classes (reference layers/nn.py mean_iou:6957):
    (mean IoU, out_wrong (C,), out_correct (C,))."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="mean_iou",
        inputs={"Predictions": [input], "Labels": [label]},
        outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                 "OutCorrect": [correct]},
        attrs={"num_classes": int(num_classes)})
    return miou, wrong, correct


def modified_huber_loss(x, y, name=None):
    """Modified Huber loss of binary classification (reference
    modified_huber_loss_op.cc): x the scores (N, 1), y labels {0, 1}."""
    helper = LayerHelper("modified_huber_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inter = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="modified_huber_loss",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "IntermediateVal": [inter]})
    return out


def positive_negative_pair(score, label, query_id, weight=None, column=-1,
                           accumulators=None, name=None):
    """Learning-to-rank pair counts (reference
    positive_negative_pair_op.cc): (pos, neg, neutral); `accumulators`
    an optional (pos, neg, neu) of earlier totals."""
    helper = LayerHelper("positive_negative_pair", name=name)
    outs = [helper.create_variable_for_type_inference("float32")
            for _ in range(3)]
    ins = {"Score": [score], "Label": [label], "QueryID": [query_id]}
    if weight is not None:
        ins["Weight"] = [weight]
    if accumulators is not None:
        for kind, acc in zip(("Positive", "Negative", "Neutral"),
                             accumulators):
            ins[f"Accumulate{kind}Pair"] = [acc]
    helper.append_op(type="positive_negative_pair", inputs=ins,
                     outputs={"PositivePair": [outs[0]],
                              "NegativePair": [outs[1]],
                              "NeutralPair": [outs[2]]},
                     attrs={"column": int(column)})
    return tuple(outs)


# ---------------------------------------------------------------------------
# The rest of the vision layers (ops/vision_extra.py)
# reference: layers/nn.py pool3d, spp (via nets), roi_pool:6690,
# roi_align:6740, affine_channel:9406, affine_grid:7576, crop:5765,
# unpool, similarity_focus:8951, psroi_pool:9628.
# ---------------------------------------------------------------------------

def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "exclusive": exclusive})
    return out


def spp(input, pyramid_height=3, pool_type="max", name=None):
    helper = LayerHelper("spp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="spp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pyramid_height": int(pyramid_height),
                            "pooling_type": pool_type})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, name=None):
    """rois: (R, 5) [batch_idx, x1, y1, x2, y2]."""
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_pool", inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "spatial_scale": float(spatial_scale)})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_align", inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "spatial_scale": float(spatial_scale),
               "sampling_ratio": int(sampling_ratio)})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None):
    helper = LayerHelper("affine_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]})
    return out


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    ins = {"Theta": [theta]}
    attrs = {}
    if isinstance(out_shape, (list, tuple)):
        attrs["output_shape"] = [int(s) for s in out_shape]
    else:
        ins["OutputShape"] = [out_shape]
    helper.append_op(type="affine_grid", inputs=ins,
                     outputs={"Output": [out]}, attrs=attrs)
    return out


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x]}
    attrs = {"offsets": list(offsets or [])}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = [int(s) for s in shape]
    elif shape is not None:
        ins["Y"] = [shape]
    helper.append_op(type="crop", inputs=ins, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def unpool(input, indices, unpool_size, name=None):
    """Max unpooling from pool2d_with_index's Mask."""
    helper = LayerHelper("unpool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="unpool", inputs={"X": [input], "Indices": [indices]},
        outputs={"Out": [out]},
        attrs={"unpool_size": [int(s) for s in unpool_size]})
    return out


def similarity_focus(input, axis, indexes, name=None):
    """Similarity-focus mask (reference layers/nn.py
    similarity_focus:8951)."""
    helper = LayerHelper("similarity_focus", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="similarity_focus", inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axis": int(axis), "indexes": [int(i) for i in indexes]})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    """Position-sensitive ROI pooling for R-FCN (reference layers/nn.py
    psroi_pool:9628); rois (R, 5) [batch_idx, x1, y1, x2, y2]."""
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="psroi_pool", inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"output_channels": int(output_channels),
               "spatial_scale": float(spatial_scale),
               "pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width)})
    return out
