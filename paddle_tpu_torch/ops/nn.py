"""Neural-net ops: the subset of paddle_tpu/ops/nn.py the ported slices
run (reference: paddle/fluid/operators/activation_op.cc, conv_op.cc,
pool_op.cc, batch_norm_op.cc, layer_norm_op.cc, softmax_op.cc,
dropout_op.cc, softmax_with_cross_entropy_op.cc, label_smooth_op.cc,
metrics/auc_op.cc).

Convolution and pooling are the reference's XLA compositions
(`lax.conv_general_dilated`, `lax.reduce_window`), not Pallas kernels:
here they are torch's own ops (cuDNN on the card), which NHWC tensors
reach as channels-last views of NCHW, so no layout copy is made.  Batch
normalization is the reference's formula in torch ops."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import (fill_index, first, nan_where, opt_in, out, pair,
                     weak_scalar)


@register_op("relu")
def relu(ctx, ins, attrs):
    return out(Out=torch.relu(first(ins, "X")))


@register_op("tanh")
def tanh(ctx, ins, attrs):
    return out(Out=torch.tanh(first(ins, "X")))


@register_op("sigmoid")
def sigmoid(ctx, ins, attrs):
    return out(Out=torch.sigmoid(first(ins, "X")))


@register_op("gelu")
def gelu(ctx, ins, attrs):
    """The exact erf form, or the tanh form when `approximate` is true
    (jax.nn.gelu's two forms).  On bf16 the reference evaluates
    jax.nn.gelu's formula op by op in bf16, rounding each step: so does
    the port there."""
    x = first(ins, "X")
    approximate = attrs.get("approximate", False)
    if x.dtype in (torch.bfloat16, torch.float16):
        if approximate:
            c = weak_scalar(math.sqrt(2 / math.pi), x)
            cdf = 0.5 * (1.0 + torch.tanh(
                c * (x + weak_scalar(0.044715, x) * x ** 3)))
            return out(Out=x * cdf)
        return out(Out=0.5 * x * torch.erfc(
            -x * weak_scalar(math.sqrt(0.5), x)))
    return out(Out=F.gelu(x, approximate="tanh" if approximate
                          else "none"))


@register_op("square")
def square(ctx, ins, attrs):
    return out(Out=torch.square(first(ins, "X")))


@register_op("sqrt")
def sqrt(ctx, ins, attrs):
    return out(Out=torch.sqrt(first(ins, "X")))


@register_op("log")
def log(ctx, ins, attrs):
    return out(Out=torch.log(first(ins, "X")))


@register_op("sign")
def sign(ctx, ins, attrs):
    return out(Out=torch.sign(first(ins, "X")))


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return out(Out=torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1)))


@register_op("dropout")
def dropout(ctx, ins, attrs):
    """Both implementations of the reference: "upscale_in_train" scales
    the kept values by 1/(1-p) while training and passes x through at
    test time; "downgrade_in_infer" keeps them unscaled while training
    and scales by (1-p) at test time.  The keep mask is drawn from the
    op's own generator (OpContext.rng), so it differs from jax's bits;
    Mask is the keep mask in x's dtype."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    is_test = attrs.get("is_test", False)
    if is_test or p == 0.0:
        y = x * weak_scalar(1.0 - p, x) \
            if is_test and impl == "downgrade_in_infer" else x
        return {"Out": [y], "Mask": [torch.ones_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.rng(), device=x.device) \
        >= p
    if impl == "upscale_in_train":
        y = torch.where(keep, x / weak_scalar(1.0 - p, x),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        y = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    return {"Out": [y.to(x.dtype)], "Mask": [keep.to(x.dtype)]}


@register_op("cross_entropy")
def cross_entropy(ctx, ins, attrs):
    """reference: operators/cross_entropy_op.cc.  X is probabilities
    (floored at 1e-12 before the log); ignore_index zeroes the loss for
    matching hard labels.  Any other label outside [0, C) after one wrap
    of negatives gives NaN, as the reference's gather does."""
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-12
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x.clamp(min=eps))).sum(dim=-1,
                                                          keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        valid = lbl != attrs.get("ignore_index", -100)
        idx, bad = fill_index(torch.where(valid, lbl, torch.zeros_like(lbl)),
                              x.shape[-1])
        picked = nan_where(bad, torch.gather(x, -1, idx.unsqueeze(-1)))
        loss = -torch.log(picked.clamp(min=eps))
        loss = torch.where(valid.unsqueeze(-1), loss,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return out(Y=loss)


@register_op("accuracy")
def accuracy(ctx, ins, attrs):
    """reference: operators/metrics/accuracy_op.cc.  A row is correct
    when its label is among its top-k Indices."""
    indices, label = first(ins, "Indices"), first(ins, "Label")
    correct = (indices == label.reshape(-1, 1)).any(dim=1)
    total = indices.shape[0]
    num_correct = correct.sum().to(torch.int32)
    acc = num_correct.to(torch.float32) / float(total)
    return {"Accuracy": [acc.reshape(1)],
            "Correct": [num_correct.reshape(1)],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=indices.device)]}


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(ctx, ins, attrs):
    """Soft labels: -sum(label * log_softmax).  Hard labels (int ids,
    trailing 1-dim optional): -log_softmax at the id, 0 where the id is
    ignore_index; label_smooth_eps folds smoothing into the hard-label
    form, (1-eps)*CE + eps*(lse - mean logits).  A hard label outside
    [0, C) after one wrap of negatives, and not ignore_index, gives NaN,
    as the reference's gather does."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    log_sm = logits - lse
    eps = float(attrs.get("label_smooth_eps", 0.0) or 0.0)
    if attrs.get("soft_label", False):
        if eps:
            raise ValueError(
                "label_smooth_eps only folds into hard-label CE; with "
                "soft_label=True smooth the label distribution yourself "
                "(layers.label_smooth)")
        loss = -(label * log_sm).sum(dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        valid = (lbl != attrs.get("ignore_index", -100)).unsqueeze(-1)
        idx, bad = fill_index(
            torch.where(valid.squeeze(-1), lbl, torch.zeros_like(lbl)),
            logits.shape[-1])
        picked = nan_where(bad, torch.gather(log_sm, -1, idx.unsqueeze(-1)))
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        loss = -torch.where(valid, picked, zero)
        if eps:
            smooth = torch.where(valid, lse - logits.mean(dim=-1,
                                                          keepdim=True),
                                 zero)
            loss = (1.0 - eps) * loss + eps * smooth
    return {"Loss": [loss], "Softmax": [torch.exp(log_sm)]}


@register_op("label_smooth")
def label_smooth(ctx, ins, attrs):
    x = first(ins, "X")
    eps = attrs.get("epsilon", 0.0)
    prior = opt_in(ins, "PriorDist")
    if prior is not None:
        return out(Out=(1 - eps) * x + eps * prior)
    return out(Out=(1 - eps) * x + eps / x.shape[-1])


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    x = first(ins, "X")
    scale = opt_in(ins, "Scale")
    bias = opt_in(ins, "Bias")
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    xf = x.to(torch.float32)
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape).to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(norm_shape).to(torch.float32)
    return {
        "Y": [y.to(x.dtype)],
        "Mean": [mean.squeeze(axes)],
        "Variance": [var.squeeze(axes)],
    }


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """max(x, 0) - x * label + log(1 + exp(-|x|)), 0 where the label is
    `ignore_index` (when that is >= 0)."""
    x, label = first(ins, "X"), first(ins, "Label")
    loss = torch.clamp(x, min=0.0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    ignore = attrs.get("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label == ignore, torch.zeros((), dtype=x.dtype,
                                                        device=x.device),
                           loss)
    return out(Out=loss)


# --------------------------------------------------------------------------
# Convolution / pooling
# --------------------------------------------------------------------------

def _nchw(x, nhwc):
    """x as NCHW: an NHWC tensor becomes its channels-last view."""
    return x.permute(0, 3, 1, 2) if nhwc else x


def _back(o, nhwc):
    return o.permute(0, 2, 3, 1) if nhwc else o


def _conv_pads(padding, sizes, kernel, strides, dilations):
    """((lo, hi), ...) per spatial dim: a number (or list) pads both sides
    alike; "VALID" not at all; "SAME" (and "SAME_LOWER") as XLA computes
    it for the reference's lax.conv_general_dilated: out = ceil(n / s),
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0), the odd one at
    the high (low) side."""
    if not isinstance(padding, str):
        return [(int(p), int(p)) for p in pair(padding, len(sizes))]
    mode = padding.upper()
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode not in ("SAME", "SAME_LOWER"):
        raise ValueError(f"conv2d padding {padding!r}: use a number, a "
                         f"list, 'SAME' or 'VALID'")
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        small, big = total // 2, total - total // 2
        pads.append((small, big) if mode == "SAME" else (big, small))
    return pads


@register_op("conv2d")
def conv2d(ctx, ins, attrs):
    """reference: operators/conv_op.cc.  Input NCHW (or NHWC with
    data_format="NHWC"), Filter OIHW in both, groups (depthwise: groups
    == C_in), dilations; the output keeps x's dtype.  Asymmetric SAME
    padding is padded explicitly, since torch pads both sides alike."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = pair(attrs.get("strides", 1))
    dilations = pair(attrs.get("dilations", 1))
    groups = attrs.get("groups", 1) or 1
    fmt = attrs.get("data_format", "NCHW")
    if fmt not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d data_format must be NCHW or NHWC, "
                         f"got {fmt!r}")
    xc = _nchw(x, fmt == "NHWC")
    pads = _conv_pads(attrs.get("paddings", 0), tuple(xc.shape[2:]),
                      tuple(w.shape[2:]), strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        (t, b), (le, r) = pads
        xc = F.pad(xc, (le, r, t, b))
        padding = 0
    o = F.conv2d(xc, w, stride=strides, padding=padding,
                 dilation=dilations, groups=groups)
    return {"Output": [_back(o, fmt == "NHWC").to(x.dtype)]}


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx, ins, attrs):
    """conv2d with groups = x.shape[1], as the reference sets it."""
    return conv2d(ctx, ins, dict(attrs, groups=first(ins, "Input").shape[1]))


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    """reference: operators/pool_op.cc.  max pooling pads with -inf; avg
    pooling divides by the window's count of unpadded values when
    `exclusive` (the default) and by kh * kw otherwise; global pooling
    ignores ksize; NHWC pools over axes (1, 2).  torch pads inside the
    pooling op only up to half the window, so a wider padding is padded
    explicitly."""
    x = first(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if attrs.get("global_pooling", False):
        sp = (1, 2) if nhwc else (2, 3)
        o = (x.amax(dim=sp, keepdim=True) if ptype == "max"
             else x.mean(dim=sp, keepdim=True))
        return out(Out=o)
    ksize = pair(attrs["ksize"])
    strides = pair(attrs.get("strides", 1))
    pads = pair(attrs.get("paddings", 0))
    xc = _nchw(x, nhwc)
    inside = all(2 * p <= k for p, k in zip(pads, ksize))
    if ptype == "max":
        if inside:
            o = F.max_pool2d(xc, ksize, strides, padding=pads)
        else:
            o = F.max_pool2d(F.pad(xc, (pads[1], pads[1], pads[0], pads[0]),
                                   value=-math.inf), ksize, strides)
    elif inside:
        o = F.avg_pool2d(xc, ksize, strides, padding=pads,
                         count_include_pad=not attrs.get("exclusive", True))
    else:
        wide = (pads[1], pads[1], pads[0], pads[0])
        o = F.avg_pool2d(F.pad(xc, wide), ksize, strides, divisor_override=1)
        if attrs.get("exclusive", True):
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                              device=x.device)
            o = o / F.avg_pool2d(F.pad(ones, wide), ksize, strides,
                                 divisor_override=1)
        else:
            o = o / float(ksize[0] * ksize[1])
    return out(Out=_back(o, nhwc).to(x.dtype))


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

@register_op("batch_norm")
def batch_norm(ctx, ins, attrs):
    """reference: operators/batch_norm_op.cc, with the reference's
    formulae, in float32:

    - training: the batch mean and the biased variance E[x^2] - mean^2
      over every axis but the channel's normalize x; MeanOut =
      momentum * Mean + (1 - momentum) * batch mean (the opposite of
      torch's momentum), VarianceOut alike with the biased variance
      (torch's running variance is unbiased), both without a gradient;
      SavedMean / SavedVariance are the batch mean and variance;
    - is_test or use_global_stats: normalize with Mean and Variance,
      which pass through.

    Y = (x - mean) * (rsqrt(var + eps) * Scale) + Bias, cast back to x's
    dtype, differentiated by autograd.  torch's batch norm (cuDNN) is not
    used: its variance is the two-pass one, which over a few values a
    channel (a cut batch at 1 x 1 spatial) gives other values than the
    reference's E[x^2] - mean^2."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean_in, var_in = first(ins, "Mean"), first(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(a for a in range(x.dim()) if a != c_axis)
    cshape = [1] * x.dim()
    cshape[c_axis] = x.shape[c_axis]
    xf = x.to(torch.float32)
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        mean_b, var_b = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        mean_b = xf.mean(dim=axes)
        var_b = torch.square(xf).mean(dim=axes) - torch.square(mean_b)
        mean_out = (momentum * mean_in + (1 - momentum) * mean_b).detach()
        var_out = (momentum * var_in + (1 - momentum) * var_b).detach()
    inv = torch.rsqrt(var_b.to(torch.float32) + eps)
    y = (xf - mean_b.reshape(cshape)) \
        * (inv * scale.to(torch.float32)).reshape(cshape) \
        + bias.to(torch.float32).reshape(cshape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [mean_b],
            "SavedVariance": [var_b]}


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------

@register_op("auc")
def auc(ctx, ins, attrs):
    """Streaming ROC AUC (reference: operators/metrics/auc_op.cc): the
    persistable StatPos / StatNeg histograms gain this batch's positives
    and negatives at bucket floor(p * num_thresholds), clipped to
    [0, num_thresholds], of the positive-class score p = Predict[:, 1];
    the area is the trapezoid over the cumulative counts taken from the
    highest bucket down.  The histogram adds whole counts, exact in any
    order below 2^24 a bucket."""
    predict, label = first(ins, "Predict"), first(ins, "Label")
    stat_pos, stat_neg = first(ins, "StatPos"), first(ins, "StatNeg")
    num_thresholds = attrs.get("num_thresholds", 4095)
    bucket = torch.floor(predict[:, 1] * num_thresholds).to(torch.int64)
    bucket = bucket.clamp(0, num_thresholds)
    lbl = label.reshape(-1).to(torch.float32)
    new_pos = stat_pos.index_add(0, bucket, lbl)
    new_neg = stat_neg.index_add(0, bucket, 1.0 - lbl)
    tp = torch.cumsum(new_pos.flip(0), 0)
    fp = torch.cumsum(new_neg.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1.0)
    fpr = fp / torch.clamp(fp[-1], min=1.0)
    return {"AUC": [torch.trapezoid(tpr, fpr).reshape(1)],
            "StatPosOut": [new_pos], "StatNegOut": [new_neg]}


@register_op("l2_normalize")
def l2_normalize(ctx, ins, attrs):
    """x / max(|x|_2 along `axis`, epsilon); Norm keeps the norm."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return {"Out": [x / torch.clamp(norm, min=eps)], "Norm": [norm]}


@register_op("square_error_cost")
def square_error_cost(ctx, ins, attrs):
    return out(Out=torch.square(first(ins, "X") - first(ins, "Y")))
