"""Neural-net ops: the port of paddle_tpu/ops/nn.py (reference:
paddle/fluid/operators/activation_op.cc, conv_op.cc, conv_transpose_op.cc,
pool_op.cc, pool_with_index_op.cc, batch_norm_op.cc, layer_norm_op.cc,
group_norm_op.cc, lrn_op.cc, softmax_op.cc, dropout_op.cc, the loss ops,
interpolate_op.cc, grid_sampler_op.cc, metrics/auc_op.cc).

Convolution and pooling are the reference's XLA compositions
(`lax.conv_general_dilated`, `lax.reduce_window`), not Pallas kernels:
here they are torch's own ops (cuDNN on the card), which NHWC tensors
reach as channels-last views of NCHW, so no layout copy is made.  Batch
normalization is the reference's formula in torch ops.  Where torch's
library op computes something else (local_response_norm's alpha / n,
interpolate's align modes, grid_sample's padding modes, max_pool2d's
indices), the reference's formula is written out in torch ops."""

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
    if ctx.cross_rank is not None and x.dim() >= 1:
        # a data-parallel step's batch slice: the global batch's mask,
        # this rank's rows of it
        g, rows = ctx.cross_rank, x.shape[0]
        keep = torch.rand((rows * g.n,) + tuple(x.shape[1:]),
                          generator=ctx.rng(), device=x.device)[
            g.index * rows:(g.index + 1) * rows] >= p
    else:
        keep = torch.rand(x.shape, generator=ctx.rng(),
                          device=x.device) >= p
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
    if ctx.cross_rank is not None:
        # a data-parallel step: the global batch's counts
        num_correct = ctx.cross_rank.all_reduce(num_correct)
        total *= ctx.cross_rank.n
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


def _row_stats(xf, begin, blk):
    """Mean and (biased) variance of xf over its dims from `begin`, kept
    for broadcasting.  With the run's `row_block` (OpContext) the rows
    (the dims before `begin`, flattened) are reduced in blocks of `blk`
    rows, the last one (or the only one, with fewer rows) zero-padded:
    torch's row reduction picks its thread layout by the row count below
    16 rows, so a row's statistics would depend on how many rows run
    together (ROADMAP C15)."""
    axes = tuple(range(begin, xf.dim()))
    lead = math.prod(xf.shape[:begin])
    if not blk or lead == blk:
        mean = xf.mean(dim=axes, keepdim=True)
        return mean, torch.square(xf - mean).mean(dim=axes, keepdim=True)
    x2 = xf.reshape(lead, -1)
    pad = -lead % blk
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
    means, variances = [], []
    for b in x2.split(blk):
        m = b.mean(dim=1, keepdim=True)
        means.append(m)
        variances.append(torch.square(b - m).mean(dim=1, keepdim=True))
    shape = tuple(xf.shape[:begin]) + (1,) * len(axes)
    return (torch.cat(means)[:lead].reshape(shape),
            torch.cat(variances)[:lead].reshape(shape))


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    x = first(ins, "X")
    scale = opt_in(ins, "Scale")
    bias = opt_in(ins, "Bias")
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    xf = x.to(torch.float32)
    mean, var = _row_stats(xf, begin, ctx.row_block)
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


def _padded(x, pads):
    """x padded explicitly where `pads` ((lo, hi) per spatial dim) is
    asymmetric, with the symmetric padding torch's op takes."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat), 0


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
    xc, padding = _padded(xc, pads)
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
    reference's E[x^2] - mean^2.

    Under a data-parallel step's `cross_rank` (training, the batch split
    over the ranks): the sums of x and x^2 and the count are summed over
    the ranks, then the same formula gives the global batch's
    statistics on every rank (the reference's GSPMD batch norm); the
    sums' backward all-reduces the cotangent (collectives.CrossRankSum)."""
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
        if ctx.cross_rank is not None:
            g = ctx.cross_rank
            count = float(x.numel() // x.shape[c_axis] * g.n)
            mean_b = g.sum(xf.sum(dim=axes)) / count
            var_b = g.sum(torch.square(xf).sum(dim=axes)) / count \
                - torch.square(mean_b)
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
    if ctx.cross_rank is not None:
        # a data-parallel step: the global batch's histograms (whole
        # counts, exact in any order)
        g = ctx.cross_rank
        new_pos = stat_pos + g.all_reduce(
            torch.zeros_like(stat_pos).index_add(0, bucket, lbl))
        new_neg = stat_neg + g.all_reduce(
            torch.zeros_like(stat_neg).index_add(0, bucket, 1.0 - lbl))
    else:
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


# --------------------------------------------------------------------------
# The rest of the activation family (reference activation_op.cc): each
# the reference's body, op by op, so float32 rounds where it rounds
# --------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _register_act(name, fn):
    @register_op(name)
    def impl(ctx, ins, attrs, _fn=fn):
        return out(Out=_fn(first(ins, "X"), attrs))


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _elu(x, alpha):
    """jax.nn.elu: x where x > 0, else alpha * expm1(x)."""
    pos = x > 0
    return torch.where(pos, x, weak_scalar(alpha, x) * torch.expm1(
        torch.where(pos, _zero(x), x)))


_register_act("logsigmoid", lambda x, a: F.logsigmoid(x))
_register_act("exp", lambda x, a: torch.exp(x))
_register_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_register_act("softshrink", lambda x, a: torch.sign(x) * torch.clamp(
    torch.abs(x) - weak_scalar(a.get("lambda", 0.5), x), min=0.0))
_register_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, _zero(x)))
_register_act("rsqrt", lambda x, a: torch.rsqrt(x))
_register_act("abs", lambda x, a: torch.abs(x))
_register_act("ceil", lambda x, a: torch.ceil(x))
_register_act("floor", lambda x, a: torch.floor(x))
_register_act("cos", lambda x, a: torch.cos(x))
_register_act("sin", lambda x, a: torch.sin(x))
# half to even, as jnp.round
_register_act("round", lambda x, a: torch.round(x))
_register_act("reciprocal", lambda x, a: 1.0 / x)
# jnp.logaddexp(x, 0)
_register_act("softplus", lambda x, a: torch.logaddexp(x, _zero(x)))
_register_act("softsign", lambda x, a: x / (torch.abs(x) + 1))
_register_act("brelu", lambda x, a: torch.clamp(
    x, a.get("t_min", 0.0), a.get("t_max", 24.0)))
_register_act("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, weak_scalar(a.get("alpha", 0.02), x) * x))
_register_act("soft_relu", lambda x, a: torch.log1p(torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_register_act("elu", lambda x, a: _elu(x, a.get("alpha", 1.0)))
_register_act("relu6", lambda x, a: torch.clamp(
    x, 0.0, a.get("threshold", 6.0)))
_register_act("pow", lambda x, a: torch.pow(
    x, weak_scalar(a.get("factor", 1.0), x)))
_register_act("stanh", lambda x, a: weak_scalar(
    a.get("scale_b", 1.7159), x) * torch.tanh(
        weak_scalar(a.get("scale_a", 0.67), x) * x))
_register_act("hard_sigmoid", lambda x, a: torch.clamp(
    weak_scalar(a.get("slope", 0.2), x) * x
    + weak_scalar(a.get("offset", 0.5), x), 0.0, 1.0))
_register_act("swish", lambda x, a: x * torch.sigmoid(
    weak_scalar(a.get("beta", 1.0), x) * x))
_register_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, _zero(x)))


@register_op("selu")
def selu(ctx, ins, attrs):
    """jax.nn.selu: scale * elu(x, alpha) with the SELU constants."""
    x = first(ins, "X")
    return out(Out=weak_scalar(_SELU_SCALE, x) * _elu(x, _SELU_ALPHA))


@register_op("prelu")
def prelu(ctx, ins, attrs):
    """x where x > 0, else alpha * x; alpha one scalar ("all"), one a
    channel ("channel") or one an element ("element")."""
    x, alpha = first(ins, "X"), first(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    return out(Out=torch.where(x > 0, x, alpha * x))


@register_op("log_softmax")
def log_softmax(ctx, ins, attrs):
    return out(Out=torch.log_softmax(first(ins, "X"),
                                     dim=attrs.get("axis", -1)))


# --------------------------------------------------------------------------
# Convolution transposes, conv3d, pooling with indices
# --------------------------------------------------------------------------

@register_op("conv3d")
def conv3d(ctx, ins, attrs):
    """reference: operators/conv_op.cc — NCDHW input, OIDHW filter,
    groups, dilations; padding a number, a list, "SAME" or "VALID"."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = pair(attrs.get("strides", 1), 3)
    dilations = pair(attrs.get("dilations", 1), 3)
    pads = _conv_pads(attrs.get("paddings", 0), tuple(x.shape[2:]),
                      tuple(w.shape[2:]), strides, dilations)
    xp, padding = _padded(x, pads)
    return {"Output": [F.conv3d(xp, w, stride=strides, padding=padding,
                                dilation=dilations,
                                groups=attrs.get("groups", 1) or 1)]}


def _conv_transpose(ins, attrs, nd):
    """reference: operators/conv_transpose_op.cc, one kernel for 2-D and
    3-D: filter (C_in, C_out / groups, k...), output (H - 1) * stride -
    2 * pad + (k - 1) * dilation + 1, torch's conv_transpose layout and
    size with output_padding 0."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    return {"Output": [fn(x, w, stride=pair(attrs.get("strides", 1), nd),
                          padding=pair(attrs.get("paddings", 0), nd),
                          groups=attrs.get("groups", 1) or 1,
                          dilation=pair(attrs.get("dilations", 1), nd))]}


@register_op("conv2d_transpose")
def conv2d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 2)


@register_op("conv3d_transpose")
def conv3d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 3)


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ctx, ins, attrs):
    """conv2d_transpose with the op's own `groups` (the reference
    registers both on one ConvTransposeOp, conv_transpose_op.cc:379)."""
    return _conv_transpose(ins, attrs, 2)


@register_op("pool2d_with_index")
def pool2d_with_index(ctx, ins, attrs):
    """reference: operators/pool_with_index_op.cc — max pooling that
    also returns, as Mask, each window maximum's flat h * w position.
    The padding reads -inf at position -1; among equal values the first
    in the window's (i, j) scan wins (the windows stacked and reduced
    by argmax, as the reference does); global pooling takes the whole
    plane and ignores the paddings."""
    x = first(ins, "X")
    n, c, h, w = x.shape
    if attrs.get("global_pooling", False):
        (kh, kw), (sh, sw), (ph, pw) = (h, w), (h, w), (0, 0)
    else:
        kh, kw = pair(attrs["ksize"])
        sh, sw = pair(attrs.get("strides", 1))
        ph, pw = pair(attrs.get("paddings", 0))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    neg = (-math.inf if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    xp = F.pad(x, (pw, pw, ph, ph), value=neg)
    pos = torch.arange(h * w, dtype=torch.int32, device=x.device)
    posp = F.pad(pos.reshape(1, 1, h, w), (pw, pw, ph, ph), value=-1)
    vals, idxs = [], []
    for i in range(kh):
        for j in range(kw):
            sl = (slice(None), slice(None),
                  slice(i, i + (oh - 1) * sh + 1, sh),
                  slice(j, j + (ow - 1) * sw + 1, sw))
            vals.append(xp[sl])
            idxs.append(posp[sl].expand(n, c, oh, ow))
    v = torch.stack(vals)                    # (kh * kw, N, C, OH, OW)
    am = torch.argmax(v, dim=0, keepdim=True)
    o = torch.gather(v, 0, am)[0]
    mask = torch.gather(torch.stack(idxs), 0, am)[0]
    return {"Out": [o.to(x.dtype)], "Mask": [mask]}


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

@register_op("group_norm")
def group_norm(ctx, ins, attrs):
    """NCHW; mean and (two-pass) variance over each group's channels and
    spatial dims; Mean and Variance with every size-1 dim squeezed, as
    the reference's jnp.squeeze does."""
    x = first(ins, "X")
    scale, bias = opt_in(ins, "Scale"), opt_in(ins, "Bias")
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = torch.square(g - mean).mean(dim=axes, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return {"Y": [y], "Mean": [mean.squeeze()],
            "Variance": [var.squeeze()]}


@register_op("lrn")
def lrn(ctx, ins, attrs):
    """reference: operators/lrn_op.cc, NCHW: MidOut = k + alpha * (sum of
    x^2 over the n channels around each, zero-padded), Out = x /
    MidOut^beta.  alpha is not divided by n (torch's
    local_response_norm divides it); the n terms are added in the
    reference's order."""
    x = first(ins, "X")
    n = attrs.get("n", 5)
    k, alpha = attrs.get("k", 2.0), attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = 0
    for i in range(n):
        acc = acc + pad[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


# --------------------------------------------------------------------------
# The rest of the losses and norms
# --------------------------------------------------------------------------

def _bce(z, t):
    return torch.clamp(z, min=0.0) - z * t + torch.log1p(
        torch.exp(-torch.abs(z)))


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(ctx, ins, attrs):
    """Distillation CTR loss, the reference's label encoding (N, 1):
    label < -1 click 0 and no teacher; -1 <= label < 0 click 1, no
    teacher; 0 <= label < 1 click 0, teacher score label; label >= 1
    click 1, teacher score label - 1.  loss = bce(x, click) [+ bce(
    clip(x, lower, upper), teacher)]."""
    x, label = first(ins, "X"), first(ins, "Label")
    hi = attrs.get("soft_max_up_bound", 15.0)
    lo = attrs.get("soft_max_lower_bound", -15.0)
    one, zero = torch.ones_like(label), torch.zeros_like(label)
    clk = torch.where(label < 0.0, torch.where(label < -1.0, zero, one),
                      torch.where(label >= 1.0, one, zero))
    teacher = torch.where(label >= 1.0, label - 1.0, label)
    loss = _bce(x, clk) + torch.where(label >= 0.0,
                                      _bce(torch.clamp(x, lo, hi), teacher),
                                      _zero(x))
    return out(Y=loss)


@register_op("huber_loss")
def huber_loss(ctx, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    loss = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx, ins, attrs):
    """reference: operators/smooth_l1_loss_op.cc — the difference scaled
    by InsideWeight before the Huber transform, the result by
    OutsideWeight, summed over every dim but the first."""
    x, y = first(ins, "X"), first(ins, "Y")
    iw, ow = opt_in(ins, "InsideWeight"), opt_in(ins, "OutsideWeight")
    s2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    if iw is not None:
        d = d * iw
    a = torch.abs(d)
    elem = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ow is not None:
        elem = elem * ow
    loss = elem.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else elem
    return {"Out": [loss.reshape(-1, 1)], "Diff": [d]}


@register_op("log_loss")
def log_loss(ctx, ins, attrs):
    p, label = first(ins, "Predicted"), first(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return out(Loss=-label * torch.log(p + eps)
               - (1 - label) * torch.log(1 - p + eps))


@register_op("hinge_loss")
def hinge_loss(ctx, ins, attrs):
    logits, label = first(ins, "Logits"), first(ins, "Labels")
    return out(Loss=torch.clamp(1.0 - (2 * label - 1) * logits, min=0.0))


@register_op("rank_loss")
def rank_loss(ctx, ins, attrs):
    label = first(ins, "Label")
    d = first(ins, "Left") - first(ins, "Right")
    return out(Out=torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss")
def margin_rank_loss(ctx, ins, attrs):
    label = first(ins, "Label")
    x1, x2 = first(ins, "X1"), first(ins, "X2")
    o = torch.clamp(-label * (x1 - x2) + attrs.get("margin", 0.0), min=0.0)
    return {"Out": [o], "Activated": [(o > 0).to(x1.dtype)]}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    return out(Out=torch.sum(torch.square(first(ins, "X"))).reshape(1))


@register_op("squared_l2_distance")
def squared_l2_distance(ctx, ins, attrs):
    d = first(ins, "X") - first(ins, "Y")
    return {"Out": [torch.square(d).sum(dim=-1, keepdim=True)],
            "sub_result": [d]}


@register_op("l1_norm")
def l1_norm(ctx, ins, attrs):
    return out(Out=torch.sum(torch.abs(first(ins, "X"))).reshape(1))


@register_op("kldiv_loss")
def kldiv_loss(ctx, ins, attrs):
    """target * (log(max(target, 1e-12)) - x), then "none", "mean",
    "sum" or "batchmean" (the sum over the batch size)."""
    x, target = first(ins, "X"), first(ins, "Target")
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean().reshape(1)
    elif red == "sum":
        loss = loss.sum().reshape(1)
    elif red == "batchmean":
        loss = (loss.sum() / x.shape[0]).reshape(1)
    return out(Loss=loss)


@register_op("bpr_loss")
def bpr_loss(ctx, ins, attrs):
    """Bayesian personalized ranking: -sum_j log(sigmoid(x_label -
    x_j)) / (C - 1), the j = label term included, as the reference
    sums it."""
    x, label = first(ins, "X"), first(ins, "Label")
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    pos = torch.gather(x, -1, lbl.to(torch.int64).unsqueeze(-1))
    loss = -torch.log(torch.sigmoid(-(x - pos))).sum(dim=-1, keepdim=True)
    return out(Y=loss / (x.shape[-1] - 1))


# --------------------------------------------------------------------------
# The rest of vision
# --------------------------------------------------------------------------

def _src_coords(out_n, in_n, align_corners, align_mode, device):
    """The interpolate op's float32 source coordinates, computed as the
    reference computes them: jnp.linspace(0, in_n - 1, out_n) with
    align_corners (stop * (i / (out_n - 1)), the last one stop itself;
    index 0 when out_n is 1), else (d + 0.5) * scale - 0.5 (align_mode
    0) or d * scale (align_mode 1) with scale in_n / out_n."""
    f32 = torch.float32
    if align_corners:
        if out_n == 1:
            return torch.zeros(1, dtype=f32, device=device)
        div = out_n - 1
        step = torch.arange(div, dtype=f32, device=device) / float(div)
        stop = torch.full((1,), in_n - 1.0, dtype=f32, device=device)
        return torch.cat([stop * step, stop])
    d = torch.arange(out_n, dtype=f32, device=device)
    scale = in_n / out_n
    if align_mode == 0:
        return (d + 0.5) * scale - 0.5
    return d * scale


@register_op("interpolate")
def interpolate(ctx, ins, attrs):
    """reference: operators/interpolate_op.cc — NCHW bilinear or nearest
    at (out_h, out_w).  align_corners defaults to True; align_mode 1 is
    the asymmetric src = dst * scale, which torch's interpolate lacks.
    Nearest rounds half up with align_corners and floors without; the
    coordinates are clamped into the input, and bilinear lerps in
    float32 from the four neighbours, each weight from the coordinate's
    fraction."""
    x = first(ins, "X")
    method = attrs.get("interp_method", "bilinear")
    ac = attrs.get("align_corners", True)
    mode = attrs.get("align_mode", 1)
    h, w = x.shape[2], x.shape[3]
    ys = torch.clamp(_src_coords(attrs["out_h"], h, ac, mode, x.device),
                     0, h - 1)
    xs = torch.clamp(_src_coords(attrs["out_w"], w, ac, mode, x.device),
                     0, w - 1)
    if method == "nearest":
        yi = (torch.floor(ys + 0.5) if ac else torch.floor(ys)).long()
        xi = (torch.floor(xs + 0.5) if ac else torch.floor(xs)).long()
        return out(Out=x[:, :, yi][:, :, :, xi].to(x.dtype))
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    xf = x.to(torch.float32)
    top = xf[:, :, y0][:, :, :, x0] * (1 - wx) \
        + xf[:, :, y0][:, :, :, x1] * wx
    bot = xf[:, :, y1][:, :, :, x0] * (1 - wx) \
        + xf[:, :, y1][:, :, :, x1] * wx
    return out(Out=(top * (1 - wy) + bot * wy).to(x.dtype))


@register_op("pad2d")
def pad2d(ctx, ins, attrs):
    """NCHW, paddings [top, bottom, left, right]; "constant" (pad_value),
    "reflect" (the edge not repeated) or "edge"."""
    x = first(ins, "X")
    t, b, le, r = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return out(Out=F.pad(x, (le, r, t, b),
                             value=attrs.get("pad_value", 0.0)))
    return out(Out=F.pad(x, (le, r, t, b),
                         mode="reflect" if mode == "reflect"
                         else "replicate"))


@register_op("grid_sampler")
def grid_sampler(ctx, ins, attrs):
    """Bilinear sampling at Grid (N, Hg, Wg, 2) of (x, y) in [-1, 1],
    corner-aligned: the weights come from the unclamped coordinates and
    each corner is read at its coordinate clamped into the input.  That
    is neither of torch's grid_sample padding modes."""
    x, grid = first(ins, "X"), first(ins, "Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(xi, yi):
        xi = torch.clamp(xi, 0, w - 1).long()
        yi = torch.clamp(yi, 0, h - 1).long()
        return x[batch, :, yi, xi]                 # (N, Hg, Wg, C)

    w00 = (x0 + 1 - gx) * (y0 + 1 - gy)
    w01 = (gx - x0) * (y0 + 1 - gy)
    w10 = (x0 + 1 - gx) * (gy - y0)
    w11 = (gx - x0) * (gy - y0)
    o = (sample(x0, y0) * w00[..., None]
         + sample(x0 + 1, y0) * w01[..., None]
         + sample(x0, y0 + 1) * w10[..., None]
         + sample(x0 + 1, y0 + 1) * w11[..., None])
    return {"Output": [o.permute(0, 3, 1, 2)]}


@register_op("space_to_depth")
def space_to_depth(ctx, ins, attrs):
    x = first(ins, "X")
    b = attrs["blocksize"]
    n, c, h, w = x.shape
    o = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return out(Out=o.reshape(n, c * b * b, h // b, w // b))


@register_op("maxout")
def maxout(ctx, ins, attrs):
    """The max over each run of `groups` consecutive channels (ties share
    the gradient evenly, as jnp.max's)."""
    x = first(ins, "X")
    g = attrs["groups"]
    n, c, h, w = x.shape
    return out(Out=x.reshape(n, c // g, g, h, w).amax(dim=2))
