"""Neural-net ops: the subset of paddle_tpu/ops/nn.py the ported slices
run (reference: paddle/fluid/operators/activation_op.cc,
layer_norm_op.cc, softmax_op.cc, dropout_op.cc,
softmax_with_cross_entropy_op.cc, label_smooth_op.cc)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import fill_index, first, nan_where, opt_in, out


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
    (jax.nn.gelu's two forms)."""
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return out(Out=torch.nn.functional.gelu(first(ins, "X"),
                                            approximate=approximate))


@register_op("sqrt")
def sqrt(ctx, ins, attrs):
    return out(Out=torch.sqrt(first(ins, "X")))


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
        y = x * (1.0 - p) if is_test and impl == "downgrade_in_infer" \
            else x
        return {"Out": [y], "Mask": [torch.ones_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.rng(), device=x.device) \
        >= p
    if impl == "upscale_in_train":
        y = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
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
