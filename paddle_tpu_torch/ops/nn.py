"""Neural-net ops: the subset of paddle_tpu/ops/nn.py the ported slice
runs (reference: paddle/fluid/operators/activation_op.cc,
layer_norm_op.cc)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, opt_in, out


@register_op("relu")
def relu(ctx, ins, attrs):
    return out(Out=torch.relu(first(ins, "X")))


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
