"""Basic math / tensor ops: the subset of paddle_tpu/ops/basic.py the
ported slice runs, as torch functions with the reference's op names,
slots and attrs (reference files: paddle/fluid/operators/mul_op.cc,
elementwise/*, fill_constant_op.cc, ...).

Ops that create a tensor from nothing (fill/random) put it on the run's
device (`ctx.device`); every other op stays on its inputs' device.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import (broadcast_y, fill_index, first, nan_where, out,
                     promote_pair, to_torch_dtype, weak_scalar)


# --------------------------------------------------------------------------
# Fill / init / random
# --------------------------------------------------------------------------

@register_op("fill_constant")
def fill_constant(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return out(Out=torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                              device=ctx.device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx, ins, attrs):
    """fill_constant whose dim `output_dim_idx` is Input's dim
    `input_dim_idx` (the batch size, by default), on Input's device."""
    x = first(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return out(Out=torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=dtype, device=x.device))


@register_op("assign")
def assign(ctx, ins, attrs):
    return out(Out=first(ins, "X"))


@register_op("gaussian_random")
def gaussian_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    x = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    x = x * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return out(Out=x.to(dtype))


@register_op("uniform_random")
def uniform_random(ctx, ins, attrs):
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    x = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    return out(Out=(x * (hi - lo) + lo).to(dtype))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random(ctx, ins, attrs):
    """A standard normal truncated to [-2, 2], then * std + mean: the
    inverse-CDF form the reference's jax.random.truncated_normal takes
    (u uniform in [erf(-2/sqrt2), erf(2/sqrt2)), sqrt2 * erfinv(u),
    clamped inside the bounds), drawn from the op's own generator, so
    the numbers differ from threefry's."""
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    lim = math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    x = math.sqrt(2.0) * torch.erfinv(u * (2.0 * lim) - lim)
    inside = 2.0 - 2.0 ** -23       # the float32 next to 2, toward 0
    x = x.clamp(-inside, inside) * attrs.get("std", 1.0) \
        + attrs.get("mean", 0.0)
    return out(Out=x.to(dtype))


# --------------------------------------------------------------------------
# Matmul
# --------------------------------------------------------------------------

@register_op("mul")
def mul(ctx, ins, attrs):
    """Flattening matmul (reference: operators/mul_op.cc) — x flattened to 2D
    at x_num_col_dims, y at y_num_col_dims.  A plain torch.matmul: the
    projections, FFN and lm_head are dense GEMMs that the reference also
    left to its compiler, outside any hand-written kernel.  With the
    run's `row_block` (OpContext), the product runs in blocks of that
    many rows, the last one zero-padded, so every row takes the same
    GEMM whatever the row count."""
    x, y = first(ins, "X"), first(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), math.prod(xs[xnc:]))
    y2 = y.reshape(math.prod(ys[:ync]), math.prod(ys[ync:]))
    blk = ctx.row_block
    if blk and x2.shape[0] > blk:
        m = x2.shape[0]
        pad = -m % blk
        if pad:
            x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
        o = torch.cat([torch.matmul(b, y2) for b in x2.split(blk)])[:m]
    else:
        o = torch.matmul(x2, y2)
    return out(Out=o.reshape(xs[:xnc] + ys[ync:]))


@register_op("matmul")
def matmul(ctx, ins, attrs):
    """Batched matmul with optional transposes of the last two dims and
    an output scale (reference: operators/matmul_op.cc)."""
    x, y = first(ins, "X"), first(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    o = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        # a bf16 product is scaled by alpha rounded to bf16 and rounded
        # to bf16 again, as jnp scales it
        o = o * weak_scalar(alpha, o)
    return out(Out=o)


# --------------------------------------------------------------------------
# Elementwise family (with fluid broadcast-axis semantics)
# --------------------------------------------------------------------------

def _register_elementwise(name, fn, out_dtype=None):
    @register_op(name)
    def impl(ctx, ins, attrs, _fn=fn, _dt=out_dtype):
        x, y = first(ins, "X"), first(ins, "Y")
        y = broadcast_y(x, y, attrs.get("axis", -1))
        o = _fn(*promote_pair(x, y))
        if _dt is not None:
            o = o.to(_dt)
        return out(Out=o)


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_pow", torch.pow)
_register_elementwise("less_than", torch.lt, torch.bool)
_register_elementwise("less_equal", torch.le, torch.bool)
_register_elementwise("greater_than", torch.gt, torch.bool)
_register_elementwise("greater_equal", torch.ge, torch.bool)
_register_elementwise("equal", torch.eq, torch.bool)
_register_elementwise("not_equal", torch.ne, torch.bool)


# --------------------------------------------------------------------------
# Reductions
# --------------------------------------------------------------------------

@register_op("mean")
def mean(ctx, ins, attrs):
    return out(Out=torch.mean(first(ins, "X")).reshape((1,)))


def _register_reduce(name, fn):
    @register_op(name)
    def impl(ctx, ins, attrs, _fn=fn):
        x = first(ins, "X")
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(a if a >= 0 else a + x.dim()
                         for a in attrs.get("dim", [0]))
        o = _fn(x, dim=dims, keepdim=keep) if dims else x
        if o.dim() == 0:
            o = o.reshape((1,))
        return out(Out=o)


_register_reduce("reduce_sum", torch.sum)
_register_reduce("reduce_mean", torch.mean)


# --------------------------------------------------------------------------
# Scale / cast / sum
# --------------------------------------------------------------------------

@register_op("scale")
def scale(ctx, ins, attrs):
    x = first(ins, "X")
    s = weak_scalar(attrs.get("scale", 1.0), x)
    b = weak_scalar(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        o = x * s + b
    else:
        o = (x + b) * s
    return out(Out=o.to(x.dtype))


@register_op("cast")
def cast(ctx, ins, attrs):
    return out(Out=first(ins, "X").to(to_torch_dtype(attrs["out_dtype"])))


@register_op("clip")
def clip(ctx, ins, attrs):
    return out(Out=torch.clamp(first(ins, "X"), attrs["min"], attrs["max"]))


@register_op("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    x = first(ins, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones((), dtype=x.dtype, device=x.device))
    return out(Out=x * factor)


@register_op("increment")
def increment(ctx, ins, attrs):
    x = first(ins, "X")
    return out(Out=x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                    device=x.device))


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """Sum a list of tensors (reference: operators/sum_op.cc)."""
    xs = ins["X"]
    o = xs[0]
    for x in xs[1:]:
        o = o + x
    return out(Out=o)


# --------------------------------------------------------------------------
# Shape manipulation
# --------------------------------------------------------------------------

def _xshape(x):
    # the reference's XShape output: an empty (0, *x.shape) tensor
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register_op("reshape")
def reshape(ctx, ins, attrs):
    """fluid reshape: 0 copies the input's dim, -1 is inferred."""
    x = first(ins, "X")
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(tuple(shape))], "XShape": [_xshape(x)]}


@register_op("transpose")
def transpose(ctx, ins, attrs):
    """A permuted view (the reference's jnp.transpose): no copy; the
    flash kernels read such views through their strides."""
    x = first(ins, "X")
    return {"Out": [x.permute(tuple(attrs["axis"]))],
            "XShape": [_xshape(x)]}


@register_op("concat")
def concat(ctx, ins, attrs):
    return out(Out=torch.cat(ins["X"], dim=attrs.get("axis", 0)))


@register_op("slice")
def slice_op(ctx, ins, attrs):
    """Per axis, as the reference: a negative start or end gets the dim
    added once (it may stay negative, and then counts from the end as
    a Python slice does), one past the dim is cut to the dim; a view,
    so the gradient routes back through autograd."""
    x = first(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = s + dim if s < 0 else min(s, dim)
        e = e + dim if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return out(Out=x[tuple(idx)])


@register_op("one_hot")
def one_hot(ctx, ins, attrs):
    """Float32 one-hot of int ids; a trailing 1-dim is dropped first, as
    in the reference (jax.nn.one_hot: an id outside [0, depth) gives an
    all-zero row)."""
    x = first(ins, "X")
    ids = x.reshape(x.shape[:-1]) if x.shape[-1] == 1 else x
    depth = int(attrs["depth"])
    classes = torch.arange(depth, device=x.device, dtype=ids.dtype)
    return out(Out=(ids.unsqueeze(-1) == classes).to(torch.float32))


@register_op("squeeze")
def squeeze(ctx, ins, attrs):
    x = first(ins, "X")
    axes = attrs.get("axes", [])
    if axes:
        o = x.squeeze(tuple(a if a >= 0 else a + x.dim() for a in axes))
    else:
        o = x.squeeze()
    return {"Out": [o], "XShape": [_xshape(x)]}


@register_op("unsqueeze")
def unsqueeze(ctx, ins, attrs):
    x = first(ins, "X")
    o = x
    for a in sorted(attrs["axes"]):
        o = o.unsqueeze(a)
    return {"Out": [o], "XShape": [_xshape(x)]}


@register_op("batched_gather")
def batched_gather(ctx, ins, attrs):
    """Per-row gather (batch_dims=1): X (N, A, ...) + Index (N, S) →
    (N, S, ...).  An index outside [0, A) after one wrap of negatives
    reads NaN, as the reference's take_along_axis does."""
    x, index = first(ins, "X"), first(ins, "Index")
    idx, bad = fill_index(index, x.shape[1])
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    idx = idx.expand(tuple(index.shape) + tuple(x.shape[2:]))
    return out(Out=nan_where(bad, torch.gather(x, 1, idx)))


@register_op("top_k")
def top_k(ctx, ins, attrs):
    """The k largest along the last axis; among equal values the lower
    index comes first, as lax.top_k orders them (a stable descending
    sort, then a slice)."""
    vals, idx = torch.sort(first(ins, "X"), dim=-1, descending=True,
                           stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k].to(torch.int32)]}


@register_op("range")
def range_op(ctx, ins, attrs):
    """Start + Step * arange(num) in Start's dtype; `num` is a required
    static attr, as in the reference (End only fixed it when built)."""
    num = attrs.get("num")
    if num is None:
        raise ValueError("range op requires the static 'num' attr")
    start = first(ins, "Start").reshape(())
    step = first(ins, "Step").reshape(())
    return out(Out=start + step * torch.arange(num, dtype=start.dtype,
                                               device=start.device))


@register_op("arg_max")
def arg_max(ctx, ins, attrs):
    x = first(ins, "X")
    return out(Out=torch.argmax(x, dim=attrs.get("axis", -1))
               .to(torch.int32))
