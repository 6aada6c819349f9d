"""Basic math / tensor ops: the port of paddle_tpu/ops/basic.py, as
torch functions with the reference's op names, slots and attrs
(reference files: paddle/fluid/operators/mul_op.cc, elementwise/*,
fill_constant_op.cc, ...).

Ops that create a tensor from nothing (fill/random) put it on the run's
device (`ctx.device`); every other op stays on its inputs' device.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import (broadcast_y, fill_index, first, nan_where, opt_in, out,
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


@register_op("assign_value")
def assign_value(ctx, ins, attrs):
    """A constant from the op's attrs (values, shape, dtype)."""
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    values = torch.tensor(attrs["values"], dtype=torch.float64)
    return out(Out=values.to(dtype).reshape(tuple(attrs["shape"]))
               .to(ctx.device))


@register_op("split")
def split(ctx, ins, attrs):
    """X split along `axis` into `num` equal pieces, or into pieces of
    the sizes `sections`."""
    x = first(ins, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        pieces = torch.split(x, list(sections), dim=axis)
    else:
        pieces = torch.chunk(x, attrs.get("num", 0), dim=axis)
    return {"Out": list(pieces)}


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
    many rows, the last one (or the only one, with fewer rows)
    zero-padded, so every row takes the same GEMM whatever the row
    count."""
    x, y = first(ins, "X"), first(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), math.prod(xs[xnc:]))
    y2 = y.reshape(math.prod(ys[:ync]), math.prod(ys[ync:]))
    blk = ctx.row_block
    if blk and x2.shape[0] != blk:
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
# floor semantics on negative integers, as jnp.floor_divide
_register_elementwise(
    "elementwise_floordiv",
    lambda x, y: torch.div(x, y, rounding_mode="floor"))
_register_elementwise("less_than", torch.lt, torch.bool)
_register_elementwise("less_equal", torch.le, torch.bool)
_register_elementwise("greater_than", torch.gt, torch.bool)
_register_elementwise("greater_equal", torch.ge, torch.bool)
_register_elementwise("equal", torch.eq, torch.bool)
_register_elementwise("not_equal", torch.ne, torch.bool)


def _register_logical(name, fn):
    @register_op(name)
    def impl(ctx, ins, attrs, _fn=fn):
        return out(Out=_fn(*(first(ins, s) for s in ("X", "Y")
                             if ins.get(s))))


_register_logical("logical_and", torch.logical_and)
_register_logical("logical_or", torch.logical_or)
_register_logical("logical_xor", torch.logical_xor)
_register_logical("logical_not", torch.logical_not)


# --------------------------------------------------------------------------
# Reductions
# --------------------------------------------------------------------------

@register_op("mean")
def mean(ctx, ins, attrs):
    """Under a data-parallel step's `cross_rank` (the batch is split
    over the ranks, each an equal slice): the ranks' means summed, over
    their count — the global batch's mean on every rank."""
    m = torch.mean(first(ins, "X"))
    if ctx.cross_rank is not None:
        m = ctx.cross_rank.sum(m) / ctx.cross_rank.n
    return out(Out=m.reshape((1,)))


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
        if ctx.cross_rank is not None:
            # (reduce_sum, reduce_mean) the reduction covered the batch
            # dim, split over the data ranks in equal slices: sum the
            # ranks' partial results
            o = ctx.cross_rank.sum(o)
            if name == "reduce_mean":
                o = o / ctx.cross_rank.n
        if o.dtype == torch.int64 and x.dtype != torch.int64:
            # jnp sums and multiplies bools and narrow ints in the
            # default int, int32 with x64 off; torch in int64
            o = o.to(torch.int32)
        if o.dim() == 0:
            o = o.reshape((1,))
        return out(Out=o)


_register_reduce("reduce_sum", torch.sum)
_register_reduce("reduce_mean", torch.mean)
# boolean results whatever the input dtype, as jnp.all / jnp.any
_register_reduce("reduce_all",
                 lambda x, dim, keepdim: torch.all(x.to(torch.bool), dim=dim,
                                                   keepdim=keepdim))
_register_reduce("reduce_any",
                 lambda x, dim, keepdim: torch.any(x.to(torch.bool), dim=dim,
                                                   keepdim=keepdim))


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
    """X + step, the step in X's dtype (truncated toward zero for an
    integer X, as jnp.asarray(step, dtype) converts it).  The step is
    filled on the device: no host-to-device copy, which on a card would
    synchronize once a call (a While loop's counter calls it once an
    iteration)."""
    x = first(ins, "X")
    step = attrs.get("step", 1.0)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        step = int(step)
    return out(Out=x + torch.full((), step, dtype=x.dtype, device=x.device))


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


@register_op("expand")
def expand(ctx, ins, attrs):
    """X tiled `expand_times` times along each dim (jnp.tile: fewer
    times than dims repeat the trailing dims)."""
    return out(Out=torch.tile(first(ins, "X"),
                              tuple(attrs["expand_times"])))


def _fill_value(dtype):
    """What jnp's gather (mode "fill") reads at an out-of-range index:
    NaN for floats, the most negative value for signed integers, True
    for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


@register_op("gather")
def gather(ctx, ins, attrs):
    """Rows of X at the flattened Index (jnp.take along axis 0): a
    negative index wraps once, one still outside [0, N) reads the fill
    value of X's dtype (NaN for floats)."""
    x, index = first(ins, "X"), first(ins, "Index")
    idx, bad = fill_index(index.reshape(-1), x.shape[0])
    o = x.index_select(0, idx)
    bad = bad.reshape(tuple(bad.shape) + (1,) * (x.dim() - 1))
    return out(Out=torch.where(bad, torch.full(
        (), _fill_value(x.dtype), dtype=x.dtype, device=x.device), o))


@register_op("where_op")
def where_op(ctx, ins, attrs):
    """X where Condition, else Y, in X and Y's promoted dtype."""
    x, y = promote_pair(first(ins, "X"), first(ins, "Y"))
    return out(Out=torch.where(first(ins, "Condition").to(torch.bool), x, y))


@register_op("is_empty")
def is_empty(ctx, ins, attrs):
    """reference: operators/is_empty_op.cc — (1,) bool, true iff the
    tensor has zero elements (a property of the shape: no host read)."""
    x = first(ins, "X")
    return out(Out=torch.tensor([x.numel() == 0], dtype=torch.bool,
                                device=x.device))


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


def stable_top_k(x, k):
    """(values, int64 indices) of the k largest along the last axis;
    among equal values the lower index comes first, as lax.top_k orders
    them (a stable descending sort, then a slice; torch.topk promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("top_k")
def top_k(ctx, ins, attrs):
    """The k largest along the last axis, ties by the lower index
    (`stable_top_k`)."""
    vals, idx = stable_top_k(first(ins, "X"), attrs["k"])
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


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


# --------------------------------------------------------------------------
# The rest of the registry's dense math (reference ops/basic.py)
# --------------------------------------------------------------------------

def _batch_like_shape(attrs, x):
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    return tuple(shape)


@register_op("fill_zeros_like")
def fill_zeros_like(ctx, ins, attrs):
    return out(Out=torch.zeros_like(first(ins, "X")))


@register_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(ctx, ins, attrs):
    """U[min, max) with Input's dim `input_dim_idx` as dim
    `output_dim_idx`, from the op's generator (ROADMAP C2)."""
    x = first(ins, "Input")
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_batch_like_shape(attrs, x), generator=ctx.rng(),
                   dtype=torch.float32, device=x.device)
    return out(Out=(u * (hi - lo) + lo).to(
        to_torch_dtype(attrs.get("dtype", "float32"))))


@register_op("gaussian_random_batch_size_like")
def gaussian_random_batch_size_like(ctx, ins, attrs):
    """N(mean, std) samples with Input's batch dim (reference:
    operators/gaussian_random_batch_size_like_op.cc), from the op's
    generator."""
    x = first(ins, "Input")
    g = torch.randn(_batch_like_shape(attrs, x), generator=ctx.rng(),
                    dtype=torch.float32, device=x.device)
    return out(Out=(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * g).to(
        to_torch_dtype(attrs.get("dtype", "float32"))))


@register_op("randint")
def randint(ctx, ins, attrs):
    """Integers uniform in [low, high) of `shape`, from the op's
    generator."""
    return out(Out=torch.randint(
        attrs.get("low", 0), attrs.get("high", 2 ** 31 - 1),
        tuple(attrs["shape"]), generator=ctx.rng(), device=ctx.device,
        dtype=to_torch_dtype(attrs.get("dtype", "int64"))))


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx, ins, attrs):
    """out[b, o] = x[b] W[o] y[b] (+ Bias)."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "Weight")
    bias = opt_in(ins, "Bias")
    o = torch.einsum("bi,oij,bj->bo", x, w, y)
    return out(Out=o if bias is None else o + bias)


# remainder with the divisor's sign, as jnp.mod
_register_elementwise("elementwise_mod", torch.remainder)


@register_op("isfinite")
def isfinite(ctx, ins, attrs):
    """One (1,) bool over every input: all of them finite (each cast to
    float32 first, as the reference's isfinite_op reduces)."""
    res = None
    for x in ins["X"]:
        f = torch.isfinite(x.to(torch.float32)).all()
        res = f if res is None else torch.logical_and(res, f)
    return out(Out=res.reshape(1))


def _reduce_dims(x, dims, keepdim, fn):
    for d in sorted(dims, reverse=True):
        x = fn(x, d, keepdim)
    return x


_register_reduce("reduce_max", torch.amax)
_register_reduce("reduce_min", torch.amin)
_register_reduce("reduce_prod", lambda x, dim, keepdim: _reduce_dims(
    x, dim, keepdim, lambda v, d, k: torch.prod(v, dim=d, keepdim=k)))


@register_op("flatten")
def flatten(ctx, ins, attrs):
    """X as 2-D: the dims before `axis` into the rows."""
    x = first(ins, "X")
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


@register_op("stack")
def stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def unstack(ctx, ins, attrs):
    x = first(ins, "X")
    return {"Y": list(torch.unbind(x, dim=attrs.get("axis", 0)))}


@register_op("scatter")
def scatter(ctx, ins, attrs):
    """X with the rows at Ids replaced by (`overwrite`) or increased by
    the rows of Updates.  A negative id wraps once; one still outside
    the rows is dropped.  With duplicate ids and `overwrite`, the last
    update of each id wins, deterministically on every device (the
    reference's XLA scatter on the CPU keeps the last write; a CUDA
    index_put is not ordered): only the last occurrence of each id is
    written, the others go to a spare row that is cut off.  The
    gradient reaches only the updates that are written.  Updates
    broadcast to one row an id."""
    x, ids, updates = first(ins, "X"), first(ins, "Ids"), first(ins,
                                                               "Updates")
    rows = x.shape[0]
    idx, bad = fill_index(ids.reshape(-1), rows)
    target = torch.where(bad, rows, idx)
    # broadcast to one row an id, as jnp's .at[ids] broadcasts them
    updates = torch.broadcast_to(updates, tuple(target.shape)
                                 + tuple(x.shape[1:]))
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if attrs.get("overwrite", True):
        order = torch.arange(target.shape[0], device=x.device)
        last = torch.full((rows + 1,), -1, dtype=torch.int64,
                          device=x.device).scatter_reduce(
            0, target, order, "amax")
        target = torch.where(last[target] == order, target, rows)
        ext = ext.index_copy(0, target, updates.to(x.dtype))
    else:
        ext = ext.index_add(0, target, updates.to(x.dtype))
    return out(Out=ext[:rows])


@register_op("minus")
def minus(ctx, ins, attrs):
    """reference: operators/minus_op.cc — Out = X - Y."""
    return out(Out=first(ins, "X") - first(ins, "Y"))


@register_op("cos_sim")
def cos_sim(ctx, ins, attrs):
    """reference: operators/cos_sim_op.cc — row-wise cosine similarity
    over all non-batch dims (Y's batch dim may be 1), with the XNorm and
    YNorm intermediates the reference exposes."""
    x, y = first(ins, "X"), first(ins, "Y")
    xf, yf = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    xn = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(yf * yf, dim=1, keepdim=True))
    dot = torch.sum(xf * yf, dim=1, keepdim=True)
    return out(Out=dot / torch.clamp(xn * yn, min=1e-12), XNorm=xn,
               YNorm=yn)


def _pad_list(cfg):
    """[(lo, hi) per dim] as F.pad's flat list, last dim first."""
    flat = []
    for lo, hi in reversed(cfg):
        flat += [lo, hi]
    return flat


@register_op("pad_constant_like")
def pad_constant_like(ctx, ins, attrs):
    """reference: operators/pad_constant_like_op.cc — Y padded at the
    high edge of every axis up to X's shape."""
    x, y = first(ins, "X"), first(ins, "Y")
    if x.dim() != y.dim():
        raise ValueError(
            f"pad_constant_like: rank mismatch {x.dim()} vs {y.dim()}")
    cfg = [(0, xd - yd) for xd, yd in zip(x.shape, y.shape)]
    if any(b < 0 for _, b in cfg):
        raise ValueError(f"pad_constant_like: X dims {tuple(x.shape)} must "
                         f"be >= Y dims {tuple(y.shape)}")
    return out(Out=torch.nn.functional.pad(
        y, _pad_list(cfg), value=attrs.get("pad_value", 0.0)))


@register_op("pad")
def pad(ctx, ins, attrs):
    """paddings [lo_0, hi_0, lo_1, hi_1, ...] with pad_value."""
    x = first(ins, "X")
    p = attrs["paddings"]
    cfg = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return out(Out=torch.nn.functional.pad(
        x, _pad_list(cfg), value=attrs.get("pad_value", 0.0)))


@register_op("reverse")
def reverse(ctx, ins, attrs):
    return out(Out=torch.flip(first(ins, "X"), dims=list(attrs["axis"])))


@register_op("shape")
def shape_op(ctx, ins, attrs):
    """Input's shape, int32 (a property of the shape: no host read)."""
    x = first(ins, "Input")
    shape = list(x.shape)
    if ctx.cross_rank is not None and shape:
        # a data-parallel step: the global batch's shape
        shape[0] *= ctx.cross_rank.n
    return out(Out=torch.tensor(tuple(shape), dtype=torch.int32,
                                device=x.device))


@register_op("argsort")
def argsort(ctx, ins, attrs):
    """Sorted values and int32 indices along `axis`, stable (equal
    values keep their order), as jnp.argsort."""
    x = first(ins, "X")
    vals, idx = torch.sort(x, dim=attrs.get("axis", -1), stable=True)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register_op("arg_min")
def arg_min(ctx, ins, attrs):
    """int32 index of the minimum along `axis`, ties to the first."""
    x = first(ins, "X")
    return out(Out=torch.argmin(x, dim=attrs.get("axis", -1))
               .to(torch.int32))


@register_op("cumsum")
def cumsum(ctx, ins, attrs):
    """The reference's formulae: exclusive as cumsum - x (not a shift),
    reverse as the flipped cumsum of the flipped x, then - x when
    exclusive too."""
    x = first(ins, "X")
    axis = attrs.get("axis", -1)
    excl = attrs.get("exclusive", False)
    if attrs.get("reverse", False):
        o = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                       [axis])
    else:
        o = torch.cumsum(x, dim=axis)
    return out(Out=o - x if excl else o)


@register_op("multiplex")
def multiplex(ctx, ins, attrs):
    """Row i of Out is row i of X[Ids[i]] (an id wraps once and is then
    clamped into range, as jnp indexing does)."""
    xs = torch.stack(ins["X"], dim=0)
    ids = first(ins, "Ids").reshape(-1).to(torch.int64)
    k = xs.shape[0]
    ids = torch.where(ids < 0, ids + k, ids).clamp(0, k - 1)
    rows = torch.arange(ids.shape[0], device=xs.device)
    return out(Out=xs[ids, rows])
