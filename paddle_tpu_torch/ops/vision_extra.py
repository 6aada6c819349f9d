"""The rest of the vision operators: the port of paddle_tpu/ops/
vision_extra.py (reference: paddle/fluid/operators/ pool_op.cc (3-D
path), spp_op.cc, roi_pool_op.cc, roi_align_op.cc, psroi_pool_op.cc,
affine_channel_op.cc, affine_grid_op.cc, crop_op.cc, unpool_op.cc and
similarity_focus_op.h).

ROI ops take a static (R, 5) roi tensor [batch_idx, x1, y1, x2, y2]
(the batch index in the box replaces the reference's LoD row mapping),
and run batched over the RoIs, with no Python loop over them:

- roi_pool takes the reference's separable max, W then H, as two
  `scatter_reduce("amax")` stages over per-pixel bin ids; each stage
  splits a max's gradient evenly among tied values, as JAX's
  segment_max does, and an empty bin reads 0.
- roi_align gathers each of the four bilinear corners from a
  channels-last copy of the map and accumulates corner by corner, so no
  more than one (R, samples, C) gather lives at a time; the sampling
  ratio is 2 when the attr is <= 0, as in the reference.
- psroi_pool is the reference's two mask products (float32, TF32 off).

Max pooling pads with -inf and its gradient goes to one element of
each window; a division by a Python number goes through `_div` (a 0-d
tensor on the operand's device), since CUDA divides by a host scalar
as a multiply by its reciprocal and the CPU does not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, opt_in, out


def _triple(v):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) == 3 else list(v) * 3
    return [v, v, v]


def _div(x, d):
    """x / d for a Python number d, rounded as IEEE division on every
    device."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), whose gradient at a bound
    is 0.5, as jnp's (torch.clamp passes 1 there).  Bounds are numbers
    or tensors that broadcast against x."""
    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(x.dtype)
        return torch.full((), float(v), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, t(lo)), t(hi))


def _maximum(x, v):
    """jnp.maximum(x, number): the gradient at a tie is 0.5."""
    return torch.maximum(x, torch.full((), float(v), dtype=x.dtype,
                                       device=x.device))


def _window_sum(x, ksize, strides, pads):
    """The sum over each window of a zero-padded NC... tensor (2-D or
    3-D windows), as lax.reduce_window with lax.add."""
    flat = [p for lohi in reversed(pads) for p in lohi]
    xp = F.pad(x, flat)
    if len(ksize) == 3:
        return F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    return F.avg_pool2d(xp, ksize, strides, divisor_override=1)


def _window_max(x, ksize, strides, pads):
    """The max over each window of an NC... tensor padded with -inf, as
    lax.reduce_window with lax.max."""
    flat = [p for lohi in reversed(pads) for p in lohi]
    xp = F.pad(x, flat, value=float("-inf"))
    if len(ksize) == 3:
        return F.max_pool3d(xp, ksize, strides)
    return F.max_pool2d(xp, ksize, strides)


@register_op("pool3d")
def pool3d(ctx, ins, attrs):
    """reference pool_op.cc 3-D kernels; NCDHW.  The exclusive average
    (with padding) divides by each window's count of real elements."""
    x = first(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return out(Out=torch.amax(x, dim=(2, 3, 4), keepdim=True))
        return out(Out=torch.mean(x, dim=(2, 3, 4), keepdim=True))
    ksize = _triple(attrs["ksize"])
    strides = _triple(attrs.get("strides", 1))
    pads = [(p, p) for p in _triple(attrs.get("paddings", 0))]
    if ptype == "max":
        o = _window_max(x, ksize, strides, pads)
    else:
        s = _window_sum(x, ksize, strides, pads)
        if attrs.get("exclusive", True) and any(p > 0 for p, _ in pads):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            o = s / _window_sum(ones, ksize, strides, pads)
        else:
            o = _div(s, ksize[0] * ksize[1] * ksize[2])
    return out(Out=o.to(x.dtype))


@register_op("spp")
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling (reference spp_op.cc): level l pools to
    2^l x 2^l bins of ceil(H/2^l) x ceil(W/2^l), the padding split as
    the reference splits it (the odd pixel after), and the flattened
    levels are concatenated: (N, C * sum 4^l).  The average divides by
    the window's size, padding included."""
    x = first(ins, "X")
    n, c, h, w = x.shape
    levels = int(attrs.get("pyramid_height", 1))
    ptype = attrs.get("pooling_type", "max")
    pieces = []
    for lvl in range(levels):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pads = [(ph, kh * bins - h - ph), (pw, kw * bins - w - pw)]
        if ptype == "max":
            o = _window_max(x, [kh, kw], [kh, kw], pads)
        else:
            o = _div(_window_sum(x, [kh, kw], [kh, kw], pads), kh * kw)
        pieces.append(o.reshape(n, -1))
    return out(Out=torch.cat(pieces, dim=1).to(x.dtype))


def _roi_batch_split(rois):
    """rois (R, 5): [batch_idx, x1, y1, x2, y2] → (int64 batch ids,
    (R, 4) boxes).  The id truncates toward zero, as astype(int32)."""
    return rois[:, 0].to(torch.int64), rois[:, 1:]


def _bins(lo, size, n_bins, n_pix, device):
    """Per-pixel bin ids (R, n_pix) of the reference's integer bin
    edges lo + floor(i * size / n) .. lo + ceil((i + 1) * size / n);
    pixels outside [lo, lo + size) get the spare id n_bins."""
    i = torch.arange(n_bins, device=device)
    start = lo[:, None] + torch.div(i[None, :] * size[:, None], n_bins,
                                    rounding_mode="floor")
    pix = torch.arange(n_pix, device=device)
    b = (pix[None, None, :] >= start[:, :, None]).sum(dim=1) - 1
    inside = (pix[None, :] >= lo[:, None]) & (pix[None, :]
                                              < (lo + size)[:, None])
    return torch.where(inside, b.clamp(0, n_bins - 1),
                       torch.full_like(b, n_bins))


@register_op("roi_pool")
def roi_pool(ctx, ins, attrs):
    """Max pooling over ROI bins (reference roi_pool_op.cc): corners
    rounded half to even after the scale, each bin's max over the
    pixels of its integer edges, W first and then H; an empty bin
    reads 0."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    _n, c, h, w = x.shape
    bix, boxes = _roi_batch_split(rois)
    r = boxes.shape[0]
    corner = torch.round(boxes * scale).to(torch.int64)
    x1, y1, x2, y2 = corner.unbind(1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    bin_x = _bins(x1, rw, pw, w, x.device)           # (R, W)
    bin_y = _bins(y1, rh, ph, h, x.device)           # (R, H)
    fm = x[bix]                                      # (R, C, H, W)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    red_w = neg.expand(r, c, h, pw + 1).clone().scatter_reduce(
        3, bin_x[:, None, None, :].expand(r, c, h, w), fm, "amax",
        include_self=False)[..., :pw]                # (R, C, H, pw)
    red = neg.expand(r, c, ph + 1, pw).clone().scatter_reduce(
        2, bin_y[:, None, :, None].expand(r, c, h, pw), red_w, "amax",
        include_self=False)[:, :, :ph]               # (R, C, ph, pw)
    o = torch.where(torch.isfinite(red), red, torch.zeros_like(red))
    return out(Out=o.to(x.dtype))


@register_op("roi_align")
def roi_align(ctx, ins, attrs):
    """Bilinear ROI align (reference roi_align_op.cc): ratio x ratio
    samples a bin (ratio 2 when the attr is <= 0), a sample outside
    [-1, H] x [-1, W] reads 0, coordinates clamp into the map before
    the bilinear weights are taken, and each bin is the mean of its
    samples."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    n, c, h, w = x.shape
    bix, boxes = _roi_batch_split(rois)
    r = boxes.shape[0]
    f32 = x.dtype
    rx1, ry1 = boxes[:, 0] * scale, boxes[:, 1] * scale
    rw = _maximum(boxes[:, 2] * scale - rx1, 1.0)
    rh = _maximum(boxes[:, 3] * scale - ry1, 1.0)
    bh, bw = _div(rh, ph), _div(rw, pw)
    iy = _div(torch.arange(ph * ratio, dtype=f32, device=x.device) + 0.5,
              ratio)
    ix = _div(torch.arange(pw * ratio, dtype=f32, device=x.device) + 0.5,
              ratio)
    yy = (ry1[:, None] + iy[None, :] * bh[:, None])[:, :, None]
    xx = (rx1[:, None] + ix[None, :] * bw[:, None])[:, None, :]
    yy, xx = torch.broadcast_tensors(yy, xx)         # (R, ph*r, pw*r)
    yy, xx = yy.reshape(r, -1), xx.reshape(r, -1)
    outside = (yy < -1.0) | (yy > h) | (xx < -1.0) | (xx > w)
    yy = _clip(yy, 0.0, h - 1)
    xx = _clip(xx, 0.0, w - 1)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    ly, lx = yy - y0, xx - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    zero = torch.zeros((), dtype=f32, device=x.device)
    hy, hx = 1 - ly, 1 - lx
    corners = ((y0, x0, hy * hx), (y1, x0, ly * hx), (y0, x1, hy * lx),
               (y1, x1, ly * lx))
    xc = x.permute(0, 2, 3, 1).reshape(n, h * w, c)  # channels last
    acc = None
    for yi, xi, wt in corners:
        g = xc[bix[:, None], yi * w + xi]            # (R, S, C)
        term = g * torch.where(outside, zero, wt)[:, :, None]
        acc = term if acc is None else acc + term
    o = acc.reshape(r, ph, ratio, pw, ratio, c).mean(dim=(2, 4))
    return out(Out=o.permute(0, 3, 1, 2).to(x.dtype))


@register_op("affine_channel")
def affine_channel(ctx, ins, attrs):
    """Per-channel scale + bias (reference affine_channel_op.cc); NCHW."""
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(-1)
    bias = first(ins, "Bias").reshape(-1)
    shape = [1, -1] + [1] * (x.dim() - 2)
    return out(Out=x * scale.reshape(shape) + bias.reshape(shape))


def _linspace(start, stop, num, dtype, device):
    """jnp.linspace(start, stop, num) in float32 as the reference
    computes it: start * (1 - t) + stop * t with t = i / (num - 1), the
    last value stop itself."""
    if num == 1:
        return torch.full((1,), float(start), dtype=dtype, device=device)
    t = _div(torch.arange(num - 1, dtype=dtype, device=device), num - 1)
    head = start * (1 - t) + stop * t
    return torch.cat([head, torch.full((1,), float(stop), dtype=dtype,
                                       device=device)])


@register_op("affine_grid")
def affine_grid(ctx, ins, attrs):
    """2-D affine sampling grid (reference affine_grid_op.cc): Theta
    (N, 2, 3) → Output (N, H, W, 2) over the align-corner grid of
    [-1, 1] (jnp.linspace's float32 coordinates).  The output shape must
    be the `output_shape` attr: an OutputShape tensor raises, as in the
    reference, where it would fix a traced output's shape."""
    theta = first(ins, "Theta")
    shape = attrs.get("output_shape")
    if not shape:
        raise ValueError(
            "affine_grid: OutputShape fed as a runtime tensor is not "
            "supported (grid dims fix the output shape when the program "
            "is built) — pass out_shape as a python list/tuple")
    _n, _c, h, w = [int(s) for s in shape]
    ys = _linspace(-1.0, 1.0, h, theta.dtype, theta.device)
    xs = _linspace(-1.0, 1.0, w, theta.dtype, theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    grid = torch.einsum("hwk,njk->nhwj", base, theta)
    return out(Output=grid.to(theta.dtype))


@register_op("crop")
def crop(ctx, ins, attrs):
    """Static crop (reference crop_op.cc): offsets + the shape attr (or
    the shape of a Y input)."""
    x = first(ins, "X")
    y = opt_in(ins, "Y")
    shape = attrs.get("shape") or (list(y.shape) if y is not None else None)
    if shape is None:
        raise ValueError("crop needs shape attr or Y input")
    offsets = attrs.get("offsets") or [0] * x.dim()
    idx = tuple(slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return out(Out=x[idx])


@register_op("unpool")
def unpool(ctx, ins, attrs):
    """Max-unpooling from pool2d_with_index's Mask (reference
    unpool_op.cc): each value written at its position of the (uh, uw)
    map.  Where two values share a position the last one wins, on every
    device, as the reference's XLA scatter keeps the last write: the
    others go to a spare column that is cut off, so only the written
    value gets a gradient.  A negative position wraps once; one still
    outside the map is dropped."""
    x = first(ins, "X")
    mask = first(ins, "Indices").to(torch.int64)
    n, c, ph, pw = x.shape
    if "unpooled_height" in attrs:
        uh, uw = int(attrs["unpooled_height"]), int(attrs["unpooled_width"])
    else:
        uh, uw = (int(s) for s in attrs["unpool_size"])
    size = uh * uw
    vals = x.reshape(n * c, ph * pw)
    pos = mask.reshape(n * c, ph * pw)
    pos = torch.where(pos < 0, pos + size, pos)
    pos = torch.where((pos < 0) | (pos >= size), size, pos)
    order = torch.arange(ph * pw, device=x.device).expand_as(pos)
    last = torch.full((n * c, size + 1), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(1, pos, order, "amax")
    pos = torch.where(last.gather(1, pos) == order, pos,
                      torch.full_like(pos, size))
    o = vals.new_zeros((n * c, size + 1)).scatter(1, pos, vals)
    return out(Out=o[:, :size].reshape(n, c, uh, uw))


@register_op("psroi_pool")
def psroi_pool(ctx, ins, attrs):
    """Position-sensitive ROI average pooling for R-FCN (reference
    psroi_pool_op.cc/.h): input channels factor as output_channels *
    pooled_h * pooled_w, and output channel c's bin (i, j) averages
    input channel (c * pooled_h + i) * pooled_w + j over the bin's
    pixels (corners rounded, then end + 1, psroi_pool_op.h:84-91)."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    c_out = int(attrs["output_channels"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c_in, h, w = x.shape
    if c_in != c_out * ph * pw:
        raise ValueError(
            f"psroi_pool: input channels {c_in} != output_channels "
            f"{c_out} * pooled_height {ph} * pooled_width {pw}")
    bix, boxes = _roi_batch_split(rois)
    fm = x.reshape(n, c_out, ph, pw, h, w)[bix]    # (R, C_out, ph, pw, H, W)
    rb = torch.round(boxes)
    x1, y1 = rb[:, 0] * scale, rb[:, 1] * scale
    x2, y2 = (rb[:, 2] + 1.0) * scale, (rb[:, 3] + 1.0) * scale
    rh = _maximum(y2 - y1, 0.1)
    rw = _maximum(x2 - x1, 0.1)
    bh, bw = _div(rh, ph), _div(rw, pw)
    dt, dev = x.dtype, x.device
    ih = torch.arange(ph, dtype=dt, device=dev)
    iw = torch.arange(pw, dtype=dt, device=dev)
    ys = _clip(torch.floor(ih[None] * bh[:, None] + y1[:, None]), 0, h)
    ye = _clip(torch.ceil((ih[None] + 1) * bh[:, None] + y1[:, None]), 0, h)
    xs = _clip(torch.floor(iw[None] * bw[:, None] + x1[:, None]), 0, w)
    xe = _clip(torch.ceil((iw[None] + 1) * bw[:, None] + x1[:, None]), 0, w)
    row = torch.arange(h, dtype=dt, device=dev)
    col = torch.arange(w, dtype=dt, device=dev)
    rm = ((row[None, None, :] >= ys[:, :, None])
          & (row[None, None, :] < ye[:, :, None])).to(dt)   # (R, ph, H)
    cm = ((col[None, None, :] >= xs[:, :, None])
          & (col[None, None, :] < xe[:, :, None])).to(dt)   # (R, pw, W)
    t = torch.einsum("rih,rcijhw->rcijw", rm, fm)
    s = torch.einsum("rjw,rcijw->rcij", cm, t)              # (R, C_out, ph, pw)
    area = ((ye - ys)[:, :, None] * (xe - xs)[:, None, :])[:, None]
    o = torch.where(area > 0, s / _maximum(area, 1.0), torch.zeros_like(s))
    return out(Out=o.to(x.dtype))


def _greedy_mask(t):
    """t (N, R, C) → 0/1 float32 masks of min(R, C) greedy picks per
    item: the largest free value (the first in row-major order among
    ties), its row and column then taken (the reference's sorted scan
    with tagged-row/col skipping)."""
    nb, r, c = t.shape
    t = t.to(torch.float32)
    ar = torch.arange(nb, device=t.device)
    mask = torch.zeros((nb, r, c), dtype=torch.float32, device=t.device)
    rfree = torch.ones((nb, r), dtype=torch.bool, device=t.device)
    cfree = torch.ones((nb, c), dtype=torch.bool, device=t.device)
    neg = torch.full((), float("-inf"), device=t.device)
    for _ in range(min(r, c)):
        avail = torch.where(rfree[:, :, None] & cfree[:, None, :], t, neg)
        flat = torch.argmax(avail.reshape(nb, -1), dim=1)
        ri, ci = flat // c, flat % c
        mask[ar, ri, ci] = 1.0
        rfree[ar, ri] = False
        cfree[ar, ci] = False
    return mask


@register_op("similarity_focus")
def similarity_focus(ctx, ins, attrs):
    """Similarity-focus mask (reference similarity_focus_op.h): for each
    selected slice along `axis`, greedily pick the largest values so
    that every (row, col) of the other two dims is used at most once,
    mark them 1, broadcast along `axis` and OR across `indexes`.  The
    greedy loop runs min(rows, cols) batched steps."""
    x = first(ins, "X")
    axis = int(attrs["axis"])
    indexes = [int(i) for i in attrs["indexes"]]
    if axis not in (1, 2, 3):
        raise ValueError(f"similarity_focus axis must be 1, 2 or 3, "
                         f"got {axis}")
    combined = None
    for idx in indexes:
        m = _greedy_mask(x.select(axis, idx)).unsqueeze(axis)
        combined = m if combined is None else torch.maximum(combined, m)
    return out(Out=torch.broadcast_to(combined, x.shape).to(x.dtype))
