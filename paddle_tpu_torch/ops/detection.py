"""Detection operators: the port of paddle_tpu/ops/detection.py
(reference: paddle/fluid/operators/detection/ — prior_box_op.cc,
box_coder_op.cc, iou_similarity_op.cc, multiclass_nms_op.cc,
yolov3_loss_op.cc, anchor_generator_op.cc, density_prior_box_op.cc,
box_clip_op.cc, bipartite_match_op.cc, target_assign_op.cc,
generate_proposals_op.cc, rpn_target_assign_op.cc,
generate_proposal_labels_op.cc, mine_hard_examples_op.cc,
polygon_box_transform_op.cc, roi_perspective_transform_op.cc and
operators/detection_map_op.cc).

The reference's static-shape contracts are kept: multiclass_nms gives a
fixed (N, keep_top_k, 6) tensor padded with -1 rows plus per-image
counts, generate_proposals a zero-padded (N, post_nms_topN, 4) with
counts, and the sampling ops fixed slot budgets with weights and
counts, selected rows compacted to the front by a stable sort.

NMS.  The reference's keep loop is sequential (a lax.fori_loop over the
top-k candidates).  Here it is the fixed point of its own recurrence on
the (k, k) suppression matrix: keep <- valid & ~any_j(keep[j] &
iou[i, j] > thr & j < i), from keep = valid, batched over images and
classes.  Iteration t fixes the first t candidates for good (by
induction on i) and the fixed point is unique, so the loop stops,
exactly at the sequential result, when nothing changes — after as many
iterations as the longest suppression chain, usually a handful, each a
host read of one bool.  With nms_eta < 1 the threshold at i is a table
entry indexed by the number of candidates kept before i (the exclusive
cumsum of keep), the table built by repeated float32 multiplication
with the reference's `> 0.5` rule.  No Python loop runs over
candidates.  `nms_iterations` holds each NMS op's iteration count of
its last call.

Ties: the top-k and sorts are stable (`basic.stable_top_k`,
`torch.argsort(stable=True)`), as lax.top_k and jnp.argsort are.  The
sampling ops draw their priorities from the op's torch generator when
use_random (ROADMAP C2); with use_random=False they take candidates in
index order, as the reference does.  nms_top_k = -1 raises, as the
reference's lax.top_k does (upstream Fluid reads it as "all").
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .basic import stable_top_k
from .common import first, opt_in, out
from .vision_extra import _clip, _div, _maximum

# each NMS op's iteration count of its last call (the fixed point's
# applications, the last of which changes nothing)
nms_iterations = {}


def _const(values, like):
    """A float32 tensor of Python numbers on `like`'s device (Python
    doubles rounded once to float32, as jnp.asarray with x64 off)."""
    return torch.tensor(np.asarray(values, np.float32), device=like.device)


def _minimum(x, v):
    return torch.minimum(x, torch.full((), float(v), dtype=x.dtype,
                                       device=x.device))


# ---------------------------------------------------------------------------
# prior boxes and anchors
# ---------------------------------------------------------------------------

def _grid_boxes(cxg, cyg, bw, bh, img_w, img_h, clip):
    """Normalized [xmin, ymin, xmax, ymax] of (H, W, P) centers ± the
    (P,) half sizes."""
    boxes = torch.stack([_div(cxg - bw, img_w), _div(cyg - bh, img_h),
                         _div(cxg + bw, img_w), _div(cyg + bh, img_h)],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


@register_op("prior_box")
def prior_box(ctx, ins, attrs):
    """SSD prior boxes for one feature map (reference prior_box_op.cc):
    Boxes (H, W, P, 4) normalized, Variances (H, W, P, 4); per min_size
    the aspect ratios (1 first, then each new ratio and, with flip, its
    inverse), then the sqrt(min * max) box."""
    feat = first(ins, "Input")
    image = first(ins, "Image")
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
        if attrs.get("flip", True) and not any(
                abs(1.0 / ar - e) < 1e-6 for e in ars):
            ars.append(1.0 / ar)
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / w
    step_h = float(attrs.get("step_h", 0.0)) or img_h / h
    offset = float(attrs.get("offset", 0.5))
    widths, heights = [], []
    for k, ms in enumerate(min_sizes):
        for ar in ars:
            widths.append(ms * ar ** 0.5)
            heights.append(ms / ar ** 0.5)
        if max_sizes:
            bs = (ms * max_sizes[k]) ** 0.5
            widths.append(bs)
            heights.append(bs)
    bw = _const(widths, feat) / 2.0
    bh = _const(heights, feat) / 2.0
    f32 = torch.float32
    cx = (torch.arange(w, dtype=f32, device=feat.device) + offset) * step_w
    cy = (torch.arange(h, dtype=f32, device=feat.device) + offset) * step_h
    p = len(widths)
    boxes = _grid_boxes(cx[None, :, None].expand(h, w, p),
                        cy[:, None, None].expand(h, w, p), bw, bh, img_w,
                        img_h, attrs.get("clip", True))
    var = _const(variances, feat).expand(h, w, p, 4)
    return out(Boxes=boxes.to(feat.dtype), Variances=var.to(feat.dtype))


@register_op("anchor_generator")
def anchor_generator(ctx, ins, attrs):
    """Faster R-CNN anchors for one feature map (reference
    anchor_generator_op.h:55-84): per ratio and size, the base box of the
    stride's area (base_w = round(sqrt(area / ratio)), base_h =
    round(base_w * ratio), Python's round: half to even) scaled by
    size / stride, centered at i * stride + offset * (stride - 1), with
    corners at ± (side - 1) / 2.  Anchors (H, W, A, 4) in pixels."""
    feat = first(ins, "Input")
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(r) for r in attrs["aspect_ratios"]]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = float(attrs.get("offset", 0.5))
    ws, hs = [], []
    for r in ratios:
        for s in sizes:
            area = stride[0] * stride[1]
            base_w = round((area / r) ** 0.5)
            base_h = round(base_w * r)
            ws.append(float(base_w) * (s / stride[0]))
            hs.append(float(base_h) * (s / stride[1]))
    bw = (_const(ws, feat) - 1.0) / 2.0
    bh = (_const(hs, feat) - 1.0) / 2.0
    a = len(ws)
    f32 = torch.float32
    cx = torch.arange(w, dtype=f32, device=feat.device) * stride[0] \
        + offset * (stride[0] - 1)
    cy = torch.arange(h, dtype=f32, device=feat.device) * stride[1] \
        + offset * (stride[1] - 1)
    cxg = cx[None, :, None].expand(h, w, a)
    cyg = cy[:, None, None].expand(h, w, a)
    anchors = torch.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh], dim=-1)
    var = _const(variances, feat).expand(h, w, a, 4)
    return out(Anchors=anchors.to(feat.dtype), Variances=var.to(feat.dtype))


@register_op("density_prior_box")
def density_prior_box(ctx, ins, attrs):
    """Dense SSD priors (reference density_prior_box_op.h:65-90): for
    each fixed size with density d and each fixed ratio, a d x d
    sub-grid of shifted boxes per cell; one integer step_average =
    int((step_w + step_h) / 2) drives both axes' shift."""
    feat = first(ins, "Input")
    image = first(ins, "Image")
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    fixed_sizes = [float(s) for s in attrs["fixed_sizes"]]
    fixed_ratios = [float(r) for r in attrs["fixed_ratios"]]
    densities = [int(d) for d in attrs["densities"]]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / w
    step_h = float(attrs.get("step_h", 0.0)) or img_h / h
    offset = float(attrs.get("offset", 0.5))
    step_average = int((step_w + step_h) * 0.5)
    centers_x, centers_y, ws, hs = [], [], [], []
    for size, dens in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw_ = size * ratio ** 0.5
            bh_ = size / ratio ** 0.5
            shift = step_average // dens
            for dy in range(dens):
                for dx in range(dens):
                    centers_x.append(
                        -step_average / 2.0 + shift / 2.0 + dx * shift)
                    centers_y.append(
                        -step_average / 2.0 + shift / 2.0 + dy * shift)
                    ws.append(bw_ / 2.0)
                    hs.append(bh_ / 2.0)
    p = len(ws)
    f32 = torch.float32
    cx = (torch.arange(w, dtype=f32, device=feat.device) + offset) * step_w
    cy = (torch.arange(h, dtype=f32, device=feat.device) + offset) * step_h
    cxg = (cx[None, :, None] + _const(centers_x, feat)[None, None, :])
    cyg = (cy[:, None, None] + _const(centers_y, feat)[None, None, :])
    boxes = _grid_boxes(cxg.expand(h, w, p), cyg.expand(h, w, p),
                        _const(ws, feat), _const(hs, feat), img_w, img_h,
                        attrs.get("clip", True))
    var = _const(variances, feat).expand(h, w, p, 4)
    return out(Boxes=boxes.to(feat.dtype), Variances=var.to(feat.dtype))


# ---------------------------------------------------------------------------
# box_coder / box_clip / iou_similarity / polygon_box_transform
# ---------------------------------------------------------------------------

@register_op("box_coder")
def box_coder(ctx, ins, attrs):
    """Encode/decode boxes against priors in center-size form
    (reference box_coder_op.cc).  PriorBox (M, 4), PriorBoxVar (M, 4)
    optional; encode: TargetBox (N, 4) corner boxes → (N, M, 4) offsets;
    decode: (N, M, 4) offsets → (N, M, 4) corner boxes."""
    prior = first(ins, "PriorBox")
    pvar = opt_in(ins, "PriorBoxVar")
    target = first(ins, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    extra = 0.0 if bool(attrs.get("box_normalized", True)) else 1.0
    pw = prior[:, 2] - prior[:, 0] + extra
    ph = prior[:, 3] - prior[:, 1] + extra
    pcx = prior[:, 0] + pw / 2.0
    pcy = prior[:, 1] + ph / 2.0
    if pvar is None:
        pvar = torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                          device=prior.device)
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + extra
        th = target[:, 3] - target[:, 1] + extra
        tcx = target[:, 0] + tw / 2.0
        tcy = target[:, 1] + th / 2.0
        ox = ((tcx[:, None] - pcx[None, :]) / pw[None, :]) / pvar[None, :, 0]
        oy = ((tcy[:, None] - pcy[None, :]) / ph[None, :]) / pvar[None, :, 1]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :])) \
            / pvar[None, :, 2]
        oh = torch.log(torch.abs(th[:, None] / ph[None, :])) \
            / pvar[None, :, 3]
        o = torch.stack([ox, oy, ow, oh], dim=-1)
    elif code_type == "decode_center_size":
        dcx = pvar[None, :, 0] * target[..., 0] * pw[None, :] + pcx[None, :]
        dcy = pvar[None, :, 1] * target[..., 1] * ph[None, :] + pcy[None, :]
        dw = torch.exp(pvar[None, :, 2] * target[..., 2]) * pw[None, :]
        dh = torch.exp(pvar[None, :, 3] * target[..., 3]) * ph[None, :]
        o = torch.stack([dcx - dw / 2.0, dcy - dh / 2.0,
                         dcx + dw / 2.0 - extra, dcy + dh / 2.0 - extra],
                        dim=-1)
    else:
        raise ValueError(f"unknown code_type {code_type!r}")
    return out(OutputBox=o)


@register_op("box_clip")
def box_clip(ctx, ins, attrs):
    """Clip boxes to the image (reference box_clip_op.h): with ImInfo
    (N, 3) [h, w, scale] of the network input, to (h / scale - 1,
    w / scale - 1) of the original image; else to the im_shape attr."""
    boxes = first(ins, "Input")
    im_info = opt_in(ins, "ImInfo")
    if im_info is not None:
        scale = _maximum(im_info[:, 2], 1e-6)
        hmax = im_info[:, 0] / scale - 1.0
        wmax = im_info[:, 1] / scale - 1.0
        shape = (-1,) + (1,) * (boxes.dim() - 2)
        wmax, hmax = wmax.reshape(shape), hmax.reshape(shape)
        return out(Output=torch.stack(
            [_clip(boxes[..., 0], 0.0, wmax), _clip(boxes[..., 1], 0.0, hmax),
             _clip(boxes[..., 2], 0.0, wmax), _clip(boxes[..., 3], 0.0, hmax)],
            dim=-1))
    h, w = attrs["im_shape"]
    lo = torch.zeros(4, dtype=boxes.dtype, device=boxes.device)
    hi = _const([w - 1.0, h - 1.0, w - 1.0, h - 1.0], boxes)
    return out(Output=_clip(boxes, lo, hi))


def _iou_matrix(x, y, normalized=True):
    """Pairwise IoU of (..., A, 4) and (..., B, 4) corner boxes → (..., A,
    B); 0 where the union is not positive.  Pixel boxes (not
    normalized) count the +1 of the reference's JaccardOverlap."""
    extra = 0.0 if normalized else 1.0
    area_x = (x[..., 2] - x[..., 0] + extra) * (x[..., 3] - x[..., 1] + extra)
    area_y = (y[..., 2] - y[..., 0] + extra) * (y[..., 3] - y[..., 1] + extra)
    ix1 = torch.maximum(x[..., :, None, 0], y[..., None, :, 0])
    iy1 = torch.maximum(x[..., :, None, 1], y[..., None, :, 1])
    ix2 = torch.minimum(x[..., :, None, 2], y[..., None, :, 2])
    iy2 = torch.minimum(x[..., :, None, 3], y[..., None, :, 3])
    iw = _maximum(ix2 - ix1 + extra, 0.0)
    ih = _maximum(iy2 - iy1 + extra, 0.0)
    inter = iw * ih
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register_op("iou_similarity")
def iou_similarity(ctx, ins, attrs):
    """Pairwise IoU (reference iou_similarity_op.cc): X (N, 4), Y (M, 4)
    → (N, M)."""
    return out(Out=_iou_matrix(first(ins, "X"), first(ins, "Y"),
                               bool(attrs.get("box_normalized", True))))


@register_op("polygon_box_transform")
def polygon_box_transform(ctx, ins, attrs):
    """EAST-style geometry decode (reference
    polygon_box_transform_op.cc): even channels 4 * x_pixel - offset,
    odd channels 4 * y_pixel - offset."""
    x = first(ins, "Input")
    _n, c, h, w = x.shape
    f32 = torch.float32
    xs = torch.arange(w, dtype=f32, device=x.device)[None, None, None, :] \
        * 4.0
    ys = torch.arange(h, dtype=f32, device=x.device)[None, None, :, None] \
        * 4.0
    even = (torch.arange(c, device=x.device) % 2 == 0).reshape(1, c, 1, 1)
    xf = x.to(f32)
    return {"Output": [torch.where(even, xs - xf, ys - xf).to(x.dtype)]}


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _eta_table(thr, eta, k):
    """Thresholds by the number of candidates kept so far: T[0] the
    float32 threshold, T[m + 1] = T[m] * eta (float32) while T[m] > 0.5,
    as the reference's loop shrinks it after each kept candidate."""
    t = [np.float32(thr)]
    e = np.float32(eta)
    for _ in range(k):
        t.append(np.float32(t[-1] * e) if t[-1] > 0.5 else t[-1])
    return np.asarray(t, np.float32)


def _nms_keep(iou, valid, thr, eta, op):
    """The reference's sequential keep loop (`_nms_class`) as the fixed
    point of keep <- valid & ~any_j(keep[j] & iou[i, j] > thr_i & j < i)
    over rows of candidates in score order.  iou (B, k, k), valid (B,
    k) → keep (B, k).  thr_i is the float32 threshold, or with eta < 1
    the table entry of the number kept before i."""
    b, k = valid.shape
    if valid.device.type == "meta" or k == 0:
        return valid
    lower = torch.ones((k, k), dtype=torch.bool,
                       device=valid.device).tril(-1)
    if eta < 1.0:
        table = torch.tensor(_eta_table(thr, eta, k), device=valid.device)
    else:
        sup_mat = (iou > torch.tensor(np.float32(thr), device=iou.device)) \
            & lower
    keep = valid
    n_iter = 0
    while True:
        n_iter += 1
        if eta < 1.0:
            kept = keep.to(torch.int64)
            thr_i = table[torch.cumsum(kept, dim=1) - kept]      # (B, k)
            sup_mat = (iou > thr_i[:, :, None]) & lower
        sup = (sup_mat & keep[:, None, :]).any(dim=2)
        new = valid & ~sup
        if torch.equal(new, keep):
            break
        keep = new
    nms_iterations[op] = n_iter
    return keep


def _nms_class(boxes, scores, score_threshold, nms_threshold, top_k,
               normalized, nms_eta, op):
    """Single-class NMS over the top_k candidates of each row: boxes
    (B, M, 4), scores (B, M) → (top scores, keep mask, order), each
    (B, k)."""
    k = min(top_k, scores.shape[-1])
    if k < 0:
        raise ValueError(
            f"{op}: top_k {top_k} is negative (the reference's lax.top_k "
            f"refuses k = -1; pass the candidate count for 'all')")
    top_scores, order = stable_top_k(scores, k)
    with torch.no_grad():
        cand = torch.gather(boxes.detach(), 1,
                            order[..., None].expand(order.shape + (4,)))
        iou = _iou_matrix(cand, cand, normalized)
        valid0 = top_scores.detach() > torch.tensor(
            np.float32(score_threshold), device=scores.device)
        keep = _nms_keep(iou, valid0, nms_threshold, nms_eta, op)
    return top_scores, keep & valid0, order


@register_op("multiclass_nms")
def multiclass_nms(ctx, ins, attrs):
    """reference multiclass_nms_op.cc with a static-shape contract:
    BBoxes (N, M, 4), Scores (N, C, M) → Out (N, keep_top_k, 6) rows
    [label, score, x1, y1, x2, y2] padded with -1, NmsRoisNum (N,)
    counts.  Per class (but the background) NMS over its nms_top_k
    best, then the keep_top_k best of all classes (ties: class order,
    then rank)."""
    bboxes = first(ins, "BBoxes")
    scores = first(ins, "Scores")
    background = int(attrs.get("background_label", 0))
    score_th = float(attrs.get("score_threshold", 0.0))
    nms_top_k = int(attrs.get("nms_top_k", 100))
    nms_th = float(attrs.get("nms_threshold", 0.3))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    normalized = bool(attrs.get("normalized", True))
    nms_eta = float(attrs.get("nms_eta", 1.0))
    n, c, m = scores.shape
    classes = [cl for cl in range(c) if cl != background]
    cc = len(classes)
    sc = scores[:, classes]                                   # (N, C', M)
    bx = bboxes[:, None].expand(n, cc, m, 4).reshape(n * cc, m, 4)
    s, keep, order = _nms_class(bx, sc.reshape(n * cc, m), score_th, nms_th,
                                nms_top_k, normalized, nms_eta,
                                "multiclass_nms")
    k = s.shape[-1]
    neg = torch.full((), -1e30, dtype=scores.dtype, device=scores.device)
    cat_s = torch.where(keep, s, neg).reshape(n, cc * k)
    cat_i = order.reshape(n, cc * k)
    cat_l = torch.tensor(classes, dtype=torch.int32,
                         device=scores.device).repeat_interleave(k)
    kk = min(keep_top_k, cc * k)
    top_s, pick = stable_top_k(cat_s, kk)
    valid = top_s > neg / 2
    lab = torch.where(valid, cat_l[pick], torch.full_like(pick, -1,
                                                          dtype=torch.int32))
    idx = torch.gather(cat_i, 1, pick)
    box = torch.gather(bboxes, 1, idx[..., None].expand(n, kk, 4))
    rows = torch.cat([lab[..., None].to(bboxes.dtype), top_s[..., None],
                      box], dim=2)
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1.0))
    if kk < keep_top_k:
        rows = F.pad(rows, (0, 0, 0, keep_top_k - kk), value=-1.0)
    counts = valid.sum(dim=1).to(torch.int32)
    return out(Out=rows, NmsRoisNum=counts)


@register_op("generate_proposals")
def generate_proposals(ctx, ins, attrs):
    """RPN proposals (reference generate_proposals_op.cc): decode the
    anchor deltas, clip to the image, mask boxes under min_size (floored
    to 1, measured in the original image) or centered outside it, NMS
    (pixel IoU) over the whole pre_nms_topN pool, keep post_nms_topN.
    Inputs Scores (N, A, H, W), BboxDeltas (N, 4A, H, W), ImInfo (N, 3),
    Anchors and Variances (H, W, A, 4); RpnRois (N, post_nms_topN, 4)
    zero-padded, RpnRoisNum (N,).  The exp of the size deltas is taken
    in float64 and rounded once, so the card and the CPU decode the same
    boxes and keep the same sets."""
    scores = first(ins, "Scores")
    deltas = first(ins, "BboxDeltas")
    im_info = first(ins, "ImInfo")
    anchors = first(ins, "Anchors").reshape(-1, 4)
    variances = first(ins, "Variances").reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))
    eta = float(attrs.get("eta", 1.0))
    n, a, h, w = scores.shape
    pre_n = min(pre_n, a * h * w)
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw / 2.0
    acy = anchors[:, 1] + ah / 2.0

    def exp32(v):
        return torch.exp(_clip(v, -10, 10).double()).to(v.dtype)

    cx = acx + dl[..., 0] * variances[:, 0] * aw
    cy = acy + dl[..., 1] * variances[:, 1] * ah
    bw = aw * exp32(dl[..., 2] * variances[:, 2])
    bh = ah * exp32(dl[..., 3] * variances[:, 3])
    wmax = (im_info[:, 1] - 1.0)[:, None]
    hmax = (im_info[:, 0] - 1.0)[:, None]
    x1 = _clip(cx - bw / 2.0, 0.0, wmax)
    y1 = _clip(cy - bh / 2.0, 0.0, hmax)
    x2 = _clip(cx + bw / 2.0, 0.0, wmax)
    y2 = _clip(cy + bh / 2.0, 0.0, hmax)
    boxes = torch.stack([x1, y1, x2, y2], dim=2)              # (N, T, 4)
    msize = max(min_size, 1.0)
    scale_ = _maximum(im_info[:, 2], 1e-6)[:, None]
    ws_orig = (x2 - x1) / scale_ + 1.0
    hs_orig = (y2 - y1) / scale_ + 1.0
    cx_c = x1 + (x2 - x1 + 1.0) / 2.0
    cy_c = y1 + (y2 - y1 + 1.0) / 2.0
    keep_size = ((ws_orig >= msize) & (hs_orig >= msize)
                 & (cx_c <= im_info[:, 1:2]) & (cy_c <= im_info[:, 0:1]))
    s_masked = torch.where(keep_size, sc, torch.full_like(sc, -1e9))
    top_s, top_i = stable_top_k(s_masked, pre_n)
    cand = torch.gather(boxes, 1, top_i[..., None].expand(n, pre_n, 4))
    kept_s, keep, order = _nms_class(cand, top_s, -1e8, nms_thresh, pre_n,
                                     False, eta, "generate_proposals")
    sel = torch.where(keep, kept_s, torch.full_like(kept_s, -1e30))
    final_s, pick = stable_top_k(sel, min(post_n, sel.shape[1]))
    valid = final_s > -1e29
    idx = torch.gather(order, 1, pick)
    rois = torch.gather(cand, 1, idx[..., None].expand(idx.shape + (4,)))
    rois = torch.where(valid[..., None], rois, torch.zeros_like(rois))
    if rois.shape[1] < post_n:
        rois = F.pad(rois, (0, 0, 0, post_n - rois.shape[1]))
        valid = F.pad(valid, (0, post_n - valid.shape[1]))
    return out(RpnRois=rois, RpnRoisNum=valid.sum(dim=1).to(torch.int32))


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

@register_op("bipartite_match")
def bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching (reference bipartite_match_op.cc):
    min(R, C) times take the globally best (row, col) pair (the first in
    row-major order among ties) while it is positive, retiring both;
    then, with match_type 'per_prediction', match the columns left
    whose best row reaches dist_threshold.  DistMat (R, C) →
    ColToRowMatchIndices (1, C) int32 (-1 unmatched), ColToRowMatchDist
    (1, C)."""
    dist = first(ins, "DistMat")
    r, c = dist.shape
    dev = dist.device
    neg = torch.full((), -1e9, dtype=dist.dtype, device=dev)
    col_idx = torch.full((c,), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((c,), dtype=dist.dtype, device=dev)
    rows, cols = torch.arange(r, device=dev), torch.arange(c, device=dev)
    d = dist
    for _ in range(min(r, c)):
        flat = torch.argmax(d.reshape(-1))
        i, j = flat // c, flat % c
        best = d.reshape(-1).gather(0, flat.reshape(1)).reshape(())
        ok = best > 0
        at_j = (cols == j) & ok
        col_idx = torch.where(at_j, i.to(torch.int32), col_idx)
        col_dist = torch.where(at_j, best, col_dist)
        d = torch.where(((rows == i)[:, None] | (cols == j)[None, :]) & ok,
                        neg, d)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        thr = float(attrs.get("dist_threshold", 0.5))
        best_val, best_row = torch.max(dist, dim=0)
        extra = (col_idx < 0) & (best_val >= thr)
        col_idx = torch.where(extra, best_row.to(torch.int32), col_idx)
        col_dist = torch.where(extra, best_val, col_dist)
    return out(ColToRowMatchIndices=col_idx[None, :],
               ColToRowMatchDist=col_dist[None, :])


@register_op("target_assign")
def target_assign(ctx, ins, attrs):
    """Scatter per-gt attributes onto matched priors (reference
    target_assign_op.cc): Out[j] = X[MatchIndices[j]] where matched,
    else mismatch_value (broadcast as the reference's where
    broadcasts); OutWeight 1/0."""
    x = first(ins, "X")
    match = first(ins, "MatchIndices").reshape(-1).to(torch.int64)
    mismatch = attrs.get("mismatch_value", 0)
    matched = match >= 0
    gathered = x[torch.clamp(match, 0, x.shape[0] - 1)]
    o = torch.where(matched[:, None], gathered,
                    torch.full_like(gathered, mismatch))
    return out(Out=o, OutWeight=matched.to(torch.float32)[:, None])


# ---------------------------------------------------------------------------
# RPN targets, proposal labels, hard examples
# ---------------------------------------------------------------------------

def _pixel_iou(a, b):
    """(..., A, 4) x (..., G, 4) pixel IoU with the +1 convention
    (bbox_util.h BboxOverlaps) → (..., A, G)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = _maximum(x2 - x1 + 1.0, 0.0)
    ih = _maximum(y2 - y1 + 1.0, 0.0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _box_to_delta(ex, gt, weights=None):
    """bbox_util.h BoxToDelta with normalized=false (+1 widths); boxes
    (..., 4) → deltas (..., 4)."""
    ex_w = ex[..., 2] - ex[..., 0] + 1.0
    ex_h = ex[..., 3] - ex[..., 1] + 1.0
    ex_cx = ex[..., 0] + 0.5 * ex_w
    ex_cy = ex[..., 1] + 0.5 * ex_h
    gt_w = gt[..., 2] - gt[..., 0] + 1.0
    gt_h = gt[..., 3] - gt[..., 1] + 1.0
    gt_cx = gt[..., 0] + 0.5 * gt_w
    gt_cy = gt[..., 1] + 0.5 * gt_h
    d = torch.stack([
        (gt_cx - ex_cx) / ex_w,
        (gt_cy - ex_cy) / ex_h,
        torch.log(_maximum(gt_w, 1e-6) / _maximum(ex_w, 1e-6)),
        torch.log(_maximum(gt_h, 1e-6) / _maximum(ex_h, 1e-6)),
    ], dim=-1)
    if weights is not None:
        d = d / _const(weights, d)
    return d


def _sample_budget(cand, budget, gen, use_random):
    """Up to `budget` (a number or an (N,) tensor) of each row's
    candidates in a bool mask (N, K): ranked by a uniform draw from
    `gen` when use_random, else by ascending index, as the reference's
    non-random path; the top min(budget, count) kept.  → (selected
    mask, (N,) int32 counts)."""
    n, k = cand.shape
    dev = cand.device
    if use_random and gen is not None:
        priority = torch.rand((n, k), generator=gen, device=dev)
    elif use_random:
        priority = torch.zeros((n, k), device=dev)
    else:
        priority = -torch.arange(k, dtype=torch.float32,
                                 device=dev).expand(n, k)
    score = torch.where(cand, priority, torch.full_like(priority,
                                                        float("-inf")))
    order = torch.argsort(-score, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(k, device=dev).expand(n, k))
    count = cand.sum(dim=1).to(torch.int32)
    count = torch.clamp(count, max=budget) if not isinstance(
        budget, torch.Tensor) else torch.minimum(count,
                                                 budget.to(torch.int32))
    return cand & (rank < count[:, None]), count


def _compact(masks_and_cats, total):
    """Stable-compact each row's selections (N, K) to the front: lower
    category first, index order within one (float keys cat * K + index,
    exact below 2^24).  → (order (N, total) row ids, garbage past the
    count; (N,) int32 counts)."""
    n, k = masks_and_cats[0][0].shape
    dev = masks_and_cats[0][0].device
    ar = torch.arange(k, dtype=torch.float32, device=dev)
    key = torch.full((n, k), 1e9, dtype=torch.float32, device=dev)
    for mask, cat in masks_and_cats:
        key = torch.where(mask, cat * float(k) + ar, key)
    order = torch.argsort(key, dim=1, stable=True)
    if k < total:
        order = F.pad(order, (0, total - k))
    count = sum(m.sum(dim=1).to(torch.int32) for m, _ in masks_and_cats)
    return order[:, :total], count


def _take_rows(x, idx):
    """x (N, K, ...) at row ids idx (N, S) → (N, S, ...)."""
    ix = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, ix.expand(tuple(idx.shape)
                                        + tuple(x.shape[2:])))


@register_op("rpn_target_assign")
def rpn_target_assign(ctx, ins, attrs):
    """RPN anchor targets (reference rpn_target_assign_op.cc): positives
    are anchors inside the image (within rpn_straddle_thresh) that are a
    gt's best (within 1e-5) or reach rpn_positive_overlap; negatives
    stay under rpn_negative_overlap; fg_fraction * batch_size_per_im fg,
    the rest bg.  Outputs in fixed slots (F fg, S score slots):
    LocationIndex (N, F), TargetBBox (N, F, 4), BBoxInsideWeight (N, F,
    4), ScoreIndex (N, S) (fg then bg), TargetLabel (N, S), ScoreWeight
    (N, S) 1 on active slots, ForegroundNumber (N,).  The reference's
    documented divergences are kept: a uniform-random subset replaces
    the reservoir walk, and a selected fg anchor is never a bg
    candidate (the reference's bg-overwrites-fg quirk, :219, is not
    copied).  Batched over the images."""
    anchor = first(ins, "Anchor").to(torch.float32)
    gt_boxes = first(ins, "GtBoxes").to(torch.float32)
    gt_num = opt_in(ins, "GtNum")
    is_crowd = opt_in(ins, "IsCrowd")
    im_info = first(ins, "ImInfo").to(torch.float32)
    s_total = int(attrs.get("rpn_batch_size_per_im", 256))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_ov = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_ov = float(attrs.get("rpn_negative_overlap", 0.3))
    use_random = bool(attrs.get("use_random", True))
    f_total = int(fg_frac * s_total)
    n, g = gt_boxes.shape[0], gt_boxes.shape[1]
    a = anchor.shape[0]
    dev = anchor.device
    if gt_num is None:
        gt_num = torch.full((n,), g, dtype=torch.int32, device=dev)
    if is_crowd is None:
        is_crowd = torch.zeros((n, g), dtype=torch.int32, device=dev)
    gen = ctx.rng() if use_random else None
    im_h, im_w, im_scale = (im_info[:, j:j + 1] for j in range(3))
    if straddle >= 0:
        inside = ((anchor[None, :, 0] >= -straddle)
                  & (anchor[None, :, 1] >= -straddle)
                  & (anchor[None, :, 2] < im_w + straddle)
                  & (anchor[None, :, 3] < im_h + straddle))     # (N, A)
    else:
        inside = torch.ones((n, a), dtype=torch.bool, device=dev)
    gt_valid = (torch.arange(g, device=dev)[None, :] < gt_num[:, None]) \
        & (is_crowd == 0)                                        # (N, G)
    gts_sc = gt_boxes * im_scale[:, :, None]
    iou = _pixel_iou(anchor[None], gts_sc)                       # (N, A, G)
    m1 = torch.full_like(iou, -1.0)
    iou = torch.where(gt_valid[:, None, :], iou, m1)
    iou = torch.where(inside[:, :, None], iou, m1)
    if g:
        a2g_max, a2g_arg = torch.max(iou, dim=2)
    else:
        a2g_max = torch.zeros((n, a), device=dev)
        a2g_arg = torch.zeros((n, a), dtype=torch.int64, device=dev)
    g2a_max = torch.amax(iou, dim=1, keepdim=True)               # (N, 1, G)
    is_gt_best = (gt_valid[:, None, :] & (g2a_max > 0)
                  & (torch.abs(iou - g2a_max) < 1e-5)).any(dim=2)
    fg_cand = inside & (is_gt_best | (a2g_max >= pos_ov))
    fg_sel, fg_cnt = _sample_budget(fg_cand, f_total, gen, use_random)
    bg_cand = inside & (a2g_max < neg_ov) & ~fg_sel
    bg_sel, _ = _sample_budget(bg_cand, s_total - fg_cnt, gen, use_random)
    loc_order, _ = _compact([(fg_sel, 0.0)], f_total)            # (N, F)
    fg_active = torch.arange(f_total, device=dev)[None, :] < fg_cnt[:, None]
    tgt_gt = _take_rows(gts_sc, torch.gather(a2g_arg, 1, loc_order))
    tgt_bbox = _box_to_delta(anchor[loc_order], tgt_gt)
    tgt_bbox = torch.where(fg_active[..., None], tgt_bbox,
                           torch.zeros_like(tgt_bbox))
    inside_w = fg_active[..., None].to(torch.float32).expand(
        n, f_total, 4).contiguous()
    score_order, score_cnt = _compact([(fg_sel, 0.0), (bg_sel, 1.0)],
                                      s_total)
    s_slot = torch.arange(s_total, device=dev)[None, :]
    score_active = s_slot < score_cnt[:, None]
    labels = (s_slot < fg_cnt[:, None]).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return {"LocationIndex": [torch.where(fg_active, loc_order, zero).to(
                torch.int32)],
            "TargetBBox": [tgt_bbox],
            "BBoxInsideWeight": [inside_w],
            "ScoreIndex": [torch.where(score_active, score_order, zero).to(
                torch.int32)],
            "TargetLabel": [torch.where(score_active, labels,
                                        torch.zeros_like(labels))],
            "ScoreWeight": [score_active.to(torch.float32)],
            "ForegroundNumber": [fg_cnt]}


@register_op("generate_proposal_labels")
def generate_proposal_labels(ctx, ins, attrs):
    """Fast R-CNN head sampling (reference
    generate_proposal_labels_op.cc): the gts then the proposals (scaled
    back to the image) form the pool; rows over fg_thresh are fg
    candidates, rows in [bg_lo, bg_hi) bg; fg_fraction * batch fg, the
    rest bg.  Rois (N, B, 4) at image scale, LabelsInt32 (N, B) (bg 0,
    padded slots -1), BboxTargets / BboxInsideWeights /
    BboxOutsideWeights (N, B, 4C) in the label's four columns, RoisNum
    (N,).  Crowd gts stay columns of the overlaps and are disqualified
    as rows; an image with no valid gt gives all-background samples.
    Batched over the images."""
    rois_in = first(ins, "RpnRois").to(torch.float32)
    rois_num = opt_in(ins, "RpnRoisNum")
    gt_classes = first(ins, "GtClasses")
    is_crowd = opt_in(ins, "IsCrowd")
    gt_boxes = first(ins, "GtBoxes").to(torch.float32)
    gt_num = opt_in(ins, "GtNum")
    im_info = first(ins, "ImInfo").to(torch.float32)
    b_total = int(attrs.get("batch_size_per_im", 256))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    reg_w = [float(v) for v in attrs.get("bbox_reg_weights",
                                         [0.1, 0.1, 0.2, 0.2])]
    class_nums = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    f_total = int(b_total * fg_frac)
    n, r = rois_in.shape[0], rois_in.shape[1]
    g = gt_boxes.shape[1]
    dev = rois_in.device
    if rois_num is None:
        rois_num = torch.full((n,), r, dtype=torch.int32, device=dev)
    if gt_num is None:
        gt_num = torch.full((n,), g, dtype=torch.int32, device=dev)
    if is_crowd is None:
        is_crowd = torch.zeros((n, g), dtype=torch.int32, device=dev)
    gen = ctx.rng() if use_random else None
    im_scale = _maximum(im_info[:, 2], 1e-6)[:, None, None]     # (N, 1, 1)
    boxes = torch.cat([gt_boxes, rois_in / im_scale], dim=1)    # (N, K, 4)
    gt_valid_col = torch.arange(g, device=dev)[None, :] < gt_num[:, None]
    row_valid = torch.cat(
        [gt_valid_col,
         torch.arange(r, device=dev)[None, :] < rois_num[:, None]], dim=1)
    iou = _pixel_iou(boxes, gt_boxes)                           # (N, K, G)
    iou = torch.where(gt_valid_col[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    max_ov, gt_arg = torch.max(iou, dim=2)
    max_ov = _maximum(max_ov, 0.0)
    is_crowd_row = torch.cat(
        [(is_crowd != 0) & gt_valid_col,
         torch.zeros((n, r), dtype=torch.bool, device=dev)], dim=1)
    max_ov = torch.where(is_crowd_row, torch.full_like(max_ov, -1.0), max_ov)
    max_ov = torch.where(row_valid, max_ov, torch.full_like(max_ov, -2.0))
    fg_sel, fg_cnt = _sample_budget(max_ov > fg_thresh, f_total, gen,
                                    use_random)
    bg_sel, _ = _sample_budget((max_ov >= bg_lo) & (max_ov < bg_hi),
                               b_total - fg_cnt, gen, use_random)
    order, count = _compact([(fg_sel, 0.0), (bg_sel, 1.0)], b_total)
    slot = torch.arange(b_total, device=dev)[None, :]
    active = slot < count[:, None]
    is_fg = slot < fg_cnt[:, None]
    sampled = _take_rows(boxes, order)                          # (N, B, 4)
    arg = torch.gather(gt_arg, 1, order)
    labels = torch.where(
        is_fg, torch.gather(gt_classes, 1, arg).to(torch.int32),
        torch.where(active, 0, -1).to(torch.int32))
    deltas = _box_to_delta(sampled, _take_rows(gt_boxes, arg), reg_w)
    deltas = torch.where(is_fg[..., None], deltas, torch.zeros_like(deltas))
    cls_ids = torch.clamp(labels, 0, class_nums - 1)
    col = (cls_ids[..., None] == torch.arange(class_nums, device=dev)).to(
        torch.float32)                                          # (N, B, C)
    expanded = (col[..., None] * deltas[:, :, None, :]).reshape(
        n, b_total, 4 * class_nums)
    wt = is_fg[..., None].to(torch.float32) * col[..., None].expand(
        n, b_total, class_nums, 4).reshape(n, b_total, 4 * class_nums)
    rois_out = torch.where(active[..., None], sampled * im_scale,
                           torch.zeros_like(sampled))
    return {"Rois": [rois_out], "LabelsInt32": [labels],
            "BboxTargets": [torch.where(is_fg[..., None], expanded,
                                        torch.zeros_like(expanded))],
            "BboxInsideWeights": [wt], "BboxOutsideWeights": [wt],
            "RoisNum": [count]}


@register_op("mine_hard_examples")
def mine_hard_examples(ctx, ins, attrs):
    """Hard-negative mining (reference mine_hard_examples_op.cc): per
    image the highest-loss eligible priors, min(neg_pos_ratio *
    positives, eligible) of the unmatched ones under neg_dist_threshold
    (max_negative), or min(sample_size, P) of all (hard_example, which
    also drops the unselected positives' matches).  NegIndices (N, P)
    ascending, padded with -1; NegMask (N, P); UpdatedMatchIndices."""
    cls_loss = first(ins, "ClsLoss").to(torch.float32)
    loc_loss = opt_in(ins, "LocLoss")
    match_idx = first(ins, "MatchIndices")
    match_dist = first(ins, "MatchDist").to(torch.float32)
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    thresh = float(attrs.get("neg_dist_threshold", 0.5))
    sample_size = int(attrs.get("sample_size", 0))
    mtype = attrs.get("mining_type", "max_negative")
    if mtype not in ("max_negative", "hard_example"):
        raise ValueError(f"unknown mining_type {mtype!r}")
    n, p = cls_loss.shape
    dev = cls_loss.device
    loss = cls_loss
    if mtype == "hard_example" and loc_loss is not None:
        loss = cls_loss + loc_loss.to(torch.float32)
    if mtype == "max_negative":
        eligible = (match_idx == -1) & (match_dist < thresh)
        num_pos = (match_idx != -1).sum(dim=1).to(torch.float32)
        budget = (num_pos * ratio).to(torch.int32)
    else:
        eligible = torch.ones((n, p), dtype=torch.bool, device=dev)
        budget = torch.full((n,), sample_size, dtype=torch.int32, device=dev)
    masked = torch.where(eligible, loss, torch.full_like(loss,
                                                         float("-inf")))
    order = torch.argsort(-masked, dim=1, stable=True)
    ar = torch.arange(p, device=dev)
    rank = torch.empty_like(order).scatter_(1, order, ar.expand(n, p))
    count = torch.minimum(eligible.sum(dim=1).to(torch.int32), budget)
    selected = eligible & (rank < count[:, None])
    if mtype == "hard_example":
        neg_sel = selected & (match_idx == -1)
        updated = torch.where((match_idx > -1) & ~selected,
                              torch.full_like(match_idx, -1), match_idx)
    else:
        neg_sel = selected
        updated = match_idx
    key = torch.where(neg_sel, ar.to(torch.float32)[None, :].expand(n, p),
                      torch.full((n, p), float("inf"), device=dev))
    neg_order = torch.argsort(key, dim=1, stable=True)
    neg_count = neg_sel.sum(dim=1)
    neg_idx = torch.where(ar[None, :] < neg_count[:, None], neg_order,
                          torch.full_like(neg_order, -1)).to(torch.int32)
    return {"NegIndices": [neg_idx],
            "NegMask": [neg_sel.to(torch.float32)],
            "UpdatedMatchIndices": [updated]}


# ---------------------------------------------------------------------------
# yolov3_loss
# ---------------------------------------------------------------------------

def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return _maximum(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _bce(logit, target):
    return _softplus(logit) - target * logit


@register_op("yolov3_loss")
def yolov3_loss(ctx, ins, attrs):
    """YOLOv3 training loss (reference yolov3_loss_op.cc): X (N, A*(5+K),
    H, W), GTBox (N, B, 4) normalized [cx, cy, w, h], GTLabel (N, B)
    (-1 or w == 0 rows are padding) → Loss (N,).  Each gt takes the best
    shape-only IoU anchor over all anchors and counts where that anchor
    is this head's; its cell index truncates toward zero.  The
    objectness target is a scatter-max over cells two gts may share;
    the per-gt gathers at a shared cell add their gradients."""
    x = first(ins, "X")
    gtbox = first(ins, "GTBox")
    gtlabel = first(ins, "GTLabel").to(torch.int64)
    anchors = [float(v) for v in attrs["anchors"]]
    mask = [int(m) for m in attrs.get("anchor_mask",
                                      range(len(anchors) // 2))]
    k = int(attrs["class_num"])
    ignore = float(attrs.get("ignore_thresh", 0.7))
    down = int(attrs.get("downsample_ratio", 32))
    n, _, h, w = x.shape
    a = len(mask)
    dev = x.device
    img_h, img_w = h * down, w * down
    x = x.reshape(n, a, 5 + k, h, w)
    tx, ty, tw, th, tobj = (x[:, :, j] for j in range(5))
    tcls = x[:, :, 5:]
    anchor_w = _const([anchors[2 * m] for m in mask], x)
    anchor_h = _const([anchors[2 * m + 1] for m in mask], x)
    all_w = _const(anchors[0::2], x)
    all_h = _const(anchors[1::2], x)
    gt_valid = (gtbox[..., 2] > 0) & (gtlabel >= 0)                # (N, B)
    gw = gtbox[..., 2] * img_w
    gh = gtbox[..., 3] * img_h
    inter = (torch.minimum(gw[..., None], all_w)
             * torch.minimum(gh[..., None], all_h))
    union = gw[..., None] * gh[..., None] + all_w * all_h - inter
    best_anchor = torch.argmax(inter / _maximum(union, 1e-9), dim=-1)
    gi = torch.clamp((gtbox[..., 0] * w).to(torch.int64), 0, w - 1)
    gj = torch.clamp((gtbox[..., 1] * h).to(torch.int64), 0, h - 1)
    f32 = x.dtype
    grid_x = torch.arange(w, dtype=f32, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, dtype=f32, device=dev)[None, None, :, None]
    px = _div(torch.sigmoid(tx) + grid_x, w)
    py = _div(torch.sigmoid(ty) + grid_y, h)
    pw = _div(torch.exp(_clip(tw, -10, 10))
              * anchor_w[None, :, None, None], img_w)
    ph = _div(torch.exp(_clip(th, -10, 10))
              * anchor_h[None, :, None, None], img_h)
    # predictions (N, A, H, W, 1) against gts (N, 1, 1, 1, B)
    g = gtbox[:, None, None, None]
    gx1, gy1 = g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2
    gx2, gy2 = g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2
    px_, py_, pw_, ph_ = (v[..., None] for v in (px, py, pw, ph))
    ix1 = torch.maximum(px_ - pw_ / 2, gx1)
    iy1 = torch.maximum(py_ - ph_ / 2, gy1)
    ix2 = torch.minimum(px_ + pw_ / 2, gx2)
    iy2 = torch.minimum(py_ + ph_ / 2, gy2)
    inter_p = _maximum(ix2 - ix1, 0.0) * _maximum(iy2 - iy1, 0.0)
    iou_pg = inter_p / _maximum(pw_ * ph_ + g[..., 2] * g[..., 3] - inter_p,
                                1e-9)
    iou_max = torch.amax(torch.where(gt_valid[:, None, None, None, :],
                                     iou_pg, torch.zeros_like(iou_pg)),
                         dim=-1)
    mask_arr = torch.tensor(mask, device=dev)
    hit = best_anchor[..., None] == mask_arr                        # (N, B, A)
    assigned = gt_valid & hit.any(-1)
    local_a = torch.argmax(hit.to(torch.int32), dim=-1)
    bix = torch.arange(n, device=dev)[:, None].expand_as(local_a)
    flat = ((bix * a + local_a) * h + gj) * w + gi
    obj_target = torch.zeros((n * a * h * w,), dtype=torch.float32,
                             device=dev).scatter_reduce(
        0, flat.reshape(-1), assigned.reshape(-1).to(torch.float32), "amax")
    obj_target = obj_target.reshape(n, a, h, w)
    noobj = ((obj_target == 0) & (iou_max <= ignore)).to(f32)
    obj_loss = (torch.sum(_bce(tobj, 1.0) * obj_target, dim=(1, 2, 3))
                + torch.sum(_bce(tobj, 0.0) * noobj, dim=(1, 2, 3)))

    def sel(arr):
        return arr[bix, local_a, gj, gi]                            # (N, B)

    scale = 2.0 - gtbox[..., 2] * gtbox[..., 3]
    tx_t = gtbox[..., 0] * w - gi.to(f32)
    ty_t = gtbox[..., 1] * h - gj.to(f32)
    aw, ah = anchor_w[local_a], anchor_h[local_a]
    tw_t = torch.log(_maximum(gw / _maximum(aw, 1e-9), 1e-9))
    th_t = torch.log(_maximum(gh / _maximum(ah, 1e-9), 1e-9))
    coord = (_bce(sel(tx), tx_t) + _bce(sel(ty), ty_t)) * scale \
        + (torch.square(sel(tw) - tw_t)
           + torch.square(sel(th) - th_t)) * 0.5 * scale
    cls_sel = tcls[bix, local_a, :, gj, gi]                         # (N, B, K)
    cls_target = (gtlabel[..., None] == torch.arange(k, device=dev)).to(f32)
    cls_loss = torch.sum(_bce(cls_sel, cls_target), dim=-1)
    per_gt = torch.where(assigned, coord + cls_loss,
                         torch.zeros_like(coord))
    return out(Loss=obj_loss + torch.sum(per_gt, dim=1))


# ---------------------------------------------------------------------------
# detection_map
# ---------------------------------------------------------------------------

@register_op("detection_map")
def detection_map(ctx, ins, attrs):
    """In-graph mean average precision (reference detection_map_op.h,
    11point or integral), on the reference's padded contract: DetectRes
    (N, M, 6) [label, score, box] (label < 0 padding), Label (N, G, 6)
    [label, box, difficult] (or 5 columns).  Detections clamp to [0, 1];
    each image's detections, by score, take their best same-class gt
    (IoU strictly over the threshold); one whose gt is taken is a false
    positive; a difficult match without evaluate_difficult counts
    neither way.  The loop over detections is batched over images.  The
    cross-batch state (metrics.DetectionMAP) is not in the op, as in the
    reference; MAP is a scalar."""
    det = first(ins, "DetectRes")
    gt = first(ins, "Label")
    class_num = int(attrs["class_num"])
    bg = attrs.get("background_label", 0)
    thr = float(attrs.get("overlap_threshold", 0.3))
    eval_difficult = bool(attrs.get("evaluate_difficult", True))
    ap_type = attrs.get("ap_type", "integral")
    n, m, _ = det.shape
    g = gt.shape[1]
    dev = det.device
    det_lbl = det[:, :, 0].to(torch.int32)
    det_score = det[:, :, 1]
    det_box = torch.clamp(det[:, :, 2:6], 0.0, 1.0)
    gt_lbl = gt[:, :, 0].to(torch.int32)
    gt_box = gt[:, :, 1:5]
    gt_diff = (gt[:, :, 5] > 0.5 if gt.shape[2] > 5
               else torch.zeros((n, g), dtype=torch.bool, device=dev))
    det_valid = det_lbl >= 0
    gt_valid = gt_lbl >= 0
    iou = _iou_matrix(det_box, gt_box)                             # (N, M, G)
    order = torch.argsort(-torch.where(det_valid, det_score,
                                       torch.full_like(det_score,
                                                       float("-inf"))),
                          dim=1, stable=True)
    ar_n = torch.arange(n, device=dev)
    ar_g = torch.arange(g, device=dev)
    visited = torch.zeros((n, g), dtype=torch.bool, device=dev)
    tp_o = torch.zeros((n, m), dtype=torch.bool, device=dev)
    fp_o = torch.zeros((n, m), dtype=torch.bool, device=dev)
    for t in range(m):
        di = order[:, t]
        dv = det_valid[ar_n, di]
        same = (gt_lbl == det_lbl[ar_n, di][:, None]) & gt_valid
        iou_i = torch.where(same, iou[ar_n, di], torch.full_like(
            iou[ar_n, di], -1.0))
        j = torch.argmax(iou_i, dim=1)
        hit = (iou_i[ar_n, j] > thr) & dv
        med = ~gt_diff[ar_n, j] | eval_difficult
        seen = visited[ar_n, j]
        tp = hit & med & ~seen
        fp = dv & (~hit | (hit & med & seen))
        visited = visited | ((ar_g[None, :] == j[:, None]) & tp[:, None])
        tp_o[ar_n, di] = tp
        fp_o[ar_n, di] = fp
    flat_score = det_score.reshape(-1)
    o = torch.argsort(-flat_score, stable=True)
    flat_lbl = det_lbl.reshape(-1)[o]
    flat_tp = tp_o.reshape(-1)[o]
    flat_fp = fp_o.reshape(-1)[o]
    counts_gt = gt_lbl.reshape(-1)
    counts_diff = gt_diff.reshape(-1)
    counts_valid = gt_valid.reshape(-1)
    classes = torch.tensor([c for c in range(class_num) if c != bg],
                           dtype=torch.int32, device=dev)
    f32 = torch.float32
    npos = (counts_valid[None] & (counts_gt[None] == classes[:, None])
            & (~counts_diff[None] | eval_difficult)).sum(dim=1)    # (Cc,)
    mine = (flat_lbl[None] == classes[:, None]) & (flat_tp | flat_fp)[None]
    ctp = torch.cumsum((mine & flat_tp[None]).to(torch.int32), dim=1)
    cfp = torch.cumsum((mine & flat_fp[None]).to(torch.int32), dim=1)
    prec = ctp.to(f32) / torch.clamp(ctp + cfp, min=1).to(f32)
    rec = ctp.to(f32) / torch.clamp(npos, min=1).to(f32)[:, None]
    if ap_type == "11point":
        pts = torch.cat([_div(torch.arange(10, dtype=f32, device=dev), 10),
                         torch.ones(1, dtype=f32, device=dev)])
        ok = mine[:, None, :] & (rec[:, None, :] >= pts[None, :, None])
        pmax = torch.amax(torch.where(ok, prec[:, None, :],
                                      torch.zeros((), device=dev)), dim=2)
        ap = _div(pmax.sum(dim=1), 11)
    else:
        new_tp = mine & flat_tp[None]
        ap = torch.where(new_tp, prec, torch.zeros((), device=dev)).sum(
            dim=1) / torch.clamp(npos, min=1).to(f32)
    has = (npos > 0) & mine.any(dim=1)
    n_eval = torch.clamp(has.sum(), min=1).to(f32)
    mean_ap = torch.where(has, ap, torch.zeros((), device=dev)).sum() / n_eval
    return {"MAP": [mean_ap]}


# ---------------------------------------------------------------------------
# roi_perspective_transform
# ---------------------------------------------------------------------------

@register_op("roi_perspective_transform")
def roi_perspective_transform(ctx, ins, attrs):
    """Perspective-warp quadrilateral ROIs to a fixed grid (reference
    roi_perspective_transform_op.cc): ROIs (R, 9) [batch_idx, x0, y0,
    .., x3, y3]; the homography of the estimated quad size maps the
    output grid into the map, sampled bilinearly, 0 outside the quad.
    Batched over the RoIs."""
    x = first(ins, "X")
    rois = first(ins, "ROIs").to(torch.float32)
    th = int(attrs["transformed_height"])
    tw = int(attrs["transformed_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, ih, iw = x.shape
    dev = x.device
    bix = rois[:, 0].to(torch.int64)
    quad = rois[:, 1:].reshape(-1, 4, 2) * scale
    rx, ry = quad[:, :, 0], quad[:, :, 1]                          # (R, 4)
    len1 = torch.hypot(rx[:, 0] - rx[:, 1], ry[:, 0] - ry[:, 1])
    len2 = torch.hypot(rx[:, 1] - rx[:, 2], ry[:, 1] - ry[:, 2])
    len3 = torch.hypot(rx[:, 2] - rx[:, 3], ry[:, 2] - ry[:, 3])
    len4 = torch.hypot(rx[:, 3] - rx[:, 0], ry[:, 3] - ry[:, 0])
    est_h = _maximum((len2 + len4) / 2.0, 1e-6)
    est_w = _maximum((len1 + len3) / 2.0, 1e-6)
    norm_h = float(th)
    norm_w = _minimum(torch.round(est_w * (norm_h - 1) / est_h) + 1,
                      float(tw))
    nw1 = _maximum(norm_w - 1.0, 1e-6)
    nh1 = float(th - 1) if th > 1 else 1e-6
    dx1, dx2 = rx[:, 1] - rx[:, 2], rx[:, 3] - rx[:, 2]
    dx3 = rx[:, 0] - rx[:, 1] + rx[:, 2] - rx[:, 3]
    dy1, dy2 = ry[:, 1] - ry[:, 2], ry[:, 3] - ry[:, 2]
    dy3 = ry[:, 0] - ry[:, 1] + ry[:, 2] - ry[:, 3]
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-9, torch.full_like(den, 1e-9), den)
    a31 = (dx3 * dy2 - dx2 * dy3) / den / nw1
    a32 = _div((dx1 * dy3 - dx3 * dy1) / den, nh1)
    a11 = (rx[:, 1] - rx[:, 0] + a31 * nw1 * rx[:, 1]) / nw1
    a12 = _div(rx[:, 3] - rx[:, 0] + a32 * nh1 * rx[:, 3], nh1)
    a21 = (ry[:, 1] - ry[:, 0] + a31 * nw1 * ry[:, 1]) / nw1
    a22 = _div(ry[:, 3] - ry[:, 0] + a32 * nh1 * ry[:, 3], nh1)
    ow = torch.arange(tw, dtype=torch.float32, device=dev)[None, None, :]
    oh = torch.arange(th, dtype=torch.float32, device=dev)[None, :, None]

    def aff(p, q, s):
        return p[:, None, None] * ow + q[:, None, None] * oh \
            + s[:, None, None]

    u = aff(a11, a12, rx[:, 0])
    v = aff(a21, a22, ry[:, 0])
    wgt = aff(a31, a32, torch.ones_like(a31))
    wgt = torch.where(torch.abs(wgt) < 1e-9, torch.full_like(wgt, 1e-9), wgt)
    src_x, src_y = u / wgt, v / wgt                                # (R, th, tw)
    crosses = []
    for kk in range(4):
        x1_, y1_ = rx[:, kk, None, None], ry[:, kk, None, None]
        x2_ = rx[:, (kk + 1) % 4, None, None]
        y2_ = ry[:, (kk + 1) % 4, None, None]
        crosses.append((x2_ - x1_) * (src_y - y1_)
                       - (y2_ - y1_) * (src_x - x1_))
    cr = torch.stack(crosses)
    eps = 1e-4
    inside = (cr >= -eps).all(dim=0) | (cr <= eps).all(dim=0)
    valid = (inside & (src_x >= -0.5) & (src_x <= iw - 0.5)
             & (src_y >= -0.5) & (src_y <= ih - 0.5))
    sx = _clip(src_x, 0.0, iw - 1.0)
    sy = _clip(src_y, 0.0, ih - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    lx, ly = sx - x0, sy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=iw - 1)
    y1 = torch.clamp(y0 + 1, max=ih - 1)
    r = rois.shape[0]
    xc = x.permute(0, 2, 3, 1).reshape(n, ih * iw, c)

    def at(yi, xi):
        return xc[bix[:, None], (yi * iw + xi).reshape(r, -1)].reshape(
            r, th, tw, c)

    def e(t):
        return t[..., None]

    val = (at(y0, x0) * e(1 - ly) * e(1 - lx) + at(y1, x0) * e(ly) * e(1 - lx)
           + at(y0, x1) * e(1 - ly) * e(lx) + at(y1, x1) * e(ly) * e(lx))
    val = torch.where(e(valid), val, torch.zeros((), dtype=val.dtype,
                                                 device=dev))
    return {"Out": [val.permute(0, 3, 1, 2).to(x.dtype)]}
