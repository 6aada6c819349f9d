"""Detection layers: the port of paddle_tpu/layers/detection.py, each
function the reference's, unchanged (reference: python/paddle/fluid/
layers/detection.py:1, 1812 LoC — the starter set: prior_box,
box_coder, iou_similarity, multiclass_nms, yolov3_loss, plus ssd-style
helpers).  Ops in ops/detection.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..layer_helper import LayerHelper


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """reference layers/detection.py prior_box."""
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance),
               "flip": bool(flip), "clip": bool(clip),
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": float(offset)})
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    """reference layers/detection.py box_coder."""
    helper = LayerHelper("box_coder", name=name)
    output = helper.create_variable_for_type_inference(target_box.dtype)
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=ins,
                     outputs={"OutputBox": [output]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return output


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    output = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [output]},
                     attrs={"box_normalized": box_normalized})
    return output


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  ap_version="integral", name=None):
    """reference layers/detection.py detection_map — in-graph per-batch
    mAP (padded-dense contract; cross-batch accumulation lives in
    metrics.DetectionMAP, see ops/detection.py)."""
    helper = LayerHelper("detection_map", name=name)
    map_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": [detect_res], "Label": [label]},
        outputs={"MAP": [map_out]},
        attrs={"class_num": class_num,
               "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    return map_out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """reference layers/detection.py multiclass_nms.  Static-shape
    contract: Out is (N, keep_top_k, 6) padded with -1 rows; the second
    return is the per-image valid count (replaces the LoD)."""
    helper = LayerHelper("multiclass_nms", name=name)
    output = helper.create_variable_for_type_inference(bboxes.dtype)
    rois_num = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [output], "NmsRoisNum": [rois_num]},
        attrs={"score_threshold": float(score_threshold),
               "nms_top_k": int(nms_top_k),
               "keep_top_k": int(keep_top_k),
               "nms_threshold": float(nms_threshold),
               "nms_eta": float(nms_eta),
               "background_label": int(background_label)})
    return output, rois_num


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=False, name=None):
    """reference layers/detection.py yolov3_loss."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="yolov3_loss",
        inputs={"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]},
        outputs={"Loss": [loss]},
        attrs={"anchors": [int(a) for a in anchors],
               "anchor_mask": [int(m) for m in anchor_mask],
               "class_num": int(class_num),
               "ignore_thresh": float(ignore_thresh),
               "downsample_ratio": int(downsample_ratio)})
    return loss


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             name=None):
    """Simplified SSD matching loss (reference layers/detection.py
    ssd_loss — bipartite + per-prediction matching with hard negative
    mining).  Composed from iou_similarity/box_coder + standard losses at
    the layer level; per-prior assignment is best-IoU with threshold
    (the per-prediction half of the reference's strategy)."""
    from . import nn as nn_layers
    from . import ops as ops_layers
    from . import tensor as tensor_layers

    # iou: (num_gt, num_prior); each prior matches its best gt
    iou = iou_similarity(gt_box, prior_box)
    best_gt = tensor_layers.argmax(iou, axis=0)          # (P,)
    best_iou = nn_layers.reduce_max(iou, dim=0)          # (P,)
    matched = tensor_layers.cast(
        nn_layers.greater_equal(
            best_iou, tensor_layers.fill_constant(
                [1], "float32", overlap_threshold)), "float32")

    # localization targets: encode each prior's matched gt against the
    # prior (center-size form — the 1:1 case of box_coder, written
    # elementwise because the op broadcasts all gt×prior pairs)
    gt_sel = nn_layers.gather(gt_box, best_gt)       # (P, 4)

    def _corners(v):
        return tuple(
            nn_layers.reshape(
                nn_layers.slice(v, axes=[1], starts=[i], ends=[i + 1]),
                [-1])
            for i in range(4))

    px1, py1, px2, py2 = _corners(prior_box)
    gx1, gy1, gx2, gy2 = _corners(gt_sel)
    pw = nn_layers.elementwise_sub(px2, px1)
    ph = nn_layers.elementwise_sub(py2, py1)
    pcx = nn_layers.elementwise_add(px1, nn_layers.scale(pw, 0.5))
    pcy = nn_layers.elementwise_add(py1, nn_layers.scale(ph, 0.5))
    gw = nn_layers.elementwise_sub(gx2, gx1)
    gh = nn_layers.elementwise_sub(gy2, gy1)
    gcx = nn_layers.elementwise_add(gx1, nn_layers.scale(gw, 0.5))
    gcy = nn_layers.elementwise_add(gy1, nn_layers.scale(gh, 0.5))
    ox = nn_layers.elementwise_div(
        nn_layers.elementwise_sub(gcx, pcx), pw)
    oy = nn_layers.elementwise_div(
        nn_layers.elementwise_sub(gcy, pcy), ph)
    ow = ops_layers.log(nn_layers.elementwise_div(gw, pw))
    oh = ops_layers.log(nn_layers.elementwise_div(gh, ph))
    target = tensor_layers.concat(
        [nn_layers.reshape(v, [-1, 1]) for v in (ox, oy, ow, oh)], axis=1)
    if prior_box_var is not None:
        # encode with the prior variances so box_coder's decode (which
        # multiplies by them) is the exact inverse at inference
        target = nn_layers.elementwise_div(target, prior_box_var)

    loc_l = nn_layers.reduce_sum(
        ops_layers.abs(nn_layers.elementwise_sub(location, target)), dim=1)
    loc_loss = nn_layers.reduce_sum(
        nn_layers.elementwise_mul(loc_l, matched))

    # confidence: matched priors take their gt's label, rest background
    lab_sel = tensor_layers.cast(
        nn_layers.gather(nn_layers.reshape(gt_label, [-1, 1]),
                             best_gt), "float32")
    bg = tensor_layers.fill_constant_batch_size_like(
        matched, [-1], "float32", float(background_label))
    one = tensor_layers.fill_constant_batch_size_like(
        matched, [-1], "float32", 1.0)
    labels = tensor_layers.cast(
        nn_layers.elementwise_add(
            nn_layers.elementwise_mul(
                nn_layers.reshape(lab_sel, [-1]), matched),
            nn_layers.elementwise_mul(
                bg, nn_layers.elementwise_sub(one, matched))), "int64")
    conf_l = nn_layers.reshape(nn_layers.softmax_with_cross_entropy(
        confidence, nn_layers.reshape(labels, [-1, 1])), [-1])
    # negative balancing: scale unmatched-prior losses so their expected
    # total is neg_pos_ratio × the positive count (a soft version of the
    # reference's hard-negative mining — top-k selection needs a dynamic
    # k that XLA's static shapes preclude; weighting preserves the same
    # positive/negative loss balance in expectation)
    num_pos = nn_layers.reduce_sum(matched)
    num_neg = nn_layers.elementwise_sub(
        tensor_layers.fill_constant([1], "float32",
                                    float(matched.shape[0])), num_pos)
    neg_w = nn_layers.elementwise_min(
        tensor_layers.fill_constant([1], "float32", 1.0),
        nn_layers.elementwise_div(
            nn_layers.scale(num_pos, scale=float(neg_pos_ratio)),
            nn_layers.elementwise_max(
                num_neg, tensor_layers.fill_constant([1], "float32",
                                                     1.0))))
    weights = nn_layers.elementwise_add(
        matched, nn_layers.elementwise_mul(
            nn_layers.elementwise_sub(one, matched),
            nn_layers.reshape(neg_w, [1])))
    conf_loss = nn_layers.reduce_sum(
        nn_layers.elementwise_mul(conf_l, weights))
    return nn_layers.elementwise_add(
        nn_layers.scale(loc_loss, scale=loc_loss_weight),
        nn_layers.scale(conf_loss, scale=conf_loss_weight))


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """reference layers/detection.py anchor_generator."""
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [var]},
        attrs={"anchor_sizes": [float(s) for s in anchor_sizes],
               "aspect_ratios": [float(r) for r in aspect_ratios],
               "variances": list(variance),
               "stride": [float(s) for s in stride],
               "offset": float(offset)})
    return anchors, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    """reference layers/detection.py density_prior_box."""
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"densities": [int(d) for d in densities],
               "fixed_sizes": [float(s) for s in fixed_sizes],
               "fixed_ratios": [float(r) for r in fixed_ratios],
               "variances": list(variance), "clip": bool(clip),
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": float(offset)})
    return boxes, var


def box_clip(input, im_info=None, im_shape=None, name=None):
    """reference layers/detection.py box_clip."""
    helper = LayerHelper("box_clip", name=name)
    output = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Input": [input]}
    attrs = {}
    if im_info is not None:
        ins["ImInfo"] = [im_info]
    elif im_shape is not None:
        attrs["im_shape"] = [int(s) for s in im_shape]
    else:
        raise ValueError("box_clip needs im_info or im_shape")
    helper.append_op(type="box_clip", inputs=ins,
                     outputs={"Output": [output]}, attrs=attrs)
    return output


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """reference layers/detection.py bipartite_match."""
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(
        dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_dist]},
        attrs={"match_type": match_type,
               "dist_threshold": float(dist_threshold)})
    return match_indices, match_dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    """reference layers/detection.py target_assign."""
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="target_assign",
        inputs={"X": [input], "MatchIndices": [matched_indices]},
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """reference layers/detection.py generate_proposals; static-shape
    contract: (N, post_nms_top_n, 4) zero-padded + valid counts."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    rois_num = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoisNum": [rois_num]},
        attrs={"pre_nms_topN": int(pre_nms_top_n),
               "post_nms_topN": int(post_nms_top_n),
               "nms_thresh": float(nms_thresh),
               "min_size": float(min_size),
               "eta": float(eta)})
    return rois, rois_num


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True,
                      gt_num=None, name=None):
    """RPN training-target assignment (reference layers/detection.py
    rpn_target_assign:54): samples fg/bg anchors, gathers the matching
    predictions, and returns
    (predicted_scores, predicted_location, target_label, target_bbox,
    bbox_inside_weight, score_weight).

    bbox_pred (N, A, 4), cls_logits (N, A, 1); gt_boxes (N, G, 4)
    zero-padded with `gt_num` valid counts (static-shape analog of the
    reference's LoD gt input); the extra score_weight return (absent in
    the reference, which emitted variable-length rows) masks padded
    sample slots and anchor_var is accepted for API parity."""
    from . import nn as nn_layers

    helper = LayerHelper("rpn_target_assign", name=name)
    loc_index = helper.create_variable_for_type_inference("int32")
    tgt_bbox = helper.create_variable_for_type_inference(bbox_pred.dtype)
    in_w = helper.create_variable_for_type_inference(bbox_pred.dtype)
    score_index = helper.create_variable_for_type_inference("int32")
    tgt_lbl = helper.create_variable_for_type_inference("int32")
    score_w = helper.create_variable_for_type_inference("float32")
    fg_num = helper.create_variable_for_type_inference("int32")
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "ImInfo": [im_info]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if gt_num is not None:
        ins["GtNum"] = [gt_num]
    helper.append_op(
        type="rpn_target_assign", inputs=ins,
        outputs={"LocationIndex": [loc_index], "TargetBBox": [tgt_bbox],
                 "BBoxInsideWeight": [in_w], "ScoreIndex": [score_index],
                 "TargetLabel": [tgt_lbl], "ScoreWeight": [score_w],
                 "ForegroundNumber": [fg_num]},
        attrs={"rpn_batch_size_per_im": int(rpn_batch_size_per_im),
               "rpn_straddle_thresh": float(rpn_straddle_thresh),
               "rpn_fg_fraction": float(rpn_fg_fraction),
               "rpn_positive_overlap": float(rpn_positive_overlap),
               "rpn_negative_overlap": float(rpn_negative_overlap),
               "use_random": bool(use_random)})
    # gather predictions at the sampled anchor slots (reference gathers
    # on the flattened pred tensors)
    pred_loc = nn_layers.batched_gather(bbox_pred, loc_index)
    pred_score = nn_layers.batched_gather(cls_logits, score_index)
    return (pred_score, pred_loc, tgt_lbl, tgt_bbox, in_w, score_w)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             rpn_rois_num=None, gt_num=None, name=None):
    """Fast-RCNN head sampling (reference layers/detection.py
    generate_proposal_labels:1648).  Returns (rois, labels_int32,
    bbox_targets, bbox_inside_weights, bbox_outside_weights, rois_num);
    all (N, B, ...) fixed-slot tensors with rois_num active counts."""
    helper = LayerHelper("generate_proposal_labels", name=name)
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    tgts = helper.create_variable_for_type_inference(rpn_rois.dtype)
    in_w = helper.create_variable_for_type_inference(rpn_rois.dtype)
    out_w = helper.create_variable_for_type_inference(rpn_rois.dtype)
    rois_num = helper.create_variable_for_type_inference("int32")
    ins = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
           "GtBoxes": [gt_boxes], "ImInfo": [im_info]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if rpn_rois_num is not None:
        ins["RpnRoisNum"] = [rpn_rois_num]
    if gt_num is not None:
        ins["GtNum"] = [gt_num]
    helper.append_op(
        type="generate_proposal_labels", inputs=ins,
        outputs={"Rois": [rois], "LabelsInt32": [labels],
                 "BboxTargets": [tgts], "BboxInsideWeights": [in_w],
                 "BboxOutsideWeights": [out_w], "RoisNum": [rois_num]},
        attrs={"batch_size_per_im": int(batch_size_per_im),
               "fg_fraction": float(fg_fraction),
               "fg_thresh": float(fg_thresh),
               "bg_thresh_hi": float(bg_thresh_hi),
               "bg_thresh_lo": float(bg_thresh_lo),
               "bbox_reg_weights": [float(v) for v in bbox_reg_weights],
               "class_nums": int(class_nums or 81),
               "use_random": bool(use_random)})
    return rois, labels, tgts, in_w, out_w, rois_num


def mine_hard_examples(cls_loss, loc_loss, match_indices, match_dist,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       sample_size=0, mining_type="max_negative",
                       name=None):
    """Hard-negative mining (reference detection/
    mine_hard_examples_op.cc).  Returns (neg_indices (N, P) padded -1,
    neg_mask (N, P), updated_match_indices)."""
    helper = LayerHelper("mine_hard_examples", name=name)
    neg_idx = helper.create_variable_for_type_inference("int32")
    neg_mask = helper.create_variable_for_type_inference("float32")
    updated = helper.create_variable_for_type_inference("int32")
    ins = {"ClsLoss": [cls_loss], "MatchIndices": [match_indices],
           "MatchDist": [match_dist]}
    if loc_loss is not None:
        ins["LocLoss"] = [loc_loss]
    helper.append_op(
        type="mine_hard_examples", inputs=ins,
        outputs={"NegIndices": [neg_idx], "NegMask": [neg_mask],
                 "UpdatedMatchIndices": [updated]},
        attrs={"neg_pos_ratio": float(neg_pos_ratio),
               "neg_dist_threshold": float(neg_dist_threshold),
               "sample_size": int(sample_size),
               "mining_type": mining_type})
    return neg_idx, neg_mask, updated


def polygon_box_transform(input, name=None):
    """EAST quad-geometry decode (reference layers/detection.py
    polygon_box_transform)."""
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              name=None):
    """Perspective-warp quad ROIs to a fixed grid (reference
    layers/detection.py roi_perspective_transform); rois (R, 9) with a
    leading batch index."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_perspective_transform",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"transformed_height": int(transformed_height),
               "transformed_width": int(transformed_width),
               "spatial_scale": float(spatial_scale)})
    return out
