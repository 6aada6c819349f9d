"""The detection family of paddle_tpu_torch, part two: the counterparts
of the reference's tests/test_detection_rpn.py and its
generate_proposals test (rpn_target_assign, generate_proposal_labels,
mine_hard_examples, polygon_box_transform, roi_perspective_transform),
each running the port and the JAX package on the same numpy inputs
(float outputs within rtol 2e-3 and atol 1e-6, integer outputs
exactly) beside the reference test's own checks, and beyond them:

- generate_proposals at a few hundred candidates an image: tied
  scores, chains of overlapping anchors, eta 1, 0.9 and 0.7, min_size,
  im_info scales: the same rois in the same order and the same counts;
- rpn_target_assign and generate_proposal_labels at a few hundred
  anchors and proposals with crowd gts and gt counts: with
  use_random=False every output equals the reference's; with
  use_random=True (the op's torch generator, ROADMAP C2) the samples
  keep the reference's invariants: budgets, fg and bg candidates only,
  no repeats, fg compacted first, targets of the sampled rows;
- roi_perspective_transform's gradient;
- a small Faster R-CNN program (2 images of 64 x 64, a cut ResNet-C4
  trunk with frozen affine_channel batch norms) built in both packages
  from chip_smoke.py's `faster_rcnn`: the same `Program.to_dict()`, the
  reference's initialized parameters carried across by
  convert.params_from_arrays (affine_channel's Scale and Bias among
  them), 3 momentum steps with use_random=False giving the reference's
  losses and samples, then the detection program (proposals, the head,
  box_coder, box_clip, multiclass_nms, detection_map) the reference's
  detections.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke
from torch_op_test import assert_same, check_op, run_torch_op_all
from torch_twin import PKGS, build, reference_arrays, scope_of

torch.set_num_threads(2)


def _pixel_iou_np(a, b):
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1 + 1, 0) * np.maximum(y2 - y1 + 1, 0)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _delta_np(ex, gt, w=(1, 1, 1, 1)):
    ex_w, ex_h = ex[2] - ex[0] + 1, ex[3] - ex[1] + 1
    gt_w, gt_h = gt[2] - gt[0] + 1, gt[3] - gt[1] + 1
    return np.array([
        ((gt[0] + 0.5 * gt_w) - (ex[0] + 0.5 * ex_w)) / ex_w / w[0],
        ((gt[1] + 0.5 * gt_h) - (ex[1] + 0.5 * ex_h)) / ex_h / w[1],
        np.log(gt_w / ex_w) / w[2], np.log(gt_h / ex_h) / w[3]],
        np.float32)


# -- the counterparts of tests/test_detection_rpn.py -----------------------

def _rpn_inputs():
    anchors = np.array([[0, 0, 9, 9], [20, 20, 39, 39], [26, 26, 45, 45],
                        [60, 60, 79, 79], [-20, -20, 5, 5],
                        [90, 90, 99, 99]], np.float32)
    gt = np.array([[[21, 21, 40, 40], [58, 58, 81, 81]]], np.float32)
    im_info = np.array([[100, 100, 1.0]], np.float32)
    return anchors, gt, im_info


def test_rpn_target_assign_deterministic():
    anchors, gt, im_info = _rpn_inputs()
    attrs = {"rpn_batch_size_per_im": 4, "rpn_fg_fraction": 0.5,
             "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
             "rpn_straddle_thresh": 0.0, "use_random": False}
    got = check_op("rpn_target_assign",
                 {"Anchor": anchors, "GtBoxes": gt, "ImInfo": im_info},
                 attrs)
    assert got["ForegroundNumber"][0] == 2
    assert set(got["LocationIndex"][0].tolist()) == {1, 3}
    assert got["ScoreWeight"][0].sum() == 4
    assert got["TargetLabel"][0].tolist() == [1, 1, 0, 0]
    assert set(got["ScoreIndex"][0, 2:].tolist()) <= {0, 5}
    iou = _pixel_iou_np(anchors, gt[0])
    for slot, aidx in enumerate(got["LocationIndex"][0].tolist()):
        np.testing.assert_allclose(
            got["TargetBBox"][0, slot],
            _delta_np(anchors[aidx], gt[0][iou[aidx].argmax()]),
            rtol=1e-4, atol=1e-5)


def test_rpn_target_assign_respects_crowd_and_gt_num():
    anchors, gt, im_info = _rpn_inputs()
    attrs = {"rpn_batch_size_per_im": 4, "rpn_fg_fraction": 0.5,
             "rpn_straddle_thresh": 0.0, "use_random": False}
    got = check_op("rpn_target_assign",
                 {"Anchor": anchors, "GtBoxes": gt, "ImInfo": im_info,
                  "IsCrowd": np.array([[0, 1]], np.int32)}, attrs)
    assert got["ForegroundNumber"][0] == 1
    assert got["LocationIndex"][0, 0] == 1
    got = check_op("rpn_target_assign",
                 {"Anchor": anchors, "GtBoxes": gt, "ImInfo": im_info,
                  "GtNum": np.array([1], np.int32)}, attrs)
    assert got["ForegroundNumber"][0] == 1


def test_generate_proposal_labels_deterministic():
    gt_boxes = np.array([[[10, 10, 29, 29], [50, 50, 69, 69]]], np.float32)
    rois = np.array([[[11, 11, 30, 30], [200, 200, 219, 219],
                      [52, 51, 70, 70], [150, 0, 169, 19]]], np.float32)
    attrs = {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
             "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
             "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 8,
             "use_random": False}
    got = check_op("generate_proposal_labels",
                 {"RpnRois": rois, "GtClasses": np.array([[3, 7]], np.int32),
                  "GtBoxes": gt_boxes,
                  "ImInfo": np.array([[224, 224, 1.0]], np.float32)}, attrs)
    labels = got["LabelsInt32"]
    assert got["RoisNum"][0] == 5
    assert labels[0, :3].tolist() == [3, 7, 3]
    assert (labels[0, 3:5] == 0).all() and labels[0, 5] == -1
    np.testing.assert_allclose(
        got["BboxTargets"][0, 2, 12:16],
        _delta_np(rois[0, 0], gt_boxes[0, 0], w=(0.1, 0.1, 0.2, 0.2)),
        rtol=1e-4, atol=1e-5)
    assert got["BboxInsideWeights"][0, 2, 12:16].tolist() == [1, 1, 1, 1]
    assert got["BboxInsideWeights"][0, 2].sum() == 4
    assert got["BboxInsideWeights"][0, 3:].sum() == 0
    np.testing.assert_allclose(got["Rois"][0, 2], rois[0, 0], rtol=1e-5)


def test_mine_hard_examples_max_negative():
    ins = {"ClsLoss": np.array([[0.9, 0.1, 0.8, 0.4, 0.7, 0.2]], np.float32),
           "MatchIndices": np.array([[0, -1, -1, -1, -1, -1]], np.int32),
           "MatchDist": np.array([[0.9, 0.2, 0.3, 0.1, 0.8, 0.2]],
                                 np.float32)}
    got = check_op("mine_hard_examples", ins,
                 {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                  "mining_type": "max_negative"})
    assert got["NegIndices"][0].tolist() == [2, 3, 5, -1, -1, -1]
    np.testing.assert_array_equal(got["NegMask"][0], [0, 0, 1, 1, 0, 1])


def test_mine_hard_examples_hard_example_updates_matches():
    ins = {"ClsLoss": np.array([[0.9, 0.1, 0.8, 0.4]], np.float32),
           "LocLoss": np.array([[0.0, 0.0, 0.0, 0.5]], np.float32),
           "MatchIndices": np.array([[0, -1, 1, -1]], np.int32),
           "MatchDist": np.zeros((1, 4), np.float32)}
    got = check_op("mine_hard_examples", ins,
                 {"sample_size": 2, "mining_type": "hard_example"})
    assert got["UpdatedMatchIndices"][0].tolist() == [0, -1, -1, -1]
    assert got["NegIndices"][0].tolist() == [3, -1, -1, -1]


def test_mine_hard_examples_on_a_batch_with_ties():
    rng = np.random.RandomState(13)
    n, p = 4, 64
    ins = {"ClsLoss": np.round(rng.rand(n, p) * 6).astype(np.float32) / 6,
           "LocLoss": rng.rand(n, p).astype(np.float32),
           "MatchIndices": np.where(rng.rand(n, p) < 0.15,
                                    rng.randint(0, 5, (n, p)),
                                    -1).astype(np.int32),
           "MatchDist": rng.rand(n, p).astype(np.float32)}
    check_op("mine_hard_examples", ins, {"neg_pos_ratio": 3.0})
    check_op("mine_hard_examples", ins, {"sample_size": 20,
                                       "mining_type": "hard_example"})


def _rpn_pipeline(fluid):
    L = fluid.layers
    h = w = 8
    na = 3
    feat = L.data(name="feat", shape=[16, h, w], dtype="float32")
    gt_boxes = L.data(name="gt", shape=[2, 4], dtype="float32")
    gt_classes = L.data(name="gtc", shape=[2], dtype="int32")
    im_info = L.data(name="im_info", shape=[3], dtype="float32")
    anchors, _vars = L.detection.anchor_generator(
        feat, anchor_sizes=[32, 64], aspect_ratios=[1.0, 2.0],
        stride=[16.0, 16.0])
    anchors3 = L.slice(anchors, axes=[2], starts=[0], ends=[na])
    flat_anchors = L.reshape(anchors3, shape=[-1, 4])
    conv = L.conv2d(feat, num_filters=16, filter_size=3, padding=1,
                    act="relu")
    scores = L.conv2d(conv, num_filters=na, filter_size=1)
    deltas = L.conv2d(conv, num_filters=4 * na, filter_size=1)
    score_flat = L.reshape(L.transpose(scores, perm=[0, 2, 3, 1]),
                           shape=[0, -1, 1])
    delta_flat = L.reshape(L.transpose(
        L.reshape(deltas, shape=[0, na, 4, h, w]), perm=[0, 3, 4, 1, 2]),
        shape=[0, -1, 4])
    (pred_score, pred_loc, tgt_lbl, tgt_bbox, in_w,
     score_w) = L.detection.rpn_target_assign(
        delta_flat, score_flat, flat_anchors, None, gt_boxes, None, im_info,
        rpn_batch_size_per_im=32, rpn_fg_fraction=0.5,
        rpn_positive_overlap=0.6, rpn_negative_overlap=0.3, use_random=False)
    cls_loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(
        L.sigmoid_cross_entropy_with_logits(
            L.squeeze(pred_score, axes=[2]), L.cast(tgt_lbl, "float32")),
        score_w)), L.reduce_sum(score_w))
    f4 = 16 * 4
    reg_loss = L.elementwise_div(L.reduce_sum(L.smooth_l1(
        L.reshape(pred_loc, shape=[0, f4]), L.reshape(tgt_bbox, shape=[0, f4]),
        inside_weight=L.reshape(in_w, shape=[0, f4]),
        outside_weight=L.reshape(in_w, shape=[0, f4]))),
        L.elementwise_max(L.reduce_sum(score_w),
                          L.fill_constant([1], "float32", 1.0)))
    loss = L.elementwise_add(cls_loss, reg_loss)
    fluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    probs = L.sigmoid(score_flat)
    probs_nahw = L.transpose(L.reshape(probs, shape=[0, h, w, na]),
                             perm=[0, 3, 1, 2])
    rois, rois_num = L.detection.generate_proposals(
        probs_nahw, deltas, im_info, anchors3,
        L.fill_constant([h, w, na, 4], "float32", 1.0), pre_nms_top_n=64,
        post_nms_top_n=16, nms_thresh=0.7, min_size=4.0)
    (s_rois, s_labels, _t, _i, _o,
     s_num) = L.detection.generate_proposal_labels(
        rois, gt_classes, None, gt_boxes, im_info, batch_size_per_im=16,
        fg_fraction=0.5, fg_thresh=0.5, class_nums=4, use_random=False,
        rpn_rois_num=rois_num)
    return loss, s_rois, s_num, s_labels


def test_rpn_pipeline_trains_end_to_end():
    """The reference's RPN pipeline from the reference's weights: the
    same losses and samples for 4 Adam steps, and the port's loss halves
    over 60."""
    feed = {"feat": np.random.RandomState(1).rand(2, 16, 8, 8).astype(
                np.float32),
            "gt": np.array([[[16, 16, 47, 47], [64, 64, 127, 127]],
                            [[32, 32, 95, 95], [0, 0, 31, 31]]], np.float32),
            "gtc": np.array([[1, 2], [3, 1]], np.int32),
            "im_info": np.array([[128, 128, 1.0], [128, 128, 1.0]],
                                np.float32)}
    runs = {}
    arrays = None
    for side, fluid in PKGS.items():
        main, startup, outs = build(fluid, _rpn_pipeline)
        if arrays is None:
            arrays = reference_arrays(startup)
        scope = scope_of(fluid, arrays, main)
        exe = fluid.Executor(fluid.CPUPlace())
        steps = 60 if side == "port" else 4
        res = [[np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=list(outs),
                                               scope=scope)]
               for _ in range(steps)]
        runs[side] = res
    for step in range(4):
        for i, name in enumerate(("loss", "rois", "count", "labels")):
            assert_same(runs["port"][step][i], runs["ref"][step][i],
                  f"step {step} {name}", dict(rtol=1e-4, atol=1e-5))
    losses = [float(r[0].reshape(-1)[0]) for r in runs["port"]]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    rv, ln, lab = runs["port"][-1][1:]
    assert rv.shape == (2, 16, 4) and (ln > 0).all()
    assert (lab >= -1).all() and (lab < 4).all()


def test_generate_proposal_labels_no_gt_image_all_background():
    got = check_op("generate_proposal_labels",
                 {"RpnRois": np.array([[[10, 10, 29, 29], [50, 50, 69, 69],
                                        [0, 0, 19, 19], [30, 30, 49, 49]]],
                                      np.float32),
                  "GtClasses": np.zeros((1, 2), np.int32),
                  "GtBoxes": np.zeros((1, 2, 4), np.float32),
                  "ImInfo": np.array([[128, 128, 1.0]], np.float32),
                  "GtNum": np.array([0], np.int32)},
                 {"batch_size_per_im": 4, "fg_fraction": 0.25,
                  "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
                  "class_nums": 4, "use_random": False})
    assert got["RoisNum"][0] == 4
    assert (got["LabelsInt32"][0] == 0).all()


def test_polygon_box_transform_decodes_offsets():
    x = np.zeros((1, 4, 2, 3), np.float32)
    x[0, 0, 1, 2], x[0, 1, 1, 2] = 1.5, 2.5
    o = check_op("polygon_box_transform", {"Input": x})["Output"]
    np.testing.assert_allclose(o[0, 0, 1, 2], 4 * 2 - 1.5)
    np.testing.assert_allclose(o[0, 1, 1, 2], 4 * 1 - 2.5)
    np.testing.assert_allclose(o[0, 0, 0], [0, 4, 8])
    np.testing.assert_allclose(o[0, 3, :, 0], [0, 4])


def test_roi_perspective_transform_axis_aligned_identity():
    x = np.random.RandomState(11).rand(1, 2, 8, 8).astype(np.float32)
    rois = np.array([[0, 1, 1, 4, 1, 4, 4, 1, 4]], np.float32)
    o = check_op("roi_perspective_transform", {"X": x, "ROIs": rois},
               {"transformed_height": 4, "transformed_width": 4,
                "spatial_scale": 1.0})["Out"]
    np.testing.assert_allclose(o[0], x[0, :, 1:5, 1:5], rtol=1e-4,
                               atol=1e-5)


def test_roi_perspective_transform_outside_quad_is_zero():
    x = np.ones((1, 1, 8, 8), np.float32)
    rois = np.array([[0, 1, 1, 2, 1, 2, 6, 1, 6]], np.float32)
    o = check_op("roi_perspective_transform", {"X": x, "ROIs": rois},
               {"transformed_height": 6, "transformed_width": 6,
                "spatial_scale": 1.0})["Out"]
    assert (o[0, 0, :, -1] == 0).all() and o[0, 0, 0, 0] == 1.0


def test_roi_perspective_transform_gradient():
    x = np.random.RandomState(14).randn(2, 3, 10, 9).astype(np.float32)
    rois = np.array([[0, 1, 1, 6, 2, 7, 7, 0.5, 6],
                     [1, 2.5, 1, 8, 1.5, 7.5, 9, 2, 8.5],
                     [0, 0, 0, 3, 0, 3, 2, 0, 2]], np.float32)
    check_op("roi_perspective_transform", {"X": x, "ROIs": rois},
           {"transformed_height": 5, "transformed_width": 7,
            "spatial_scale": 0.8}, "Out", grad_slots=["X"])


# -- generate_proposals -----------------------------------------------------

def test_generate_proposals_smoke():
    rng = np.random.RandomState(6)
    n, a, h, w = 1, 3, 4, 4
    anchors = run_torch_op_all(
        "anchor_generator", {"Input": np.zeros((n, 8, h, w), np.float32)},
        {"anchor_sizes": [16.0, 32.0], "aspect_ratios": [1.0, 2.0],
         "stride": [16.0, 16.0]})["Anchors"][..., :a, :]
    got = check_op("generate_proposals",
                 {"Scores": rng.rand(n, a, h, w).astype(np.float32),
                  "BboxDeltas": (rng.randn(n, 4 * a, h, w) * 0.1).astype(
                      np.float32),
                  "ImInfo": np.array([[64.0, 64.0, 1.0]], np.float32),
                  "Anchors": anchors,
                  "Variances": np.ones(anchors.shape, np.float32)},
                 {"pre_nms_topN": 20, "post_nms_topN": 8, "nms_thresh": 0.7,
                  "min_size": 1.0})
    rois, n_valid = got["RpnRois"], int(got["RpnRoisNum"][0])
    assert rois.shape == (n, 8, 4) and 1 <= n_valid <= 8
    v = rois[0, :n_valid]
    assert (v[:, 0] >= 0).all() and (v[:, 2] <= 63).all()
    assert (v[:, 2] > v[:, 0]).all() and (v[:, 3] > v[:, 1]).all()
    np.testing.assert_allclose(rois[0, n_valid:], 0.0)


def _proposal_inputs(seed, n=2, a=9, h=6, w=7):
    rng = np.random.RandomState(seed)
    anchors = run_torch_op_all(
        "anchor_generator", {"Input": np.zeros((n, 8, h, w), np.float32)},
        {"anchor_sizes": [16.0, 32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [8.0, 8.0]})["Anchors"]
    return {"Scores": (np.round(rng.rand(n, a, h, w) * 10) / 10).astype(
                np.float32),
            "BboxDeltas": (rng.randn(n, 4 * a, h, w) * 0.2).astype(
                np.float32),
            "ImInfo": np.array([[48.0, 56.0, 1.0], [72.0, 84.0, 1.5]],
                               np.float32),
            "Anchors": anchors,
            "Variances": np.ones(anchors.shape, np.float32)}


@pytest.mark.parametrize("eta", [1.0, 0.9, 0.7])
def test_generate_proposals_few_hundred_ties_and_eta(eta):
    """378 candidates an image (42 cells x 9 anchors), scores in tenths
    (ties), anchors overlapping in chains: the same rois in the same
    order, the same counts."""
    from paddle_tpu_torch.ops import detection

    ins = _proposal_inputs(15)
    for pre, post, min_size in ((378, 100, 0.0), (200, 60, 6.0)):
        got = check_op("generate_proposals", ins,
                     {"pre_nms_topN": pre, "post_nms_topN": post,
                      "nms_thresh": 0.6, "min_size": min_size, "eta": eta},
                     tol=dict(rtol=0, atol=1e-4))
        assert (got["RpnRoisNum"] > 10).all()
        assert detection.nms_iterations["generate_proposals"] >= 2


def test_rpn_target_assign_and_proposal_labels_at_size():
    """A few hundred anchors and proposals, crowd gts, gt counts, two
    images: every output of both ops equals the reference's with
    use_random=False."""
    rng = np.random.RandomState(16)
    ins = _proposal_inputs(16)
    anchors = ins["Anchors"].reshape(-1, 4)
    lo = rng.rand(2, 5, 2) * 40
    gts = np.concatenate([lo, lo + 12 + rng.rand(2, 5, 2) * 30],
                         -1).astype(np.float32)
    crowd = np.array([[0, 0, 1, 0, 0], [0, 0, 0, 0, 1]], np.int32)
    gt_num = np.array([5, 3], np.int32)
    got = check_op("rpn_target_assign",
                 {"Anchor": anchors, "GtBoxes": gts, "ImInfo": ins["ImInfo"],
                  "IsCrowd": crowd, "GtNum": gt_num},
                 {"rpn_batch_size_per_im": 64, "rpn_straddle_thresh": 0.0,
                  "use_random": False})
    assert (got["ForegroundNumber"] > 0).all()
    props = run_torch_op_all("generate_proposals", ins,
                             {"pre_nms_topN": 300, "post_nms_topN": 120,
                              "nms_thresh": 0.7, "min_size": 0.0})
    got = check_op("generate_proposal_labels",
                 {"RpnRois": props["RpnRois"],
                  "RpnRoisNum": props["RpnRoisNum"],
                  "GtClasses": rng.randint(1, 6, (2, 5)).astype(np.int32),
                  "IsCrowd": crowd, "GtBoxes": gts, "GtNum": gt_num,
                  "ImInfo": ins["ImInfo"]},
                 {"batch_size_per_im": 48, "fg_fraction": 0.25,
                  "fg_thresh": 0.3, "bg_thresh_hi": 0.3,
                  "class_nums": 6, "use_random": False})
    assert (got["RoisNum"] > 12).all()


def test_sampling_with_use_random_keeps_the_references_invariants():
    rng = np.random.RandomState(17)
    ins = _proposal_inputs(17)
    anchors = ins["Anchors"].reshape(-1, 4)
    lo = rng.rand(2, 4, 2) * 30
    gts = np.concatenate([lo, lo + 16 + rng.rand(2, 4, 2) * 20],
                         -1).astype(np.float32)
    attrs = {"rpn_batch_size_per_im": 32, "rpn_straddle_thresh": 0.0,
             "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
             "use_random": True}
    ins_a = {"Anchor": anchors, "GtBoxes": gts, "ImInfo": ins["ImInfo"]}
    got = run_torch_op_all("rpn_target_assign", ins_a, attrs)
    det = run_torch_op_all("rpn_target_assign", ins_a,
                           dict(attrs, use_random=False))
    # the fg candidate count is the same with or without the draw
    np.testing.assert_array_equal(got["ForegroundNumber"],
                                  det["ForegroundNumber"])
    for i in range(2):
        im_h, im_w = ins["ImInfo"][i, :2]
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                  & (anchors[:, 2] < im_w) & (anchors[:, 3] < im_h))
        iou = _pixel_iou_np(anchors, gts[i] * ins["ImInfo"][i, 2])
        best = np.where(inside, iou.max(1), -1)
        nfg = int(got["ForegroundNumber"][i])
        assert 0 < nfg <= 16
        fg = got["LocationIndex"][i, :nfg]
        assert len(set(fg.tolist())) == nfg and inside[fg].all()
        score = got["ScoreIndex"][i]
        w = got["ScoreWeight"][i]
        active = score[w > 0]
        assert len(set(active.tolist())) == len(active) <= 32
        assert (active[:nfg] == fg).all()
        bg = active[nfg:]
        assert (best[bg] < 0.3).all() and inside[bg].all()
        assert (got["TargetLabel"][i][w > 0] == (np.arange(len(active))
                                                 < nfg)).all()
        for s, aidx in enumerate(fg):
            np.testing.assert_allclose(
                got["TargetBBox"][i, s],
                _delta_np(anchors[aidx], (gts[i] * ins["ImInfo"][i, 2])[
                    np.argmax(np.where(inside[aidx], iou[aidx], -1))]),
                rtol=1e-4, atol=1e-4)
    props = run_torch_op_all("generate_proposals", ins,
                             {"pre_nms_topN": 300, "post_nms_topN": 120,
                              "nms_thresh": 0.7, "min_size": 0.0})
    lab_ins = {"RpnRois": props["RpnRois"], "RpnRoisNum": props["RpnRoisNum"],
               "GtClasses": np.array([[1, 2, 3, 4]] * 2, np.int32),
               "GtBoxes": gts, "ImInfo": ins["ImInfo"]}
    lab_attrs = {"batch_size_per_im": 40, "fg_fraction": 0.25,
                 "fg_thresh": 0.4, "bg_thresh_hi": 0.4, "class_nums": 5,
                 "use_random": True}
    got = run_torch_op_all("generate_proposal_labels", lab_ins, lab_attrs)
    det = run_torch_op_all("generate_proposal_labels", lab_ins,
                           dict(lab_attrs, use_random=False))
    np.testing.assert_array_equal(got["RoisNum"], det["RoisNum"])
    for i in range(2):
        lab, cnt = got["LabelsInt32"][i], int(got["RoisNum"][i])
        nfg = int((lab > 0).sum())
        assert nfg <= 10 and (lab[:nfg] > 0).all()
        assert (lab[nfg:cnt] == 0).all() and (lab[cnt:] == -1).all()
        rows = got["Rois"][i, :cnt]
        assert len({tuple(r) for r in rows[nfg:]}) == cnt - nfg
        wsum = got["BboxInsideWeights"][i].reshape(40, 5, 4).sum(-1)
        assert (wsum[np.arange(nfg), lab[:nfg]] == 4).all()
        assert wsum.sum() == 4 * nfg


# -- a small Faster R-CNN program -------------------------------------------

FRCNN_SMALL = dict(chip_smoke.FRCNN, image=(64, 64), batch=2, classes=5,
                   gt_boxes=3, stages=(1, 1, 1, 1), base=4,
                   anchor_sizes=(16.0, 32.0, 64.0), rpn_batch=32,
                   train_nms=(100, 20), test_nms=(60, 10), rois=16,
                   roi_resolution=4)
LOSSES = ("loss", "rpn_cls_loss", "rpn_reg_loss", "loss_cls", "loss_bbox")


def test_faster_rcnn_trains_and_detects_as_the_reference():
    cfg = FRCNN_SMALL
    feed = chip_smoke.frcnn_feed(cfg, 0)
    progs, arrays = {}, None
    for side, fluid in PKGS.items():
        main, startup, out = build(fluid, lambda f: chip_smoke.faster_rcnn(
            f, cfg, train=True, use_random=False))
        infer, _s, iout = build(fluid, lambda f: chip_smoke.faster_rcnn(
            f, cfg, train=False))
        if arrays is None:
            arrays = reference_arrays(startup)
        progs[side] = (main, out, infer, iout, scope_of(fluid, arrays, main),
                       fluid.Executor(fluid.CPUPlace()))
    for i in (0, 2):
        assert json.dumps(progs["ref"][i].to_dict(), sort_keys=True,
                          default=str) == json.dumps(
            progs["port"][i].to_dict(), sort_keys=True, default=str)
    frozen = [v.name for v in progs["port"][0].list_vars()
              if v.name.endswith("_scale")]
    assert len(frozen) == 17          # conv1 and 4 blocks of 4 affines
    fetched = {}
    for side, (main, out, infer, iout, scope, exe) in progs.items():
        f = {k: v for k, v in feed.items() if main.global_block().has_var(k)}
        names = LOSSES + ("fg_num", "sampled", "rois_num")
        fetched[side] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[out[k] for k in names], scope=scope)]
            for _ in range(3)]
        fetched[side].append([np.asarray(v) for v in exe.run(
            infer, feed=feed, fetch_list=[iout[k] for k in (
                "rois_num", "dets", "det_num", "m_ap")], scope=scope)])
        # the frozen affines did not train
        for n in frozen:
            np.testing.assert_array_equal(np.asarray(
                scope.find_var(n)), arrays[n])
    for step in range(3):
        for i, name in enumerate(LOSSES + ("fg_num", "sampled",
                                           "rois_num")):
            assert_same(fetched["port"][step][i], fetched["ref"][step][i],
                  f"step {step} {name}", dict(rtol=1e-4, atol=1e-6))
    assert np.isfinite([s[0] for s in fetched["port"][:3]]).all()
    for i, name in enumerate(("rois_num", "dets", "det_num", "m_ap")):
        assert_same(fetched["port"][3][i], fetched["ref"][3][i], name,
              dict(rtol=1e-3, atol=1e-5))
