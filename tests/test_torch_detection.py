"""The detection family of paddle_tpu_torch (ops/detection.py,
layers/detection.py), part one: the counterparts of the reference's
tests/test_detection.py, each running the port and the JAX package on
the same numpy inputs (float outputs within rtol 2e-3 and atol 1e-6,
integer outputs and kept sets exactly) beside the reference test's own
checks, and beyond them:

- multiclass_nms at a few hundred candidates a class: tied scores
  (lax.top_k's order, lower index first), chains of overlapping boxes
  (suppression by a suppressed box must not happen), nms_eta < 1, a
  background label of -1, the reference's raise on nms_top_k = -1, and
  the NMS fixed point's iteration count against the longest chain;
- yolov3_loss with two gts in one cell (the objectness scatter-max and
  the gathers' summed gradients) and its gradient, at two heads;
- detection_map's reference cases and a batch at 11 points;
- the 18 `layers.detection` names build the reference's
  `Program.to_dict()` and give its fetches (ssd_loss, the SSD head and
  the YOLO toy model train in both from the reference's weights).

The RPN, proposal-label and hard-example ops and the Faster R-CNN
program are tests/test_torch_detection_rpn.py.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from torch_op_test import (assert_same, check_op, run_ref_op_jit,
                           run_torch_op_all)
from torch_twin import twins

torch.set_num_threads(2)


def _iou_np(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return inter / ua if ua > 0 else 0.0


def _sorted_boxes(rng, n):
    return np.sort(rng.rand(n, 2, 2).astype(np.float32), axis=1).reshape(
        n, 4)


# -- the counterparts of tests/test_detection.py ---------------------------

def test_iou_similarity_matches_numpy():
    rng = np.random.RandomState(0)
    x, y = _sorted_boxes(rng, 5), _sorted_boxes(rng, 7)
    got = check_op("iou_similarity", {"X": x, "Y": y}, out_slot="Out",
                 grad_slots=["X", "Y"])["Out"]
    for i in range(5):
        for j in range(7):
            assert got[i, j] == pytest.approx(_iou_np(x[i], y[j]), abs=1e-5)


def test_prior_box_reference():
    feat = np.zeros((1, 8, 4, 4), np.float32)
    img = np.zeros((1, 3, 64, 64), np.float32)
    attrs = {"min_sizes": [16.0], "max_sizes": [32.0],
             "aspect_ratios": [2.0], "flip": True, "clip": True,
             "variances": [0.1, 0.1, 0.2, 0.2]}
    got = check_op("prior_box", {"Input": feat, "Image": img}, attrs)
    boxes = got["Boxes"]
    assert boxes.shape == (4, 4, 4, 4)
    np.testing.assert_allclose(boxes[0, 0, 0], [0.0, 0.0, 0.25, 0.25],
                               atol=1e-6)
    s = np.sqrt(16.0 * 32.0) / 2
    np.testing.assert_allclose(
        boxes[0, 0, 3],
        np.clip([(8 - s) / 64, (8 - s) / 64, (8 + s) / 64, (8 + s) / 64],
                0, 1), atol=1e-5)
    np.testing.assert_allclose(got["Variances"][0, 0, 0],
                               [0.1, 0.1, 0.2, 0.2])


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_roundtrip(normalized):
    rng = np.random.RandomState(1)
    m, n = 6, 3
    prior = _sorted_boxes(rng, m) * (1 if normalized else 50)
    pvar = np.full((m, 4), 0.1, np.float32)
    gt = _sorted_boxes(rng, n) * (1 if normalized else 50)
    ins = {"PriorBox": prior, "PriorBoxVar": pvar, "TargetBox": gt}
    attrs = {"code_type": "encode_center_size",
             "box_normalized": normalized}
    enc = check_op("box_coder", ins, attrs, "OutputBox",
                 grad_slots=["TargetBox"])["OutputBox"]
    assert enc.shape == (n, m, 4)
    dec = check_op("box_coder", dict(ins, TargetBox=enc),
                 dict(attrs, code_type="decode_center_size"), "OutputBox",
                 grad_slots=["TargetBox", "PriorBox"])["OutputBox"]
    for i in range(n):
        for j in range(m):
            np.testing.assert_allclose(dec[i, j], gt[i], rtol=1e-4,
                                       atol=1e-4)


def _nms_np(boxes, scores, score_th, nms_th, top_k):
    order = np.argsort(-scores, kind="stable")[:top_k]
    keep = []
    for i in order:
        if scores[i] <= score_th:
            continue
        if all(_iou_np(boxes[i], boxes[j]) <= nms_th for j in keep):
            keep.append(i)
    return keep


def test_multiclass_nms_matches_numpy():
    rng = np.random.RandomState(2)
    n, m, c = 2, 20, 3
    centers = rng.rand(n, m, 2) * 0.8 + 0.1
    sizes = rng.rand(n, m, 2) * 0.2 + 0.05
    bboxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                            axis=2).astype(np.float32)
    scores = rng.rand(n, c, m).astype(np.float32)
    attrs = {"background_label": 0, "score_threshold": 0.3,
             "nms_top_k": 10, "nms_threshold": 0.4, "keep_top_k": 8}
    got = check_op("multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
                 attrs)
    rows, counts = got["Out"], got["NmsRoisNum"]
    for i in range(n):
        expect = [(cl, scores[i, cl, j], tuple(bboxes[i, j]))
                  for cl in range(1, c)
                  for j in _nms_np(bboxes[i], scores[i, cl], 0.3, 0.4, 10)]
        expect.sort(key=lambda e: -e[1])
        expect = expect[:8]
        assert counts[i] == len(expect)
        for k, (cl, s, bx) in enumerate(expect):
            assert int(rows[i, k, 0]) == cl
            assert rows[i, k, 1] == pytest.approx(s, rel=1e-5)
            np.testing.assert_allclose(rows[i, k, 2:], bx, rtol=1e-5)
        if len(expect) < 8:
            assert (rows[i, len(expect):, 0] == -1).all()


YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


def test_yolov3_loss_basics():
    rng = np.random.RandomState(3)
    n, a, k, h, w = 2, 3, 5, 8, 8
    x = (rng.randn(n, a * (5 + k), h, w) * 0.1).astype(np.float32)
    gtbox = np.zeros((n, 4, 4), np.float32)
    gtlabel = np.full((n, 4), -1, np.int32)
    gtbox[:, 0] = [0.5, 0.5, 0.06, 0.1]
    gtlabel[:, 0] = 2
    attrs = {"anchors": YOLO_ANCHORS, "anchor_mask": [0, 1, 2],
             "class_num": k, "ignore_thresh": 0.7, "downsample_ratio": 32}
    loss = check_op("yolov3_loss", {"X": x, "GTBox": gtbox,
                                  "GTLabel": gtlabel}, attrs)["Loss"]
    assert loss.shape == (n,)
    assert (loss > 0).all() and np.isfinite(loss).all()
    loss2 = check_op("yolov3_loss",
                   {"X": x, "GTBox": gtbox,
                    "GTLabel": np.full((n, 4), -1, np.int32)},
                   attrs)["Loss"]
    assert (loss2 < loss).all()


def _yolo_model(fluid):
    n, a, k, h, w = 2, 3, 4, 4, 4
    L = fluid.layers
    feat = L.data("feat", shape=[n, 8, h, w], append_batch_size=False)
    gtb = L.data("gtb", shape=[n, 2, 4], append_batch_size=False)
    gtl = L.data("gtl", shape=[n, 2], dtype="int64", append_batch_size=False)
    head = L.conv2d(feat, num_filters=a * (5 + k), filter_size=1)
    loss_v = L.detection.yolov3_loss(
        head, gtb, gtl, anchors=[10, 13, 16, 30, 33, 23],
        anchor_mask=[0, 1, 2], class_num=k, ignore_thresh=0.7,
        downsample_ratio=32)
    loss = L.reduce_mean(loss_v)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_yolov3_trains():
    """The reference's one-head YOLO toy model from the reference's
    weights: the same losses for 6 steps, and the port's loss falls by
    a fifth over 25."""
    rng = np.random.RandomState(4)
    feed = {"feat": rng.randn(2, 8, 4, 4).astype(np.float32),
            "gtb": np.tile(np.array([[0.4, 0.6, 0.2, 0.3],
                                     [0.7, 0.3, 0.1, 0.2]], np.float32),
                           (2, 1, 1)),
            "gtl": np.tile(np.array([1, 3], np.int64), (2, 1))}
    tw = twins(_yolo_model)
    losses = {}
    for side, (main, scope, exe, loss) in tw.items():
        steps = 25 if side == "port" else 6
        losses[side] = [float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(()))
            for _ in range(steps)]
    np.testing.assert_allclose(losses["port"][:6], losses["ref"], rtol=1e-4)
    assert losses["port"][-1] < losses["port"][0] * 0.8
    assert np.isfinite(losses["port"]).all()


def _ssd_head(fluid):
    p = 16
    L = fluid.layers
    feat = L.data("feat", shape=[1, 8, 4, 4], append_batch_size=False)
    img = L.data("img", shape=[1, 3, 64, 64], append_batch_size=False)
    priors, _pvar = L.detection.prior_box(feat, img, min_sizes=[24.0],
                                          clip=True)
    priors2d = L.reshape(priors, [p, 4])
    loc = L.data("loc", shape=[p, 4], append_batch_size=False)
    conf = L.data("conf", shape=[p, 3], append_batch_size=False)
    gtb = L.data("gtb", shape=[2, 4], append_batch_size=False)
    gtl = L.data("gtl", shape=[2, 1], dtype="int64", append_batch_size=False)
    return L.detection.ssd_loss(loc, conf, gtb, gtl, priors2d,
                                overlap_threshold=0.1)


def test_ssd_head_smoke():
    rng = np.random.RandomState(5)
    feed = {"feat": np.zeros((1, 8, 4, 4), np.float32),
            "img": np.zeros((1, 3, 64, 64), np.float32),
            "loc": rng.randn(16, 4).astype(np.float32) * 0.1,
            "conf": rng.randn(16, 3).astype(np.float32),
            "gtb": np.array([[0.1, 0.1, 0.4, 0.4],
                             [0.5, 0.5, 0.9, 0.9]], np.float32),
            "gtl": np.array([[1], [2]], np.int64)}
    got = {}
    for side, (main, scope, exe, loss) in twins(_ssd_head).items():
        got[side] = np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0])
    assert_same(got["port"], got["ref"], "ssd_loss")
    assert np.isfinite(got["port"]).all() and got["port"].reshape(-1)[0] > 0


def test_anchor_generator_reference_cell():
    feat = np.zeros((1, 8, 2, 2), np.float32)
    attrs = {"anchor_sizes": [32.0], "aspect_ratios": [1.0],
             "stride": [16.0, 16.0]}
    anchors = check_op("anchor_generator", {"Input": feat}, attrs)["Anchors"]
    assert anchors.shape == (2, 2, 1, 4)
    np.testing.assert_allclose(anchors[0, 0, 0], [-8.0, -8.0, 23.0, 23.0],
                               atol=1e-5)
    a2 = check_op("anchor_generator", {"Input": feat},
                dict(attrs, aspect_ratios=[2.0]))["Anchors"]
    assert (a2[0, 0, 0, 2] - a2[0, 0, 0, 0] + 1,
            a2[0, 0, 0, 3] - a2[0, 0, 0, 1] + 1) == (22.0, 44.0)
    # Faster R-CNN's 15 anchors at stride 16, with Python's round of .5
    # to even (ratio 0.5: sqrt(512) = 22.6 → 23, 23 * 0.5 = 11.5 → 12)
    many = check_op("anchor_generator", {"Input": np.zeros((1, 2, 3, 5),
                                                         np.float32)},
                  {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
                   "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0],
                   "variances": [1.0, 1.0, 1.0, 1.0]})["Anchors"]
    assert many.shape == (3, 5, 15, 4)
    assert many[0, 0, 0, 3] - many[0, 0, 0, 1] + 1 == 24.0


def test_density_prior_box_counts():
    feat = np.zeros((1, 8, 2, 2), np.float32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    boxes = check_op("density_prior_box", {"Input": feat, "Image": img},
                   {"densities": [2], "fixed_sizes": [8.0],
                    "fixed_ratios": [1.0]})["Boxes"]
    assert boxes.shape == (2, 2, 4, 4)
    sz = boxes[..., 2] - boxes[..., 0]
    np.testing.assert_allclose(sz[sz > 0.24], 0.25, rtol=1e-5)
    check_op("density_prior_box", {"Input": np.zeros((1, 8, 3, 5),
                                                   np.float32),
                                 "Image": np.zeros((1, 3, 48, 75),
                                                   np.float32)},
           {"densities": [4, 2, 1], "fixed_sizes": [8.0, 16.0, 32.0],
            "fixed_ratios": [1.0, 2.0], "clip": False})


def test_box_clip():
    boxes = np.array([[[-5.0, -3.0, 50.0, 20.0]]], np.float32)
    im_info = np.array([[30.0, 40.0, 1.0]], np.float32)
    got = check_op("box_clip", {"Input": boxes, "ImInfo": im_info})["Output"]
    np.testing.assert_allclose(got[0, 0], [0, 0, 39, 20])
    rng = np.random.RandomState(6)
    boxes = (rng.randn(2, 5, 4) * 30 + 20).astype(np.float32)
    im_info = np.array([[30.0, 40.0, 1.0], [60.0, 50.0, 1.5]], np.float32)
    check_op("box_clip", {"Input": boxes, "ImInfo": im_info}, {},
           "Output", grad_slots=["Input"])
    check_op("box_clip", {"Input": boxes}, {"im_shape": [30, 40]})


def test_bipartite_match_greedy():
    dist = np.array([[0.6, 0.9, 0.2], [0.8, 0.7, 0.1]], np.float32)
    got = check_op("bipartite_match", {"DistMat": dist})
    np.testing.assert_array_equal(got["ColToRowMatchIndices"][0], [1, 0, -1])
    np.testing.assert_allclose(got["ColToRowMatchDist"][0], [0.8, 0.9, 0.0],
                               rtol=1e-6)
    got = check_op("bipartite_match", {"DistMat": dist},
                 {"match_type": "per_prediction", "dist_threshold": 0.15})
    np.testing.assert_array_equal(got["ColToRowMatchIndices"][0], [1, 0, 0])
    # ties and zero rows
    rng = np.random.RandomState(7)
    d = np.round(rng.rand(6, 9) * 4).astype(np.float32) / 4
    d[2] = 0
    check_op("bipartite_match", {"DistMat": d})
    check_op("bipartite_match", {"DistMat": d},
           {"match_type": "per_prediction", "dist_threshold": 0.4})


def test_target_assign():
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    match = np.array([[1, -1, 0]], np.int32)
    got = check_op("target_assign", {"X": x, "MatchIndices": match},
                 {"mismatch_value": -7})
    np.testing.assert_allclose(got["Out"], [[3, 4], [-7, -7], [1, 2]])
    np.testing.assert_allclose(got["OutWeight"][:, 0], [1, 0, 1])


def _dm(det, gt, **attrs):
    a = dict(class_num=2, background_label=0, overlap_threshold=0.5,
             evaluate_difficult=True, ap_type="integral")
    a.update(attrs)
    got = check_op("detection_map", {"DetectRes": np.asarray(det, np.float32),
                                   "Label": np.asarray(gt, np.float32)}, a)
    return float(got["MAP"])


def test_detection_map_visited_gt_is_fp():
    det = [[[1, 0.9, 0.00, 0.00, 0.50, 0.50],
            [1, 0.8, 0.05, 0.05, 0.55, 0.55]]]
    gt = [[[1, 0.00, 0.00, 0.50, 0.50, 0], [1, 0.15, 0.15, 0.65, 0.65, 0]]]
    np.testing.assert_allclose(_dm(det, gt, overlap_threshold=0.4), 0.5,
                               atol=1e-6)


def test_detection_map_difficult_gt_ignored():
    det = [[[1, 0.9, 0.00, 0.00, 0.50, 0.50],
            [1, 0.8, 0.60, 0.60, 0.90, 0.90]]]
    gt = [[[1, 0.00, 0.00, 0.50, 0.50, 1], [1, 0.62, 0.62, 0.88, 0.88, 0]]]
    np.testing.assert_allclose(_dm(det, gt, evaluate_difficult=False), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(_dm(det, gt, evaluate_difficult=True), 1.0,
                               atol=1e-6)


def test_detection_map_strict_threshold_and_clip():
    det = [[[1, 0.9, 0.0, 0.0, 0.5, 1.0]]]
    gt = [[[1, 0.0, 0.0, 1.0, 1.0, 0]]]
    assert _dm(det, gt, overlap_threshold=0.5) == 0.0
    det2 = [[[1, 0.9, -0.5, -0.5, 1.5, 1.5]]]
    np.testing.assert_allclose(_dm(det2, gt, overlap_threshold=0.5), 1.0,
                               atol=1e-6)


def test_detection_map_11point():
    det = [[[1, 0.9, 0.00, 0.00, 0.50, 0.50],
            [1, 0.8, 0.05, 0.05, 0.55, 0.55]]]
    gt = [[[1, 0.00, 0.00, 0.50, 0.50, 0], [1, 0.15, 0.15, 0.65, 0.65, 0]]]
    np.testing.assert_allclose(
        _dm(det, gt, overlap_threshold=0.4, ap_type="11point"), 6 / 11,
        atol=1e-6)


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
def test_detection_map_on_a_batch(ap_type):
    """4 images, 5 classes, 12 detection slots (some padding) and 6 gts
    (some difficult, some padding), as multiclass_nms and a loader give
    them."""
    rng = np.random.RandomState(8)
    n, m, g = 4, 12, 6
    gt_box = _sorted_boxes(rng, n * g).reshape(n, g, 4)
    gt_lbl = rng.randint(1, 5, (n, g)).astype(np.float32)
    gt_lbl[:, -1] = -1
    gt = np.concatenate([gt_lbl[..., None], gt_box,
                         (rng.rand(n, g, 1) < 0.2).astype(np.float32)], -1)
    pick = rng.randint(0, g, (n, m))
    jitter = rng.randn(n, m, 4).astype(np.float32) * 0.05
    det_box = np.take_along_axis(gt_box, pick[..., None], 1) + jitter
    det_lbl = np.where(rng.rand(n, m) < 0.8,
                       np.take_along_axis(gt_lbl, pick, 1),
                       rng.randint(1, 5, (n, m))).astype(np.float32)
    det_lbl[:, -2:] = -1
    score = np.round(rng.rand(n, m) * 8).astype(np.float32) / 8   # ties
    det = np.concatenate([det_lbl[..., None], score[..., None], det_box], -1)
    for diff in (True, False):
        v = _dm(det, gt, class_num=5, ap_type=ap_type,
                evaluate_difficult=diff)
        assert 0.0 < v <= 1.0


def test_detection_map_layer_in_program():
    det = np.array([[[1, 0.9, 0.0, 0.0, 0.5, 0.5],
                     [1, 0.8, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    gt = np.array([[[1, 0.05, 0.05, 0.45, 0.45, 0],
                    [1, 0.62, 0.62, 0.88, 0.88, 0]]], np.float32)
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            d = fluid.layers.data("d", shape=[1, 2, 6],
                                  append_batch_size=False)
            g = fluid.layers.data("g", shape=[1, 2, 6],
                                  append_batch_size=False)
            m = fluid.layers.detection.detection_map(d, g, class_num=2,
                                                     overlap_threshold=0.4)
        exe = fluid.Executor(fluid.CPUPlace())
        (v,) = exe.run(main, feed={"d": det, "g": gt}, fetch_list=[m])
        np.testing.assert_allclose(np.asarray(v), 1.0, atol=1e-6)


# -- NMS at a few hundred candidates ----------------------------------------

def _chain_boxes(rng, n, m):
    """Boxes in overlapping chains: runs of boxes each shifted a little
    from the last, so a box suppressed by its predecessor would suppress
    its successor under a wrong (parallel) NMS."""
    base = rng.rand(n, m // 8, 1, 2) * 0.7
    step = np.arange(8)[None, None, :, None] * 0.03
    lo = (base + step * rng.choice([-1, 1], (n, m // 8, 1, 2))).reshape(
        n, m, 2)
    size = 0.15 + rng.rand(n, m, 2) * 0.05
    return np.concatenate([lo, lo + size], -1).astype(np.float32)


@pytest.mark.parametrize("eta", [1.0, 0.9, 0.7])
def test_multiclass_nms_few_hundred_ties_and_chains(eta):
    from paddle_tpu_torch.ops import detection

    rng = np.random.RandomState(9)
    n, c, m = 2, 4, 320
    bboxes = _chain_boxes(rng, n, m)
    scores = (np.round(rng.rand(n, c, m) * 20) / 20).astype(np.float32)
    attrs = {"background_label": 1, "score_threshold": 0.1,
             "nms_top_k": 300, "nms_threshold": 0.6, "keep_top_k": 200,
             "nms_eta": eta}
    got = check_op("multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
                 attrs)
    assert (got["NmsRoisNum"] > 20).all()
    assert detection.nms_iterations["multiclass_nms"] >= 3
    # against a sequential numpy NMS (eta 1)
    if eta == 1.0:
        for i in range(n):
            kept = {(cl, j) for cl in (0, 2, 3)
                    for j in _nms_np(bboxes[i], scores[i, cl], 0.1, 0.6,
                                     300)}
            rows = got["Out"][i, :got["NmsRoisNum"][i]]
            assert len(kept) >= len(rows)
            for row in rows:
                j = int(np.where((bboxes[i] == row[2:]).all(1))[0][0])
                assert (int(row[0]), j) in kept


def test_multiclass_nms_background_minus_one_and_refused_top_k():
    rng = np.random.RandomState(10)
    bboxes = _chain_boxes(rng, 1, 64)
    scores = rng.rand(1, 2, 64).astype(np.float32)
    attrs = {"background_label": -1, "score_threshold": 0.05,
             "nms_top_k": 64, "nms_threshold": 0.5, "keep_top_k": 100}
    check_op("multiclass_nms", {"BBoxes": bboxes, "Scores": scores}, attrs)
    attrs["nms_top_k"] = -1
    with pytest.raises(Exception):
        run_ref_op_jit("multiclass_nms", {"BBoxes": bboxes,
                                          "Scores": scores}, attrs)
    with pytest.raises(ValueError, match="top_k"):
        run_torch_op_all("multiclass_nms", {"BBoxes": bboxes,
                                            "Scores": scores}, attrs)


# -- yolov3_loss ------------------------------------------------------------

@pytest.mark.parametrize("mask", [[0, 1, 2], [3, 4, 5]])
def test_yolov3_loss_two_boxes_in_one_cell_and_gradient(mask):
    rng = np.random.RandomState(11)
    n, k, h, w = 2, 3, 6, 6
    x = (rng.randn(n, 3 * (5 + k), h, w) * 0.5).astype(np.float32)
    gtbox = np.array([[[0.51, 0.52, 0.1, 0.12], [0.53, 0.54, 0.08, 0.1],
                       [0.2, 0.3, 0.3, 0.25], [0, 0, 0, 0]],
                      [[0.7, 0.2, 0.2, 0.4], [0.71, 0.21, 0.19, 0.38],
                       [0.1, 0.9, 0.05, 0.05], [0.5, 0.5, 0.4, 0.3]]],
                     np.float32)
    gtlabel = np.array([[0, 2, 1, -1], [1, 1, 2, 0]], np.int32)
    attrs = {"anchors": YOLO_ANCHORS[:6] + [40, 45, 60, 80, 100, 90],
             "anchor_mask": mask, "class_num": k, "ignore_thresh": 0.5,
             "downsample_ratio": 16}
    check_op("yolov3_loss", {"X": x, "GTBox": gtbox, "GTLabel": gtlabel},
           attrs, "Loss", grad_slots=["X"])


# -- the 18 layers of layers.detection --------------------------------------

def _detection_layers(fluid):
    L = fluid.layers
    D = L.detection
    feat = L.data("feat", shape=[2, 4, 3, 3], append_batch_size=False)
    img = L.data("img", shape=[2, 3, 48, 48], append_batch_size=False)
    bx = L.data("bx", shape=[5, 4], append_batch_size=False)
    gt = L.data("gt", shape=[3, 4], append_batch_size=False)
    boxes, var = D.prior_box(feat, img, [8.0], [16.0], [2.0], flip=True,
                             clip=True)
    dboxes, _ = D.density_prior_box(feat, img, [2], [8.0], [1.0])
    anchors, avar = D.anchor_generator(feat, [16.0, 32.0], [0.5, 1.0])
    iou = D.iou_similarity(gt, bx)
    enc = D.box_coder(bx, None, gt)
    match, mdist = D.bipartite_match(iou)
    assigned, aw = D.target_assign(gt, match)
    clipped = D.box_clip(L.reshape(bx, [1, 5, 4]), im_shape=[1, 1])
    sc = L.data("sc", shape=[1, 3, 5], append_batch_size=False)
    nms, nms_n = D.multiclass_nms(L.reshape(bx, [1, 5, 4]), sc, 0.05, 5, 4)
    gl = L.data("gl", shape=[1, 3, 6], append_batch_size=False)
    m_ap = D.detection_map(nms, gl, class_num=3)
    yx = L.data("yx", shape=[2, 18, 3, 3], append_batch_size=False)
    yb = L.data("yb", shape=[2, 2, 4], append_batch_size=False)
    yl = L.data("yl", shape=[2, 2], dtype="int32", append_batch_size=False)
    yolo = D.yolov3_loss(yx, yb, yl, [10, 13, 16, 30, 33, 23], [0, 1, 2], 1,
                         0.7, 32)
    geo = D.polygon_box_transform(L.data("geo", shape=[1, 4, 3, 3],
                                         append_batch_size=False))
    quad = D.roi_perspective_transform(
        feat, L.data("q", shape=[2, 9], append_batch_size=False), 2, 3)
    cl = L.data("cl", shape=[2, 5], append_batch_size=False)
    mi = L.data("mi", shape=[2, 5], dtype="int32", append_batch_size=False)
    md = L.data("md", shape=[2, 5], append_batch_size=False)
    neg, negm, upd = D.mine_hard_examples(cl, None, mi, md)
    loc = L.data("loc", shape=[5, 4], append_batch_size=False)
    conf = L.data("conf", shape=[5, 3], append_batch_size=False)
    gtl = L.data("gtl", shape=[3, 1], dtype="int64", append_batch_size=False)
    ssd = D.ssd_loss(loc, conf, gt, gtl, bx, overlap_threshold=0.3)
    return [boxes, var, dboxes, anchors, avar, iou, enc, match, mdist,
            assigned, aw, clipped, nms, nms_n, m_ap, yolo, geo, quad, neg,
            negm, upd, ssd]


def test_the_detection_layers_build_the_references_program_and_fetches():
    """Fifteen of the 18 names here; rpn_target_assign,
    generate_proposals and generate_proposal_labels build the Faster
    R-CNN program of tests/test_torch_detection_rpn.py."""
    rng = np.random.RandomState(12)
    bx = _sorted_boxes(rng, 5)
    feed = {"feat": rng.randn(2, 4, 3, 3).astype(np.float32),
            "img": np.zeros((2, 3, 48, 48), np.float32),
            "bx": bx, "gt": _sorted_boxes(rng, 3),
            "sc": rng.rand(1, 3, 5).astype(np.float32),
            "gl": np.array([[[1, *bx[0], 0], [2, *bx[3], 0],
                             [-1, 0, 0, 0, 0, 0]]], np.float32),
            "yx": rng.randn(2, 18, 3, 3).astype(np.float32),
            "yb": np.array([[[0.5, 0.5, 0.3, 0.3], [0.2, 0.7, 0.1, 0.2]]] * 2,
                           np.float32),
            "yl": np.zeros((2, 2), np.int32),
            "geo": rng.randn(1, 4, 3, 3).astype(np.float32),
            "q": np.array([[0, 0, 0, 2, 0, 2, 2, 0, 2],
                           [1, 0.5, 0, 2, 0.5, 1.5, 2, 0, 1.5]], np.float32),
            "cl": rng.rand(2, 5).astype(np.float32),
            "mi": np.array([[0, -1, -1, 1, -1], [-1, -1, 2, -1, -1]],
                           np.int32),
            "md": rng.rand(2, 5).astype(np.float32) * 0.6,
            "loc": rng.randn(5, 4).astype(np.float32) * 0.1,
            "conf": rng.randn(5, 3).astype(np.float32),
            "gtl": np.array([[1], [2], [1]], np.int64)}
    dicts, fetched = {}, {}
    for side, fluid in (("ref", jf), ("port", tf)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = _detection_layers(fluid)
        ops = {op.type for op in main.global_block().ops}
        dicts[side] = json.dumps(main.to_dict(), sort_keys=True,
                                 default=str)
        exe = fluid.Executor(fluid.CPUPlace())
        fetched[side] = [np.asarray(v) for v in
                         exe.run(main, feed=feed, fetch_list=outs)]
    assert dicts["ref"] == dicts["port"]
    assert {"prior_box", "density_prior_box", "anchor_generator",
            "iou_similarity", "box_coder", "bipartite_match",
            "target_assign", "box_clip", "multiclass_nms", "detection_map",
            "yolov3_loss", "polygon_box_transform",
            "roi_perspective_transform", "mine_hard_examples"} <= ops
    for i, (a, b) in enumerate(zip(fetched["port"], fetched["ref"])):
        assert_same(a, b, f"fetch {i}")
