"""The vision_extra family of paddle_tpu_torch (ops/vision_extra.py:
pool3d, spp, roi_pool, roi_align, psroi_pool, affine_channel,
affine_grid, crop, unpool, similarity_focus) against the JAX package on
the same numpy inputs, at the op sweep's tolerances (float outputs
within rtol 2e-3 and atol 1e-6, integer outputs exactly), beyond the
sweep's one spec each:

- pool3d: max with padding over all-negative input, exclusive and
  inclusive averages with padding, global pooling; spp at three levels
  on odd sizes (its asymmetric padding), max and average; gradients;
- roi_pool with tied maxima in a bin (JAX splits the gradient evenly
  among ties at both stages, W then H), empty bins and RoIs of two
  images; roi_align with RoIs over the map's border and outside it,
  sampling ratios 0 (2 in the reference) and 3, and the gradients of
  the map and of the boxes; psroi_pool and its gradient;
- unpool with two values at one position (the last one wins, and only
  it gets a gradient); crop from a Y input; affine_grid at sizes 1 and
  odd, its gradient, and the raise on a runtime OutputShape (in both
  packages, through a program); similarity_focus on every axis;
- the ten `layers` wrappers build the reference's `Program.to_dict()`
  and give its fetches; `layers` exports every public name of the
  reference's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from torch_op_test import (assert_same, check_op, ref_op_grads_jit,
                           run_ref_op_jit, run_torch_op_all, torch_op_grads)

torch.set_num_threads(2)

R = np.random.RandomState(22)


# -- pooling ----------------------------------------------------------------

X3 = R.randn(2, 3, 5, 6, 7).astype(np.float32)


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": 3, "strides": 2, "paddings": 1},
    {"pooling_type": "max", "ksize": [2, 3, 2], "strides": [1, 2, 2]},
    {"pooling_type": "avg", "ksize": 3, "strides": 2, "paddings": 1},
    {"pooling_type": "avg", "ksize": 3, "strides": 2, "paddings": 1,
     "exclusive": False},
    {"pooling_type": "avg", "ksize": 2, "strides": 1},
    {"pooling_type": "max", "global_pooling": True, "ksize": 1},
    {"pooling_type": "avg", "global_pooling": True, "ksize": 1},
])
def test_pool3d_matches_the_reference(attrs):
    check_op("pool3d", {"X": X3}, attrs, grad_slots=["X"])


def test_pool3d_max_pads_with_minus_inf():
    x = -np.abs(X3) - 1.0
    got = check_op("pool3d", {"X": x}, {"pooling_type": "max", "ksize": 3,
                                      "strides": 2, "paddings": 1})
    assert (got["Out"] < -1.0).all()


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("hw", [(7, 5), (9, 13)])
def test_spp_levels_match_the_reference(ptype, hw):
    x = R.randn(2, 3, *hw).astype(np.float32)
    got = check_op("spp", {"X": x}, {"pyramid_height": 3,
                                   "pooling_type": ptype},
                 grad_slots=["X"])
    assert got["Out"].shape == (2, 3 * (1 + 4 + 16))


# -- RoI ops ----------------------------------------------------------------

def _rois(boxes):
    return np.asarray(boxes, np.float32)


ROIS = _rois([[0, 0, 0, 5, 5], [1, 2, 1, 9, 7], [0, 6.4, 3.5, 11.6, 9.5],
              [1, 0, 0, 0, 0], [0, 10, 8, 14, 11]])


def test_roi_pool_ties_split_the_gradient_as_the_reference():
    x = np.round(R.rand(2, 3, 10, 12) * 3).astype(np.float32)   # many ties
    attrs = {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0}
    check_op("roi_pool", {"X": x, "ROIs": ROIS}, attrs, grad_slots=["X"])
    # more bins than pixels: empty bins read 0
    attrs = {"pooled_height": 4, "pooled_width": 5, "spatial_scale": 0.5}
    got = check_op("roi_pool", {"X": x, "ROIs": ROIS}, attrs,
                 grad_slots=["X"])
    assert (got["Out"][3] == 0).any() and np.isfinite(got["Out"]).all()


BORDER_ROIS = _rois([[0, -3.0, -2.0, 4.0, 5.0], [1, 8.5, 6.0, 14.0, 12.5],
                     [0, 20.0, 20.0, 30.0, 30.0], [1, 1.2, 1.7, 2.1, 2.2],
                     [0, 0.0, 0.0, 11.0, 9.0]])


@pytest.mark.parametrize("ratio", [0, 3])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_align_at_the_border_matches_the_reference(ratio, scale):
    x = R.randn(2, 3, 10, 12).astype(np.float32)
    attrs = {"pooled_height": 2, "pooled_width": 3, "spatial_scale": scale,
             "sampling_ratio": ratio}
    ins = {"X": x, "ROIs": BORDER_ROIS}
    got = check_op("roi_align", ins, attrs)
    if scale == 1.0:
        # the RoI past the map samples nothing
        assert (got["Out"][2] == 0).all()
    # the gradients of the map and of the box coordinates (batch ids
    # have none; the coordinates' sum a few products, atol 1e-5)
    g = torch_op_grads("roi_align", ins, attrs, ["X", "ROIs"], ["Out"])
    w = ref_op_grads_jit("roi_align", ins, attrs, ["X", "ROIs"], ["Out"])
    assert_same(g["X"], w["X"], "roi_align: dOut/dX")
    assert np.abs(w["ROIs"][:, 1:]).max() > 0
    np.testing.assert_allclose(g["ROIs"][:, 1:], w["ROIs"][:, 1:],
                               rtol=2e-3, atol=1e-5)


def test_psroi_pool_matches_the_reference():
    x = R.rand(2, 2 * 3 * 2, 9, 8).astype(np.float32)
    attrs = {"output_channels": 2, "pooled_height": 3, "pooled_width": 2,
             "spatial_scale": 0.5}
    rois = _rois([[0, 1, 2, 12, 14], [1, 0, 0, 3, 3], [0, 5.5, 4.4, 15, 17],
                  [1, 2, 2, 2, 2]])
    check_op("psroi_pool", {"X": x, "ROIs": rois}, attrs, grad_slots=["X"])


def test_psroi_pool_refuses_a_channel_count_as_the_reference():
    x = np.zeros((1, 5, 4, 4), np.float32)
    attrs = {"output_channels": 2, "pooled_height": 2, "pooled_width": 2}
    with pytest.raises(ValueError):
        run_torch_op_all("psroi_pool", {"X": x, "ROIs": ROIS[:1]}, attrs)
    with pytest.raises(ValueError):
        run_ref_op_jit("psroi_pool", {"X": x, "ROIs": ROIS[:1]}, attrs)


# -- the rest ---------------------------------------------------------------

def test_affine_channel_matches_the_reference():
    ins = {"X": R.randn(2, 4, 3, 5).astype(np.float32),
           "Scale": R.rand(4).astype(np.float32) + 0.5,
           "Bias": R.randn(4).astype(np.float32)}
    check_op("affine_channel", ins, {}, grad_slots=["X", "Scale", "Bias"])


@pytest.mark.parametrize("shape", [[2, 1, 5, 7], [2, 3, 1, 4],
                                   [2, 1, 16, 9]])
def test_affine_grid_matches_the_reference(shape):
    theta = R.randn(2, 2, 3).astype(np.float32)
    got = check_op("affine_grid", {"Theta": theta},
                 {"output_shape": shape}, out_slot="Output",
                 grad_slots=["Theta"])
    assert got["Output"].shape == (2, shape[2], shape[3], 2)


def test_affine_grid_refuses_a_runtime_output_shape_in_both():
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            theta = fluid.layers.data("theta", shape=[1, 2, 3],
                                      append_batch_size=False)
            shp = fluid.layers.data("shp", shape=[4], dtype="int32",
                                    append_batch_size=False)
            grid = fluid.layers.affine_grid(theta, shp)
        exe = fluid.Executor(fluid.CPUPlace())
        with pytest.raises(ValueError, match="OutputShape"):
            exe.run(main, feed={"theta": np.zeros((1, 2, 3), np.float32),
                                "shp": np.array([1, 1, 3, 3], np.int32)},
                    fetch_list=[grid])


def test_crop_from_a_y_input_matches_the_reference():
    x = R.randn(4, 5, 6).astype(np.float32)
    y = np.zeros((2, 3, 4), np.float32)
    check_op("crop", {"X": x, "Y": y}, {"offsets": [1, 2, 0]},
           grad_slots=["X"])


def test_unpool_last_write_wins_and_alone_gets_the_gradient():
    x = R.randn(2, 2, 2, 3).astype(np.float32)
    idx = R.randint(0, 12, (2, 2, 2, 3)).astype(np.int32)
    idx[0, 0, 0, 0] = idx[0, 0, 1, 2] = 5       # two values at one place
    attrs = {"unpool_size": [3, 4]}
    got = check_op("unpool", {"X": x, "Indices": idx}, attrs,
                 grad_slots=["X"])
    assert got["Out"][0, 0].reshape(-1)[5] == x[0, 0, 1, 2]
    g = torch_op_grads("unpool", {"X": x, "Indices": idx}, attrs, ["X"],
                       ["Out"])["X"]
    assert g[0, 0, 0, 0] == 0 and g[0, 0, 1, 2] != 0


@pytest.mark.parametrize("axis,indexes", [(1, [0, 2]), (2, [1]),
                                          (3, [0, 3])])
def test_similarity_focus_matches_the_reference(axis, indexes):
    x = R.rand(2, 3, 4, 5).astype(np.float32)
    x[0, 0, 1, 1] = x[0, 0, 2, 3]                  # a tie
    got = check_op("similarity_focus", {"X": x},
                 {"axis": axis, "indexes": indexes})
    assert set(np.unique(got["Out"])) <= {0.0, 1.0}


# -- layers -----------------------------------------------------------------

def _vision_program(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 8, 6, 7], append_batch_size=False)
    x3 = L.data("x3", shape=[1, 2, 4, 4, 4], append_batch_size=False)
    rois = L.data("rois", shape=[3, 5], append_batch_size=False)
    theta = L.data("theta", shape=[2, 2, 3], append_batch_size=False)
    idx = L.data("idx", shape=[2, 8, 3, 3], dtype="int32",
                  append_batch_size=False)
    scale = L.assign(np.linspace(0.5, 1.5, 8).astype(np.float32))
    bias = L.assign(np.linspace(-1, 1, 8).astype(np.float32))
    pooled = L.pool2d(x, 2, "max", 2)
    outs = [L.pool3d(x3, 2, "avg", 2),
            L.spp(x, pyramid_height=2),
            L.roi_pool(x, rois, 2, 3, 0.5),
            L.roi_align(x, rois, 2, 2, 0.5, sampling_ratio=2),
            L.affine_channel(x, scale=scale, bias=bias),
            L.affine_grid(theta, [2, 1, 3, 4]),
            L.crop(x, shape=[1, 4, 3, 3], offsets=[1, 2, 1, 2]),
            L.unpool(pooled, idx, [6, 6]),
            L.similarity_focus(x, axis=1, indexes=[0, 3]),
            L.psroi_pool(x, rois, 2, 0.5, 2, 2)]
    return outs


def test_the_vision_layers_build_the_references_program_and_fetches():
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    feed = {"x": R.randn(2, 8, 6, 7).astype(np.float32),
            "x3": R.randn(1, 2, 4, 4, 4).astype(np.float32),
            "rois": _rois([[0, 0, 0, 9, 9], [1, 2, 1, 12, 11],
                           [0, 4, 3, 8, 13]]),
            "theta": R.randn(2, 2, 3).astype(np.float32),
            "idx": R.randint(0, 36, (2, 8, 3, 3)).astype(np.int32)}
    dicts, fetched = {}, {}
    for side, fluid in (("ref", jf), ("port", tf)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = _vision_program(fluid)
        dicts[side] = json.dumps(main.to_dict(), sort_keys=True,
                                 default=str)
        exe = fluid.Executor(fluid.CPUPlace())
        fetched[side] = [np.asarray(v) for v in
                         exe.run(main, feed=feed, fetch_list=outs)]
    assert dicts["ref"] == dicts["port"]
    assert len(fetched["port"]) == 10
    for i, (a, b) in enumerate(zip(fetched["port"], fetched["ref"])):
        assert_same(a, b, f"layer {i}")


def test_layers_exports_every_public_name_of_the_references():
    import paddle_tpu.layers as ref_layers
    import paddle_tpu_torch.layers as port_layers

    want = {n for n in dir(ref_layers) if not n.startswith("_")}
    have = {n for n in dir(port_layers) if not n.startswith("_")}
    assert len(want) == 252
    assert not want - have, sorted(want - have)
    for n in ("detection", "pool3d", "roi_align", "affine_channel",
              "LayerHelper", "ParamAttr", "Variable", "tensor_layers"):
        assert hasattr(port_layers, n)
