"""Edge cases of the registry's dense half (ops/nn.py, basic.py, misc.py,
sparse.py and rnn.py of the reference) in paddle_tpu_torch against the
JAX package, on the same numpy inputs, forward (every output slot) and
gradients, at the sweep's tolerances (tests/test_torch_op_sweep.py:
float outputs within rtol 2e-3 and atol 1e-6, integer and boolean
outputs exactly), where the torch library call computes something else
than the reference or the CUDA semantics could part from the CPU's:

- interpolate: bilinear and nearest, align_corners True and False,
  align_mode 0 and 1, up and down, out size 1, the nearest index at
  exact halves;
- lrn's MidOut (alpha not divided by n);
- grid_sampler at points outside [-1, 1] (weights from the unclamped
  coordinates, reads clamped);
- pool2d_with_index padded, global (paddings ignored) and with ties in
  a window (the first in scan order wins);
- scatter with duplicate ids, overwrite (the last wins) and add, and
  ids negative or past the rows;
- cumsum exclusive, reverse and both; argsort and arg_min with ties;
  hash of negative ids; shard_index; multiplex;
- conv2d/conv3d transposes with groups, dilation, stride and padding;
  conv3d with "SAME" padding;
- attention_lstm with ragged lengths (one of 0) and the attention
  scalars; row_conv.

Then `layers`: one program calling every `layers` name this slice adds
(83 of them, switch_moe included) builds the same `Program.to_dict()` in
both packages, and runs in the port on the CPU to finite values.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=1e-6)
R = np.random.RandomState(20)


def _f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _same(got, want, what):
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


_IMG = _f32(2, 3, 5, 7)
_TIES = np.array([[[[1, 1, 0, 2], [1, 0, 2, 2], [3, 3, 1, 1],
                    [3, 0, 1, 1]]]], np.float32) * 0.5
_GRID_OUT = np.array([[[[-1.4, -1.2], [0.3, 1.6]], [[1.0, -1.0],
                                                    [2.5, 0.2]]]],
                     np.float32)
_ROWS = _f32(6, 3)
_DUP = np.array([2, 4, 2, -1, 7, 2, 4], np.int32)   # -1 wraps to 5; 7 drops
_UPD = _f32(7, 3)

# (op, inputs, attrs, output slot for the gradient, gradient slots)
CASES = {
    "interp bilinear align_corners up": (
        "interpolate", {"X": _IMG}, {"out_h": 9, "out_w": 13}, "Out",
        ["X"]),
    "interp bilinear align_corners down": (
        "interpolate", {"X": _IMG}, {"out_h": 3, "out_w": 4}, "Out", ["X"]),
    "interp bilinear mode 0": (
        "interpolate", {"X": _IMG}, {"out_h": 8, "out_w": 11,
                                     "align_corners": False,
                                     "align_mode": 0}, "Out", ["X"]),
    "interp bilinear mode 1": (
        "interpolate", {"X": _IMG}, {"out_h": 8, "out_w": 11,
                                     "align_corners": False,
                                     "align_mode": 1}, "Out", ["X"]),
    "interp bilinear out size 1": (
        "interpolate", {"X": _IMG}, {"out_h": 1, "out_w": 1}, "Out", ["X"]),
    "interp nearest align_corners halves": (
        "interpolate", {"X": _IMG}, {"out_h": 9, "out_w": 13,
                                     "interp_method": "nearest"}, "Out",
        ["X"]),
    "interp nearest floor": (
        "interpolate", {"X": _IMG}, {"out_h": 4, "out_w": 10,
                                     "interp_method": "nearest",
                                     "align_corners": False}, "Out", ["X"]),
    "interp nearest out size 1": (
        "interpolate", {"X": _IMG}, {"out_h": 1, "out_w": 3,
                                     "interp_method": "nearest"}, "Out",
        ["X"]),
    "lrn MidOut": ("lrn", {"X": np.abs(_f32(2, 6, 3, 3)) + 0.5},
                   {"n": 5, "k": 1.5, "alpha": 0.3, "beta": 0.6}, "MidOut",
                   ["X"]),
    "lrn Out": ("lrn", {"X": np.abs(_f32(2, 6, 3, 3)) + 0.5},
                {"n": 3, "alpha": 0.3}, "Out", ["X"]),
    "grid_sampler outside [-1, 1]": (
        "grid_sampler", {"X": _f32(1, 2, 4, 5), "Grid": _GRID_OUT},
        {}, "Output", ["X", "Grid"]),
    "pool2d_with_index padded": (
        "pool2d_with_index", {"X": -np.abs(_f32(2, 2, 5, 5)) - 1.0},
        {"ksize": 3, "strides": 2, "paddings": 1}, "Out", ["X"]),
    "pool2d_with_index padding past the input": (
        "pool2d_with_index", {"X": _f32(1, 1, 3, 3)},
        {"ksize": 2, "strides": 2, "paddings": 1}, "Out", ["X"]),
    "pool2d_with_index global": (
        "pool2d_with_index", {"X": _f32(2, 3, 4, 3)},
        {"ksize": 2, "global_pooling": True, "paddings": 1}, "Out", ["X"]),
    "pool2d_with_index ties": (
        "pool2d_with_index", {"X": _TIES}, {"ksize": 2, "strides": 2},
        "Out", ["X"]),
    "pool2d_with_index overlapping ties": (
        "pool2d_with_index", {"X": _TIES}, {"ksize": 3, "strides": 1},
        "Out", ["X"]),
    "scatter overwrite duplicates": (
        "scatter", {"X": _ROWS, "Ids": _DUP, "Updates": _UPD},
        {"overwrite": True}, "Out", ["X", "Updates"]),
    "scatter add duplicates": (
        "scatter", {"X": _ROWS, "Ids": _DUP, "Updates": _UPD},
        {"overwrite": False}, "Out", ["X", "Updates"]),
    "cumsum exclusive": ("cumsum", {"X": _f32(3, 5)},
                         {"axis": 1, "exclusive": True}, "Out", ["X"]),
    "cumsum reverse": ("cumsum", {"X": _f32(3, 5)},
                       {"axis": 0, "reverse": True}, "Out", ["X"]),
    "cumsum exclusive reverse": ("cumsum", {"X": _f32(3, 5)},
                                 {"axis": -1, "exclusive": True,
                                  "reverse": True}, "Out", ["X"]),
    "argsort ties": ("argsort", {"X": np.array(
        [[2, 1, 2, 0, 1, 2], [5, 5, 5, 5, 1, 1]], np.float32)},
        {"axis": -1}, "Out", ["X"]),
    "argsort ties axis 0": ("argsort", {"X": np.array(
        [[1, 0, 3], [1, 2, 3], [0, 2, 3]], np.float32)}, {"axis": 0},
        "Out", []),
    "arg_min ties": ("arg_min", {"X": np.array(
        [[3, 1, 1, 2], [0, 0, 0, 0]], np.float32)}, {"axis": 1}, "Out",
        []),
    "hash negative ids": ("hash", {"X": np.array(
        [[-1], [-7], [-2 ** 31], [2 ** 31 - 1], [0], [123456789]],
        np.int32)}, {"mod_by": 10007}, "Out", []),
    "shard_index negatives": ("shard_index", {"X": np.array(
        [[-3], [0], [7], [8], [15], [20]], np.int32)},
        {"index_num": 16, "nshards": 2, "shard_id": 1,
         "ignore_value": -9}, "Out", []),
    "multiplex": ("multiplex", {"Ids": np.array([[2], [0], [1], [2]],
                                                np.int32),
                                "X": [_f32(4, 3) for _ in range(3)]},
                  {}, "Out", []),
    "conv2d_transpose groups dilation": (
        "conv2d_transpose", {"Input": _f32(2, 4, 5, 4),
                             "Filter": _f32(4, 3, 3, 2) * 0.3},
        {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2],
         "groups": 2}, "Output", ["Input", "Filter"]),
    "conv3d_transpose stride 2": (
        "conv3d_transpose", {"Input": _f32(1, 2, 3, 4, 3),
                             "Filter": _f32(2, 3, 2, 3, 2) * 0.3},
        {"strides": 2, "paddings": [0, 1, 0]}, "Output",
        ["Input", "Filter"]),
    "depthwise_conv2d_transpose": (
        "depthwise_conv2d_transpose", {"Input": _f32(1, 3, 4, 4),
                                       "Filter": _f32(3, 1, 3, 3) * 0.3},
        {"strides": 2, "paddings": 1, "groups": 3}, "Output",
        ["Input", "Filter"]),
    "conv3d SAME stride 2": (
        "conv3d", {"Input": _f32(1, 2, 5, 6, 5),
                   "Filter": _f32(3, 2, 3, 2, 3) * 0.3},
        {"strides": 2, "paddings": "SAME"}, "Output", ["Input", "Filter"]),
    "conv3d groups dilation": (
        "conv3d", {"Input": _f32(1, 4, 6, 6, 6),
                   "Filter": _f32(2, 2, 2, 2, 2) * 0.3},
        {"groups": 2, "dilations": 2, "paddings": 1}, "Output",
        ["Input", "Filter"]),
    "attention_lstm ragged, scalars": (
        "attention_lstm", {
            "X": _f32(3, 5, 4), "C0": _f32(3, 2), "H0": _f32(3, 2),
            "AttentionWeight": _f32(6, 1), "AttentionBias": _f32(1, 1),
            "AttentionScalar": np.array([[0.7]], np.float32),
            "AttentionScalarBias": np.array([[0.1]], np.float32),
            "LSTMWeight": _f32(6, 8), "LSTMBias": _f32(1, 8),
            "SeqLen": np.array([5, 0, 3], np.int32)},
        {}, "Hidden", ["X", "C0", "H0", "AttentionWeight", "LSTMWeight",
                       "LSTMBias"]),
    "row_conv": ("row_conv", {"X": _f32(2, 6, 3), "Filter": _f32(3, 3)},
                 {}, "Out", ["X", "Filter"]),
    "teacher_student every branch": (
        "teacher_student_sigmoid_loss",
        {"X": np.array([[-20.0], [0.3], [-0.7], [18.0], [2.0]], np.float32),
         "Label": np.array([[-2.0], [-0.5], [0.3], [1.6], [0.0]],
                           np.float32)},
        {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}, "Y",
        ["X"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_case_matches_the_reference(case):
    op, ins, attrs, out_slot, grad_slots = CASES[case]
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(want), case
    for slot in want:
        _same(got[slot], want[slot], f"{case}: {slot}")
    for slot in grad_slots:
        g = torch_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        w = ref_op_grads(op, ins, attrs, [slot], [out_slot])[slot]
        assert np.abs(w).max() > 0, f"{case}: vacuous d/d{slot}"
        _same(g, w, f"{case}: d{out_slot}/d{slot}")


def test_scatter_overwrite_keeps_the_last_duplicate():
    out = run_torch_op_all("scatter", {"X": _ROWS, "Ids": _DUP,
                                       "Updates": _UPD}, {})["Out"]
    np.testing.assert_array_equal(out[2], _UPD[5])
    np.testing.assert_array_equal(out[4], _UPD[6])
    np.testing.assert_array_equal(out[5], _UPD[3])
    np.testing.assert_array_equal(out[[0, 1, 3]], _ROWS[[0, 1, 3]])
    g = torch_op_grads("scatter", {"X": _ROWS, "Ids": _DUP,
                                   "Updates": _UPD}, {}, ["Updates"],
                       ["Out"])["Updates"]
    assert not g[[0, 1, 2, 4]].any() and g[[3, 5, 6]].all()


def test_hash_is_the_uint32_xorshift_multiply():
    x = np.array([-1, -7, 5, 2 ** 31 - 1], np.int32)
    v = x.astype(np.uint32).astype(np.uint64)
    v ^= v >> 16
    v = (v * 0x45D9F3B) & 0xFFFFFFFF
    v ^= v >> 16
    got = run_torch_op_all("hash", {"X": x}, {"mod_by": 1000})["Out"]
    np.testing.assert_array_equal(got, (v % 1000).astype(np.int32))


def test_pool2d_with_index_mask_is_the_first_maximum():
    o = run_torch_op_all("pool2d_with_index", {"X": _TIES},
                         {"ksize": 2, "strides": 2})
    np.testing.assert_array_equal(o["Mask"][0, 0], [[0, 3], [8, 10]])


# -- the layers this slice adds ---------------------------------------------

def _every_new_layer(fluid):
    """One call of each layers name the slice adds; returns the outputs
    to fetch."""
    L = fluid.layers
    outs = []
    x = L.data("x", shape=[3, 6, 6], dtype="float32")
    v = L.data("v", shape=[8], dtype="float32")
    w = L.data("w", shape=[8], dtype="float32")
    ids = L.data("ids", shape=[1], dtype="int64")
    seq = L.data("seq", shape=[5, 4], dtype="float32", lod_level=1)
    for name in ("abs", "brelu", "ceil", "cos", "elu", "exp", "floor",
                 "hard_shrink", "hard_sigmoid", "leaky_relu", "log_softmax",
                 "logsigmoid", "reciprocal", "relu", "relu6", "round",
                 "rsqrt", "selu", "sign", "sin", "soft_relu", "softplus",
                 "softshrink", "softsign", "stanh", "swish", "tanh_shrink",
                 "thresholded_relu"):
        outs.append(getattr(L, name)(v))
    outs.append(L.pow(v, factor=2.0))
    outs.append(L.argmin(v, axis=1))
    outs += list(L.argsort(v, axis=1))
    outs.append(L.conv2d_transpose(x, num_filters=4, filter_size=3,
                                   stride=2, padding=1))
    x5 = L.reshape(x, shape=[-1, 1, 3, 6, 6])
    outs.append(L.conv3d(x5, num_filters=2, filter_size=3, padding=1))
    outs.append(L.conv3d_transpose(x5, num_filters=2, filter_size=2))
    outs.append(L.conv_shift(v, L.slice(w, axes=[1], starts=[0],
                                        ends=[3])))
    outs.append(L.cos_sim(v, w))
    outs.append(L.cumsum(v, axis=1, exclusive=True, reverse=True))
    for name in ("elementwise_min", "elementwise_pow", "elementwise_mod",
                 "greater_equal"):
        outs.append(getattr(L, name)(L.abs(v), L.abs(w)))
    outs.append(L.flatten(x, axis=2))
    outs.append(L.grid_sampler(x, L.scale(L.reshape(
        L.slice(x, axes=[1], starts=[0], ends=[2]), shape=[-1, 6, 6, 2]),
        scale=0.5)))
    outs.append(L.group_norm(x, groups=3))
    outs.append(L.huber_loss(v, w, delta=0.5))
    outs.append(L.image_resize(x, out_shape=[4, 9]))
    outs.append(L.resize_bilinear(x, scale=1.5))
    outs.append(L.resize_nearest(x, out_shape=[3, 5]))
    outs.append(L.isfinite(v))
    outs.append(L.kldiv_loss(v, L.abs(w), reduction="batchmean"))
    outs.append(L.log_loss(L.sigmoid(v), L.sigmoid(w)))
    outs.append(L.lrn(L.abs(x), n=3))
    outs.append(L.maxout(x, groups=3))
    mw = L.create_global_var(shape=[8, 2], value=0.5, dtype="float32",
                             persistable=True, name="mul_w")
    outs.append(L.mul(v, mw))
    outs.append(L.pad(v, paddings=[1, 0, 2, 1], pad_value=0.5))
    outs.append(L.pad2d(x, paddings=[1, 0, 2, 1], mode="reflect"))
    outs.append(L.pad_constant_like(x, L.slice(x, axes=[2], starts=[0],
                                               ends=[4])))
    outs.append(L.prelu(x, mode="channel"))
    outs.append(L.random_crop(x, shape=[3, 4, 4]))
    outs.append(L.reduce_max(v, dim=1))
    outs.append(L.reduce_min(x, dim=[1, 2], keep_dim=True))
    outs.append(L.reduce_prod(w))
    outs.append(L.reverse(x, axis=[1, 3]))
    outs.append(L.scatter(w, L.cast(L.argmin(w, axis=0), "int32"),
                          L.slice(v, axes=[0], starts=[0], ends=[1])))
    outs.append(L.shape(x))
    outs.append(L.smooth_l1(v, w, sigma=2.0))
    outs.append(L.space_to_depth(x, blocksize=2))
    outs.append(L.stack([v, w], axis=1))
    outs += L.unstack(L.reshape(v, shape=[-1, 2, 4]), axis=1)
    h, aux, frac = L.switch_moe(v, num_experts=4, d_inner=16, top_k=2)
    outs += [h, aux, frac]
    outs.append(L.teacher_student_sigmoid_loss(
        L.slice(v, axes=[1], starts=[0], ends=[1]),
        L.slice(w, axes=[1], starts=[0], ends=[1])))
    outs.append(L.uniform_random_batch_size_like(v, shape=[-1, 3]))
    outs.append(L.gaussian_random(shape=[2, 3], std=0.5))
    outs.append(L.uniform_random(shape=[2, 3], min=0.0, max=2.0))
    outs.append(L.zeros(shape=[2], dtype="float32"))
    outs.append(L.ones(shape=[2], dtype="int32"))
    outs.append(L.zeros_like(v))
    gv = L.create_global_var(shape=[2], value=3.0, dtype="float32",
                             persistable=True, name="gvar")
    outs.append(L.elementwise_add(gv, L.ones(shape=[2], dtype="float32")))
    L.create_tensor("float32", name="tensor_slot")
    outs.append(L.row_conv(seq, future_context_size=2))
    outs.append(L.Print(v, message="every_new_layer"))
    dst = fluid.default_main_program().global_block().create_var(
        name="pyout", shape=(-1, 8), dtype="float32")
    L.py_func(lambda a: a * 2.0, v, dst)
    outs.append(dst)
    assert L.normalize_dtype("int64") == "int64"
    return outs


def test_every_new_layer_builds_the_reference_program():
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    progs = {}
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = _every_new_layer(fluid)
        progs[fluid.__name__] = (main, startup, outs)
    (jm, js, _), (tm, ts, touts) = progs["paddle_tpu"], \
        progs["paddle_tpu_torch"]
    assert json.dumps(tm.to_dict(), sort_keys=True) == \
        json.dumps(jm.to_dict(), sort_keys=True)
    assert json.dumps(ts.to_dict(), sort_keys=True) == \
        json.dumps(js.to_dict(), sort_keys=True)
    r = np.random.RandomState(0)
    feed = {"x": r.rand(2, 3, 6, 6).astype(np.float32) + 0.1,
            "v": r.randn(2, 8).astype(np.float32),
            "w": r.randn(2, 8).astype(np.float32),
            "ids": r.randint(0, 8, (2, 1)).astype(np.int64),
            "seq": r.randn(2, 5, 4).astype(np.float32),
            "seq.seq_len": np.array([5, 3], np.int32)}
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    got = exe.run(tm, feed=feed, fetch_list=touts, scope=scope)
    assert len(got) == len(touts)
    for var, val in zip(touts, got):
        val = np.asarray(val)
        if np.issubdtype(val.dtype, np.floating):
            assert np.isfinite(val).all() or var.name.startswith(
                ("rsqrt", "reciprocal", "log")), var.name
