"""The port op sweep: every op paddle_tpu_torch registers, driven from
the reference sweep's input specs (`S` of tests/test_op_sweep.py) in
both packages on the same numpy inputs.

- Forward: every output slot the two return, through `run_torch_op_all`
  against `run_ref_op_all` (tests/torch_op_test.py).  Floating outputs
  within rtol 2e-3 and atol 1e-6 (float32 on both sides, other libm and
  summation orders, sums over a few terms); integer and boolean outputs
  exactly.
- Gradients, where the spec lists `grad` slots: `torch_op_grads` (torch
  autograd) against `ref_op_grads` (jax.grad) of one fixed weighted sum
  of the spec's output, within rtol 2e-3 and atol 1e-6.
- Ops the spec marks RANDOM draw from torch generators, not threefry
  (ROADMAP C2): their shape and dtype are the reference's, their
  moments those of the distribution (on 4096 draws), and
  truncated_gaussian_random stays inside mean +- 2 std.
- Coverage: every port op has a spec in `S` or an exemption with its
  reason, and every port op name is a reference op name.
- The edge cases of the ops ported with BERT: `slice` starts and ends
  negative and out of range, `range`'s output dtype, `gelu`'s two forms,
  `reduce_mean` over dim lists, keep_dim and reduce_all.
- The edge cases of the ops ported with the image family and DeepFM,
  forward (every output slot) and gradients: conv2d with "SAME" (odd and
  even totals) and "VALID" at stride 2, groups, dilation and NHWC;
  depthwise SAME; max pooling with padding over all-negative input and
  with padding wider than half the window; exclusive and inclusive avg
  pooling with padding; global pooling; NHWC pooling; batch norm's
  momentum convention and biased variance, NHWC, is_test and
  use_global_stats; Nesterov momentum; sigmoid CE's ignore_index; AUC
  on running histograms; fill_constant_batch_size_like's dim indices.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as ref_registry
from paddle_tpu_torch.core.registry import registered_ops
from test_op_sweep import RANDOM, S
from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=1e-6)

# port ops without a spec in S, each with the reason
EXEMPT = {
    "backward_marker": "internal sentinel marking the forward/backward "
                       "boundary; the executor splits the step at it "
                       "(test_torch_training.py)",
    "lr_schedule": "driven by the optimizer machinery; its rates are "
                   "held against the reference in test_torch_training.py "
                   "and test_torch_bert.py",
}
PORT_OPS = registered_ops()
SWEPT = sorted(op for op in PORT_OPS if op in S)
DETERMINISTIC = [op for op in SWEPT if S[op].get("nondiff") != RANDOM]
RANDOM_OPS = [op for op in SWEPT if S[op].get("nondiff") == RANDOM]
GRADS = [(op, slot) for op in DETERMINISTIC if not S[op].get("nondiff")
         for slot in S[op].get("grad", [])]


def _assert_same(got, want, what):
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _same_dtype(got, want):
    """The port's runtime dtype is the reference's (64-bit names narrow
    to 32 bits in both)."""
    return np.dtype(got.dtype) == np.dtype(want.dtype)


def test_every_port_op_is_swept_or_exempt():
    port, ref = set(PORT_OPS), set(ref_registry._REGISTRY)
    assert not port - ref, f"port ops the reference lacks: {port - ref}"
    missing = sorted(port - set(S) - set(EXEMPT))
    assert not missing, f"port ops without a sweep spec: {missing}"
    assert not set(EXEMPT) & set(S)
    assert set(EXEMPT) <= port
    assert {"gelu", "range", "slice", "truncated_gaussian_random",
            "reduce_mean", "conv2d", "depthwise_conv2d", "pool2d",
            "batch_norm", "momentum", "auc", "square",
            "sigmoid_cross_entropy_with_logits",
            "fill_constant_batch_size_like"} <= set(SWEPT)


@pytest.mark.parametrize("op", DETERMINISTIC)
def test_forward_matches_the_reference(op):
    spec = S[op]
    got = run_torch_op_all(op, spec["ins"], spec.get("attrs"))
    want = run_ref_op_all(op, spec["ins"], spec.get("attrs"))
    assert spec["out"] in got
    slots = sorted(set(got) & set(want))
    assert spec["out"] in slots
    for slot in slots:
        _assert_same(got[slot], want[slot], f"{op}.{slot}")
        assert _same_dtype(got[slot], want[slot]), \
            f"{op}.{slot}: {got[slot].dtype} != {want[slot].dtype}"
    if spec.get("shape") is not None:
        assert got[spec["out"]].shape == tuple(spec["shape"])


@pytest.mark.parametrize("op,slot", GRADS)
def test_gradient_matches_the_reference(op, slot):
    spec = S[op]
    got = torch_op_grads(op, spec["ins"], spec.get("attrs"), [slot],
                         [spec["out"]])[slot]
    want = ref_op_grads(op, spec["ins"], spec.get("attrs"), [slot],
                        [spec["out"]])[slot]
    _assert_same(got, want, f"d{op}/d{slot}")
    assert np.abs(want).max() > 0, "a vacuous gradient"


# moments of each random op on 4096 draws: (attrs, mean, std)
_TRUNC_STD = 0.8796256610342398     # of N(0, 1) truncated to [-2, 2]
MOMENTS = {
    "gaussian_random": [({"mean": 1.0, "std": 2.0}, 1.0, 2.0)],
    "uniform_random": [({"min": -3.0, "max": 5.0}, 1.0, 8 / 12 ** 0.5)],
    "truncated_gaussian_random": [
        ({}, 0.0, _TRUNC_STD),
        ({"mean": 0.5, "std": 0.02}, 0.5, 0.02 * _TRUNC_STD)],
}


@pytest.mark.parametrize("op", RANDOM_OPS)
def test_random_op_shape_dtype_and_moments(op):
    spec = S[op]
    got = run_torch_op_all(op, spec["ins"], spec.get("attrs"))
    want = run_ref_op_all(op, spec["ins"], spec.get("attrs"))
    out = spec["out"]
    assert got[out].shape == want[out].shape == tuple(spec["shape"])
    assert _same_dtype(got[out], want[out])
    if op == "dropout":
        x = np.ones((64, 64), np.float32)
        o = run_torch_op_all(op, {"X": x}, spec["attrs"])
        keep = o["Mask"]
        assert set(np.unique(keep)) <= {0.0, 1.0}
        np.testing.assert_array_equal(o["Out"], x * keep)  # downgrade
        assert abs(keep.mean() - (1 - spec["attrs"]["dropout_prob"])) \
            < 4 * 0.5 / 64
        return
    for attrs, mean, std in MOMENTS[op]:
        attrs = dict(spec.get("attrs", {}), shape=[64, 64], **attrs)
        x = run_torch_op_all(op, {}, attrs)[out]
        assert x.shape == (64, 64) and np.isfinite(x).all()
        assert abs(x.mean() - mean) < 4 * std / 64, attrs
        assert abs(x.std() - std) < 0.05 * std, attrs
        if op == "truncated_gaussian_random":
            bound = 2 * attrs.get("std", 1.0)
            assert np.abs(x - mean).max() <= bound * (1 + 1e-6), attrs
            assert np.abs(x - mean).max() > 0.95 * bound, attrs


# -- edge cases of the ops ported with BERT --------------------------------

_X = np.arange(4 * 6, dtype=np.float32).reshape(4, 6) * 0.1 - 1.0


@pytest.mark.parametrize("starts,ends", [
    ([1, -2], [3, 100]),             # end past the dim is cut to it
    ([-3, -100], [-1, 4]),           # s + dim still negative
    ([-100, 2], [-50, -1]),          # both negative after the wrap
    ([5, 0], [2, 6]),                # start past the dim, start > end
    ([0, -6], [4, 0]),               # empty on axis 1
    ([2, 7], [-1, 9]),
])
def test_slice_bounds_match_the_reference(starts, ends):
    attrs = {"axes": [0, 1], "starts": starts, "ends": ends}
    got = run_torch_op_all("slice", {"Input": _X}, attrs)["Out"]
    want = run_ref_op_all("slice", {"Input": _X}, attrs)["Out"]
    _assert_same(got, want, f"slice {starts} {ends}")
    if got.size:
        g = torch_op_grads("slice", {"Input": _X}, attrs, ["Input"],
                           ["Out"])["Input"]
        w = ref_op_grads("slice", {"Input": _X}, attrs, ["Input"],
                         ["Out"])["Input"]
        _assert_same(g, w, "slice gradient")


@pytest.mark.parametrize("dtype,start,step,num", [
    (np.int32, 0, 1, 16),            # layers.range(..., "int64") feeds
    (np.int32, 5, -2, 4),
    (np.float32, 0.5, 0.25, 7),
])
def test_range_values_and_dtype_match_the_reference(dtype, start, step,
                                                    num):
    ins = {"Start": np.array([start], dtype),
           "End": np.array([start + step * num], dtype),
           "Step": np.array([step], dtype)}
    got = run_torch_op_all("range", ins, {"num": num})["Out"]
    want = run_ref_op_all("range", ins, {"num": num})["Out"]
    _assert_same(got, want, "range")
    assert got.dtype == want.dtype


def test_range_layer_narrows_int64_as_the_reference():
    """layers.range(0, T, 1, "int64") declares int64 and runs as int32 in
    both packages; the VarDesc says what the reference's says."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf

    outs = {}
    for fluid in (jf, tf):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            r = fluid.layers.range(0, 8, 1, "int64")
        exe = fluid.Executor(fluid.CPUPlace())
        got = exe.run(main, fetch_list=[r], scope=fluid.Scope())[0]
        outs[fluid.__name__] = (np.asarray(got),
                                main.global_block().var(r.name).dtype)
    (a, da), (b, db) = outs["paddle_tpu_torch"], outs["paddle_tpu"]
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.int32 and da == db


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_forms_match_the_reference(approximate):
    x = np.linspace(-4, 4, 41, dtype=np.float32).reshape(1, 41)
    attrs = {"approximate": approximate}
    _assert_same(run_torch_op_all("gelu", {"X": x}, attrs)["Out"],
                 run_ref_op_all("gelu", {"X": x}, attrs)["Out"], "gelu")
    _assert_same(torch_op_grads("gelu", {"X": x}, attrs, ["X"],
                                ["Out"])["X"],
                 ref_op_grads("gelu", {"X": x}, attrs, ["X"], ["Out"])["X"],
                 "gelu gradient")


@pytest.mark.parametrize("attrs", [
    {"dim": [0, 2]},
    {"dim": [-1], "keep_dim": True},
    {"dim": [1, -1], "keep_dim": True},
    {"reduce_all": True, "dim": [0]},
    {"reduce_all": True, "dim": [0], "keep_dim": True},
    {"dim": [0]},
])
def test_reduce_mean_dims_match_the_reference(attrs):
    x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    _assert_same(run_torch_op_all("reduce_mean", {"X": x}, attrs)["Out"],
                 run_ref_op_all("reduce_mean", {"X": x}, attrs)["Out"],
                 f"reduce_mean {attrs}")
    _assert_same(torch_op_grads("reduce_mean", {"X": x}, attrs, ["X"],
                                ["Out"])["X"],
                 ref_op_grads("reduce_mean", {"X": x}, attrs, ["X"],
                              ["Out"])["X"], "reduce_mean gradient")


# -- edge cases of the ops ported with the image family and DeepFM --------

_R = np.random.RandomState(11)
_IMG = _R.randn(2, 3, 7, 7).astype(np.float32)
_NEG = -np.abs(_R.randn(1, 2, 5, 5)).astype(np.float32) - 1.0
_W = (_R.randn(4, 3, 3, 3) * 0.3).astype(np.float32)
_WG = (_R.randn(6, 1, 3, 3) * 0.3).astype(np.float32)
_BN = dict(X=(_R.randn(4, 3, 2, 2) * 2 + 3).astype(np.float32),
           Scale=_R.rand(3).astype(np.float32) + 0.5,
           Bias=_R.randn(3).astype(np.float32),
           Mean=_R.randn(3).astype(np.float32),
           Variance=_R.rand(3).astype(np.float32) + 0.5)
_BN_NHWC = dict(_BN, X=np.ascontiguousarray(_BN["X"].transpose(0, 2, 3, 1)))
_P, _G, _V = (_R.randn(3, 2).astype(np.float32) for _ in range(3))

# (op, inputs, attrs, output slot, gradient slots)
EDGES = {
    "conv SAME stride 2": ("conv2d", {"Input": _IMG, "Filter": _W},
                           {"strides": 2, "paddings": "SAME"}, "Output",
                           ["Input", "Filter"]),
    "conv SAME stride 2 even": ("conv2d", {"Input": _IMG[:, :, :6, :6],
                                           "Filter": _W},
                                {"strides": 2, "paddings": "SAME"},
                                "Output", ["Input", "Filter"]),
    "conv VALID stride 2": ("conv2d", {"Input": _IMG, "Filter": _W},
                            {"strides": [2, 1], "paddings": "VALID"},
                            "Output", ["Input", "Filter"]),
    "conv groups 3": ("conv2d", {"Input": _IMG, "Filter": _WG},
                      {"groups": 3, "paddings": 1}, "Output",
                      ["Input", "Filter"]),
    "conv dilation 2": ("conv2d", {"Input": _IMG, "Filter": _W},
                        {"dilations": 2, "paddings": [2, 1]}, "Output",
                        ["Input", "Filter"]),
    "conv NHWC": ("conv2d", {"Input": np.ascontiguousarray(
        _IMG.transpose(0, 2, 3, 1)), "Filter": _W},
        {"strides": 2, "paddings": 1, "data_format": "NHWC"}, "Output",
        ["Input", "Filter"]),
    "depthwise SAME": ("depthwise_conv2d",
                       {"Input": _IMG, "Filter": _WG[:3]},
                       {"paddings": "SAME"}, "Output", ["Input", "Filter"]),
    "max pool padded, all negative": ("pool2d", {"X": _NEG},
                                      {"ksize": 3, "strides": 2,
                                       "paddings": 1}, "Out", ["X"]),
    # windows wholly in the padding: -inf (max) and 0 / 0 (exclusive avg)
    "max pool padded wider than half": ("pool2d", {"X": _NEG},
                                        {"ksize": 2, "strides": 1,
                                         "paddings": 2}, "Out", ["X"]),
    "avg pool exclusive padded": ("pool2d", {"X": _IMG},
                                  {"ksize": 3, "strides": 2, "paddings": 1,
                                   "pooling_type": "avg"}, "Out", ["X"]),
    "avg pool inclusive padded": ("pool2d", {"X": _IMG},
                                  {"ksize": 3, "strides": 2, "paddings": 1,
                                   "pooling_type": "avg",
                                   "exclusive": False}, "Out", ["X"]),
    "avg pool exclusive wider than half": ("pool2d", {"X": _IMG},
                                           {"ksize": 2, "strides": 2,
                                            "paddings": 2,
                                            "pooling_type": "avg"},
                                           "Out", ["X"]),
    "global max pool": ("pool2d", {"X": _IMG},
                        {"ksize": 2, "global_pooling": True}, "Out", ["X"]),
    "global avg pool NHWC": ("pool2d", {"X": _IMG},
                             {"ksize": 5, "global_pooling": True,
                              "pooling_type": "avg", "data_format": "NHWC"},
                             "Out", ["X"]),
    "max pool NHWC": ("pool2d", {"X": np.ascontiguousarray(
        _IMG.transpose(0, 2, 3, 1))}, {"ksize": 3, "strides": 2,
                                       "paddings": 1,
                                       "data_format": "NHWC"}, "Out", ["X"]),
    "batch norm momentum 0.7, biased variance": (
        "batch_norm", _BN, {"momentum": 0.7, "epsilon": 1e-3}, "Y",
        ["X", "Scale", "Bias"]),
    "batch norm NHWC": ("batch_norm", _BN_NHWC,
                        {"data_layout": "NHWC"}, "Y",
                        ["X", "Scale", "Bias"]),
    "batch norm is_test": ("batch_norm", _BN, {"is_test": True}, "Y",
                           ["X", "Scale", "Bias"]),
    "batch norm use_global_stats": ("batch_norm", _BN,
                                    {"use_global_stats": True}, "Y",
                                    ["X", "Scale", "Bias"]),
    "momentum nesterov": ("momentum", {"Param": _P, "Grad": _G,
                                       "Velocity": _V,
                                       "LearningRate": np.array(
                                           [0.1], np.float32)},
                          {"mu": 0.9, "use_nesterov": True}, "ParamOut",
                          []),
    "sigmoid CE ignore_index": ("sigmoid_cross_entropy_with_logits",
                                {"X": _P, "Label": np.array(
                                    [[0, 1], [2, 1], [0, 2]], np.float32)},
                                {"ignore_index": 2}, "Out", ["X"]),
    "auc on running stats": ("auc", {
        "Predict": np.stack([1 - _R.rand(9), _R.rand(9)], 1)
        .astype(np.float32),
        "Label": _R.randint(0, 2, (9, 1)).astype(np.int64),
        "StatPos": _R.randint(0, 3, 33).astype(np.float32),
        "StatNeg": _R.randint(0, 3, 33).astype(np.float32)},
        {"num_thresholds": 32}, "AUC", []),
    "fill_constant_batch_size_like dims": (
        "fill_constant_batch_size_like", {"Input": _IMG},
        {"shape": [4, -1, 2], "dtype": "int32", "value": 7,
         "input_dim_idx": 2, "output_dim_idx": 1}, "Out", []),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_vision_and_ctr_op_edge_cases_match_the_reference(case):
    op, ins, attrs, out_slot, grad_slots = EDGES[case]
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        _assert_same(got[slot], want[slot], f"{case}: {slot}")
        assert _same_dtype(got[slot], want[slot]), f"{case}: {slot}"
    for slot in grad_slots:
        _assert_same(
            torch_op_grads(op, ins, attrs, [slot], [out_slot])[slot],
            ref_op_grads(op, ins, attrs, [slot], [out_slot])[slot],
            f"{case}: d{out_slot}/d{slot}")
