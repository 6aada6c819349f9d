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
- bf16 operands as the AMP policy hands them to the ops of the three AMP
  paths (`BF16_CASES`): the reference's output dtypes, bit for bit where
  both packages round exact float32 values once, within one bf16 ulp
  where the value rounded is a sum taken in another order.  Not
  matched: avg pooling with a window on bf16, whose reference sums the
  window in bf16 (`lax.reduce_window`), rounding each partial sum; the
  AMP paths pool bf16 only by max and global average.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as ref_registry
from paddle_tpu_torch.core.registry import registered_ops
from test_op_sweep import RANDOM, S
from torch_op_test import (ref_op_grads, round_bf16, run_ref_op_all,
                           run_torch_op_all, to_torch, torch_op_grads)

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


# -- bf16 operands, as the AMP policy hands them to the ops ----------------

def _bf16(a):
    return round_bf16(np.asarray(a, np.float32))


_A = _bf16(_R.randn(3, 4, 8))
_B = _bf16(_R.randn(3, 8, 5))
_INT_A = _bf16(_R.randint(-3, 4, (2, 4, 3)))        # exact products
_INT_B = _bf16(_R.randint(-3, 4, (2, 3, 5)))
_X = _bf16(_R.randn(2, 3, 8))
_QKV = [_bf16(_R.randn(2, 2, 6, 8)) for _ in range(3)]
_BF16_IMG = _bf16(_R.randn(2, 4, 6, 6))

# (op, ins, attrs, the slots given as bf16, "exact" or "ulp"): "exact"
# where both packages compute each bf16 output from exact float32 values
# and round once, so the bits agree; "ulp" within one bf16 ulp where the
# float32 value before the rounding is a sum taken in another order
BF16_CASES = {
    "mul": ("mul", {"X": _A[0], "Y": _B[0]}, {}, "XY", "ulp"),
    "matmul alpha": ("matmul", {"X": _INT_A, "Y": _INT_B},
                     {"alpha": 0.3}, "XY", "exact"),
    "matmul transpose_Y": ("matmul", {"X": _A, "Y": _bf16(
        _R.randn(3, 5, 8))}, {"transpose_Y": True, "alpha": 0.125},
                           "XY", "ulp"),
    "add bf16 + f32 bias promotes": ("elementwise_add", {
        "X": _X, "Y": _R.randn(8).astype(np.float32)}, {}, "X", "exact"),
    "add bf16 + bf16": ("elementwise_add", {"X": _X, "Y": _bf16(
        _R.randn(2, 3, 8))}, {}, "XY", "exact"),
    "mul f32 0-d * bf16 promotes": ("elementwise_mul", {
        "X": np.array(0.3, np.float32), "Y": _X}, {}, "Y", "exact"),
    "sub": ("elementwise_sub", {"X": _X, "Y": _bf16(_R.randn(8))},
            {}, "XY", "exact"),
    "div": ("elementwise_div", {"X": _X, "Y": _bf16(
        _R.rand(2, 3, 8) + 0.5)}, {}, "XY", "exact"),
    "max": ("elementwise_max", {"X": _X, "Y": _bf16(_R.randn(2, 3, 8))},
            {}, "XY", "exact"),
    "scale": ("scale", {"X": _X}, {"scale": 0.3, "bias": 0.1}, "X",
              "exact"),
    "scale bias first": ("scale", {"X": _X}, {"scale": 0.3, "bias": 0.1,
                                              "bias_after_scale": False},
                         "X", "exact"),
    "reshape": ("reshape", {"X": _X}, {"shape": [0, 24]}, "X", "exact"),
    "transpose": ("transpose", {"X": _X}, {"axis": [1, 0, 2]}, "X",
                  "exact"),
    "slice": ("slice", {"Input": _X}, {"axes": [2], "starts": [1],
                                       "ends": [5]}, "Input", "exact"),
    "layer_norm": ("layer_norm", {"X": _X, "Scale": _R.rand(8).astype(
        np.float32), "Bias": _R.randn(8).astype(np.float32)},
                   {"begin_norm_axis": 2}, "X", "ulp"),
    "batch_norm": ("batch_norm", dict(
        X=_BF16_IMG, Scale=_R.rand(4).astype(np.float32),
        Bias=_R.randn(4).astype(np.float32),
        Mean=np.zeros(4, np.float32), Variance=np.ones(4, np.float32)),
        {}, "X", "ulp"),
    "relu": ("relu", {"X": _X}, {}, "X", "exact"),
    "gelu": ("gelu", {"X": _X}, {}, "X", "ulp"),
    "gelu tanh": ("gelu", {"X": _X}, {"approximate": True}, "X", "ulp"),
    "dropout is_test": ("dropout", {"X": _X}, {"dropout_prob": 0.3,
                                               "is_test": True}, "X",
                        "exact"),
    "conv2d": ("conv2d", {"Input": _BF16_IMG, "Filter": _bf16(
        _R.randn(3, 4, 3, 3))}, {"paddings": 1}, "InputFilter", "ulp"),
    "global avg pool": ("pool2d", {"X": _BF16_IMG},
                        {"ksize": 6, "global_pooling": True,
                         "pooling_type": "avg"}, "X", "ulp"),
    "max pool": ("pool2d", {"X": _BF16_IMG}, {"ksize": 3, "strides": 2,
                                              "paddings": 1}, "X",
                 "exact"),
    "top_k": ("top_k", {"X": _X[0]}, {"k": 3}, "X", "exact"),
    "composed attention": ("flash_attention", {
        "Q": _QKV[0], "K": _QKV[1], "V": _QKV[2],
        "Bias": _bf16(_R.randn(1, 1, 6, 6))},
        {"scale": 0.3, "causal": True}, "QKVBias", "ulp"),
}


def _ref_bf16(op, ins, attrs, slots):
    """The reference op on the same values, the named slots as bf16
    arrays (run eagerly: each op rounds where its code does)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.registry import OpContext as RefContext
    from paddle_tpu.core.registry import get_op_impl as ref_impl

    jins = {s: [jnp.asarray(v, jnp.bfloat16 if s in slots else None)]
            for s, v in ins.items()}
    outs = ref_impl(op)(RefContext(jax.random.PRNGKey(0), 0), jins,
                        dict(attrs))
    return {s: v[0] for s, v in outs.items()}


_BF16_SLOTS = {"QKVBias": {"Q", "K", "V", "Bias"},
               "InputFilter": {"Input", "Filter"}, "XY": {"X", "Y"}}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_operands_give_the_references_dtypes_and_roundings(case):
    """Each op on the three AMP paths returns the reference's output
    dtype from bf16 operands (a bf16 and a float32 operand promote to
    float32, also where the float32 one is 0-d, which torch alone would
    not promote on) and rounds where the reference rounds: a Python
    scale (matmul's alpha, scale's scale and bias, dropout's 1 - p, the
    composed attention's scale) is rounded to bf16 before it multiplies
    a bf16 tensor, as jnp applies a weak-typed scalar."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    op, ins, attrs, spec, kind = BF16_CASES[case]
    slots = _BF16_SLOTS.get(spec, {spec})
    tins = {s: [to_torch(v, torch.bfloat16 if s in slots else None)]
            for s, v in ins.items()}
    got = get_op_impl(op)(OpContext((0, 0), 0, device="cpu"), tins,
                          dict(attrs))
    want = _ref_bf16(op, ins, attrs, slots)
    for slot, w in want.items():
        if slot not in got:
            continue
        g = got[slot][0]
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
            f"{case}: {slot} {g.dtype} != {w.dtype}"
        g = g.float().numpy() if g.is_floating_point() else g.numpy()
        w = np.asarray(w, np.float32 if np.issubdtype(
            np.asarray(w).dtype, np.floating) or str(w.dtype) == "bfloat16"
            else None)
        if kind == "exact" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{case}: {slot}")
        else:
            np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{case}: {slot}")
