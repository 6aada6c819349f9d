"""QAT and int8 serving in paddle_tpu_torch (ops/quantize.py, quantize.py)
against the JAX package on the same numpy inputs and parameters:

- the four fake-quantize ops bit for bit, forward and the
  straight-through gradient (the moving-average op's first step, a
  running scale and is_test);
- quantized_conv2d and quantized_matmul bit for bit, and their int32
  accumulators equal to numpy's int64 products: groups, NHWC, stride,
  dilation, SAME padding, K not a multiple of 8, 16 rows or fewer; the
  int8 route raises where torch._int_mm refuses, with no float fallback;
- QuantizeTranspiler's training and inference programs, `to_dict()`
  equal to the reference's, for a small conv + fc net and for
  ResNet-50;
- convert_to_int8 from a reference QAT scope carried over by
  convert.params_from_arrays: the returned plan and the int8 codes
  equal, and the int8 program's outputs within TOL_INT8 of the
  reference's;
- the five cases of tests/test_int8_serving.py through Executor.run
  (AnalysisConfig.enable_int8 and the Predictor are A step 9): a QAT
  model exported, loaded and converted keeps its accuracy; a model
  without the QAT pattern converts nothing; matmul's transpose_Y is
  baked into the int8 weight; a weight whose QDQ output also feeds a
  float consumer stays float; a weight shared by two ops converts once
  with its true scale;
- int8 parameters survive save_inference_model/load_inference_model;
- three QAT training steps of the small net (and two under gradient
  accumulation): losses, parameters and the moving-average scale states
  within TOL_QAT of the reference's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from torch_op_test import (ref_op_grads, run_ref_op_all, run_torch_op_all,
                           torch_op_grads)
from torch_twin import twins

torch.set_num_threads(2)

# int8 program outputs (softmax probabilities) across packages: the
# first conv's codes and accumulators agree exactly, later activations
# are float32 values of other summation orders that may land a code one
# step away at a rounding tie
TOL_INT8 = 2e-3
# QAT training against the reference: the losses and the moving-average
# scale states within TOL_QAT (float32 on both sides, other summation
# orders); each parameter's change over the steps within TOL_QAT_UPDATE
# relative L2.  The conv's inputs and weights sit on their quantization
# grids and its bias starts at 0, so an output that is exactly 0 in
# exact arithmetic rounds to +-1 ulp in another order, and relu's
# gradient flips at that pixel: one element of the conv's gradient
# differs by ~1e-3 at step 1 (measured), a few 1e-3 of the update's norm.
TOL_QAT = 1e-5
TOL_QAT_UPDATE = 2e-2

R = np.random.RandomState(23)


def _f32(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _codes(*shape):
    return R.randint(-127, 128, shape).astype(np.int8)


def _bits(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# -- the fake-quantize ops ---------------------------------------------------

_X = np.concatenate([_f32(3, 7), np.array([[0.5, -0.5, 2.5, -1.5, 0.0,
                                            3.0, -3.0]], np.float32)])
FAKE = {
    "fake_quantize_abs_max": ({"X": _X}, {"bit_length": 8}),
    "fake_quantize_abs_max 4 bits": ({"X": _X}, {"bit_length": 4}),
    "fake_dequantize_max_abs": ({"X": np.round(_X * 40),
                                 "Scale": np.array([0.37], np.float32)},
                                {"max_range": 127.0}),
    "fake_quantize_dequantize_abs_max": ({"X": _X}, {"bit_length": 8}),
    "moving average, first step": ({"X": _X, "InScale": np.zeros(
        1, np.float32)}, {"moving_rate": 0.9}),
    "moving average, running": ({"X": _X, "InScale": np.array(
        [2.2], np.float32)}, {"moving_rate": 0.8, "bit_length": 6}),
    "moving average, is_test": ({"X": _X, "InScale": np.array(
        [1.3], np.float32)}, {"is_test": True}),
}


def _fake_op(case):
    op = case.split(" 4 bits")[0]
    return ("fake_quantize_dequantize_moving_average_abs_max"
            if op.startswith("moving average") else op)


@pytest.mark.parametrize("case", sorted(FAKE))
def test_fake_quantize_ops_are_bit_equal_with_their_gradient(case):
    op, (ins, attrs) = _fake_op(case), FAKE[case]
    got = run_torch_op_all(op, ins, attrs)
    want = run_ref_op_all(op, ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        _bits(got[slot], want[slot], f"{case}: {slot}")
    if "dequantize_abs_max" in op or "moving" in op:
        g = torch_op_grads(op, ins, attrs, ["X"], ["Out"])["X"]
        w = ref_op_grads(op, ins, attrs, ["X"], ["Out"])["X"]
        _bits(g, w, f"{case}: the straight-through gradient")


# -- quantized_conv2d / quantized_matmul -----------------------------------

def _conv_case(n, c, h, w, o, k, groups=1, nhwc=False, **attrs):
    x = _f32(n, c, h, w)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        attrs["data_format"] = "NHWC"
    return ({"Input": x, "Filter": _codes(o, c // groups, k, k)},
            dict({"in_scale": 2.1, "weight_scale": 0.73, "groups": groups},
                 **attrs))


QCONV = {
    "3x3 pad 1": _conv_case(2, 8, 6, 5, 16, 3, paddings=1),
    "stem 7x7 stride 2, K = 147": _conv_case(1, 3, 15, 15, 8, 7, strides=2,
                                             paddings=3),
    "groups 4, NHWC": _conv_case(2, 8, 5, 5, 12, 3, groups=4, nhwc=True,
                                 paddings=1),
    "depthwise": _conv_case(1, 6, 5, 5, 6, 3, groups=6, paddings=1),
    "dilation 2, stride 2, SAME": _conv_case(1, 5, 9, 8, 7, 3, strides=2,
                                             dilations=2, paddings="SAME"),
    "1x1 stride 2": _conv_case(2, 16, 7, 7, 9, 1, strides=2),
    "asymmetric stride, 4-bit": _conv_case(1, 4, 6, 7, 5, 2,
                                           strides=[2, 1], bit_length=4),
}


def _int64_conv(codes, w, strides, pads, dilations, groups):
    """int64 numpy convolution of the codes, the accumulator's truth."""
    n, c, h, wd = codes.shape
    o, cg, kh, kw = w.shape
    (pt, pb), (pl, pr) = pads
    xp = np.pad(codes.astype(np.int64), ((0, 0), (0, 0), (pt, pb),
                                         (pl, pr)))
    oh = (h + pt + pb - dilations[0] * (kh - 1) - 1) // strides[0] + 1
    ow = (wd + pl + pr - dilations[1] * (kw - 1) - 1) // strides[1] + 1
    out = np.zeros((n, o, oh, ow), np.int64)
    og = o // groups
    for i in range(oh):
        for j in range(ow):
            for g in range(groups):
                win = xp[:, g * cg:(g + 1) * cg,
                         i * strides[0]:i * strides[0]
                         + dilations[0] * (kh - 1) + 1:dilations[0],
                         j * strides[1]:j * strides[1]
                         + dilations[1] * (kw - 1) + 1:dilations[1]]
                out[:, g * og:(g + 1) * og, i, j] = np.einsum(
                    "nchw,ochw->no", win,
                    w[g * og:(g + 1) * og].astype(np.int64))
    return out


@pytest.mark.parametrize("case", sorted(QCONV))
def test_quantized_conv2d_is_exact(case):
    from paddle_tpu_torch.ops.common import pair
    from paddle_tpu_torch.ops.nn import _conv_pads
    from paddle_tpu_torch.ops.quantize import conv_accumulators

    ins, attrs = QCONV[case]
    got = run_torch_op_all("quantized_conv2d", ins, attrs)["Output"]
    want = run_ref_op_all("quantized_conv2d", ins, attrs)["Output"]
    _bits(got, want, case)
    codes, acc = conv_accumulators(torch.as_tensor(ins["Input"]),
                                   torch.as_tensor(ins["Filter"]), attrs)
    assert acc.dtype == torch.int32
    strides = pair(attrs.get("strides", 1))
    dilations = pair(attrs.get("dilations", 1))
    pads = _conv_pads(attrs.get("paddings", 0), tuple(codes.shape[2:]),
                      ins["Filter"].shape[2:], strides, dilations)
    truth = _int64_conv(codes.numpy().astype(np.int64), ins["Filter"],
                        strides, pads, dilations, attrs["groups"])
    np.testing.assert_array_equal(acc.numpy(), truth)


QMATMUL = {
    "3 rows, K = 5": ({"X": _f32(3, 5), "Y": _codes(5, 7)}, {}),
    "16 rows": ({"X": _f32(16, 24), "Y": _codes(24, 8)}, {}),
    "fc on (N, C, H, W)": ({"X": _f32(4, 3, 2, 2), "Y": _codes(12, 10)},
                           {"x_num_col_dims": 1}),
    "num_col_dims 2": ({"X": _f32(2, 5, 6), "Y": _codes(2, 3, 4)},
                       {"x_num_col_dims": 2, "y_num_col_dims": 2}),
}


@pytest.mark.parametrize("case", sorted(QMATMUL))
def test_quantized_matmul_is_exact(case):
    ins, attrs = QMATMUL[case]
    attrs = dict(attrs, in_scale=1.7, weight_scale=0.41)
    _bits(run_torch_op_all("quantized_matmul", ins, attrs)["Out"],
          run_ref_op_all("quantized_matmul", ins, attrs)["Out"], case)


def test_a_refused_int8_product_raises_with_no_float_fallback(monkeypatch):
    def refuse(a, b):
        raise RuntimeError("_int_mm refused the shape")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    for op, (ins, attrs) in (("quantized_conv2d", QCONV["3x3 pad 1"]),
                             ("quantized_matmul", (QMATMUL["16 rows"][0], {
                                 "in_scale": 1.0, "weight_scale": 1.0}))):
        with pytest.raises(RuntimeError, match="refused"):
            run_torch_op_all(op, ins, attrs)


# -- the transpiler ------------------------------------------------------------

def _qat_net(fluid, optimizer="adam"):
    """The small conv + fc net of tests/test_int8_serving.py, QAT
    transpiled before minimize (Adam at 0.02, or momentum 0.9 at 0.1)."""
    L = fluid.layers
    x = L.data(name="x", shape=[1, 8, 8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="int64")
    conv = L.conv2d(x, num_filters=8, filter_size=3, padding=1, act="relu")
    pool = L.pool2d(conv, pool_size=2, pool_stride=2, pool_type="avg")
    probs = L.fc(pool, size=4, act="softmax")
    loss = L.mean(L.cross_entropy(probs, y))
    acc = L.accuracy(probs, y)
    fluid.QuantizeTranspiler().training_transpile(
        fluid.default_main_program(), fluid.default_startup_program())
    if optimizer == "adam":
        fluid.optimizer.AdamOptimizer(learning_rate=0.02).minimize(loss)
    elif optimizer == "momentum":
        fluid.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
    return loss, probs, acc


def _dataset(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 8, 8).astype(np.float32)
    q = np.stack([x[:, 0, :4, :4].mean((1, 2)), x[:, 0, :4, 4:].mean((1, 2)),
                  x[:, 0, 4:, :4].mean((1, 2)), x[:, 0, 4:, 4:].mean((1, 2))],
                 axis=1)
    return x, q.argmax(1)[:, None].astype(np.int64)


def _same_dict(a, b):
    assert json.dumps(a.to_dict(), sort_keys=True) == \
        json.dumps(b.to_dict(), sort_keys=True)


def _build(fluid, body):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = body(fluid)
    return main, startup, out


def test_transpiled_small_net_is_the_reference_program():
    progs = {f: _build(f, _qat_net) for f in (jf, tf)}
    for i in (0, 1):
        _same_dict(progs[tf][i], progs[jf][i])
    types = [op.type for op in progs[tf][0].global_block().ops]
    assert types.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 2
    assert types.count("fake_quantize_dequantize_abs_max") == 2
    for f in (jf, tf):
        infer = progs[f][0].clone(for_test=True)
        f.QuantizeTranspiler().inference_transpile(infer)
        progs[f] = infer
    _same_dict(progs[tf], progs[jf])
    with pytest.raises(RuntimeError, match="before append_backward"):
        tf.QuantizeTranspiler().training_transpile(
            _build(tf, _qat_net)[0])


def test_transpiled_resnet50_is_the_reference_program():
    def body(fluid):
        if fluid is jf:
            from paddle_tpu.models import resnet
        else:
            from paddle_tpu_torch.models import resnet
        model = resnet.build_model(dataset="flowers", depth=50,
                                   class_dim=10, with_optimizer=False)
        fluid.QuantizeTranspiler().training_transpile(
            fluid.default_main_program(), fluid.default_startup_program())
        fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(model["loss"])

    progs = {f: _build(f, body) for f in (jf, tf)}
    for i in (0, 1):
        _same_dict(progs[tf][i], progs[jf][i])
    ops = progs[tf][0].global_block().ops
    quantizable = [op for op in ops if op.type in ("conv2d", "mul")]
    acts = {op.input("Input" if op.type == "conv2d" else "X")[0]
            for op in quantizable}
    types = [op.type for op in ops]
    # one weight QDQ an op; one activation QDQ a distinct input (a
    # block's first conv and its projection shortcut share theirs)
    assert len(quantizable) == 54 and len(acts) == 50
    assert types.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 50
    assert types.count("fake_quantize_dequantize_abs_max") == 54


# -- convert_to_int8 from a reference QAT scope ----------------------------

def _calibrated(n_steps=3):
    """The small net trained `n_steps` QAT steps in the reference, then
    its for_test clone in both packages, the port's scope holding the
    reference's state (convert.params_from_arrays)."""
    from paddle_tpu_torch.convert import params_from_arrays

    x, y = _dataset(64, seed=1)
    jm, js, (jloss, jprobs, _) = _build(jf, _qat_net)
    tm, _, (_, tprobs, _) = _build(tf, _qat_net)
    jscope = jf.Scope()
    exe = jf.Executor(jf.CPUPlace())
    exe.run(js, scope=jscope)
    for i in range(n_steps):
        exe.run(jm, feed={"x": x[i * 16:(i + 1) * 16],
                          "y": y[i * 16:(i + 1) * 16]},
                fetch_list=[jloss], scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    tscope = tf.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=tm).items():
        tscope.set_var(n, t)
    states = [n for n in arrays if n.endswith(".quant_scale_state")]
    assert len(states) == 2 and all(arrays[n][0] > 0 for n in states)
    assert all(tscope.find_var(n).dtype == torch.float32 for n in states)
    return ((jm.clone(for_test=True), jscope, jprobs),
            (tm.clone(for_test=True), tscope, tprobs), x)


def test_convert_to_int8_plan_codes_and_outputs_match_the_reference():
    import paddle_tpu.quantize as jq

    (jinf, jscope, jprobs), (tinf, tscope, tprobs), x = _calibrated()
    jplan = jq.convert_to_int8(jinf, jscope)
    tplan = tf.quantize_module.convert_to_int8(tinf, tscope)
    assert [v[0] for v in tplan.values()] == ["quantized_conv2d",
                                             "quantized_matmul"]
    assert tplan == {k: tuple(v) for k, v in jplan.items()}
    _same_dict(tinf, jinf)
    for op in tinf.global_block().ops:
        if op.type.startswith("quantized_"):
            w = op.input("Filter" if op.type == "quantized_conv2d"
                         else "Y")[0]
            got = tscope.find_var(w)
            assert got.dtype == torch.int8
            _bits(got.numpy(), np.asarray(jscope.find_var(w)), w)
    feed = {"x": x}
    jout = jf.Executor(jf.CPUPlace()).run(jinf, feed=feed,
                                          fetch_list=[jprobs.name],
                                          scope=jscope)[0]
    tout = tf.Executor(tf.CPUPlace()).run(tinf, feed=feed,
                                          fetch_list=[tprobs.name],
                                          scope=tscope)[0]
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=0,
                               atol=TOL_INT8)
    assert (tout.argmax(1) == np.asarray(jout).argmax(1)).all()

    # the reference's converted scope, int8 weights and all, carried
    # over: the same int8 program results
    from paddle_tpu_torch.convert import params_from_arrays

    carried = tf.Scope()
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    for n, t in params_from_arrays(arrays, "cpu", program=tinf).items():
        carried.set_var(n, t)
    assert sum(v.dtype == torch.int8 for v in carried.vars.values()) == 2
    again = tf.Executor(tf.CPUPlace()).run(tinf, feed=feed,
                                           fetch_list=[tprobs.name],
                                           scope=carried)[0]
    _bits(again, tout, "the int8 program on the carried scope")


# -- the cases of tests/test_int8_serving.py -------------------------------

def test_int8_conversion_keeps_the_qat_accuracy(tmp_path):
    x, y = _dataset()
    main, startup, (loss, probs, acc) = _build(tf, _qat_net)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    with tf.scope_guard(scope):
        exe.run(startup)
        for _ in range(12):
            for i in range(8):
                sl = slice(i * 32, (i + 1) * 32)
                exe.run(main, feed={"x": x[sl], "y": y[sl]},
                        fetch_list=[loss])
        train_acc = float(exe.run(main, feed={"x": x, "y": y},
                                  fetch_list=[acc])[0].reshape(-1)[0])
        assert train_acc > 0.85, f"QAT model underfit: {train_acc}"
        infer = main.clone(for_test=True)
        d = str(tmp_path / "model")
        tf.io.save_inference_model(
            d, ["x"], [infer.global_block().var(probs.name)], exe,
            main_program=infer)
    fp_scope, q_scope = tf.Scope(), tf.Scope()
    with tf.scope_guard(fp_scope):
        fp_prog, _, fetch = tf.io.load_inference_model(d, exe)
        fp_out = exe.run(fp_prog, feed={"x": x}, fetch_list=fetch)[0]
    with tf.scope_guard(q_scope):
        q_prog, _, fetch = tf.io.load_inference_model(d, exe)
        converted = tf.quantize_module.convert_to_int8(q_prog, q_scope)
        q_out = exe.run(q_prog, feed={"x": x}, fetch_list=fetch)[0]
    assert converted
    types = [op.type for op in q_prog.global_block().ops]
    assert "quantized_conv2d" in types and "quantized_matmul" in types
    assert not any(t.startswith("fake_quantize") for t in types)
    assert [n for n, v in q_scope.vars.items()
            if isinstance(v, torch.Tensor) and v.dtype == torch.int8]
    fp_acc = float((fp_out.argmax(1) == y[:, 0]).mean())
    q_acc = float((q_out.argmax(1) == y[:, 0]).mean())
    assert q_acc >= fp_acc - 0.01, (fp_acc, q_acc)
    np.testing.assert_allclose(q_out.sum(1), 1.0, rtol=1e-3, atol=1e-3)

    # the converted program and its int8 parameters round-trip
    d8 = str(tmp_path / "int8")
    with tf.scope_guard(q_scope):
        tf.io.save_inference_model(d8, ["x"], fetch, exe,
                                   main_program=q_prog)
    with tf.scope_guard(tf.Scope()):
        prog8, _, fetch8 = tf.io.load_inference_model(d8, exe)
        again = exe.run(prog8, feed={"x": x}, fetch_list=fetch8)[0]
        ints = {n: v for n, v in tf.global_scope().vars.items()
                if isinstance(v, torch.Tensor) and v.dtype == torch.int8}
    assert ints and all(torch.equal(v, q_scope.find_var(n))
                        for n, v in ints.items())
    _bits(again, q_out, "the reloaded int8 program")


def test_non_qat_model_converts_nothing():
    def body(fluid):
        xin = fluid.layers.data(name="x", shape=[6], dtype="float32")
        return fluid.layers.fc(xin, size=3, act="softmax")

    main, startup, pred = _build(tf, body)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    infer = main.clone(for_test=True)
    assert tf.quantize_module.convert_to_int8(infer, scope) == {}
    out = exe.run(infer, feed={"x": R.rand(4, 6).astype(np.float32)},
                  fetch_list=[pred], scope=scope)[0]
    assert out.shape == (4, 3)


def _calibrate_and_convert(body, feed, steps=3):
    """body's program QAT transpiled, calibrated `steps` forward runs,
    cloned for test: (float output, converted plan, int8 output, scope,
    each parameter's max |w| before the conversion)."""
    main, startup, out = _build(tf, lambda f: body(f))
    with tf.program_guard(main, startup):
        tf.QuantizeTranspiler().training_transpile(main, startup)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    infer = main.clone(for_test=True)
    ref = exe.run(infer, feed=feed, fetch_list=[out], scope=scope)[0]
    amax = {p.name: float(scope.find_var(p.name).abs().max())
            for p in main.all_parameters()}
    plan = tf.quantize_module.convert_to_int8(infer, scope)
    got = exe.run(infer, feed=feed, fetch_list=[out], scope=scope)[0]
    return ref, plan, got, scope, amax


def _param(fluid, name, shape):
    from paddle_tpu_torch.layer_helper import LayerHelper

    return LayerHelper(f"{name}_holder").create_parameter(
        tf.ParamAttr(name=name), shape=shape, dtype="float32")


def test_transpose_y_is_baked_into_the_int8_weight():
    def body(fluid):
        xin = fluid.layers.data(name="x", shape=[6], dtype="float32")
        w = _param(fluid, "wt", [3, 6])
        return fluid.layers.softmax(fluid.layers.matmul(xin, w,
                                                        transpose_y=True))

    ref, plan, got, scope, _ = _calibrate_and_convert(
        body, {"x": R.rand(16, 6).astype(np.float32)})
    assert plan, "a transpose_Y matmul converts"
    wq = scope.find_var("wt")
    assert wq.dtype == torch.int8 and tuple(wq.shape) == (6, 3)
    np.testing.assert_allclose(got, ref, atol=0.02)


def test_weight_with_a_foreign_qdq_consumer_stays_float():
    def body(fluid):
        L = fluid.layers
        a = L.data(name="a", shape=[6], dtype="float32")
        w, v = _param(fluid, "mixed_w", [6, 3]), _param(fluid, "pure_v",
                                                        [3, 4])
        return L.elementwise_add(L.reduce_sum(L.matmul(a, w)),
                                 L.reduce_sum(L.matmul(w, v)))

    ref, plan, got, scope, _ = _calibrate_and_convert(
        body, {"a": R.rand(8, 6).astype(np.float32)})
    assert scope.find_var("mixed_w").dtype == torch.float32
    assert scope.find_var("pure_v").dtype == torch.int8
    assert len(plan) == 1
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


def test_shared_weight_converts_once_with_its_true_scale():
    def body(fluid):
        L = fluid.layers
        a = L.data(name="a", shape=[6], dtype="float32")
        b = L.data(name="b", shape=[6], dtype="float32")
        w = _param(fluid, "shared_w", [6, 3])
        return L.elementwise_add(L.matmul(a, w), L.matmul(b, w))

    ref, plan, got, scope, amax = _calibrate_and_convert(
        body, {"a": R.rand(8, 6).astype(np.float32),
               "b": R.rand(8, 6).astype(np.float32)})
    assert len(plan) == 2
    assert {ws for (_t, _i, ws) in plan.values()} == {amax["shared_w"]}
    assert scope.find_var("shared_w").dtype == torch.int8
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


# -- QAT training against the reference -------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_qat_training_steps_match_the_reference(k):
    """Three momentum steps (k = 2: two accumulated micro-batches a step,
    the scale states moving twice a step in both packages, ROADMAP C10)
    from the reference's startup values: the losses and the two
    moving-average scale states within TOL_QAT, every parameter's and
    velocity's change within TOL_QAT_UPDATE."""
    x, y = _dataset(96, seed=2)
    tw = twins(lambda f: _qat_net(f, "momentum")[0])
    res = {}
    for side, (main, scope, exe, loss) in tw.items():
        names = [v.name for v in main.list_vars() if v.persistable
                 and not v.name.startswith("__")]

        def state():
            return {n: np.asarray(scope.find_var(n).numpy()
                                  if side == "port" else scope.find_var(n))
                    for n in names}

        start, losses = state(), []
        for i in range(3):
            sl = slice(i * 32, (i + 1) * 32)
            out = exe.run(main, feed={"x": x[sl], "y": y[sl]},
                          fetch_list=[loss], scope=scope,
                          accumulation_steps=k)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        res[side] = (losses, start, state())
    (tl, _, ts), (jl, j0, js) = res["port"], res["ref"]
    np.testing.assert_allclose(tl, jl, rtol=TOL_QAT, atol=TOL_QAT)
    states = [n for n in js if n.endswith(".quant_scale_state")]
    assert len(states) == 2 and all(js[n][0] > 0 and j0[n][0] == 0
                                    for n in states)
    for n, want in js.items():
        if n in states or want.dtype.kind != "f" or want.size == 1:
            np.testing.assert_allclose(ts[n], want, rtol=TOL_QAT,
                                       atol=TOL_QAT, err_msg=n)
        else:
            upd = want - j0[n]
            assert np.linalg.norm(upd) > 0, n
            err = np.linalg.norm(ts[n] - want) / np.linalg.norm(upd)
            assert err <= TOL_QAT_UPDATE, (n, err)
