"""The image family (ResNet, SE-ResNeXt, VGG, MNIST) on the CPU: the port
against the JAX package.

- Every build's main and startup programs have the reference's
  `Program.to_dict()`: ResNet on ImageNet (bottleneck, depth 50, and
  basic, depth 18) and cifar10, both data formats, SE-ResNeXt-50, VGG-16
  and the MNIST CNN.
- From the reference's startup scope, carried across with
  `convert.params_from_arrays(..., program=main)`, three steps give the
  same losses, step-1 gradients, parameters, optimizer accumulators
  (velocities, Adam moments) and batch-norm moving statistics, on
  networks made of each model module's own blocks at a cut size:
  ResNet's bottleneck stack and cifar10 ResNet at depth 8 (momentum),
  two SE-ResNeXt blocks with grouped convs and squeeze-excitation
  (momentum), VGG-16 at cifar size and the MNIST CNN (Adam).  Dropout is
  set to 0 in both programs (the port's masks come from torch
  generators, ROADMAP C2).
- Full ResNet-50 at 2 x 3 x 64 x 64: the first step's loss and moving
  statistics, and its gradients at a looser tolerance (see
  `test_resnet50_first_step_matches_the_reference`).
- NHWC against NCHW in the port, `clone(for_test=True)` running on the
  stored statistics, and `use_amp=True` building the reference's
  program (its AMP steps are in tests/test_torch_amp.py).

Tolerances, float32 on both sides: losses within 1e-5 relative (after
an Adam step, plus 1e-4 absolute: see below); each
step-1 gradient within TOL_GRAD relative L2, against its norm plus 1e-4
of the largest gradient norm (a conv or fc bias that feeds a batch norm
has a gradient of 0 in exact arithmetic, so both sides hold rounding
noise there); momentum parameters within 1e-6 and accumulators and
moving statistics within 1e-4 of the largest of their kind.  Adam turns
a gradient of pure noise into a step of about +-lr whose sign is noise,
so Adam parameters are held within 4 * sum(lr), as in
test_torch_training.py.  VGG's thirteen batch norms over a few values a
channel (batch 8, 2 x 2 in the last block) make its later gradients
sensitive to such steps: its Adam moments and moving statistics after
three steps are held within 1e-2 of the largest of their kind (1.2e-3
measured).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import mnist as jmn
from paddle_tpu.models import resnet as jres
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models import mnist as tmn
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

torch.set_num_threads(2)

MODULES = {"resnet": (jres, tres), "se_resnext": (jse, tse),
           "vgg": (jvgg, tvgg), "mnist": (jmn, tmn)}
TOL_GRAD = 1e-4


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _build(fluid, fn, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = fn(**kw)
    return main, startup, out


BUILDS = {
    "resnet50": ("resnet", dict(depth=50)),
    "resnet50 NHWC": ("resnet", dict(depth=50, data_format="NHWC")),
    "resnet18": ("resnet", dict(depth=18, class_dim=102)),
    "resnet cifar10": ("resnet", dict(dataset="cifar10")),
    "resnet cifar10 NHWC": ("resnet", dict(dataset="cifar10",
                                           data_format="NHWC")),
    "se_resnext50": ("se_resnext", dict(lr_boundaries=[10, 20],
                                        lr_values=[0.1, 0.01, 0.001])),
    "vgg16": ("vgg", {}),
    "vgg16 flowers": ("vgg", dict(dataset="flowers")),
    "mnist": ("mnist", {}),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_programs_serialize_as_the_reference(case):
    module, kw = BUILDS[case]
    jmod, tmod = MODULES[module]
    jm, js, _ = _build(jf, jmod.build_model, **kw)
    tm, ts, _ = _build(tf, tmod.build_model, **kw)
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)
    types = {op.type for op in tm.global_block().ops}
    assert {"conv2d", "pool2d"} <= types
    if module != "mnist":
        assert "batch_norm" in types


# -- three training steps against the reference ----------------------------

def _bottleneck_net(fluid, data_format="NCHW"):
    """ResNet's stem, a bottleneck stage of two blocks and a strided one
    (projection shortcuts), global average pooling and the classifier,
    from the resnet module's own functions; momentum 0.9."""
    mod = jres if fluid is jf else tres
    layers = fluid.layers
    x = layers.data("data", shape=[3, 32, 32])
    label = layers.data("label", shape=[1], dtype="int64")
    if data_format == "NHWC":
        x = layers.transpose(x, perm=[0, 2, 3, 1])
    h = mod.conv_bn_layer(x, 16, 7, 2, 3, data_format=data_format)
    h = layers.pool2d(h, pool_type="max", pool_size=3, pool_stride=2,
                      pool_padding=1, data_format=data_format)
    h = mod.layer_warp(mod.bottleneck, h, 8, 2, 1, data_format=data_format)
    h = mod.layer_warp(mod.bottleneck, h, 16, 1, 2, data_format=data_format)
    h = layers.pool2d(h, pool_type="avg", global_pooling=True, pool_size=7,
                      data_format=data_format)
    return _classify(fluid, h, label, lambda: fluid.optimizer.
                     MomentumOptimizer(0.01, 0.9))


def _cifar8_net(fluid):
    mod = jres if fluid is jf else tres
    layers = fluid.layers
    x = layers.data("data", shape=[3, 32, 32])
    label = layers.data("label", shape=[1], dtype="int64")
    predict = mod.resnet_cifar10(x, 10, depth=8)
    loss = layers.mean(layers.cross_entropy(predict, label))
    fluid.optimizer.MomentumOptimizer(0.01, 0.9, use_nesterov=True) \
        .minimize(loss)
    return {"loss": loss}


def _se_net(fluid):
    """SE-ResNeXt's stem and two of its bottleneck blocks (cardinality
    32, squeeze-excitation, a strided projection), from the se_resnext
    module's own functions; momentum 0.9."""
    mod = jse if fluid is jf else tse
    layers = fluid.layers
    x = layers.data("data", shape=[3, 32, 32])
    label = layers.data("label", shape=[1], dtype="int64")
    h = mod.conv_bn_layer(x, 32, 7, stride=2, act="relu")
    h = layers.pool2d(h, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    h = mod.bottleneck_block(h, 64, 1, 32, 16)
    h = mod.bottleneck_block(h, 128, 2, 32, 16)
    h = layers.pool2d(h, pool_type="avg", global_pooling=True)
    return _classify(fluid, h, label, lambda: fluid.optimizer.
                     MomentumOptimizer(0.01, 0.9))


def _classify(fluid, h, label, make_opt):
    layers = fluid.layers
    predict = layers.fc(h, 10, act="softmax")
    loss = layers.mean(layers.cross_entropy(predict, label))
    make_opt().minimize(loss)
    return {"loss": loss}


def _vgg_net(fluid):
    return (jvgg if fluid is jf else tvgg).build_model(learning_rate=1e-4)


def _mnist_net(fluid):
    return (jmn if fluid is jf else tmn).build_model()


# name: (make_net, batch shape, feed name, Adam's learning rate or None)
TRAIN = {
    "resnet bottleneck": (_bottleneck_net, (2, 3, 32, 32), "data", None),
    "resnet cifar10 depth 8": (_cifar8_net, (2, 3, 32, 32), "data", None),
    "se_resnext blocks": (_se_net, (2, 3, 32, 32), "data", None),
    "vgg16 cifar10": (_vgg_net, (8, 3, 32, 32), "data", 1e-4),
    "mnist": (_mnist_net, (4, 1, 28, 28), "pixel", 1e-3),
}


def _program(fluid, make_net):
    main, startup, out = _build(fluid, lambda: make_net(fluid))
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.desc.attrs["dropout_prob"] = 0.0
    return main, startup, out


def _feed(shape, name, seed=0):
    rng = np.random.RandomState(seed)
    return {name: rng.randn(*shape).astype(np.float32),
            "label": rng.randint(0, 10, (shape[0], 1)).astype(np.int64)}


def _port_scope(arrays, program):
    scope = tf.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=program).items():
        scope.set_var(n, t)
    return scope


def _assert_grads(got, want, params, tol):
    floor = 1e-4 * max(np.linalg.norm(w) for w in want)
    for name, a, b in zip(params, got, want):
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + floor)
        assert err <= tol, f"{name}@GRAD: relative L2 error {err}"


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_trains_like_the_reference(case):
    make_net, shape, feed_name, adam_lr = TRAIN[case]
    jm, js, jo = _program(jf, make_net)
    tm, ts, to = _program(tf, make_net)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    tscope = _port_scope(arrays, tm)
    params = [p.name for p in jm.all_parameters()]
    fetch = [jo["loss"].name] + [f"{p}@GRAD" for p in params]
    feed = _feed(shape, feed_name)
    jexe, texe = jf.Executor(jf.CPUPlace()), tf.Executor(tf.CPUPlace())
    for step in range(3):
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(
            got[0], want[0], rtol=1e-5, atol=1e-4 if adam_lr and step else 0,
            err_msg=f"step {step + 1} loss")
        if step == 0:
            _assert_grads(got[1:], want[1:], params, TOL_GRAD)
    kinds = {}
    for v in tm.global_block().vars.values():
        if v.persistable and v.name not in params:
            kind = v.name.rsplit(".", 1)[-1]
            kinds.setdefault(kind, []).append(v.name)
    assert ("mean" in kinds) == (case != "mnist")
    for name in params:
        a = tscope.find_var(name).numpy()
        b = np.asarray(jscope.find_var(name))
        bound = 4 * 3 * adam_lr if adam_lr else 1e-6
        assert np.abs(a - b).max() <= bound, name
        if name.endswith(".w_0"):
            assert np.abs(b - arrays[name]).max() > 0, f"{name} is still"
    for kind, names in kinds.items():
        want = {n: np.asarray(jscope.find_var(n)) for n in names}
        scale = max(np.abs(w).max() for w in want.values())
        tol = 1e-2 if case.startswith("vgg") else 1e-4
        for n in names:
            err = np.abs(tscope.find_var(n).numpy() - want[n]).max()
            assert err <= tol * scale + 1e-12, f"{n}: {err} of {scale}"


def test_resnet50_first_step_matches_the_reference():
    """Full ResNet-50 (bottleneck, depth 50, 10 classes) at 2 x 3 x 64 x
    64: the step-1 loss within 1e-4, every batch norm's moving mean and
    variance after it within 1e-2 of the largest of its kind, and the
    step-1 gradients within 0.2 relative L2.  Fifty-three batch norms of
    a few values a channel, each dividing by the reference's float32
    E[x^2] - mean^2, amplify rounding from layer to layer: on this input
    the reference's own gradients lie up to 9.5% from the same program
    evaluated in float64 in the port, the port's 2.3%, and the two
    packages 9.1% apart (relative L2, worst parameter)."""
    kw = dict(depth=50, class_dim=10)
    jm, js, jo = _build(jf, jres.build_model, **kw)
    tm, ts, to = _build(tf, tres.build_model, **kw)
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    tscope = _port_scope(arrays, tm)
    params = [p.name for p in jm.all_parameters()]
    fetch = [jo["loss"].name] + [f"{p}@GRAD" for p in params]
    feed = _feed((2, 3, 64, 64), "data")
    want = jf.Executor(jf.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=jscope)
    got = tf.Executor(tf.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                         scope=tscope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=0)
    _assert_grads(got[1:], want[1:], params, 0.2)
    stats = [v.name for v in tm.global_block().vars.values()
             if v.name.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 53
    for suffix in (".mean", ".var"):
        names = [n for n in stats if n.endswith(suffix)]
        scale = max(np.abs(np.asarray(jscope.find_var(n))).max()
                    for n in names)
        for n in names:
            err = np.abs(tscope.find_var(n).numpy()
                         - np.asarray(jscope.find_var(n))).max()
            assert err <= 1e-2 * scale, f"{n}: {err} of {scale}"


def test_nhwc_trains_as_nchw_in_the_port():
    """The bottleneck stack channels-last and channels-first from the
    same weights: the same losses, gradients and moving statistics."""
    runs = []
    arrays = None
    for fmt in ("NCHW", "NHWC"):
        main, startup, out = _build(
            tf, lambda: _bottleneck_net(tf, data_format=fmt))
        if arrays is None:
            scope = tf.Scope()
            tf.Executor(tf.CPUPlace()).run(startup, scope=scope)
            arrays = {n: v.numpy() for n, v in scope.vars.items()
                      if isinstance(v, torch.Tensor)}
        scope = _port_scope(arrays, main)
        params = [p.name for p in main.all_parameters()]
        fetch = [out["loss"].name] + [f"{p}@GRAD" for p in params]
        exe = tf.Executor(tf.CPUPlace())
        res = [exe.run(main, feed=_feed((2, 3, 32, 32), "data"),
                       fetch_list=fetch, scope=scope) for _ in range(2)]
        stats = {n: scope.find_var(n).numpy() for n in arrays
                 if n.endswith((".mean", ".var"))}
        runs.append((res, stats, params))
    (a, sa, params), (b, sb, _) = runs
    for step in range(2):
        np.testing.assert_allclose(b[step][0], a[step][0], rtol=1e-5)
    _assert_grads(b[0][1:], a[0][1:], params, TOL_GRAD)
    for n in sa:
        np.testing.assert_allclose(sb[n], sa[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_clone_for_test_runs_on_stored_statistics():
    """After two training steps, the program cloned for test sets
    is_test on every batch norm, normalizes with the stored moving
    statistics (the reference's output from the same scope values) and
    leaves them as they were."""
    jm, js, jo = _program(jf, _cifar8_net)
    tm, ts, to = _program(tf, _cifar8_net)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    for _ in range(2):
        exe.run(tm, feed=_feed((2, 3, 32, 32), "data"),
                fetch_list=[to["loss"]], scope=scope)
    test_t = tm.clone(for_test=True)
    test_j = jm.clone(for_test=True)
    bns = [op for op in test_t.global_block().ops if op.type == "batch_norm"]
    assert bns and all(op.desc.attrs["is_test"] for op in bns)
    arrays = {n: v.numpy() for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    jscope = jf.Scope()
    for n, a in arrays.items():
        jscope.set_var(n, a)
    feed = _feed((3, 3, 32, 32), "data", seed=1)
    predict = [op for op in test_t.global_block().ops
               if op.type == "softmax"][-1].output("Out")[0]
    got = exe.run(test_t, feed=feed, fetch_list=[to["loss"], predict],
                  scope=scope)
    want = jf.Executor(jf.CPUPlace()).run(
        test_j, feed=feed, fetch_list=[jo["loss"].name, predict],
        scope=jscope)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for n, a in arrays.items():
        if n.endswith((".mean", ".var")):
            np.testing.assert_array_equal(scope.find_var(n).numpy(), a)
    assert any(np.abs(a).max() > 0 for n, a in arrays.items()
               if n.endswith(".mean"))


def test_resnet50_use_amp_builds_the_references_program():
    """use_amp=True decorates the momentum optimizer as the reference
    does: the same Program.to_dict(), its "amp" field included (the AMP
    steps themselves: tests/test_torch_amp.py)."""
    tm = _build(tf, tres.build_model, use_amp=True)[0]
    jm = _build(jf, jres.build_model, use_amp=True)[0]
    assert tm._amp_lists is not None and tm.to_dict()["amp"] is not None
    assert _json(tm) == _json(jm)
