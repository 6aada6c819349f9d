"""The optimizer classes, ModelAverage and ExponentialMovingAverage in the
port, against the JAX package.

- Each of LarsMomentum, Adamax, Adagrad, DecayedAdagrad, Adadelta,
  RMSProp (plain, with momentum, centered) and Ftrl (lr_power -0.5 and
  another) builds the same `Program.to_dict()` as the reference (the
  update ops, the accumulators and their startup initializers) and, from
  the reference's startup values carried across with
  `convert.params_from_arrays`, gives the same persistables after three
  steps of a two-layer regression (rtol 1e-5: float32 on both sides,
  other summation orders).
- Sparse adagrad: an is_sparse table updated lazily (rows not looked up
  keep their bits) equals the reference's sparse update and the port's
  own dense update.
- ModelAverage and EMA: the accumulators and the shadow weights after
  training equal the reference's; `apply()` installs the reference's
  averaged values (rtol 1e-6), ModelAverage's without a host read;
  `restore()` puts back the very tensors it took out.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf

from torch_twin import PKGS, batches, no_host_reads, persistables, twins

torch.set_num_threads(2)

OPTIMIZERS = {
    "lars_momentum": ("LarsMomentum", dict(learning_rate=0.1, momentum=0.9,
                                           lars_coeff=0.01)),
    "adamax": ("Adamax", dict(learning_rate=0.05)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.05)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop momentum": ("RMSProp", dict(learning_rate=0.01,
                                         momentum=0.9)),
    "rmsprop centered": ("RMSProp", dict(learning_rate=0.01, centered=True,
                                         epsilon=1e-4)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    "ftrl lr_power": ("Ftrl", dict(learning_rate=0.1, l1=0.001,
                                   lr_power=-0.7)),
}


def _net(fluid, opt=None, kw=None):
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, size=8, act="tanh")
    pred = layers.fc(h, size=1)
    loss = layers.mean(layers.square(pred - y))
    if opt is not None:
        getattr(fluid.optimizer, opt)(**kw).minimize(loss)
    return loss


def _close(got, want, rtol=1e-5, atol=1e-7):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=n)


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_the_reference(case):
    opt, kw = OPTIMIZERS[case]
    tw = twins(lambda f: _net(f, opt, kw))
    assert json.dumps(tw["port"][0].to_dict(), sort_keys=True) == \
        json.dumps(tw["ref"][0].to_dict(), sort_keys=True)
    got = {}
    for side, (main, scope, exe, loss) in tw.items():
        losses = [float(np.asarray(exe.run(main, feed=b, fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for b in batches(3, seed=4)]
        got[side] = (losses, persistables(main, scope))
    np.testing.assert_allclose(got["port"][0], got["ref"][0], rtol=1e-5)
    _close(got["port"][1], got["ref"][1])
    # and the parameters moved
    start = twins(lambda f: _net(f, opt, kw))["port"]
    init = persistables(start[0], start[1])
    assert any(not np.allclose(init[p.name], got["port"][1][p.name])
               for p in start[0].all_parameters())


def test_optimizer_aliases_are_the_classes():
    for short in ("LarsMomentum", "Adamax", "Adagrad", "DecayedAdagrad",
                  "Adadelta", "RMSProp", "Ftrl"):
        cls = getattr(tf.optimizer, short)
        assert cls is getattr(tf.optimizer, f"{short}Optimizer")
        assert cls.__name__ == getattr(jf.optimizer, short).__name__


def _table(fluid, is_sparse=True):
    layers = fluid.layers
    ids = layers.data("ids", shape=[3], dtype="int64")
    emb = layers.embedding(ids, size=[30, 4], is_sparse=is_sparse)
    loss = layers.reduce_mean(layers.square(layers.scale(emb, bias=-0.5)))
    fluid.optimizer.AdagradOptimizer(
        learning_rate=0.3, initial_accumulator_value=0.1).minimize(loss)
    return loss


def test_sparse_adagrad_matches_the_reference_and_the_dense_update():
    rng = np.random.RandomState(6)
    feeds = [{"ids": rng.randint(0, 12, (4, 3)).astype(np.int64)}
             for _ in range(3)]   # rows 12.. are never looked up
    got = {}
    for name, body in (("sparse", _table),
                       ("dense", lambda f: _table(f, is_sparse=False))):
        for side, (main, scope, exe, loss) in twins(body).items():
            table = main.all_parameters()[0].name
            before = persistables(main, scope)
            for feed in feeds:
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            got[name, side] = (table, before, persistables(main, scope))
    table, before, after = got["sparse", "port"]
    _close(after, got["sparse", "ref"][2])
    _close(after, got["dense", "port"][2], rtol=1e-6)
    moment = f"{table}.moment"
    for n in (table, moment):
        np.testing.assert_array_equal(after[n][12:], before[n][12:])
        assert not np.array_equal(after[n][:12], before[n][:12])


def _averaged(fluid, kind):
    loss = _net(fluid, "SGD", dict(learning_rate=0.2))
    if kind == "model_average":
        avg = fluid.optimizer.ModelAverage(0.5, min_average_window=2,
                                           max_average_window=3)
    else:
        avg = fluid.optimizer.ExponentialMovingAverage(decay=0.9)
        avg.update()
    return loss, avg


@pytest.mark.parametrize("kind", ["model_average", "ema"])
@pytest.mark.parametrize("steps", [0, 5])
def test_apply_and_restore_match_the_reference(kind, steps):
    got = {}
    for side, (main, scope, exe, (loss, avg)) in twins(
            lambda f: _averaged(f, kind)).items():
        for b in batches(steps, seed=9):
            exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        trained = persistables(main, scope)
        params = [p.name for p in main.all_parameters()]
        fluid = PKGS[side]
        with fluid.scope_guard(scope):
            before = {n: scope.find_var(n) for n in params}
            with avg.apply(exe):
                applied = {n: np.asarray(
                    scope.find_var(n).numpy() if side == "port"
                    else scope.find_var(n)) for n in params}
            after = {n: scope.find_var(n) for n in params}
        if side == "port":
            assert all(after[n] is before[n] for n in params)
        got[side] = (trained, applied)
    _close(got["port"][0], got["ref"][0])
    _close(got["port"][1], got["ref"][1], rtol=1e-6)
    if steps == 0:
        # nothing accumulated yet: apply() installs the parameters
        _close(got["port"][1], {n: got["port"][0][n]
                                for n in got["port"][1]}, rtol=0, atol=0)


def test_model_average_apply_reads_nothing_back_and_restores_by_hand():
    main, scope, exe, (loss, avg) = twins(
        lambda f: _averaged(f, "model_average"))["port"]
    for b in batches(4, seed=2):
        exe.run(main, feed=b, fetch_list=[loss], scope=scope)
    params = [p.name for p in main.all_parameters()]
    before = {n: scope.find_var(n) for n in params}
    with tf.scope_guard(scope), no_host_reads():
        with avg.apply(exe, need_restore=False):
            pass
    assert all(scope.find_var(n) is not before[n] for n in params)
    avg.restore(exe)
    assert all(scope.find_var(n) is before[n] for n in params)
