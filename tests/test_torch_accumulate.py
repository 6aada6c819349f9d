"""Gradient accumulation (`Executor.run(accumulation_steps=K)`) in the
port, against the JAX package's accumulation and against the full batch.

- The tiny Transformer (2 layers, d_model 32, flash, dropout 0) with
  K = 2 and 4: three steps against the reference's K-step accumulation
  from the same startup values (losses 1e-5, step-1 gradients 1e-4 of
  each gradient's max |g|, parameters within 4 * sum(lr)); and step 1
  against the port's own full-batch step (the loss and the gradients
  within float32 summation noise: the mean of the micro means is the
  full-batch mean on full-length rows).  The noam counter is a
  persistable forward output, so it advances K times a step in both
  packages; the full-batch comparison over three steps advances it to
  match.
- The fetch contract: a per-example value concatenates back to the full
  batch, a batch mean averages, a feed stays fetchable at full size.
- A feed of ndim 0 or a batch K does not divide raises ValueError.
- Batch norm's moving statistics thread through the micro-batches (K
  micro-batches compound K updates), as in the reference.
- An is_sparse table takes the dense gradient under accumulation, as in
  the reference, and trains the same.
- Dynamic loss scaling: the guard sees the averaged gradients and the
  fetched loss is unscaled; `iterations` composes with accumulation.
- Each micro-batch draws its own dropout masks, the run counter
  advances once a step, and the numerics bitmap covers every
  micro-batch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import observe as jobs
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.core.executor import RNG_STATE_VAR
from paddle_tpu_torch.models import transformer as tt

from torch_amp_parity import keep_reference_roundings
from torch_twin import PKGS, batches, build, linreg, persistables, twins

torch.set_num_threads(2)

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
            use_flash=True, warmup_steps=100)
MODELS = {"ref": jt, "port": tt}
COUNTER = "@lr_decay_counter@"


def _noam(step, d_model=32, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _transformer(fluid):
    side = "ref" if fluid is jf else "port"
    return MODELS[side].build_model(**ARCH)["loss"]


def _feed():
    # full-length rows: the token mean of each micro-batch has the same
    # denominator, so the mean of the micro means is the full-batch mean
    return tt.make_fake_batch(4, 16, 100, 100, seed=1)


def _grad_names(main):
    return [f"{p.name}@GRAD" for p in main.all_parameters()]


def _steps(t, feed, k, n=3, fetch_grads=False, counter_extra=0):
    main, scope, exe, loss = t
    fetch = [loss] + (_grad_names(main) if fetch_grads else [])
    losses, grads = [], None
    for step in range(n):
        if counter_extra:
            c = scope.find_var(COUNTER)
            scope.set_var(COUNTER, c + counter_extra)
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      accumulation_steps=k)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if step == 0:
            grads = [np.asarray(g) for g in out[1:]]
    return losses, grads, persistables(main, scope)


@pytest.mark.parametrize("k", [2, 4])
def test_transformer_accumulation_matches_the_reference(k):
    tw = twins(_transformer)
    feed = _feed()
    got = _steps(tw["port"], feed, k, fetch_grads=True)
    want = _steps(tw["ref"], feed, k, fetch_grads=True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30))
    # the noam counter advanced K times a step in both packages
    assert got[2][COUNTER].item() == want[2][COUNTER].item() == 3 * k
    lr_sum = sum(_noam(t) for t in range(k, 3 * k + 1, k))
    main = tw["port"][0]
    for p in main.all_parameters():
        np.testing.assert_allclose(got[2][p.name], want[2][p.name], rtol=0,
                                   atol=4 * lr_sum + 1e-6, err_msg=p.name)


@pytest.mark.parametrize("k", [2, 4])
def test_transformer_accumulation_matches_the_full_batch(k):
    """K micro-batches against the port's own full-batch steps, the
    full-batch run's counter advanced K - 1 before each step so both
    follow the same learning rates (step s at noam(s * K))."""
    tw = twins(_transformer)
    feed = _feed()
    acc = _steps(tw["port"], feed, k, fetch_grads=True)
    tw1 = twins(_transformer)
    full = _steps(tw1["port"], feed, 1, fetch_grads=True,
                  counter_extra=k - 1)
    assert abs(acc[0][0] - full[0][0]) <= 1e-6
    np.testing.assert_allclose(acc[0], full[0], rtol=0, atol=1e-5)
    for g, w in zip(acc[1], full[1]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    lr_sum = sum(_noam(t) for t in range(k, 3 * k + 1, k))
    for p in tw["port"][0].all_parameters():
        np.testing.assert_allclose(acc[2][p.name], full[2][p.name], rtol=0,
                                   atol=4 * lr_sum + 1e-6, err_msg=p.name)


def _fetching(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1)
    loss = layers.mean(layers.square(pred - y))
    avg_pred = layers.reduce_mean(pred)
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss, pred, avg_pred


def test_fetch_contract_matches_the_reference_and_the_full_batch():
    b = batches(1, bs=8)[0]
    got = {}
    for side, (main, scope, exe, (loss, pred, avg)) in twins(
            _fetching).items():
        got[side] = [np.asarray(v) for v in exe.run(
            main, feed=b, fetch_list=[loss, pred, avg, "x"], scope=scope,
            accumulation_steps=4)]
    full = twins(_fetching)["port"]
    main, scope, exe, (loss, pred, avg) = full
    want = [np.asarray(v) for v in exe.run(
        main, feed=b, fetch_list=[loss, pred, avg, "x"], scope=scope)]
    for port, ref, whole in zip(got["port"], got["ref"], want):
        assert port.shape == ref.shape == whole.shape
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port, whole, rtol=1e-6, atol=1e-7)
    assert got["port"][1].shape == (8, 1)        # per example: concatenated
    np.testing.assert_array_equal(got["port"][3], b["x"])


@pytest.mark.parametrize("feed", [
    {"x": np.zeros((6, 4), np.float32), "y": np.zeros((6, 1), np.float32)},
    {"x": np.zeros((8, 4), np.float32), "y": np.float32(1.0)},
])
def test_indivisible_or_unbatched_feed_raises(feed):
    for side, (main, scope, exe, loss) in twins(
            lambda f: linreg(f, opt="sgd")).items():
        with pytest.raises(ValueError, match="divisible"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    accumulation_steps=4)


def _bn(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[3, 4, 4], dtype="float32")
    h = layers.batch_norm(layers.conv2d(x, num_filters=2, filter_size=3))
    loss = layers.mean(layers.square(h))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss


def test_batch_norm_moving_stats_thread_through_the_micro_batches():
    rng = np.random.RandomState(3)
    feed = {"x": (rng.randn(8, 3, 4, 4) * 2 + 1).astype(np.float32)}
    got = {}
    for side, (main, scope, exe, loss) in twins(_bn).items():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                accumulation_steps=2)
        got[side] = persistables(main, scope)
    stats = [n for n in got["port"] if "moving" in n or "mean" in n
             or "variance" in n]
    assert stats
    for n in got["ref"]:
        np.testing.assert_allclose(got["port"][n], got["ref"][n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    # two micro-batches compound two momentum updates of the statistics:
    # not the full batch's one
    main, scope, exe, loss = twins(_bn)["port"]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    once = persistables(main, scope)
    assert any(not np.allclose(once[n], got["port"][n]) for n in stats)


def _sparse_emb(fluid):
    layers = fluid.layers
    ids = layers.data("ids", shape=[3], dtype="int64")
    emb = layers.embedding(ids, size=[20, 4], is_sparse=True)
    loss = layers.reduce_mean(layers.square(emb))
    fluid.optimizer.AdagradOptimizer(learning_rate=0.5).minimize(loss)
    return loss


def test_sparse_table_takes_the_dense_gradient_under_accumulation():
    feed = {"ids": np.random.RandomState(5).randint(0, 20, (4, 3))
            .astype(np.int64)}
    got = {}
    for side, (main, scope, exe, loss) in twins(_sparse_emb).items():
        table = main.all_parameters()[0].name
        for _ in range(2):
            out = exe.run(main, feed=feed,
                          fetch_list=[loss, f"{table}@GRAD"], scope=scope,
                          accumulation_steps=2)
        assert np.asarray(out[1]).shape == (20, 4)   # dense
        got[side] = persistables(main, scope)
    for n in got["ref"]:
        np.testing.assert_allclose(got["port"][n], got["ref"][n],
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def _scaled(fluid):
    return linreg(fluid, opt="sgd", amp=dict(
        use_dynamic_loss_scaling=True, init_loss_scaling=8.0,
        incr_every_n_steps=2))


def _scaled_run(t, side, b, k):
    main, scope, exe, loss = t
    poisoned = PKGS[side].resilience.chaos.poison_feed(b[0], ["x"])
    losses = []
    for feed in (poisoned, b[1], b[2]):
        losses.append(float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope,
            accumulation_steps=k)[0]).reshape(-1)[0]))
    tel = {"ref": jobs, "port": tobs}[side].fetch_telemetry(scope)
    return (losses, tel.skipped_update_steps, tel.loss_scale,
            persistables(main, scope))


def test_dynamic_loss_scaling_under_accumulation(monkeypatch):
    """A NaN in one micro-batch makes the averaged gradients non-finite:
    the guard skips the step and halves the scale; the fetched losses are
    unscaled, equal to the full-batch run's.  The reference keeps the
    roundings its bf16 ops specify (torch_amp_parity)."""
    keep_reference_roundings(monkeypatch)
    b = batches(3)
    seen = {side: _scaled_run(t, side, b, 2)
            for side, t in twins(_scaled).items()}
    assert seen["port"][1:3] == seen["ref"][1:3] == (1, 8.0)
    assert np.isnan(seen["port"][0][0]) and np.isnan(seen["ref"][0][0])
    np.testing.assert_allclose(seen["port"][0][1:], seen["ref"][0][1:],
                               rtol=1e-5)
    for n, v in seen["ref"][3].items():
        np.testing.assert_allclose(seen["port"][3][n], v, rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    full = _scaled_run(twins(_scaled)["port"], "port", b, 1)
    assert full[1:3] == seen["port"][1:3]
    np.testing.assert_allclose(seen["port"][0][1:], full[0][1:], rtol=1e-6)


def test_iterations_compose_with_accumulation():
    b = batches(1)[0]
    got = {}
    for side, (main, scope, exe, loss) in twins(
            lambda f: linreg(f)).items():
        out = exe.run(main, feed=b, fetch_list=[loss], scope=scope,
                      iterations=3, accumulation_steps=2)
        got[side] = (np.asarray(out[0]), persistables(main, scope))
    np.testing.assert_allclose(got["port"][0], got["ref"][0], rtol=1e-5)
    for n, v in got["ref"][1].items():
        np.testing.assert_allclose(got["port"][1][n], v, rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    main, scope, exe, loss = twins(lambda f: linreg(f))["port"]
    for _ in range(3):
        last = exe.run(main, feed=b, fetch_list=[loss], scope=scope,
                       accumulation_steps=2)
    np.testing.assert_array_equal(np.asarray(last[0]), got["port"][0])


def _dropout(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[64], dtype="float32")
    h = layers.fc(x, size=64)
    d = layers.dropout(h, dropout_prob=0.5)
    loss = layers.mean(d)
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss, d


def test_each_micro_batch_draws_its_own_masks_and_the_counter_once():
    main, startup, (loss, d) = build(tf, _dropout)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    run0 = scope.find_var(RNG_STATE_VAR)
    row = np.random.RandomState(0).rand(1, 64).astype(np.float32)
    out = np.asarray(exe.run(main, feed={"x": np.repeat(row, 4, 0)},
                             fetch_list=[d], scope=scope,
                             accumulation_steps=2)[0])
    assert scope.find_var(RNG_STATE_VAR) == run0 + 1
    kept = out != 0
    # the same rows in the two micro-batches, other masks
    assert not np.array_equal(kept[:2], kept[2:])
    # while the same micro-batch of the next step differs again
    out2 = np.asarray(exe.run(main, feed={"x": np.repeat(row, 4, 0)},
                              fetch_list=[d], scope=scope,
                              accumulation_steps=2)[0])
    assert scope.find_var(RNG_STATE_VAR) == run0 + 2
    assert not np.array_equal(kept, out2 != 0)


def _named(f):
    return linreg(f, opt="sgd", d=8, names=True)


def test_numerics_bitmap_covers_every_micro_batch():
    """A NaN in the second micro-batch only is latched at the op that
    first produced it, as in the reference."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 8).astype(np.float32),
            "y": rng.rand(8, 1).astype(np.float32)}
    feed["y"][6, 0] = np.nan
    fno = {}
    for side, (main, scope, exe, loss) in twins(
            _named, prepare=lambda fl, m: {"ref": jobs, "port": tobs}[
                "ref" if fl is jf else "port"].enable_numerics(m)).items():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                accumulation_steps=2)
        fno[side] = {"ref": jobs, "port": tobs}[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
    assert fno["port"] is not None and fno["port"] == fno["ref"]
