"""The SparseGrad path on the CPU: the port's counterparts of
tests/test_sparse.py, each also held against the JAX package, and DeepFM
against the reference.

- An is_sparse table's gradient is a SparseGrad of the looked-up ids and
  row gradients; with one batch repeated, the sparse trajectory of sgd,
  momentum and adam is the dense one (the same rows are touched every
  step), and the reference's sparse trajectory (losses within 1e-5
  relative, tables within 1e-5 + 1e-7).
- Sparse Adam and momentum are lazy: over two batches touching other
  rows, untouched rows and their moments keep their bits, and rows
  touched only by the first batch do not move in the second step,
  exactly as in the reference.
- `merged()` sums duplicates in the reference's layout; `to_dense` is
  the scatter-add.
- padding_idx keeps its row frozen on the sparse path as on the dense.
- A table another op reads falls back to the dense gradient.
- DeepFM (vocab 1001, DNN 16 x 2, batch 64): the reference's program,
  its batch maker bit for bit, and three Adam steps from the reference's
  startup scope: losses and AUC within 1e-5, the AUC histograms exactly
  (whole counts), parameters within 4 * sum(lr) and untouched table rows
  and moments bit-equal to their start.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.core.selected_rows import SparseGrad as RefSparseGrad
from paddle_tpu.models import deepfm as jd
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.core.executor import interpret_program
from paddle_tpu_torch.core.selected_rows import SparseGrad
from paddle_tpu_torch.models import deepfm as td

torch.set_num_threads(2)

V, D, B, F = 50, 8, 16, 4
OPTS = {"sgd": lambda o: o.SGD(learning_rate=0.1),
        "momentum": lambda o: o.Momentum(learning_rate=0.1, momentum=0.9),
        "adam": lambda o: o.Adam(learning_rate=0.01)}


def _build(fluid, is_sparse, opt, padding_idx=None, shared=False):
    main, startup = fluid.Program(), fluid.Program()
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = layers.data("ids", shape=[B, F], dtype="int64",
                          append_batch_size=False)
        y = layers.data("y", shape=[B, 1], append_batch_size=False)
        emb = layers.embedding(
            ids, size=[V, D], is_sparse=is_sparse, padding_idx=padding_idx,
            param_attr=fluid.ParamAttr(
                name="tbl", initializer=fluid.initializer.Constant(0.05)))
        s = layers.reduce_sum(emb, dim=1)
        p = layers.fc(s, size=1, param_attr=fluid.ParamAttr(
            name="w", initializer=fluid.initializer.Constant(0.2)))
        d = layers.elementwise_sub(p, y)
        loss = layers.reduce_mean(layers.square(d))
        if shared:
            # a second reader of the table: its gradient reaches every row
            tbl = main.global_block().var("tbl")
            loss = layers.elementwise_add(
                loss, layers.scale(layers.reduce_mean(layers.square(tbl)),
                                   scale=10.0))
        OPTS[opt](fluid.optimizer).minimize(loss)
    return main, startup, loss


def _feed(seed=0, lo=0, hi=V):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(lo, hi, (B, F)).astype(np.int64),
            "y": rng.rand(B, 1).astype(np.float32)}


def _train(fluid, program, feeds):
    main, startup, loss = program
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for f in feeds]
    state = {n: np.asarray(v if fluid is jf else v.numpy())
             for n, v in scope.vars.items()
             if n.startswith("tbl") and v is not None}
    return losses, state


def _grad_of(program, feed, name="tbl@GRAD"):
    """The table's gradient as the port's training step leaves it."""
    main, startup, loss = program
    scope = tf.Scope()
    tf.Executor(tf.CPUPlace()).run(startup, scope=scope)
    env = {n: v for n, v in scope.vars.items()
           if isinstance(v, torch.Tensor)}
    env.update({n: torch.as_tensor(a) for n, a in feed.items()})
    return interpret_program(main, env, (0, 0), fetch_names=[loss.name],
                             device="cpu")[name]


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_matches_dense_and_the_reference(opt):
    feeds = [_feed()] * 5
    g = _grad_of(_build(tf, True, opt), feeds[0])
    assert isinstance(g, SparseGrad) and g.rows.shape == (B * F, D)
    assert not isinstance(_grad_of(_build(tf, False, opt), feeds[0]),
                          SparseGrad)
    dense = _train(tf, _build(tf, False, opt), feeds)
    sparse = _train(tf, _build(tf, True, opt), feeds)
    ref = _train(jf, _build(jf, True, opt), feeds)
    for other in (dense, ref):
        np.testing.assert_allclose(sparse[0], other[0], rtol=1e-5)
        assert sparse[1].keys() == other[1].keys()
        for n in sparse[1]:
            np.testing.assert_allclose(sparse[1][n], other[1][n],
                                       rtol=1e-5, atol=1e-7, err_msg=n)
    assert sparse[0][-1] < sparse[0][0]


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_sparse_updates_are_lazy(opt):
    """Batch 1 touches rows 0..19, batch 2 rows 30..49: rows 20..29 and
    their accumulators keep their starting bits, rows only batch 1
    touched keep batch 1's values through step 2, as in the
    reference."""
    feeds = [_feed(1, 0, 20), _feed(2, 30, V)]
    once = _train(tf, _build(tf, True, opt), feeds[:1])[1]
    got = _train(tf, _build(tf, True, opt), feeds)
    want = _train(jf, _build(jf, True, opt), feeds)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for n, a in got[1].items():
        np.testing.assert_allclose(a, want[1][n], rtol=1e-5, atol=1e-7,
                                   err_msg=n)
        start = 0.05 if n == "tbl" else 0.0
        if a.shape[0] == V:
            np.testing.assert_array_equal(a[20:30], np.full_like(
                a[20:30], np.float32(start)), err_msg=n)
            first = np.unique(feeds[0]["ids"])
            np.testing.assert_array_equal(a[first], once[n][first],
                                          err_msg=n)
    assert not np.allclose(got[1]["tbl"][:20], 0.05)


def test_merged_sums_duplicates_as_the_reference():
    import jax.numpy as jnp

    ids = np.array([3, 1, 3, 7, 1, 3], np.int64)
    rows = np.arange(6 * 2, dtype=np.float32).reshape(6, 2) * 0.1
    got = SparseGrad(torch.as_tensor(ids), torch.as_tensor(rows),
                     (10, 2)).merged()
    want = RefSparseGrad(jnp.asarray(ids, jnp.int32), jnp.asarray(rows),
                         (10, 2)).merged()
    for name, a, b in zip(("valid", "ids", "rows"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert got[1][:3].tolist() == [1, 3, 7]
    dense = np.zeros((10, 2), np.float32)
    np.add.at(dense, ids, rows)
    np.testing.assert_allclose(
        SparseGrad(torch.as_tensor(ids), torch.as_tensor(rows),
                   (10, 2)).to_dense().numpy(), dense, rtol=1e-6)


def test_sparse_respects_padding_idx():
    feeds = [_feed()] * 3
    got = _train(tf, _build(tf, True, "sgd", padding_idx=0), feeds)[1]
    dense = _train(tf, _build(tf, False, "sgd", padding_idx=0), feeds)[1]
    want = _train(jf, _build(jf, True, "sgd", padding_idx=0), feeds)[1]
    assert (feeds[0]["ids"] == 0).any()
    np.testing.assert_array_equal(got["tbl"][0],
                                  np.full(D, np.float32(0.05)))
    for other in (dense, want):
        np.testing.assert_allclose(got["tbl"], other["tbl"], rtol=1e-5,
                                   atol=1e-7)


def test_a_shared_table_falls_back_to_dense():
    program = _build(tf, True, "sgd", shared=True)
    g = _grad_of(program, _feed())
    assert isinstance(g, torch.Tensor) and g.shape == (V, D)
    got = _train(tf, program, [_feed()])[1]["tbl"]
    want = _train(jf, _build(jf, True, "sgd", shared=True), [_feed()])[1]
    np.testing.assert_allclose(got, want["tbl"], rtol=1e-5, atol=1e-7)
    untouched = np.setdiff1d(np.arange(V), np.unique(_feed()["ids"]))
    assert untouched.size and not np.allclose(got[untouched], 0.05)


# -- DeepFM -----------------------------------------------------------------

ARCH = dict(vocab_size=1001, dnn_hidden=(16, 16))


def _build_deepfm(fluid, mod):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build_model(**ARCH)
    return main, startup, out


def test_the_reference_batch_maker_is_the_ports():
    want = jd.make_fake_batch(5, vocab_size=1001, seed=4)
    got = td.make_fake_batch(5, vocab_size=1001, seed=4)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].dtype == want[n].dtype


def test_deepfm_trains_like_the_reference():
    jm, js, jo = _build_deepfm(jf, jd)
    tm, ts, to = _build_deepfm(tf, td)
    assert json.dumps(tm.to_dict(), sort_keys=True) == \
        json.dumps(jm.to_dict(), sort_keys=True)
    assert json.dumps(ts.to_dict(), sort_keys=True) == \
        json.dumps(js.to_dict(), sort_keys=True)
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    tscope = tf.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=tm).items():
        tscope.set_var(n, t)
    feed = td.make_fake_batch(64, vocab_size=ARCH["vocab_size"], seed=1)
    assert isinstance(_grad_of((tm, ts, to["loss"]), feed, "fm_emb@GRAD"),
                      SparseGrad)
    stats = [n for n in arrays if n.startswith("auc")]
    assert len(stats) == 2
    fetch = [jo["loss"].name, jo["auc"].name]
    jexe, texe = jf.Executor(jf.CPUPlace()), tf.Executor(tf.CPUPlace())
    for step in range(3):
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        for name, a, b in zip(("loss", "auc"), got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step + 1} {name}")
    assert sum(tscope.find_var(n).numpy().sum() for n in stats) == 3 * 64
    touched = np.unique(feed["sparse_ids"])
    untouched = np.setdiff1d(np.arange(ARCH["vocab_size"]), touched)
    bound = 4 * 3 * 1e-3
    for v in tm.global_block().vars.values():
        if not v.persistable:
            continue
        a = tscope.find_var(v.name).numpy()
        b = np.asarray(jscope.find_var(v.name))
        if v.name in stats:
            np.testing.assert_array_equal(a, b, err_msg=v.name)
        elif v.name.endswith(("pow_acc", "learning_rate")):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=v.name)
        else:
            assert np.abs(a - b).max() <= bound, v.name
        if v.name.startswith(("fm_w1", "fm_emb")) \
                and a.shape[0] == ARCH["vocab_size"]:
            np.testing.assert_array_equal(a[untouched],
                                          arrays[v.name][untouched],
                                          err_msg=v.name)
            assert not np.array_equal(a[touched], arrays[v.name][touched])
