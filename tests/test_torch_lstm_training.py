"""The stacked dynamic LSTM slice end to end on the CPU: the port against
the JAX package.

A small model (vocab 50, emb 8, hidden 8, 3 stacked layers, batch 3,
max_len 10, ragged lengths, `pallas_rnn=True` on both sides: the
reference runs its Pallas recurrence kernels through the interpreter, the
port the plain versions of its CUDA kernels).

- `build_model` serializes to the same `Program.to_dict()` in both
  packages (main and startup, backward_marker and adam ops included).
- From the reference's initialized parameters, carried across with
  `convert.params_from_arrays`, three Adam steps give the same losses
  (1e-5), the same accuracy, step-1 gradients within 1e-4 of each
  gradient's max |g| and parameters after step 3 within 4 * sum(lr) (Adam
  turns a gradient near 0 into a step of about +-lr whose sign is float32
  noise).
- The reference's program handed over as `to_dict()` trains to the same
  numbers as the port's own; the `for_test` clone runs forward-only and
  agrees with the reference's clone.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import stacked_dynamic_lstm as jl
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models import stacked_dynamic_lstm as tl
from paddle_tpu_torch.ops import kernels

torch.set_num_threads(2)

ARCH = dict(vocab_size=50, emb_dim=8, hidden_dim=8, stacked_num=3,
            max_len=10, learning_rate=1e-3, pallas_rnn=True)
LR, STEPS = 1e-3, 3


def _build(fluid, mod, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = mod.build_model(**dict(ARCH, **kw))
    return main, startup, out


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _reference_scope(startup):
    scope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    return scope, {n: np.asarray(v) for n, v in scope.vars.items()
                   if v is not None}


def _port_scope(arrays, program):
    scope = tf.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=program).items():
        scope.set_var(n, t)
    return scope


def _batch():
    feed = tl.make_fake_batch(3, ARCH["max_len"], ARCH["vocab_size"], seed=1)
    feed["words.seq_len"] = np.array([10, 6, 1], np.int32)
    return feed


def test_make_fake_batch_is_the_reference_batch():
    a, b = tl.make_fake_batch(5, 12, 40, seed=3), \
        jl.make_fake_batch(5, 12, 40, seed=3)
    assert set(a) == set(b)
    for n in a:
        assert a[n].dtype == b[n].dtype
        np.testing.assert_array_equal(a[n], b[n])
    assert a["words.seq_len"].min() >= 6 and a["words.seq_len"].max() <= 12


@pytest.mark.parametrize("kw", [{}, {"pallas_rnn": False, "rnn_unroll": 2},
                                {"with_optimizer": False}],
                         ids=["pallas", "scan-unroll", "no-optimizer"])
def test_programs_serialize_equal(kw):
    jm, js, _ = _build(jf, jl, **kw)
    tm, ts, _ = _build(tf, tl, **kw)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("dynamic_lstm") == 3
    assert ("adam" in types) == kw.get("with_optimizer", True)


def test_use_amp_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="B.3 item 3"):
        _build(tf, tl, use_amp=True)


def test_convert_carries_the_lstm_parameters_by_name():
    tm, _, _ = _build(tf, tl)
    _, js, _ = _build(jf, jl)
    _, arrays = _reference_scope(js)
    got = params_from_arrays(arrays, "cpu", program=tm)
    h = ARCH["hidden_dim"]
    for i in range(3):
        assert tuple(got[f"lstm_{i}.w_0"].shape) == (h, 4 * h)
        assert tuple(got[f"lstm_{i}.b_0"].shape) == (1, 4 * h)
        np.testing.assert_array_equal(got[f"lstm_{i}.w_0"].numpy(),
                                      arrays[f"lstm_{i}.w_0"])
    assert tuple(got["embedding_0.w_0"].shape) == (ARCH["vocab_size"],
                                                   ARCH["emb_dim"])
    bad = dict(arrays)
    bad["lstm_1.w_0"] = bad["lstm_1.w_0"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_arrays(bad, "cpu", program=tm)
    del bad["lstm_1.w_0"]
    with pytest.raises(ValueError, match="missing"):
        params_from_arrays(bad, "cpu", program=tm)


@pytest.mark.parametrize("handed_over", [False, True],
                         ids=["built-by-the-port", "from-to_dict"])
def test_stacked_lstm_trains_like_the_reference(handed_over):
    jm, js, jmod = _build(jf, jl)
    if handed_over:
        # the reference's program crosses as a dict, its parameters as
        # numpy arrays
        tm = tf.Program.from_dict(json.loads(json.dumps(jm.to_dict())))
        loss_name, acc_name = jmod["loss"].name, jmod["accuracy"].name
    else:
        tm, _, tmod = _build(tf, tl)
        loss_name, acc_name = tmod["loss"].name, tmod["accuracy"].name
    jscope, arrays = _reference_scope(js)
    tscope = _port_scope(arrays, tm)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    fetch = [loss_name, acc_name] + [f"{p}@GRAD" for p in params]
    feed = _batch()
    kernels.reset_counts()
    for step in range(STEPS):
        jo = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        to = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(to[1], jo[1])
        if step == 0:
            for name, a, b in zip(params, to[2:], jo[2:]):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                    err_msg=f"{name}@GRAD")
    c = kernels.counts()
    assert c["plain"]["lstm_fwd"] == 3 * STEPS
    assert c["plain"]["lstm_bwd"] == 3 * STEPS
    assert c["composed"]["dynamic_lstm"] == 0
    bound = 4 * LR * STEPS + 1e-7
    for p in params:
        a = tscope.find_var(p).numpy()
        assert np.abs(a - np.asarray(jscope.find_var(p))).max() <= bound, p
    moved = max(float(np.abs(tscope.find_var(p).numpy() - arrays[p]).max())
                for p in params)
    assert moved > 1e-4
    assert not [n for n, t in tscope.vars.items()
                if isinstance(t, torch.Tensor)
                and (t.requires_grad or t.grad_fn is not None)]


def test_for_test_clone_runs_forward_only_and_matches():
    jm, js, jmod = _build(jf, jl)
    tm, _, tmod = _build(tf, tl)
    jscope, arrays = _reference_scope(js)
    tscope = _port_scope(arrays, tm)
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    assert _json(ttest) == _json(jtest)
    feed = _batch()
    fetch = [jmod["loss"].name, jmod["accuracy"].name]
    kernels.reset_counts()
    to = tf.Executor(tf.CPUPlace()).run(ttest, feed=feed, fetch_list=fetch,
                                        scope=tscope)
    jo = jf.Executor(jf.CPUPlace()).run(jtest, feed=feed, fetch_list=fetch,
                                        scope=jscope)
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to[1], jo[1])
    c = kernels.counts()
    assert c["plain"]["lstm_fwd"] == 3 and c["plain"]["lstm_bwd"] == 0
    # nothing was updated: the parameters are the ones carried across
    for p in (q.name for q in tm.all_parameters()):
        np.testing.assert_array_equal(tscope.find_var(p).numpy(), arrays[p])


def test_accuracy_and_loss_fetch_next_to_integer_outputs():
    """The integer top_k / accuracy outputs fetch beside the loss in a
    training step; the .seq_len companions stay int32 outside autograd."""
    tm, ts, tmod = _build(tf, tl)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    ops = tm.global_block().ops
    acc_op = next(op for op in ops if op.type == "accuracy")
    topk_op = next(op for op in ops if op.type == "top_k")
    names = [tmod["loss"].name, acc_op.desc.outputs["Correct"][0],
             acc_op.desc.outputs["Total"][0],
             topk_op.desc.outputs["Indices"][0], "lstm_0.tmp_0.seq_len"]
    loss, correct, total, idx, sl = exe.run(tm, feed=_batch(),
                                            fetch_list=names, scope=scope)
    assert abs(float(loss[0]) - np.log(2)) < 0.1
    assert correct.dtype == np.int32 and total.dtype == np.int32
    assert int(total[0]) == 3 and 0 <= int(correct[0]) <= 3
    assert idx.dtype == np.int32 and idx.shape == (3, 1)
    assert sl.dtype == np.int32
    np.testing.assert_array_equal(sl, _batch()["words.seq_len"])
