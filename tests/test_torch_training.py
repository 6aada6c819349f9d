"""The training slice end to end on the CPU: the port against the JAX
package.

- The tiny Transformer (2 layers, d_model 32, 2 heads, vocab 100, T=16,
  batch 4, ragged lengths of at least 1, dropout 0; use_flash=True with
  head_major False and True, use_flash=False, and fused_qkv with
  head_major False and True) builds the same `Program.to_dict()` in both
  packages, backward_marker and adam ops included; from the reference's
  startup scope, carried across with `convert.params_from_arrays`, three
  Adam steps give the same losses (1e-5), step-1 gradients (1e-4 of each
  gradient's max |g|: float32, other summation orders), Adam moments
  after step 3 (1e-4 of max) and parameters after step 3 (within
  4 * sum(lr): Adam with epsilon 1e-9 turns a gradient near 0 into a
  step of about +-lr whose sign is float32 noise).
- `params_from_arrays(..., program=main)` carries the whole training
  scope: parameters, moments, beta-pow accumulators, the lr counter and
  a learning-rate variable.
- Gradient clipping and weight decay build and train as in the
  reference; with neither, the optimizer passes (param, grad) through.
- `device=None` resolves to the card or raises; no scope tensor keeps
  autograd state after a step; explicit gradient sync raises naming
  its ROADMAP step, and `moe_experts`, once unported, builds the
  reference's program (tests/test_torch_moe.py trains it).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models import transformer as tt

torch.set_num_threads(2)

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
            use_flash=True, warmup_steps=100)


def _build(fluid, build_fn, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build_fn(**kw)
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
    feed = tt.make_fake_batch(4, 16, 100, 100, seed=1)
    feed["src_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["trg_len"] = np.array([3, 16, 12, 1], np.int32)
    return feed


def _noam(step, d_model=32, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


@pytest.mark.parametrize("head_major", [False, True])
def test_transformer_trains_like_the_reference(head_major):
    _trains_like_the_reference(dict(ARCH, head_major=head_major),
                               n_flash=6 if head_major else 4)


@pytest.mark.parametrize("kw,n_flash,n_slice", [
    (dict(use_flash=False), 0, 0),
    (dict(fused_qkv=True), 4, 12),
    (dict(fused_qkv=True, head_major=True), 6, 12),
])
def test_transformer_options_train_like_the_reference(kw, n_flash,
                                                      n_slice):
    """use_flash=False (every attention composed, the decoder's causal
    bias from range and less_equal) and fused_qkv in either layout (q,
    k and v sliced from one projection: the flash op reads the slices,
    and their gradients come back through slice)."""
    tm = _trains_like_the_reference(dict(ARCH, **kw), n_flash)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("slice") == n_slice
    assert ("range" in types) == (not kw.get("use_flash", True))


def _trains_like_the_reference(kw, n_flash):
    jm, js, jmod = _build(jf, jt.build_model, **kw)
    tm, ts, tmod = _build(tf, tt.build_model, **kw)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    assert "backward_marker" in types and "adam" in types
    assert types.count("flash_attention") == n_flash

    jscope, arrays = _reference_scope(js)
    tscope = _port_scope(arrays, tm)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    fetch = [jmod["loss"].name] + [f"{p}@GRAD" for p in params]
    feed = _batch()
    for step in range(3):
        jo = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        to = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
        if step == 0:
            for name, a, b in zip(params, to[1:], jo[1:]):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                    err_msg=f"{name}@GRAD")
    bound = 4 * sum(_noam(t) for t in (1, 2, 3)) + 1e-7
    for v in tm.global_block().vars.values():
        if not v.persistable:
            continue
        a = tscope.find_var(v.name).numpy()
        b = np.asarray(jscope.find_var(v.name))
        if v.name in params:
            assert np.abs(a - b).max() <= bound, v.name
        else:                        # moments, beta pows, the lr counter
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                err_msg=v.name)
    # the parameters moved, and nothing of the graph stayed in the scope
    moved = max(float(np.abs(tscope.find_var(p).numpy() - arrays[p]).max())
                for p in params)
    assert moved > 1e-4
    assert not [n for n, t in tscope.vars.items()
                if isinstance(t, torch.Tensor)
                and (t.requires_grad or t.grad_fn is not None)]
    return tm


def test_convert_carries_the_whole_training_scope():
    tm, ts, _ = _build(tf, tt.build_model, **ARCH)
    jm, js, _ = _build(jf, jt.build_model, **ARCH)
    _, arrays = _reference_scope(js)
    got = params_from_arrays(arrays, "cpu", program=tm)
    persist = {v.name for v in tm.global_block().vars.values()
               if v.persistable}
    assert set(got) == persist
    kinds = {"moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc"}
    for kind in kinds:
        assert any(n.endswith(f".{kind}") for n in got), kind
    assert "@lr_decay_counter@" in got
    for n, t in got.items():
        np.testing.assert_array_equal(t.numpy(), arrays[n])
    # a float learning rate becomes a persistable var of its own
    def sgd_net(fluid):
        x = fluid.layers.data("x", shape=[4])
        loss = fluid.layers.reduce_sum(fluid.layers.fc(x, size=3))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        return loss

    sm, ss, _ = _build(tf, lambda: sgd_net(tf))
    jsm, jss, _ = _build(jf, lambda: sgd_net(jf))
    _, sarrays = _reference_scope(jss)
    got = params_from_arrays(sarrays, "cpu", program=sm)
    lr = [n for n in got if n.endswith(".learning_rate")]
    assert lr and float(got[lr[0]][0]) == pytest.approx(0.1)


@pytest.mark.parametrize("setup", ["none", "l2_globalnorm", "l1_value",
                                   "norm"])
def test_clip_and_regularizer_match_the_reference(setup):
    def net(fluid):
        from importlib import import_module

        clip = import_module(f"{fluid.__name__}.clip")
        reg = import_module(f"{fluid.__name__}.regularizer")
        clip_attr = {"l2_globalnorm": clip.GradientClipByGlobalNorm(0.5),
                     "l1_value": clip.GradientClipByValue(0.05),
                     "norm": clip.GradientClipByNorm(0.3)}.get(setup)
        decay = {"l2_globalnorm": reg.L2Decay(0.1),
                 "l1_value": reg.L1Decay(0.05)}.get(setup)
        x = fluid.layers.data("x", shape=[6])
        h = fluid.layers.fc(x, size=5, act="relu",
                            param_attr=fluid.ParamAttr(
                                gradient_clip=clip_attr))
        loss = fluid.layers.reduce_sum(fluid.layers.fc(
            h, size=1, param_attr=fluid.ParamAttr(gradient_clip=clip_attr)))
        opt = fluid.optimizer.SGDOptimizer(0.5, regularization=decay)
        _, pg = opt.minimize(loss)
        return loss, pg

    tm, ts, (tloss, tpg) = _build(tf, lambda: net(tf))
    jm, js, (jloss, _) = _build(jf, lambda: net(jf))
    assert _json(tm) == _json(jm)
    if setup == "none":              # passed through: the grads themselves
        assert all(g.name == f"{p.name}@GRAD" for p, g in tpg)
        types = [op.type for op in tm.global_block().ops]
        assert set(types[types.index("backward_marker") + 1:]) == {"sgd"}
    jscope, arrays = _reference_scope(js)
    tscope = _port_scope(arrays, tm)
    feed = {"x": np.random.RandomState(0).randn(8, 6).astype(np.float32)}
    for _ in range(2):
        want = jf.Executor(jf.CPUPlace()).run(jm, feed=feed,
                                              fetch_list=[jloss],
                                              scope=jscope)
        got = tf.Executor(tf.CPUPlace()).run(tm, feed=feed,
                                             fetch_list=[tloss],
                                             scope=tscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for p in tm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-5, atol=1e-6)


def test_default_device_is_the_card_or_raises(monkeypatch):
    from paddle_tpu_torch.core.executor import interpret_program, run_ops
    from paddle_tpu_torch.core.registry import OpContext

    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        x = tf.layers.data("x", shape=[3])
        y = tf.layers.scale(x, scale=2.0)      # shape inference: meta
    assert tuple(main.global_block().var(y.name).shape) == (-1, 3)
    env = {"x": torch.ones(2, 3)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: OpContext((0, 0), 0),
                 lambda: run_ops(main.global_block().ops, dict(env), None),
                 lambda: interpret_program(main, dict(env), None,
                                           fetch_names=[y.name])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    out = interpret_program(main, dict(env), None, fetch_names=[y.name],
                            device="cpu")
    assert float(out[y.name].sum()) == 12.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert OpContext((0, 0), 0).device == torch.device("cuda", 0)


@pytest.mark.parametrize("kw,item", [
    (dict(moe_experts=2), "queue A item 6"),
])
def test_unported_transformer_options_raise(kw, item):
    """The options that raised naming their queue A item (`moe_experts`,
    item 6, ported in step 8c) now build the reference's program: one
    moe_ffn a FFN sublayer, none raising."""
    tm, ts, _ = _build(tf, tt.build_model, **dict(ARCH, **kw))
    jm, js, _ = _build(jf, jt.build_model, **dict(ARCH, **kw))
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("moe_ffn") == 2 * ARCH["n_layer"]


def test_unported_executor_features_raise():
    tm, ts, tmod = _build(tf, tt.build_model, **ARCH)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    tm._grad_sync = object()
    with pytest.raises(NotImplementedError, match="A step 10"):
        exe.run(tm, feed=_batch(), fetch_list=[tmod["loss"]], scope=scope)
    # an is_sparse lookup of a trainable table no longer raises: it takes
    # the SparseGrad path (tests/test_torch_sparse.py), and SGD moves
    # only the looked-up row
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        ids = tf.layers.data("ids", shape=[3], dtype="int64")
        emb = tf.layers.embedding(ids, size=[10, 4], is_sparse=True)
        loss = tf.layers.reduce_sum(emb)
        tf.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe.run(startup, scope=scope)
    table = main.global_block().all_parameters()[0].name
    before = scope.find_var(table).numpy().copy()
    exe.run(main, feed={"ids": np.zeros((2, 3), np.int64)},
            fetch_list=[loss], scope=scope)
    after = scope.find_var(table).numpy()
    np.testing.assert_allclose(after[0], before[0] - 0.1 * 6, rtol=1e-6)
    np.testing.assert_array_equal(after[1:], before[1:])
