"""Recompute segments and pipeline tags on one device in the port.

- The tiny Transformer built with `recompute=True`, `pipeline=True` or
  both serializes as the reference's build does, trains as the
  reference's recompute build does (three Adam steps: losses 1e-5,
  step-1 gradients 1e-4 of max |g|, parameters within 4 * sum(lr)), and
  gives the port's plain run's losses, gradients and parameters bit for
  bit on the CPU, float32 and under bf16 AMP (the casts are recomputed
  inside the segments).  BERT with `pipeline=True` likewise.
- Dropout inside a segment runs twice a step (forward and recompute) and
  draws the same mask both times: with dropout on, the recompute run's
  gradients equal the plain run's bit for bit.
- A segment saves only its inputs: under
  `torch.autograd.graph.saved_tensors_hooks`, no activation of the
  segment is packed, and only the names read after it leave it.
- A 1-op run is not checkpointed; a step leaves no tensor in a
  reference cycle (no early-stopped recompute); an is_sparse lookup
  inside a segment keeps its SparseGrad path and trains as the
  reference does; the numerics bitmap crosses the segment (the first
  non-finite op latched as in the reference).
"""

from __future__ import annotations

import json
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import observe as jobs
from paddle_tpu.models import bert as jb
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.core import executor as tex
from paddle_tpu_torch.core.registry import _REGISTRY
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.models import transformer as tt

from torch_twin import build, persistables, reference_arrays, scope_of, twins

torch.set_num_threads(2)

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
            use_flash=True, warmup_steps=100)
BERT_ARCH = dict(vocab_size=100, max_len=16, n_layer=2, n_head=2,
                 d_model=32, d_inner=64, max_predictions=4, dropout=0.0,
                 use_flash=True)
SCOPES = {"recompute": dict(recompute=True), "pipeline": dict(pipeline=True),
          "both": dict(recompute=True, pipeline=True)}


def _noam(step, d_model=32, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _json(program):
    """Program.to_dict() with the scope tags renumbered by first
    appearance: both packages count scopes in a process-wide counter, so
    the raw numbers depend on what was built before."""
    d = program.to_dict()
    seen = {}
    for op in d["ops"]:
        for key in ("__recompute__", "__pp_group__"):
            if key in op["attrs"]:
                tag = (key, op["attrs"][key])
                op["attrs"][key] = seen.setdefault(tag, len(seen))
    return json.dumps(d, sort_keys=True)


def _feed():
    feed = tt.make_fake_batch(4, 16, 100, 100, seed=1)
    feed["src_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["trg_len"] = np.array([3, 16, 12, 1], np.int32)
    return feed


def _port_run(arrays, kw, feed, steps=3, model=tt, arch=ARCH):
    """`steps` steps of the port's build with `kw` from `arrays`:
    (losses, step-1 gradients, final persistables), all tensors."""
    main, _, out = build(tf, lambda f: model.build_model(**dict(arch, **kw)))
    scope = scope_of(tf, arrays, main)
    exe = tf.Executor(tf.CPUPlace())
    grads = [f"{p.name}@GRAD" for p in main.all_parameters()]
    losses, g1 = [], None
    for step in range(steps):
        res = exe.run(main, feed=feed, fetch_list=[out["loss"]] + grads,
                      scope=scope, return_numpy=False)
        losses.append(res[0])
        if step == 0:
            g1 = res[1:]
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    return losses, g1, state


def _assert_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _startup_arrays(model, arch):
    _, startup, _ = build(jf, lambda f: model.build_model(**arch))
    return reference_arrays(startup)


@pytest.mark.parametrize("case", sorted(SCOPES))
def test_transformer_scopes_serialize_as_the_reference(case):
    kw = dict(ARCH, **SCOPES[case])
    jm, js, _ = build(jf, lambda f: jt.build_model(**kw))
    tm, ts, _ = build(tf, lambda f: tt.build_model(**kw))
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    attrs = [op.desc.attrs for op in tm.global_block().ops]
    key = "__recompute__" if "recompute" in SCOPES[case] else "__pp_group__"
    assert sum(key in a for a in attrs) > 0


@pytest.mark.parametrize("case", sorted(SCOPES))
@pytest.mark.parametrize("amp", [False, True])
def test_transformer_scopes_match_the_plain_run_bit_for_bit(case, amp):
    arch = dict(ARCH, use_amp=amp)
    arrays = _startup_arrays(jt, arch)
    plain = _port_run(arrays, {}, _feed(), arch=arch)
    scoped = _port_run(arrays, SCOPES[case], _feed(), arch=arch)
    _assert_bits(scoped[0], plain[0])
    _assert_bits(scoped[1], plain[1])
    assert set(scoped[2]) == set(plain[2])
    _assert_bits([scoped[2][n] for n in sorted(plain[2])],
                 [plain[2][n] for n in sorted(plain[2])])


def test_transformer_recompute_matches_the_reference():
    arch = dict(ARCH, recompute=True)
    arrays = _startup_arrays(jt, arch)
    got = _port_run(arrays, {}, _feed(), arch=arch)
    jm, _, jout = build(jf, lambda f: jt.build_model(**arch))
    scope = scope_of(jf, arrays, jm)
    exe = jf.Executor(jf.CPUPlace())
    grads = [f"{p.name}@GRAD" for p in jm.all_parameters()]
    want_losses, want_g = [], None
    for step in range(3):
        res = exe.run(jm, feed=_feed(), fetch_list=[jout["loss"]] + grads,
                      scope=scope)
        want_losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        if step == 0:
            want_g = [np.asarray(g) for g in res[1:]]
    np.testing.assert_allclose([float(x.reshape(-1)[0]) for x in got[0]],
                               want_losses, rtol=0, atol=1e-5)
    for g, w in zip(got[1], want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30))
    bound = 4 * sum(_noam(t) for t in range(1, 4)) + 1e-6
    for p in jm.all_parameters():
        np.testing.assert_allclose(got[2][p.name].numpy(),
                                   np.asarray(scope.find_var(p.name)),
                                   rtol=0, atol=bound, err_msg=p.name)


def _bert_feed():
    feed = tb.make_fake_batch(4, 16, 100, 4, seed=2)
    feed["seq_len"] = np.array([16, 9, 1, 5], np.int32)
    return feed


def test_bert_pipeline_serializes_and_trains_as_the_plain_build():
    kw = dict(BERT_ARCH, pipeline=True)
    jm, js, _ = build(jf, lambda f: jb.build_model(**kw))
    tm, ts, _ = build(tf, lambda f: tb.build_model(**kw))
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    arrays = _startup_arrays(jb, BERT_ARCH)
    plain = _port_run(arrays, {}, _bert_feed(), model=tb, arch=BERT_ARCH)
    piped = _port_run(arrays, dict(pipeline=True), _bert_feed(), model=tb,
                      arch=BERT_ARCH)
    _assert_bits(piped[0], plain[0])
    _assert_bits(piped[1], plain[1])


def _mlp(fluid, recompute=True, dropout=0.0):
    """x (B, 5) -> fc 13 relu -> [dropout] -> fc 7 inside a recompute
    scope, then mean(square(.)) outside it."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[5], dtype="float32")
    scope = fluid.recompute_scope() if recompute else nullcontext()
    with scope:
        h = layers.fc(x, size=13, act="relu")
        if dropout:
            h = layers.dropout(h, dropout_prob=dropout)
        o = layers.fc(h, size=7)
    loss = layers.mean(layers.square(o))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss


def _mlp_runs(dropout, steps=2):
    """(plain, recompute) runs of `_mlp` in the port from one set of
    startup values: each (losses, gradients of every step)."""
    arrays = None
    runs = []
    for rc in (False, True):
        main, startup, loss = build(
            tf, lambda f: _mlp(f, recompute=rc, dropout=dropout), seed=5)
        if arrays is None:
            scope = tf.Scope()
            tf.Executor(tf.CPUPlace()).run(startup, scope=scope)
            arrays = {n: v.numpy() for n, v in scope.vars.items()
                      if isinstance(v, torch.Tensor)}
        scope = scope_of(tf, arrays, main)
        exe = tf.Executor(tf.CPUPlace())
        grads = [f"{p.name}@GRAD" for p in main.all_parameters()]
        feed = {"x": np.random.RandomState(1).rand(6, 5).astype(np.float32)}
        out = [exe.run(main, feed=feed, fetch_list=[loss] + grads,
                       scope=scope, return_numpy=False)
               for _ in range(steps)]
        runs.append([t for step in out for t in step])
    return runs


def test_dropout_masks_repeat_inside_a_segment(monkeypatch):
    calls = []
    impl = _REGISTRY["dropout"]

    def counted(ctx, ins, attrs):
        if ctx.device.type != "meta":      # not shape inference
            calls.append(ctx.op_index)
        return impl(ctx, ins, attrs)

    monkeypatch.setitem(_REGISTRY, "dropout", counted)
    plain, recomputed = _mlp_runs(dropout=0.5)
    # the plain run calls dropout once a step, the recompute run twice
    # (its forward and the backward's recompute), under one op index
    assert len(calls) == 2 + 4 and len(set(calls)) == 1
    _assert_bits(recomputed, plain)
    # and the mask is a real one
    assert 0 < float((plain[1] == 0).float().mean()) < 1


def test_a_segment_saves_only_its_inputs():
    packed = {}
    for rc in (False, True):
        main, startup, loss = build(tf, lambda f: _mlp(f, recompute=rc))
        scope = tf.Scope()
        exe = tf.Executor(tf.CPUPlace())
        exe.run(startup, scope=scope)
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        feed = {"x": np.ones((6, 5), np.float32)}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        packed[rc] = shapes
    # the plain forward saves the hidden activation (B, 13); under
    # recompute the checkpoint packs the segment's inputs (x, both
    # weights and biases) and nothing it computes; square, after the
    # segment, saves its input (B, 7)
    assert (6, 13) in packed[False]
    assert sorted(packed[True]) == sorted(
        [(6, 5), (5, 13), (13,), (13, 7), (7,), (6, 7)])
    # only the names read after the segment leave it
    main, startup, loss = build(tf, _mlp)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    env = {v.name: scope.find_var(v.name) for v in main.list_vars()
           if v.persistable and scope.find_var(v.name) is not None}
    env["x"] = torch.ones(6, 5)
    out = tex.interpret_program(main, env, (0, 1), fetch_names=[loss.name],
                                device="cpu")
    relu_out = [op.desc.output_names()[0] for op in main.global_block().ops
                if op.type == "relu"][0]
    assert relu_out not in out and loss.name in out


def test_a_one_op_run_is_not_checkpointed(monkeypatch):
    import torch.utils.checkpoint as tuc

    n = []
    real = tuc.checkpoint

    def counted(*a, **kw):
        n.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tuc, "checkpoint", counted)

    def one(fluid):
        layers = fluid.layers
        x = layers.data(name="x", shape=[5], dtype="float32")
        h = layers.fc(x, size=4, bias_attr=False)
        with fluid.recompute_scope():
            h = layers.scale(h, scale=2.0)
        loss = layers.mean(h)
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        return loss

    for body, want in ((one, 0), (_mlp, 1)):
        main, startup, loss = build(tf, body)
        scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
        exe.run(startup, scope=scope)
        n.clear()
        exe.run(main, feed={"x": np.ones((2, 5), np.float32)},
                fetch_list=[loss], scope=scope)
        assert len(n) == want


def _sparse(fluid):
    layers = fluid.layers
    ids = layers.data("ids", shape=[3], dtype="int64")
    with fluid.recompute_scope():
        emb = layers.embedding(ids, size=[20, 4], is_sparse=True)
        h = layers.fc(emb, size=4, num_flatten_dims=2, act="tanh")
    loss = layers.reduce_mean(layers.square(h))
    fluid.optimizer.AdagradOptimizer(learning_rate=0.5).minimize(loss)
    return loss


def test_sparse_lookup_inside_a_segment_matches_the_reference(monkeypatch):
    from paddle_tpu_torch.core.selected_rows import SparseGrad

    seen = []
    real = tex._update

    def spy(program, env, seed, device, rest_ops, k, loss, grads, *a, **kw):
        seen.extend(type(g) for g in grads.values())
        return real(program, env, seed, device, rest_ops, k, loss, grads,
                    *a, **kw)

    monkeypatch.setattr(tex, "_update", spy)
    feed = {"ids": np.random.RandomState(5).randint(0, 20, (4, 3))
            .astype(np.int64)}
    got = {}
    for side, (main, scope, exe, loss) in twins(_sparse).items():
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        got[side] = persistables(main, scope)
    assert SparseGrad in seen
    for n, v in got["ref"].items():
        np.testing.assert_allclose(got["port"][n], v, rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def test_numerics_bitmap_crosses_a_segment():
    def body(fluid):
        layers = fluid.layers
        x = layers.data(name="x", shape=[5], dtype="float32")
        with fluid.recompute_scope():
            h = layers.fc(x, size=6, act="relu")
            h = layers.sqrt(layers.scale(h, scale=1.0, bias=-1.0))
            o = layers.fc(h, size=3)
        loss = layers.mean(layers.square(o))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        return loss

    feed = {"x": np.random.RandomState(2).rand(4, 5).astype(np.float32)}
    fno = {}
    for side, (main, scope, exe, loss) in twins(
            body, prepare=lambda fl, m: {"ref": jobs, "port": tobs}[
                "ref" if fl is jf else "port"].enable_numerics(m)).items():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        fno[side] = {"ref": jobs, "port": tobs}[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
    assert fno["port"] is not None and fno["port"] == fno["ref"]
    ops = twins(body)["port"][0].global_block().ops
    assert "__recompute__" in ops[fno["port"]["op_index"]].desc.attrs


def test_a_recompute_step_leaves_no_tensor_in_a_reference_cycle():
    """Every tensor of a step is freed by reference counting: nothing of
    a segment's recompute waits for the garbage collector (an early-
    stopped recompute ends in an exception whose traceback would hold
    the recomputed tensors in a cycle)."""
    import gc

    main, startup, out = build(
        tf, lambda f: tt.build_model(**dict(ARCH, recompute=True,
                                            dropout=0.1)))
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[out["loss"]], scope=scope)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        exe.run(main, feed=_feed(), fetch_list=[out["loss"]], scope=scope)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not leaked, [tuple(t.shape) for t in leaked[:8]]
