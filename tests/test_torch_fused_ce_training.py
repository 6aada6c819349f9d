"""The fused-CE training slice on the CPU: the Transformer with
`use_fused_ce=True` in the port against the JAX package.

- The tiny Transformer of tests/test_torch_training.py (2 layers,
  d_model 32, 2 heads, vocab 100, T=16, batch 4, ragged lengths,
  dropout 0, use_flash=True) with `use_fused_ce=True`, with
  `flash_cross` False and True, builds the same `Program.to_dict()` in
  both packages, main and startup; from the reference's startup scope
  three Adam steps give the same losses, step-1 gradients, moments and
  parameters, at the tolerances of
  test_transformer_trains_like_the_reference (the reference runs its
  fused op on the Pallas kernels, interpreted).
- The training step's forward is pruned to what the loss, the fetches,
  the update ops and persistable state need: the fused program's
  `logits` matmul runs only when `logits` is fetched, and then equals
  the reference's; pruning the unfused program (dropout 0.1) changes no
  bit of its losses or parameters, since each op keeps its program
  index and so its random stream.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import kernels

from test_torch_training import (ARCH, _batch, _build, _json, _noam,
                                 _port_scope, _reference_scope)

torch.set_num_threads(2)

FUSED = dict(ARCH, use_fused_ce=True)


@pytest.mark.parametrize("flash_cross", [False, True])
def test_fused_ce_programs_equal_the_reference(flash_cross):
    kw = dict(FUSED, flash_cross=flash_cross)
    jm, js, _ = _build(jf, jt.build_model, **kw)
    tm, ts, _ = _build(tf, tt.build_model, **kw)
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("fused_vocab_softmax_ce") == 1
    assert "softmax_with_cross_entropy" not in types
    assert types.count("flash_attention") == (6 if flash_cross else 4)
    names = {p.name for p in tm.all_parameters()}
    assert any(n.startswith("vocab_proj") for n in names)


@pytest.mark.parametrize("flash_cross", [False, True])
def test_fused_ce_transformer_trains_like_the_reference(flash_cross):
    kw = dict(FUSED, flash_cross=flash_cross)
    jm, js, jmod = _build(jf, jt.build_model, **kw)
    tm, ts, tmod = _build(tf, tt.build_model, **kw)
    jscope, arrays = _reference_scope(js)
    tscope = _port_scope(arrays, tm)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    fetch = [jmod["loss"].name] + [f"{p}@GRAD" for p in params]
    feed = _batch()
    kernels.reset_counts()
    for step in range(3):
        jo = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        to = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)
        if step == 0:
            for name, a, b in zip(params, to[1:], jo[1:]):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                    err_msg=f"{name}@GRAD")
    plain = kernels.counts()["plain"]
    assert plain["vocab_ce_fwd"] == plain["vocab_ce_dh"] == 3
    assert plain["vocab_ce_dw"] == 3
    bound = 4 * sum(_noam(t) for t in (1, 2, 3)) + 1e-7
    for v in tm.global_block().vars.values():
        if not v.persistable:
            continue
        a = tscope.find_var(v.name).numpy()
        b = np.asarray(jscope.find_var(v.name))
        if v.name in params:
            assert np.abs(a - b).max() <= bound, v.name
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                err_msg=v.name)
    assert not [n for n, t in tscope.vars.items()
                if isinstance(t, torch.Tensor)
                and (t.requires_grad or t.grad_fn is not None)]


def test_fused_step_computes_logits_only_when_fetched(monkeypatch):
    jm, js, jmod = _build(jf, jt.build_model, **FUSED)
    tm, ts, tmod = _build(tf, tt.build_model, **FUSED)
    _, arrays = _reference_scope(js)
    logits = tmod["logits"].name
    ran = []
    real = texec._run_one_op

    def spy(op, *a, **k):
        ran.extend(op.desc.output_names())
        return real(op, *a, **k)

    monkeypatch.setattr(texec, "_run_one_op", spy)
    exe = tf.Executor(tf.CPUPlace())
    loss = tmod["loss"].name
    exe.run(tm, feed=_batch(), fetch_list=[loss],
            scope=_port_scope(arrays, tm))
    fused = [op.desc.output_names()[0] for op in tm.global_block().ops
             if op.type == "fused_vocab_softmax_ce"]
    assert logits not in ran and fused[0] in ran
    ran.clear()
    got = exe.run(tm, feed=_batch(), fetch_list=[loss, logits],
                  scope=_port_scope(arrays, tm))
    assert ran.count(logits) == 1
    jscope, _ = _reference_scope(js)
    want = jf.Executor(jf.CPUPlace()).run(
        jm, feed=_batch(), fetch_list=[jmod["loss"].name,
                                       jmod["logits"].name], scope=jscope)
    assert got[1].shape == (4, 16, 100)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def test_pruning_leaves_the_unfused_step_unchanged(monkeypatch):
    tm, ts, tmod = _build(tf, tt.build_model, **dict(ARCH, dropout=0.1))
    _, arrays = _reference_scope(_build(jf, jt.build_model,
                                        **dict(ARCH, dropout=0.1))[1])
    params = [p.name for p in tm.all_parameters()]
    k = tm._backward_info["index"]
    live = texec._live_forward(tm, [tmod["loss"].name])
    assert live == sorted(live) and len(live) <= k

    def run(prune):
        if not prune:
            monkeypatch.setattr(texec, "_live_forward",
                                lambda program, fetch: range(k))
        scope = _port_scope(arrays, tm)
        exe = tf.Executor(tf.CPUPlace())
        losses = [exe.run(tm, feed=_batch(), fetch_list=[tmod["loss"]],
                          scope=scope)[0] for _ in range(2)]
        monkeypatch.undo()
        return losses, {p: scope.find_var(p).numpy() for p in params}

    pruned, unpruned = run(True), run(False)
    for a, b in zip(pruned[0], unpruned[0]):
        np.testing.assert_array_equal(a, b)
    for p in params:
        np.testing.assert_array_equal(pruned[1][p], unpruned[1][p],
                                      err_msg=p)
