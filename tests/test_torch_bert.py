"""BERT-base pretraining (MLM + NSP) end to end on the CPU: the port
against the JAX package.

A tiny BERT (2 layers, d_model 32, 2 heads, d_inner 64, vocab 100,
max_len 16, 4 masked positions, batch 4, ragged lengths of at least 1,
dropout 0) with `use_flash` False, True, and True with `head_major`:

- the main and the startup program have the same `Program.to_dict()` in
  both packages;
- from the reference's startup scope, carried across with
  `convert.params_from_arrays(..., program=main)`, three Adam steps give
  the same losses (total, MLM and NSP, 1e-5), step-1 gradients (1e-4 of
  each gradient's max |g|), Adam moments after step 3 (1e-4 of max) and
  parameters after step 3 (within 4 * sum(lr)): the tolerances of
  tests/test_torch_training.py, for the same reasons.  The learning
  rate (linear warmup over polynomial decay) is first held equal at
  each step.

The reference's flash op takes its XLA route on the CPU, the port's its
kernels' plain versions.  Row 2 of the batch has length 1 and row 3
length 5, so the flash path starts on padded keys.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import bert as jb
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models import bert as tb

torch.set_num_threads(2)

# build_model's learning rate (1e-4, warmup 10000): steps 1-3 warm up
ARCH = dict(vocab_size=100, max_len=16, n_layer=2, n_head=2, d_model=32,
            d_inner=64, max_predictions=4, dropout=0.0)
CASES = {"composed": dict(use_flash=False),
         "flash": dict(use_flash=True),
         "flash head_major": dict(use_flash=True, head_major=True)}


def _build(fluid, build_fn, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build_fn(**kw)
    return main, startup, out


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _batch():
    feed = tb.make_fake_batch(4, ARCH["max_len"], ARCH["vocab_size"],
                              ARCH["max_predictions"], seed=2)
    feed["seq_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["mask_weight"][1, 2:] = 0.0
    return feed


def _lr_var(program):
    ops = [op for op in program.global_block().ops
           if op.type == "lr_schedule"]
    return ops[-1].output("Out")[0]


def test_the_reference_batch_maker_is_the_ports():
    want = jb.make_fake_batch(3, 16, 100, 4, seed=5)
    got = tb.make_fake_batch(3, 16, 100, 4, seed=5)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].dtype == want[n].dtype


@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_trains_like_the_reference(case):
    kw = dict(ARCH, **CASES[case])
    jm, js, jmod = _build(jf, jb.build_model, **kw)
    tm, ts, tmod = _build(tf, tb.build_model, **kw)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("flash_attention") == (2 if kw["use_flash"] else 0)
    assert {"gelu", "range", "slice", "backward_marker", "adam"} \
        <= set(types)
    assert "truncated_gaussian_random" in \
        [op.type for op in ts.global_block().ops]

    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(v) for n, v in jscope.vars.items()
              if v is not None}
    tscope = tf.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=tm).items():
        tscope.set_var(n, t)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    params = [p.name for p in jm.all_parameters()]
    lr = _lr_var(jm)
    assert lr == _lr_var(tm)
    fetch = [jmod[k].name for k in ("loss", "mlm_loss", "nsp_loss")] \
        + [lr] + [f"{p}@GRAD" for p in params]
    feed = _batch()
    lrs = []
    for step in range(3):
        jo = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        to = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        for name, a, b in zip(("loss", "mlm", "nsp"), to[:3], jo[:3]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step + 1} {name}")
        np.testing.assert_allclose(to[3], jo[3], rtol=1e-6, atol=0)
        lrs.append(float(np.asarray(jo[3]).reshape(-1)[0]))
        if step == 0:
            for name, a, b in zip(params, to[4:], jo[4:]):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                    err_msg=f"{name}@GRAD")
    assert 0 < lrs[0] < lrs[1] < lrs[2]                   # warming up
    bound = 4 * sum(lrs) + 1e-7
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
    moved = max(float(np.abs(tscope.find_var(p).numpy() - arrays[p]).max())
                for p in params)
    assert moved > lrs[0] / 2


def test_the_learning_rate_schedule_matches_past_its_warmup():
    """linear_lr_warmup over polynomial_decay, warmup 2: steps 1-4 run
    both branches, and each step's rate is the reference's."""
    kw = dict(ARCH, learning_rate=1e-3, warmup_steps=2)
    lrs = []
    for fluid, mod in ((jf, jb), (tf, tb)):
        main, startup, _ = _build(fluid, mod.build_model, **kw)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        lrs.append([float(np.asarray(exe.run(
            main, feed=_batch(), fetch_list=[_lr_var(main)],
            scope=scope)[0]).reshape(-1)[0]) for _ in range(4)])
    np.testing.assert_allclose(lrs[1], lrs[0], rtol=1e-6, atol=0)
    assert lrs[0][0] < lrs[0][1] and lrs[0][2] > lrs[0][3]


@pytest.mark.parametrize("head_major", [False, True])
def test_the_flash_path_matches_the_composed_one(head_major):
    """In the port alone: the flash op (its plain versions) and the
    composed matmul + softmax attention give the same losses from the
    same weights, on a batch with padded rows."""
    losses = []
    arrays = None
    for use_flash in (False, True):
        kw = dict(ARCH, use_flash=use_flash,
                  head_major=head_major and use_flash)
        tm, ts, tmod = _build(tf, tb.build_model, **kw)
        scope = tf.Scope()
        exe = tf.Executor(tf.CPUPlace())
        if arrays is None:
            exe.run(ts, scope=scope)
            arrays = {n: v.numpy() for n, v in scope.vars.items()
                      if isinstance(v, torch.Tensor)}
        else:
            for n, t in params_from_arrays(arrays, "cpu").items():
                scope.set_var(n, t)
        losses.append(exe.run(tm, feed=_batch(), fetch_list=[tmod["loss"]],
                              scope=scope)[0])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-5)


def test_the_startup_draws_truncated_normal_weights():
    tm, ts, _ = _build(tf, tb.build_model, **ARCH)
    scope = tf.Scope()
    tf.Executor(tf.CPUPlace()).run(ts, scope=scope)
    w = scope.find_var("word_embedding").numpy()
    assert w.shape == (ARCH["vocab_size"], ARCH["d_model"])
    assert np.abs(w).max() <= 2 * 0.02 and w.std() == pytest.approx(
        0.02 * 0.8796, rel=0.1)


@pytest.mark.parametrize("kw", [dict(pipeline=True)])
def test_unported_bert_options_raise(kw):
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        _build(tf, tb.build_model, **dict(ARCH, **kw))
