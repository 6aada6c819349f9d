"""bf16 mixed precision (paddle_tpu_torch/amp.py) on the CPU: the port
against the JAX package (paddle_tpu/amp.py).

- The policy: the white and black lists are the reference's, overlapping
  lists raise, `decorate(...).minimize` marks the program (and bumps its
  version) in both packages, `to_dict`/`from_dict` round-trip the
  "amp" field with the reference's JSON, `cast_ins_for_op` casts only
  float32 into white ops and bf16 into black ops, white ops return bf16
  (as tests/test_amp.py checks in the reference) while parameters stay
  float32, and dynamic loss scaling raises naming its ROADMAP step.
- Three AMP training steps of tiny BERT (use_flash) and of the cut
  ResNet (cifar10, depth 8, as tests/test_torch_vision.py cuts it) in
  both packages (tests/torch_amp_parity.py runs them): the same
  `Program.to_dict()`, "amp" included; the same set of (op type, input
  dtypes after the cast) on both sides; the losses, step-1 gradients and
  parameters against the reference's, with each tolerance below.
  The Transformer's cases are in tests/test_torch_amp_transformer.py.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import amp as jamp
from paddle_tpu.models import bert as jb
from paddle_tpu.models import resnet as jres
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.models import resnet as tres

from torch_amp_parity import (build, check_amp_parity, check_state,
                              l2_distance, program_json, three_runs)

torch.set_num_threads(2)


def _mlp(fluid, use_amp=True, lists=None):
    """fc -> relu -> fc -> softmax CE, SGD, optionally under AMP."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        if use_amp:
            opt = fluid.amp.decorate(opt, amp_lists=lists)
        version = main._version
        opt.minimize(loss)
    return main, startup, loss, h, version


def test_the_lists_are_the_references():
    assert tamp.DEFAULT_WHITE == jamp.DEFAULT_WHITE
    assert tamp.DEFAULT_BLACK == jamp.DEFAULT_BLACK
    lists = tamp.AutoMixedPrecisionLists(custom_white_list=["gelu"],
                                         custom_black_list=["tanh"])
    assert "gelu" in lists.white_list and "tanh" in lists.black_list


@pytest.mark.parametrize("mod", [jamp, tamp])
def test_overlapping_lists_raise(mod):
    with pytest.raises(ValueError, match="both white and black"):
        mod.AutoMixedPrecisionLists(custom_black_list=["mul"])


def test_decorate_marks_the_program_in_both_packages():
    progs = {}
    for fluid in (jf, tf):
        main, _, _, _, version = _mlp(fluid)
        assert main._amp_lists is not None and main._version > version
        assert "mul" in main._amp_lists.white_list
        assert "softmax_with_cross_entropy" in main._amp_lists.black_list
        progs[fluid] = main
    assert program_json(progs[tf]) == program_json(progs[jf])
    assert progs[tf].to_dict()["amp"] == {
        "white": sorted(jamp.DEFAULT_WHITE),
        "black": sorted(jamp.DEFAULT_BLACK)}
    # the wrapped optimizer's other attributes are the optimizer's own
    opt = tf.amp.decorate(tf.optimizer.SGD(learning_rate=0.5))
    assert opt._learning_rate == 0.5


def test_to_dict_round_trips_amp_as_the_reference():
    lists = {fluid: fluid.amp.AutoMixedPrecisionLists(
        custom_white_list=["gelu"]) for fluid in (jf, tf)}
    jm = _mlp(jf, lists=lists[jf])[0]
    tm = _mlp(tf, lists=lists[tf])[0]
    d = tm.to_dict()
    assert "gelu" in d["amp"]["white"]
    back = tf.Program.from_dict(json.loads(json.dumps(d)))
    assert back._amp_lists.white_list == lists[tf].white_list
    assert back._amp_lists.black_list == lists[tf].black_list
    assert program_json(back) == program_json(tm)
    ref_back = jf.Program.from_dict(json.loads(program_json(tm)))
    assert program_json(ref_back) == program_json(jm) == program_json(back)
    plain = tf.Program.from_dict(_mlp(tf, use_amp=False)[0].to_dict())
    assert plain._amp_lists is None


def test_dynamic_loss_scaling_raises_naming_its_roadmap_item():
    """Dynamic loss scaling is ported now (ROADMAP A step 6b): where
    `decorate(use_dynamic_loss_scaling=True)` raised naming its step, it
    builds the reference's LossScaleConfig, and `minimize` enables the
    update guard with it, as paddle_tpu/amp.py:60-118 does."""
    opts = {fluid: fluid.amp.decorate(
        fluid.optimizer.SGD(0.1), use_dynamic_loss_scaling=True,
        init_loss_scaling=8.0, incr_every_n_steps=3) for fluid in (jf, tf)}
    for fluid, opt in opts.items():
        cfg = opt._loss_scaling
        assert (cfg.init_loss_scaling, cfg.incr_every_n_steps,
                cfg.decr_every_n_nan_or_inf, cfg.incr_ratio,
                cfg.decr_ratio) == (8.0, 3, 1, 2.0, 0.5)
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
            opt.minimize(loss)
        assert main._update_guard.loss_scaling is cfg
        assert main._telemetry_enabled and main._amp_lists is not None
    assert tf.amp.decorate(tf.optimizer.SGD(0.1))._loss_scaling is None


def test_cast_ins_for_op_casts_only_what_the_lists_name():
    lists = tamp.AutoMixedPrecisionLists()
    f32, bf16 = torch.ones(2), torch.ones(2, dtype=torch.bfloat16)
    ids = torch.ones(2, dtype=torch.int64)
    got = tamp.cast_ins_for_op("mul", {"X": [f32], "Y": [bf16, ids]},
                               lists)
    assert [v.dtype for v in got["X"] + got["Y"]] == \
        [torch.bfloat16, torch.bfloat16, torch.int64]
    got = tamp.cast_ins_for_op("softmax", {"X": [bf16, f32]}, lists)
    assert [v.dtype for v in got["X"]] == [torch.float32, torch.float32]
    ins = {"X": [bf16, f32]}
    assert tamp.cast_ins_for_op("relu", ins, lists) is ins


def test_white_ops_return_bf16_and_parameters_stay_float32():
    """The reference's tests/test_amp.py checks, in the port: the fc's
    mul returns bf16 (its bias add then promotes to float32, as jnp
    does), one SGD step leaves every parameter float32, and a bf16
    fetch comes back as float32 numpy (numpy has no bf16)."""
    main, startup, loss, h, _ = _mlp(tf)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(8, 16).astype(np.float32),
            "y": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    mul_out = [op.output("Out")[0] for op in main.global_block().ops
               if op.type == "mul"][0]
    got = exe.run(main, feed=feed, fetch_list=[loss, mul_out, h],
                  scope=scope, return_numpy=False)
    assert got[1].dtype == torch.bfloat16
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    assert exe.run(main, feed=feed, fetch_list=[mul_out],
                   scope=scope)[0].dtype == np.float32
    for p in main.all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name


# -- three AMP steps against the reference -----------------------------

BERT = dict(vocab_size=100, max_len=16, n_layer=2, n_head=2, d_model=32,
            d_inner=64, max_predictions=4, dropout=0.0, use_flash=True)


def _bert_batch():
    feed = tb.make_fake_batch(4, BERT["max_len"], BERT["vocab_size"],
                              BERT["max_predictions"], seed=2)
    feed["seq_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["mask_weight"][1, 2:] = 0.0
    return feed


def _lr_var(program):
    return [op for op in program.global_block().ops
            if op.type == "lr_schedule"][-1].output("Out")[0]


def _bf16_flash_seen(logs):
    """The flash op received Q, K, V and the key bias all in bf16."""
    sigs = [sig for op, sig in logs["port"] if op == "flash_attention"]
    assert sigs and all(dt == ("bfloat16",) for sig in sigs
                        for slot, dt in sig if slot in "QKV" or
                        slot == "Bias"), sigs


def test_bert_amp_trains_like_the_reference(monkeypatch):
    """Tiny BERT (use_flash) under AMP, three Adam steps.  Step 1: the
    loss and the gradients each within a quarter of the reference's own
    AMP-vs-float32 difference (measured: loss 0, gradients 0.04 of it).
    Losses of steps 2 and 3 within 1e-5 (measured 5e-7) and each within
    a quarter of AMP's effect on it; the three steps' parameter updates
    within a quarter of AMP's effect on them (measured 0.09), and every
    parameter within 4 * sum(lr) of the reference's AMP run (Adam turns
    a gradient of rounding noise into a step of about +-lr, as in
    tests/test_torch_bert.py)."""
    def make(fluid, mod):
        return lambda amp: build(fluid, mod.build_model, **BERT,
                                 use_amp=amp)

    jm = make(jf, jb)(True)[0]
    lr = _lr_var(jm)
    runs, arrays, progs, logs = three_runs(
        monkeypatch, make(jf, jb), make(tf, tb), _bert_batch(),
        lr_var=lr)
    assert program_json(progs["port_amp"]) == program_json(jm)
    assert logs["port"] == logs["ref"]
    _bf16_flash_seen(logs)
    check_amp_parity(runs, arrays)
    lf, la, lp = (runs[s][0] for s in ("ref_f32", "ref_amp", "port_amp"))
    np.testing.assert_allclose(lp, la, rtol=0, atol=1e-5)
    assert (np.abs(lp - la) <= 0.25 * np.abs(la - lf)).all(), (lp, la, lf)
    state = {s: {p: np.asarray(t, np.float32) for p, t in
                 runs[s][2].items()} for s in runs}
    assert l2_distance(state["port_amp"], state["ref_amp"]) <= \
        0.25 * l2_distance(state["ref_amp"], state["ref_f32"])
    check_state(runs, arrays, 4 * sum(runs["ref_amp"][3]) + 1e-7)


def _cifar8(fluid, mod, amp):
    """The cut ResNet of tests/test_torch_vision.py (cifar10, depth 8,
    momentum with Nesterov), its optimizer decorated for AMP."""
    def net():
        layers = fluid.layers
        x = layers.data("data", shape=[3, 32, 32])
        label = layers.data("label", shape=[1], dtype="int64")
        predict = mod.resnet_cifar10(x, 10, depth=8)
        loss = layers.mean(layers.cross_entropy(predict, label))
        opt = fluid.optimizer.MomentumOptimizer(0.01, 0.9,
                                                use_nesterov=True)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
        return {"loss": loss}
    return build(fluid, net, pallas=False)


def test_resnet_amp_trains_like_the_reference(monkeypatch):
    """The cut ResNet under AMP, three momentum steps: conv2d and mul
    take bf16, batch_norm's Y, relu, pool2d and the residual adds carry
    bf16, the statistics, the loss and the update stay float32.

    The quarter rule holds at the first residual block's output
    (measured: 0.10 of the reference's AMP-vs-float32 difference there),
    but not at the loss: every bf16 rounding whose float32 argument the
    two packages compute in another summation order (a batch norm's
    E[x^2] - mean^2) can land one bf16 ulp apart (26 of 131072 values
    after the first batch norm), and eight batch norms grow those flips
    layer by layer until, at the loss, the two packages are as far apart
    as AMP is from float32 (ratios 0.02, 0.10, 0.20, 0.36, 0.43 after
    successive blocks; 0.7 to 1.5 at the loss and gradients; the
    reference's own jit and eager runs part by 0.3).  So past the first
    block both are held to bf16 tolerances: losses within 3e-3 (measured
    2.2e-3 at step 3), step-1 gradients within 0.1 relative L2 of the
    reference's (measured 0.044; AMP against float32 is 0.108), and the
    three steps' parameter updates within 0.1 relative L2 of the
    reference's (measured 0.048; AMP against float32 is 0.074)."""
    block = "elementwise_add_0.tmp_1"
    runs, arrays, progs, logs = three_runs(
        monkeypatch, lambda amp: _cifar8(jf, jres, amp),
        lambda amp: _cifar8(tf, tres, amp),
        _resnet_batch(), extra=(block,))
    assert program_json(progs["port_amp"]) == program_json(
        progs["ref_amp"])
    assert logs["port"] == logs["ref"]
    bf16_ops = {op for op, sig in logs["port"] if "bfloat16" in str(sig)}
    assert bf16_ops == {"conv2d", "batch_norm", "relu", "pool2d",
                        "elementwise_add", "mul"}
    out = {s: runs[s][1][block].astype(np.float64) for s in runs}
    assert np.linalg.norm(out["port_amp"] - out["ref_amp"]) <= \
        0.25 * np.linalg.norm(out["ref_amp"] - out["ref_f32"])
    np.testing.assert_allclose(runs["port_amp"][0], runs["ref_amp"][0],
                               rtol=0, atol=3e-3)
    params = list(runs["port_amp"][2])
    grads = {s: {p: runs[s][1][p] for p in params} for s in runs}
    norm = l2_distance(grads["ref_amp"], {p: 0 * g for p, g in
                                          grads["ref_amp"].items()})
    assert l2_distance(grads["port_amp"], grads["ref_amp"]) <= 0.1 * norm
    update = {s: {p: np.asarray(runs[s][2][p], np.float32) - arrays[p]
                  for p in params} for s in runs}
    assert l2_distance(update["port_amp"], update["ref_amp"]) <= \
        0.1 * l2_distance(update["ref_amp"], {p: 0 * u for p, u in
                                              update["ref_amp"].items()})
    check_state(runs, arrays, np.inf)


def _resnet_batch():
    rng = np.random.RandomState(0)
    return {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
