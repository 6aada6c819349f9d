"""Checkpoint and resume of the AMP fused-CE Transformer on the CPU: the
path chip_smoke.py's phase 6l drives at full width on the card.

The tiny Transformer of tests/test_torch_amp_transformer.py (2 layers,
d_model 32, 2 heads, vocab 100, T = 16, batch 4, ragged lengths) with
`use_fused_ce=True` and `use_amp=True`, under dynamic loss scaling and
the update guard (`resilience.enable_update_guard` with the reference's
default `LossScaleConfig`, what `amp.decorate(...,
use_dynamic_loss_scaling=True).minimize` enables).

- In the port, with dropout 0.1: 2 steps, `io.save_sharded`, a fresh
  scope and executor that run the startup program, `io.load_sharded`,
  the RNG counter and the telemetry accumulator carried across as the
  reference's Trainer carries them (paddle_tpu/contrib/trainer.py:
  327-409, through JSON), then 2 more steps: the losses, every
  persistable and the telemetry equal 4 uninterrupted steps', bit for
  bit.
- Across packages, dropout 0: the reference's checkpoint after 2 steps,
  continued 2 steps in the port, stays within the AMP Transformer
  parity tolerances (tests/test_torch_amp_transformer.py: losses within
  2e-3, parameters within 4 * sum(lr)) of the reference's own
  continuation; the guard's integer counters and the loss scale equal
  the reference's exactly.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core.executor import RNG_STATE_VAR
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import metrics as tmetrics

from torch_amp_parity import build, keep_reference_roundings
from torch_twin import persistables, reference_arrays, scope_of

torch.set_num_threads(2)

ARCH = dict(src_vocab_size=100, trg_vocab_size=100, max_length=16,
            n_layer=2, n_head=2, d_model=32, d_inner_hid=64, dropout=0.0,
            use_flash=True, warmup_steps=100, use_fused_ce=True,
            use_amp=True)


def _batch():
    feed = tt.make_fake_batch(4, 16, 100, 100, seed=1)
    feed["src_len"] = np.array([16, 9, 1, 5], np.int32)
    feed["trg_len"] = np.array([3, 16, 12, 1], np.int32)
    return feed


def _noam(step, d_model=32, warmup=100, scale=2.0):
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _build(fluid, mod, **kw):
    main, startup, out = build(fluid, mod.build_model, **dict(ARCH, **kw))
    main.random_seed = 7
    fluid.resilience.enable_update_guard(
        main, loss_scaling=fluid.resilience.LossScaleConfig())
    return main, startup, out


def carry_train_state(old, new, program, device="cpu"):
    """The RNG counter and the telemetry accumulator from scope `old`
    into scope `new`, through JSON as the reference's Trainer writes
    them (its _capture_train_state / _restore_train_state)."""
    st = {"rng": old.find_var(RNG_STATE_VAR),
          "telemetry": {k: v.cpu().numpy().tolist() for k, v in
                        old.find_var(tmetrics.TELEMETRY_VAR).items()}}
    st = json.loads(json.dumps(st))
    new.set_var(RNG_STATE_VAR, st["rng"])
    fresh = tmetrics.init_telemetry_for(program, device)
    new.set_var(tmetrics.TELEMETRY_VAR, {
        k: torch.tensor(v, dtype=fresh[k].dtype, device=device)
        for k, v in st["telemetry"].items()})


def _steps(exe, main, scope, loss, feed, n):
    return [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            for _ in range(n)]


def _tel(scope):
    return {k: v.numpy() for k, v in
            scope.find_var(tmetrics.TELEMETRY_VAR).items()}


def test_port_resume_is_bit_for_bit(tmp_path):
    feed = _batch()
    main, startup, out = _build(tf, tt, dropout=0.1)
    arrays = reference_arrays(_build(jf, jt, dropout=0.1)[1])
    exe = tf.Executor(tf.CPUPlace())
    whole = scope_of(tf, arrays, main)
    want = _steps(exe, main, whole, out["loss"], feed, 4)

    part = scope_of(tf, arrays, main)
    got = _steps(exe, main, part, out["loss"], feed, 2)
    with tf.scope_guard(part):
        job = tf.io.save_sharded(exe, str(tmp_path), main_program=main)
    assert job.bytes_total > 0
    main2, startup2, out2 = _build(tf, tt, dropout=0.1)
    fresh, exe2 = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe2.run(startup2, scope=fresh)          # loading overwrites it
    with tf.scope_guard(fresh):
        tf.io.load_sharded(exe2, str(tmp_path), main_program=main2)
    saved = persistables(main, part)
    for n, a in persistables(main2, fresh).items():
        np.testing.assert_array_equal(a, saved[n], err_msg=n)
    carry_train_state(part, fresh, main2)
    got += _steps(exe2, main2, fresh, out2["loss"], feed, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    final = persistables(main, whole)
    for n, a in persistables(main2, fresh).items():
        np.testing.assert_array_equal(a, final[n], err_msg=n)
    tw, tr = _tel(whole), _tel(fresh)
    assert set(tw) == set(tr)
    for k in tw:
        np.testing.assert_array_equal(tr[k], tw[k], err_msg=k)
    assert int(tw["steps"]) == 4 and int(tw["skipped_update_steps"]) == 0
    assert float(tw["loss_scale"]) == 2.0 ** 15


def test_reference_checkpoint_continues_in_the_port(tmp_path, monkeypatch):
    keep_reference_roundings(monkeypatch)
    feed = _batch()
    jmain, jstartup, jout = _build(jf, jt)
    jscope, jexe = jf.Scope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    for _ in range(2):
        jexe.run(jmain, feed=feed, fetch_list=[jout["loss"]], scope=jscope)
    with jf.scope_guard(jscope):
        jf.io.save_sharded(jexe, str(tmp_path), main_program=jmain)
    jraw = {k: np.asarray(v).tolist() for k, v in
            jscope.find_var(jf.observe.TELEMETRY_VAR).items()}
    ref = [float(np.asarray(l).reshape(-1)[0]) for l in
           _steps(jexe, jmain, jscope, jout["loss"], feed, 2)]
    ref_tel = jf.observe.fetch_telemetry(jscope)

    main, startup, out = _build(tf, tt)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    with tf.scope_guard(scope):
        tf.io.load_sharded(exe, str(tmp_path), main_program=main)
    # the accumulator as the reference's Trainer carries it (its JSON
    # values into this build's template)
    tel = tmetrics.init_telemetry_for(main, "cpu")
    scope.set_var(tmetrics.TELEMETRY_VAR, {
        k: torch.tensor(jraw[k], dtype=v.dtype) for k, v in tel.items()})
    got = [float(np.asarray(l).reshape(-1)[0]) for l in
           _steps(exe, main, scope, out["loss"], feed, 2)]
    tel = tf.observe.fetch_telemetry(scope)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    assert (tel.steps, tel.skipped_update_steps, tel.nonfinite_grad_steps,
            tel.loss_scale) == (ref_tel.steps, ref_tel.skipped_update_steps,
                                ref_tel.nonfinite_grad_steps,
                                ref_tel.loss_scale)
    bound = 4 * sum(_noam(t) for t in (3, 4)) + 1e-7
    params = sorted(p.name for p in main.all_parameters())
    for p in params:
        a = scope.find_var(p).numpy()
        b = np.asarray(jscope.find_var(p))
        assert np.max(np.abs(a - b)) <= bound, p
