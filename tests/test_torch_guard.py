"""The in-step update guard and dynamic loss scaling in the port, against
the JAX package: tests/test_resilience.py:73-239, each run in both
packages from the same startup values and batches
(tests/torch_twin.py).

- The guard skips EXACTLY the poisoned step: the guarded run's
  persistables equal a run that never saw that batch (rtol 1e-6, the
  reference test's own), in each package.
- Without the guard one NaN batch corrupts every parameter, in both.
- The guarded step reads nothing back to the host: with
  `Tensor.item`/`__bool__`/`tolist`/`cpu`/`numpy` made to raise, a
  guarded and an unguarded step run the same (the port's counterpart of
  the reference's "no extra dispatch, no callback" check).
- The guard composes with `iterations=`; the loss scale halves on
  overflow and recovers after `incr_every_n_steps` good steps, and a
  telemetry window reset keeps the schedule; loss-scaled AMP updates
  match the unscaled AMP run (rtol 1e-5, the reference test's).

Integer counters and the power-of-two loss scale must equal the
reference's exactly.  Float results are held to the reference's at
rtol 1e-5 (float32 on both sides, other summation orders); the AMP runs
too, with the reference keeping the bf16 roundings its ops specify
(tests/torch_amp_parity.py: without that, XLA folds some away and the
two differ by up to 5e-3 relative after three momentum steps).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import observe as jobs
from paddle_tpu_torch import observe as tobs

from torch_amp_parity import keep_reference_roundings
from torch_twin import (PKGS, batches, linreg, no_host_reads, persistables,
                        twins)

torch.set_num_threads(2)

RTOL = 1e-5
OBS = {"ref": jobs, "port": tobs}


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    jf.resilience.chaos.clear()
    tf.resilience.chaos.clear()


def _run(t, feeds, **kw):
    main, scope, exe, loss = t
    for b in feeds:
        exe.run(main, feed=b, fetch_list=[loss], scope=scope, **kw)
    return persistables(main, scope)


def _close(got, want, rtol, what):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=1e-7,
                                   err_msg=f"{what}: {n}")


def _guarded(fluid, main):
    fluid.resilience.enable_update_guard(main)


def _tel_ints(tel):
    return (tel.steps, tel.skipped_update_steps, tel.nonfinite_grad_steps,
            tel.nonfinite_loss_steps, tel.loss_scale)


def test_guard_skips_exactly_the_poisoned_step():
    b = batches(4)
    clean = {s: _run(t, (b[0], b[1], b[3]))
             for s, t in twins(linreg).items()}
    guarded = twins(linreg, prepare=_guarded)
    got, tel = {}, {}
    for side, t in guarded.items():
        poisoned = PKGS[side].resilience.chaos.poison_feed(b[2], ["x"])
        got[side] = _run(t, (b[0], b[1], poisoned, b[3]))
        tel[side] = OBS[side].fetch_telemetry(t[1])
        assert (tel[side].steps, tel[side].skipped_update_steps,
                tel[side].nonfinite_grad_steps) == (4, 1, 1), side
        for n, a in got[side].items():
            assert np.isfinite(a).all(), (side, n)
        _close(got[side], clean[side], 1e-6, side)
    assert _tel_ints(tel["port"]) == _tel_ints(tel["ref"])
    _close(got["port"], got["ref"], RTOL, "port against reference")


def test_unguarded_program_is_corrupted_by_the_same_poison():
    b = batches(2)
    for side, t in twins(linreg).items():
        poisoned = PKGS[side].resilience.chaos.poison_feed(b[0], ["x"])
        got = _run(t, (poisoned,))
        assert any(not np.isfinite(v).all() for v in got.values()), side


@pytest.mark.parametrize("guard", [False, True])
def test_guard_adds_no_host_reads(guard):
    """The guarded step keeps the loss scale, the finite flag and the
    selects on the device: like the unguarded step, it reads nothing
    back (fetches stay tensors with return_numpy=False)."""
    b = batches(2)
    main, scope, exe, loss = twins(
        lambda f: linreg(f, amp=dict(use_dynamic_loss_scaling=guard)),
        prepare=None)["port"]
    poisoned = tf.resilience.chaos.poison_feed(b[1], ["x"])
    with no_host_reads():
        for feed in (b[0], poisoned):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
    assert tobs.telemetry_enabled(main) == guard
    if guard:
        tel = tobs.fetch_telemetry(scope)
        assert (tel.steps, tel.skipped_update_steps) == (2, 1)


def test_guard_composes_with_chained_iterations():
    b = batches(1)
    got, tel, loss = {}, {}, {}
    for side, (main, scope, exe, lv) in twins(linreg,
                                              prepare=_guarded).items():
        loss[side] = exe.run(main, feed=b[0], fetch_list=[lv],
                             scope=scope, iterations=4)[0]
        tel[side] = OBS[side].fetch_telemetry(scope)
        assert (tel[side].steps, tel[side].skipped_update_steps) == (4, 0)
        got[side] = persistables(main, scope)
    assert _tel_ints(tel["port"]) == _tel_ints(tel["ref"])
    np.testing.assert_allclose(loss["port"], loss["ref"], rtol=RTOL)
    assert tel["port"].loss_last == pytest.approx(tel["ref"].loss_last,
                                                  rel=RTOL)
    _close(got["port"], got["ref"], RTOL, "iterations=4")


def _scaled(init_scale=8.0, incr_every=2):
    return lambda f: linreg(f, opt="sgd", amp=dict(
        use_dynamic_loss_scaling=True, init_loss_scaling=init_scale,
        incr_every_n_steps=incr_every))


def test_loss_scale_halves_on_overflow_and_recovers():
    b = batches(3)
    seen = {}
    for side, (main, scope, exe, loss) in twins(_scaled()).items():
        poisoned = PKGS[side].resilience.chaos.poison_feed(b[0], ["x"])
        exe.run(main, feed=poisoned, fetch_list=[loss], scope=scope)
        first = OBS[side].fetch_telemetry(scope, reset=False)
        assert first.loss_scale == 4.0          # halved on overflow
        assert first.skipped_update_steps == 1
        scales = []
        for feed in b[1:]:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            scales.append(OBS[side].fetch_telemetry(
                scope, reset=False).loss_scale)
        last = OBS[side].fetch_telemetry(scope)
        assert scales == [4.0, 8.0]             # doubled after 2 good
        assert last.skipped_update_steps == 1
        seen[side] = (_tel_ints(first), scales, _tel_ints(last))
    assert seen["port"] == seen["ref"]


def test_loss_scaled_updates_match_unscaled_amp_run(monkeypatch):
    """The scale is a power of two (an exact exponent shift) and the
    gradients are unscaled before the optimizer, so an AMP run WITH
    dynamic scaling matches the same AMP run WITHOUT it.  The reference
    keeps the roundings its bf16 ops specify
    (torch_amp_parity.keep_reference_roundings)."""
    keep_reference_roundings(monkeypatch)
    b = batches(3, seed=11)
    runs = {}
    for scaling in (False, True):
        body = (lambda s: lambda f: linreg(f, amp=dict(
            use_dynamic_loss_scaling=s, init_loss_scaling=1024.0)))(scaling)
        for side, t in twins(body).items():
            runs[side, scaling] = _run(t, b)
    for side in PKGS:
        _close(runs[side, True], runs[side, False], 1e-5, side)
    _close(runs["port", True], runs["ref", True], RTOL,
           "port against reference, scaled")


def test_loss_scale_survives_telemetry_window_reset():
    b = batches(1)
    seen = {}
    for side, (main, scope, exe, loss) in twins(_scaled()).items():
        poisoned = PKGS[side].resilience.chaos.poison_feed(b[0], ["x"])
        exe.run(main, feed=poisoned, fetch_list=[loss], scope=scope)
        assert OBS[side].fetch_telemetry(scope).loss_scale == 4.0
        # the reset above zeroed window counters but kept the schedule
        tel = OBS[side].fetch_telemetry(scope, reset=False)
        assert tel.loss_scale == 4.0
        assert tel.steps == 0
        seen[side] = _tel_ints(tel)
    assert seen["port"] == seen["ref"]
