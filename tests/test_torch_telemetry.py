"""Device-side StepTelemetry and numerics observability in the port,
against the JAX package: tests/test_observe.py:61-108 and
tests/test_observe_numerics.py:65-192 and :266, each run in both
packages from the same startup values and feeds (tests/torch_twin.py).

- Telemetry accumulates across `iterations=` (5 steps from 1 + 4), is
  healthy on clean data, counts a NaN batch as one non-finite loss and
  one non-finite gradient step, and leaves no trace in the scope when
  the program did not opt in.
- Per-group squared gradient and update norms compose to the global
  ones (rel 1e-5, the reference test's), and each group's norms equal
  the reference's (rtol 1e-5: float32, other summation orders).
- The first-nonfinite latch: the first poisoned step of a window wins,
  clean steps never clear it, a later poison of an earlier op does not
  overwrite it, a fetch reset opens a fresh window; the latched op
  index is the reference's, through `iterations=` too.
- A zero-bit latch reads as backward/autodiff.
- Disabled, nothing of it runs: with every telemetry, numerics and
  guard entry point made to raise, a plain step runs; enabled, the
  step reads nothing back to the host.

Integer counters are held equal to the reference's exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu import observe as jobs
from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.observe import numerics as tnum
from paddle_tpu_torch.resilience import guard as tguard

from torch_twin import linreg, no_host_reads, twins

torch.set_num_threads(2)

RTOL = 1e-5
OBS = {"ref": jobs, "port": tobs}


def _feed(rng, n=8, d=4):
    return {"x": rng.rand(n, d).astype(np.float32),
            "y": rng.rand(n, 1).astype(np.float32)}


def _poisoned(feed, name):
    bad = dict(feed)
    bad[name] = feed[name].copy()
    bad[name].reshape(-1)[0] = np.nan
    return bad


def _first_consumer(program, feed_name):
    ops = program.global_block().ops
    return next(i for i, op in enumerate(ops)
                if feed_name in op.desc.input_names())


def _ints(tel):
    return (tel.steps, tel.nonfinite_grad_steps, tel.nonfinite_loss_steps,
            tel.skipped_update_steps)


def _sgd(f):
    return linreg(f, opt="sgd")


def _named(f):
    return linreg(f, opt="sgd", d=8, names=True)


def _telemetry(fluid, main):
    OBS["ref" if fluid.__name__ == "paddle_tpu" else "port"] \
        .enable_telemetry(main)


def _numerics(fluid, main):
    OBS["ref" if fluid.__name__ == "paddle_tpu" else "port"] \
        .enable_numerics(main)


def test_telemetry_accumulates_across_chained_iterations():
    tel, tel2 = {}, {}
    for side, (main, scope, exe, loss) in twins(
            _sgd, prepare=_telemetry).items():
        rng = np.random.RandomState(0)
        feed = _feed(rng)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                iterations=4)
        tel[side] = OBS[side].fetch_telemetry(scope)
        assert tel[side].steps == 5 and tel[side].healthy
        assert tel[side].loss_mean > 0 and tel[side].grad_norm_mean > 0
        assert tel[side].update_norm_mean > 0
        exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
        tel2[side] = OBS[side].fetch_telemetry(scope)
        assert tel2[side].steps == 1       # reset opened a fresh window
    for t in (tel, tel2):
        assert _ints(t["port"]) == _ints(t["ref"])
        for f in ("loss_last", "loss_mean", "grad_norm_last",
                  "grad_norm_mean", "update_norm_last", "update_norm_mean"):
            assert getattr(t["port"], f) == pytest.approx(
                getattr(t["ref"], f), rel=RTOL), f


def test_telemetry_counts_nonfinite_loss_and_grads():
    tel = {}
    for side, (main, scope, exe, loss) in twins(
            _sgd, prepare=_telemetry).items():
        bad = _feed(np.random.RandomState(0))
        bad["x"][0, 0] = np.nan
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
        tel[side] = OBS[side].fetch_telemetry(scope)
        assert _ints(tel[side]) == (1, 1, 1, 0)
        assert not tel[side].healthy
    assert _ints(tel["port"]) == _ints(tel["ref"])


def test_telemetry_off_is_zero_footprint():
    for side, (main, scope, exe, loss) in twins(_sgd).items():
        exe.run(main, feed=_feed(np.random.RandomState(0)),
                fetch_list=[loss], scope=scope)
        assert scope.find_var(OBS[side].TELEMETRY_VAR) is None
        assert OBS[side].fetch_telemetry(scope) is None


def test_group_norms_compose_to_global():
    tel = {}
    for side, (main, scope, exe, loss) in twins(
            _named, prepare=_numerics).items():
        rng = np.random.RandomState(0)
        for _ in range(3):
            exe.run(main, feed=_feed(rng, d=8), fetch_list=[loss],
                    scope=scope)
        t = tel[side] = OBS[side].fetch_telemetry(scope, program=main)
        assert t.steps == 3 and t.healthy
        assert set(t.groups) >= {"attn_qkv", "ffn_in", "ffn_out"}
        gsq = sum(s["grad_norm_last"] ** 2 for s in t.groups.values())
        assert gsq == pytest.approx(t.grad_norm_last ** 2, rel=1e-5)
        usq = sum(s["update_norm_last"] ** 2 for s in t.groups.values())
        assert usq == pytest.approx(t.update_norm_last ** 2, rel=1e-5)
        for name, s in t.groups.items():
            assert s["param_norm"] > 0 and s["update_ratio"] > 0, name
        rep = OBS[side].numerics_report(t)
        assert rep["dead_groups"] == []
        assert rep["worst_update_ratio_group"] in t.groups
        table = OBS[side].format_numerics_table(t)
        assert "attn_qkv" in table and "upd_ratio" in table
    assert set(tel["port"].groups) == set(tel["ref"].groups)
    for g, s in tel["ref"].groups.items():
        for k, v in s.items():
            assert tel["port"].groups[g][k] == pytest.approx(v, rel=RTOL), \
                (g, k)


def test_first_nonfinite_latch_semantics():
    fno, fno2 = {}, {}
    for side, (main, scope, exe, loss) in twins(
            _named, prepare=_numerics).items():
        rng = np.random.RandomState(0)
        op_y = _first_consumer(main, "y")   # late op (loss head)
        op_x = _first_consumer(main, "x")   # op 0 (first fc mul)
        assert op_x < op_y
        feed = _feed(rng, d=8)
        for f in (feed, _poisoned(feed, "y"), feed, _poisoned(feed, "x")):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        fno[side] = OBS[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
        # the FIRST poisoned step (y -> loss head) is latched even
        # though a LATER step poisoned an earlier op (x -> op 0)
        assert fno[side]["op_index"] == op_y, (side, fno[side])
        assert fno[side]["op_type"] == \
            main.global_block().ops[op_y].desc.type
        assert "group" in fno[side]
        exe.run(main, feed=_poisoned(_feed(rng, d=8), "x"),
                fetch_list=[loss], scope=scope)
        fno2[side] = OBS[side].fetch_telemetry(
            scope, program=main).first_nonfinite_op
        assert fno2[side]["op_index"] == op_x
    assert fno["port"] == fno["ref"]
    assert fno2["port"] == fno2["ref"]


def test_numerics_ride_chained_iterations():
    got = {}
    for side, (main, scope, exe, loss) in twins(
            _named, prepare=_numerics).items():
        rng = np.random.RandomState(0)
        feed = _feed(rng, d=8)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                iterations=4)
        tel = OBS[side].fetch_telemetry(scope, program=main)
        assert tel.steps == 5
        assert tel.groups["attn_qkv"]["grad_norm_rms"] > 0
        assert tel.first_nonfinite_op is None
        exe.run(main, feed=_poisoned(_feed(rng, d=8), "y"),
                fetch_list=[loss], scope=scope, iterations=3)
        tel2 = OBS[side].fetch_telemetry(scope, program=main)
        assert tel2.steps == 3
        assert tel2.first_nonfinite_op["op_index"] == \
            _first_consumer(main, "y")
        got[side] = (_ints(tel), _ints(tel2), tel2.first_nonfinite_op)
    assert got["port"] == got["ref"]


def test_group_names_match_the_reference():
    """The group vocabulary and the name rule are the reference's (the
    switch_moe half of the reference test waits for the port's MoE
    layers, ROADMAP A step 8c)."""
    names = ["moe_gate.w_0", "moe_gate_enc3.w_0", "moe_expert_enc3.w_1",
             "attn_qkv_7.b_0", "src_word_emb.w_0", "fc_3.w_0",
             "ffn_in.w_0", "attn_out_2.b_0"]
    assert tobs.GROUP_NAMES == jobs.GROUP_NAMES
    assert [tobs.group_of(n) for n in names] == \
        [jobs.group_of(n) for n in names]
    assert [tobs.GROUP_NAMES[tobs.group_of(n)] for n in names[:6]] == \
        ["moe_gate", "moe_gate", "moe_expert", "attn_qkv", "embedding",
         "other"]


def test_backward_origin_latch_reports_autodiff():
    """A latch with ZERO bits (every op output finite, grads not) is
    joined as backward/autodiff, in both packages alike."""
    from paddle_tpu.observe import numerics as jnum

    for words in (np.zeros(2, np.uint32), np.zeros(1, np.uint32)):
        info = tnum.join_first_nonfinite(words)
        assert info["op_index"] is None
        assert "backward" in info["op_type"]
        assert info == jnum.join_first_nonfinite(words)
    top = np.array([0, 1 << 31], np.uint32)       # bit 63: the sign bit
    assert tnum.join_first_nonfinite(top)["op_index"] == 63 == \
        jnum.join_first_nonfinite(top)["op_index"]


def test_numerics_disabled_runs_none_of_it(monkeypatch):
    """Not opted in, the step runs no telemetry, numerics or guard code
    (every entry point raises here); opted in, it reads nothing back to
    the host during the step, and a bit-31 op still latches."""
    def refuse(*a, **k):
        raise AssertionError("ran while disabled")

    main, scope, exe, loss = twins(_named)["port"]
    feed = _feed(np.random.RandomState(0), d=8)
    with monkeypatch.context() as m:
        for mod, names in ((tmetrics, ("init_telemetry_for",
                                       "device_update")),
                           (tnum, ("update_bits", "init_step_bits",
                                   "device_group_update",
                                   "latch_step_bits")),
                           (tguard, ("all_finite", "select_updates",
                                     "guard_telemetry_update"))):
            for n in names:
                m.setattr(mod, n, refuse)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    tobs.enable_numerics(main)
    with no_host_reads():
        exe.run(main, feed=_poisoned(feed, "y"), fetch_list=[loss],
                scope=scope, return_numpy=False)
    bits = tnum.init_step_bits(40, "cpu")
    tnum.update_bits(bits, 31, [torch.tensor([float("inf")])])
    assert bits[0].item() == -(1 << 31)
    tel = tobs.fetch_telemetry(scope, program=main)
    assert tel.first_nonfinite_op["op_index"] == _first_consumer(main, "y")
