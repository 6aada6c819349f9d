"""The port's goodput ledger and reader decorators on the CPU
(paddle_tpu_torch/observe/goodput.py, data/decorator.py), against the
reference's:

- phase scripts run through the port's and the reference's
  `GoodputLedger` under the same injected `clock=` give equal reports,
  tables and chrome traces, and hold the ledger's invariants (the
  categories sum to the wall exactly; nesting, windows, the background
  channel, replay, compile re-attribution of a kernel build recorded
  in `runtime_stats`, the span ring, unknown categories);
- the Trainer's ledger with a slow reader (data_stall) and with a
  restart replay (a crash between a checkpoint and the progress
  cursor): the replayed steps counted, the categories summing to the
  wall, `ckpt_stats` reading the ledger;
- the reader decorators give the reference's samples in the
  reference's order: `shuffle` with a seed (the order a bit-exact
  resume relies on), `batch`, `buffered`, `chain`, `compose`, `firstn`,
  `map_readers`, `xmap_readers` and `Fake`.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import paddle_tpu.data.decorator as jdec
import paddle_tpu.observe.goodput as jgp
import paddle_tpu.observe.monitoring as jmon
import paddle_tpu_torch as pt
import paddle_tpu_torch.data.decorator as tdec
import paddle_tpu_torch.observe.goodput as tgp
import paddle_tpu_torch.observe.monitoring as tmon
import torch_preempt_worker as W
from paddle_tpu_torch.contrib import (CheckpointConfig, EndStepEvent,
                                      Trainer)

torch.set_num_threads(2)


class FakeClock:
    """Deterministic monotonic clock for exact-arithmetic scripts."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# each script: (ledger, clock, runtime_stats) -> extra report kwargs
def _flat(led, clk, rt):
    led.open_window()
    with led.phase("step", steps=1):
        clk.advance(1.0)
    with led.phase("data_stall"):
        clk.advance(0.5)
    with led.phase("checkpoint", label="save:0"):
        clk.advance(0.2)
    clk.advance(0.3)                      # unclaimed -> idle
    led.close_window()
    return {}


def _nested(led, clk, rt):
    with led.window():
        with led.phase("step", steps=1):
            clk.advance(0.4)
            with led.phase("checkpoint"):
                clk.advance(0.3)
            clk.advance(0.3)
    with led.phase("barrier_wait"):       # outside the window
        clk.advance(0.7)
    return {}


def _background_and_replay(led, clk, rt):
    led.note_replay((0, 6), (0, 9))
    with led.window():
        with led.phase("replay", steps=3):
            clk.advance(0.9)
        with led.phase("step", steps=2):
            clk.advance(0.8)
        led.note_background("ckpt_write", 1.5)
    return {"mfu": 0.32}


def _kernel_build(led, clk, rt):
    """A first step that builds a CUDA kernel: the build's wall moves
    from "step" to "compile" (in the reference, an XLA compile)."""
    with led.window():
        with led.phase("step", steps=1):
            clk.advance(2.0)
            rt.record_compile(1.5)
        with led.phase("step", steps=1):
            clk.advance(0.25)
        clk.advance(0.5)
        rt.record_compile(0.25)           # outside any phase
    return {}


def _span_ring(led, clk, rt):
    with led.window():
        for _ in range(20):
            with led.phase("step", label="s", steps=1):
                clk.advance(0.01)
    return {}


SCRIPTS = {"flat": _flat, "nested": _nested,
           "background_and_replay": _background_and_replay,
           "kernel_build": _kernel_build, "span_ring": _span_ring}


def _run(gp, rt, script):
    clk = FakeClock()
    led = gp.GoodputLedger(clock=clk, max_spans=16)
    extra = SCRIPTS[script](led, clk, rt)
    rep = gp.goodput_report(led, **extra)
    return rep, gp.format_goodput_table(rep), led.export_chrome_trace()


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_ledger_matches_the_reference(script):
    port, port_table, port_trace = _run(tgp, tmon.runtime_stats, script)
    ref, ref_table, ref_trace = _run(jgp, jmon.runtime_stats, script)
    assert port == ref
    assert port_table == ref_table and port_trace == ref_trace
    cats = port["categories_s"]
    assert set(cats) == set(tgp.CATEGORIES)
    assert sum(cats.values()) == pytest.approx(port["wall_s"], abs=1e-9)
    assert abs(sum(port["fractions"].values()) - 1.0) < 1e-5
    if script == "flat":
        assert (cats["step"], cats["idle"], port["goodput"]) == \
            (1.0, 0.3, 0.5)
    if script == "kernel_build":
        assert cats["compile"] == pytest.approx(1.75)
        assert cats["step"] == pytest.approx(0.75)
    if script == "span_ring":
        assert port["spans_dropped"] == 4 and port["steps"] == 20
    if script == "background_and_replay":
        assert port["background_ms"] == {"ckpt_write": 1500.0}
        assert port["replay"] == {"from": [0, 6], "to": [0, 9]}
        assert port["effective_mfu"] == round(0.32 * 0.8 / 1.7, 6)


def test_unknown_category_and_idempotent_window():
    clk = FakeClock()
    led = tgp.GoodputLedger(clock=clk)
    for bad in ("espresso", "idle"):
        with pytest.raises(ValueError):
            with led.phase(bad):
                pass
    led.open_window()
    clk.advance(1.0)
    led.open_window()                     # must not reset the origin
    clk.advance(1.0)
    assert led.wall_s() == pytest.approx(2.0)
    led.close_window()
    led.close_window()
    assert led.wall_s() == pytest.approx(2.0)
    assert led.category_s("idle") == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# The Trainer's ledger
# ---------------------------------------------------------------------------

def _trainer(ckpt):
    return Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                   checkpoint_config=CheckpointConfig(
                       ckpt, step_interval=3, epoch_interval=10 ** 6))


def _slow(reader, delay):
    def read():
        for b in reader():
            time.sleep(delay)
            yield b

    return read


def test_trainer_ledger_sums_to_wall_with_data_stall(tmp_path):
    t = _trainer(str(tmp_path / "ck"))
    t.train(num_epochs=1, reader=_slow(W.make_reader(6), 0.02))
    t.stop()
    rep = t.goodput(mfu=0.5)
    cats = rep["categories_s"]
    assert abs(sum(cats.values()) - rep["wall_s"]) < 1e-3
    assert rep["steps"] == 6 and rep["replay_steps"] == 0
    assert cats["data_stall"] >= 6 * 0.02 * 0.8
    assert cats["checkpoint"] > 0.0
    assert rep["effective_mfu"] == pytest.approx(0.5 * rep["goodput"],
                                                 abs=2e-6)
    assert t.ckpt_stats["blocking_ms"] == pytest.approx(
        t.goodput_ledger.category_ms("checkpoint"), abs=1e-3)
    assert t.ckpt_stats["write_ms"] == pytest.approx(
        t.goodput_ledger.background_ms("ckpt_write"), abs=1e-3)


def test_trainer_restart_replay_badput(tmp_path):
    ck = str(tmp_path / "ck")

    class Boom(RuntimeError):
        pass

    def handler(e):
        # EndStepEvent fires BEFORE its step's progress write: raising
        # at step 7 leaves the crash cursor at (0, 7)
        if isinstance(e, EndStepEvent) and e.step == 7:
            raise Boom("chaos")

    with pytest.raises(Boom):
        _trainer(ck).train(num_epochs=1, reader=W.make_reader(),
                           event_handler=handler)
    t2 = _trainer(ck)
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 6)
    t2.train(num_epochs=1, reader=W.make_reader())
    t2.stop()
    rep = t2.goodput()
    assert rep["replay_steps"] == 1       # step 6 ran twice
    assert rep["steps"] == 5
    assert rep["replay"] == {"from": [0, 6], "to": [0, 7]}
    assert rep["categories_s"]["replay"] > 0.0
    assert abs(sum(rep["categories_s"].values()) - rep["wall_s"]) < 1e-3


# ---------------------------------------------------------------------------
# Reader decorators against the reference's
# ---------------------------------------------------------------------------

def _samples(n=23, seed=0):
    r = np.random.RandomState(seed)
    return lambda: iter([int(v) for v in r.permutation(1000)[:n]])


def _fresh(n=23, seed=0):
    """A reader that yields the same samples on every call."""
    items = list(_samples(n, seed)())
    return lambda: iter(items)


CASES = {
    "shuffle_seed": lambda d: d.shuffle(_fresh(), 5, seed=13),
    "shuffle_seed_whole": lambda d: d.shuffle(_fresh(), 100, seed=7),
    "batch": lambda d: d.batch(_fresh(), 4),
    "batch_drop_last": lambda d: d.batch(_fresh(), 4, drop_last=True),
    "buffered": lambda d: d.buffered(_fresh(), 3),
    "chain": lambda d: d.chain(_fresh(5), _fresh(4, seed=1)),
    "compose": lambda d: d.compose(_fresh(6), _fresh(6, seed=2)),
    "firstn": lambda d: d.firstn(_fresh(), 7),
    "map_readers": lambda d: d.map_readers(lambda a, b: a - b, _fresh(),
                                           _fresh(seed=3)),
    "xmap_ordered": lambda d: d.xmap_readers(lambda v: v * 2, _fresh(),
                                             3, 4, order=True),
    "fake": lambda d: d.Fake()(_fresh(), 5),
    "shuffle_batch": lambda d: d.batch(d.shuffle(_fresh(), 6, seed=1), 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decorators_match_the_reference(case):
    got = [list(CASES[case](tdec)()) for _ in range(2)]
    want = list(CASES[case](jdec)())
    assert got[0] == want and got[1] == want   # and again: resume-safe


def test_compose_checks_alignment():
    r = tdec.compose(_fresh(3), _fresh(4))
    with pytest.raises(RuntimeError, match="different lengths"):
        list(r())
    assert len(list(tdec.compose(_fresh(3), _fresh(4),
                                 check_alignment=False)())) == 4
