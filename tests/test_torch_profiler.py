"""The port's trace plane: `fluid.profiler` (paddle_tpu_torch/profiler.py)
and the per-op time table of a `torch.profiler` trace
(paddle_tpu_torch/observe/trace.py), on the CPU, against the reference's
tests/test_observe.py:180-216.

- `fluid_op_of` reads the reference's scope names as the reference does.
- `profiler.profiler(sorted_key=...)` around an MLP's steps prints the
  fluid profiler's report, whose rows name the program's ops (`mul`,
  `elementwise_add`), forward and backward: the backward's aten ops land
  on the op whose forward made their autograd node.
- `op_cost_table(profile_dir=...)` joins the trace's times to its rows.
- Nothing records outside a profile: the op hook is off again after it.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observe import trace


@pytest.mark.parametrize("name,want", [
    ("jit(step)/mul:3/dot_general", "mul"),
    ("jit(step)/while/body/conv2d:12/convolution", "conv2d"),
    ("jit(f)/while_op:2/mul:7/mul", "mul"),
    ("jit(f)/transpose/no_scope_here", None),
    ("jit(step)/jit(main)/jvp(mul:3)/dot_general", "mul"),
    ("jit(step)/transpose(jvp(softmax:25))/mul", "softmax"),
    ("mul:3", "mul"),
    ("elementwise_add:14", "elementwise_add"),
])
def test_fluid_op_of_matches_reference(name, want):
    assert tf.observe.fluid_op_of(name) == want == \
        jf.observe.fluid_op_of(name)


def _mlp():
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.layers.data(name="x", shape=[16], dtype="float32")
        y = tf.layers.data(name="y", shape=[1], dtype="float32")
        h = tf.layers.fc(x, size=32, act="relu")
        pred = tf.layers.fc(h, size=1)
        loss = tf.layers.mean(tf.layers.square_error_cost(pred, y))
        tf.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(32, 16).astype(np.float32),
            "y": rng.rand(32, 1).astype(np.float32)}
    return main, scope, exe, loss, feed


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    main, scope, exe, loss, feed = _mlp()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    trace_dir = os.path.join(str(tmp_path_factory.mktemp("prof")), "trace")
    with profiler.profiler(sorted_key="total", profile_path=trace_dir):
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, scope, exe, loss, feed, trace_dir


def test_profiler_prints_the_per_op_table(profiled, capsys):
    *_, trace_dir = profiled
    profiler.print_profile_summary(trace_dir, "calls")
    printed = capsys.readouterr().out
    assert "Profiling Report" in printed and "sorted by: calls" in printed
    rows = profiler.profile_table(trace_dir)
    ops = {r["op_type"] for r in rows}
    assert {"mul", "elementwise_add", "relu", "sgd"} <= ops, ops
    for r in rows:
        assert r["calls"] >= 1 and r["total_ms"] >= 0.0
        assert 0.0 <= r["ratio"] <= 1.0
    assert abs(sum(r["ratio"] for r in rows) - 1.0) < 1e-9
    # the backward's products are charged to mul: two steps, each mul op
    # one product forward and two backward (dX, dW; the first fc's dX is
    # not needed) -> more than the forward's 2 a step
    mul = next(r for r in rows if r["op_type"] == "mul")
    assert mul["calls"] >= 2 * (2 + 3)
    assert trace.op_scope[0] is None


def test_instr_time_table_and_cost_join(profiled):
    main, scope, exe, loss, feed, trace_dir = profiled
    instr = trace.instr_time_table(trace_dir)
    assert any(name.startswith("aten::") for name in instr)
    assert {v["op_name"].split(":")[0] for v in instr.values()
            if v["op_name"]} >= {"mul", "relu"}
    rows = tf.observe.op_cost_table(main, feed=feed, fetch_list=[loss],
                                    scope=scope, exe=exe,
                                    profile_dir=trace_dir)
    timed = {r["op_type"] for r in rows if r["time_ms"]}
    assert {"mul", "relu", "sgd"} <= timed, timed
    # the CPU has no peak: no roofline denominator
    assert all(r["achieved_flops_frac"] is None for r in rows)


def test_profiler_start_stop_errors(tmp_path):
    d = str(tmp_path / "p")
    with pytest.raises(RuntimeError, match="no profiler"):
        profiler.stop_profiler()
    profiler.start_profiler("CPU", d)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiler.start_profiler("CPU", d)
        with profiler.record_event("user_range"):
            pass
    finally:
        profiler.stop_profiler(profile_path=d)
    with pytest.raises(NotImplementedError):
        profiler.cuda_profiler("x")
    t = profiler.Timer()
    t.start()
    t.pause()
    assert t.elapsed >= 0.0
    with pytest.raises(FileNotFoundError):
        trace.op_time_table(str(tmp_path / "empty"))
