"""The port's FLAGS (paddle_tpu_torch/flags.py) against the reference's
table, the env bridge, the Executor's debug checks and the flags read
at use (the health plane, the supervisor, the checkpoint barrier, the
DeviceFeeder's speed-test mode).  Host code: held exactly."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.flags import FLAGS as REF_FLAGS
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import layers
from paddle_tpu_torch.flags import FLAGS

CPU = pt.CPUPlace()


@pytest.fixture
def restore_flags():
    saved = dict(FLAGS._values)
    user = set(FLAGS._set_by_user)
    yield
    FLAGS._values.update(saved)
    FLAGS._set_by_user.clear()
    FLAGS._set_by_user.update(user)


def test_flag_table_equals_the_reference():
    ref = REF_FLAGS._defs
    port = FLAGS._defs
    assert list(port) == list(ref)
    for name in ref:
        assert (port[name].default, port[name].type) == (
            ref[name].default, ref[name].type), name
        assert port[name].help
    assert set(FLAGS.to_dict()) == set(REF_FLAGS.to_dict())


@pytest.mark.parametrize("text,want", [("false", False), ("0", False),
                                       ("no", False), ("TRUE", True),
                                       ("1", True), ("yes", True)])
def test_env_bridge_reads_bools(monkeypatch, restore_flags, text, want):
    """FLAGS_x=false reads False (a plain bool("false") would be True)."""
    reg = port_flags.FlagRegistry()
    monkeypatch.setenv("FLAGS_probe", text)
    reg.define("probe", not want)
    assert reg.probe is want and reg.is_set("probe")
    monkeypatch.setenv("FLAGS_check_nan_inf", text)
    port_flags.init_from_env()
    assert FLAGS.check_nan_inf is want


def test_env_bridge_typed_values_and_unknown_names(monkeypatch,
                                                   restore_flags):
    monkeypatch.setenv("FLAGS_paddle_num_threads", "7")
    monkeypatch.setenv("FLAGS_heartbeat_interval_s", "0.25")
    port_flags.init_from_env()
    assert FLAGS.paddle_num_threads == 7
    assert FLAGS.heartbeat_interval_s == 0.25
    FLAGS.benchmark = "false"
    assert FLAGS.benchmark is False
    with pytest.raises(AttributeError):
        FLAGS.no_such_flag
    with pytest.raises(AttributeError):
        FLAGS.another_unknown = 1


def test_memory_fraction_is_not_applied_unless_set(monkeypatch,
                                                   restore_flags):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, i: calls.append((f, i)))
    FLAGS._set_by_user.discard("fraction_of_tpu_memory_to_use")
    port_flags.apply_memory_fraction(torch.device("cuda", 0))
    assert calls == []
    # set: applied once per device, refused above what is held
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"total_memory": 1000}))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda i: 100)
    FLAGS.fraction_of_tpu_memory_to_use = 0.5
    port_flags.apply_memory_fraction(torch.device("cuda", 0))
    port_flags.apply_memory_fraction(torch.device("cuda", 0))
    assert calls == [(0.5, 0)]
    FLAGS.fraction_of_tpu_memory_to_use = 0.05
    with pytest.raises(ValueError, match="already holds"):
        port_flags.apply_memory_fraction(torch.device("cuda", 0))
    port_flags._mem_applied.clear()


def _nan_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[2], dtype="float32")
        y = layers.log(x)  # log(-1) = nan
        z = layers.fc(x, size=2, param_attr=pt.ParamAttr(name="w"))
    return main, startup, y, z


@pytest.mark.parametrize("where", ["fetch", "persistable"])
def test_check_nan_inf_raises_naming_the_var(restore_flags, where):
    """tests/test_aux.py:26 in the port, on a fetch and on a
    persistable."""
    main, startup, y, z = _nan_program()
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    if where == "fetch":
        feed, fetch, name = {"x": -np.ones((1, 2), np.float32)}, [y], y.name
    else:
        scope.set_var("w", torch.tensor([[1.0, float("nan")],
                                         [0.5, 2.0]]))
        feed, fetch, name = {"x": np.ones((1, 2), np.float32)}, [], "w"
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)   # flag off
    FLAGS.check_nan_inf = True
    with pytest.raises(FloatingPointError, match=f"{where}.*'{name}'"):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_benchmark_flag_syncs_only_a_card(monkeypatch, restore_flags):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    main, startup, y, z = _nan_program()
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    FLAGS.benchmark = True
    exe.run(main, feed={"x": np.ones((1, 2), np.float32)},
            fetch_list=[z], scope=scope)
    assert calls == []      # the CPU has nothing in flight


def test_reader_queue_speed_test_mode_serves_the_first_batch(
        restore_flags):
    from paddle_tpu_torch.data.pipeline import DeviceFeeder

    def reader():
        for i in range(5):
            yield {"x": np.full((2,), i, np.float32)}

    FLAGS.reader_queue_speed_test_mode = True
    it = iter(DeviceFeeder(reader, capacity=2, device=CPU))
    got = [float(next(it)["x"][0]) for _ in range(8)]
    assert got == [0.0] * 8
    it.reset()


def test_runtime_flags_reach_objects_built_after(restore_flags,
                                                 monkeypatch):
    """A FLAGS value set in the process reaches the next HealthMonitor
    (through its HealthConfig), Supervisor and checkpoint barrier."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.resilience import health
    from paddle_tpu_torch.resilience.chaos import FakeKv
    from paddle_tpu_torch.resilience.supervisor import Supervisor

    FLAGS.heartbeat_interval_s = 0.25
    FLAGS.heartbeat_miss_budget = 3
    mon = health.HealthMonitor(FakeKv(), rank=0, num_ranks=2,
                               config=health.HealthConfig())
    assert (mon.config.interval_s, mon.config.miss_window_s) == (0.25, 0.75)
    FLAGS.supervisor_max_restarts = 7
    assert Supervisor(["true"], 1).max_restarts == 7
    monkeypatch.delenv("PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S", raising=False)
    FLAGS.ckpt_barrier_timeout_s = 12.5
    assert io.barrier_timeout_s() == 12.5
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_TIMEOUT_S", "3")
    assert io.barrier_timeout_s() == 3.0
