"""The port's device-fed input pipeline (paddle_tpu_torch/data/pipeline.py
DeviceFeeder and PyReader) on the CPU: the counterparts of
tests/test_pipeline.py:15-107 (order, prefetch, error propagation,
restart, PyReader training and arity) and of the reference's feeder
hardening tests (retry with fast-forward, the stall event, validation
quarantine), and reset() in the middle of a pass.  Batches are compared
exactly."""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers, observe
from paddle_tpu_torch.data.pipeline import DeviceFeeder, PyReader
from paddle_tpu_torch.resilience import chaos

CPU = pt.CPUPlace()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    chaos.clear()


def _feed_batches(n):
    r = np.random.RandomState(5)
    return [{"x": r.rand(4, 2).astype(np.float32)} for _ in range(n)]


def test_device_feeder_order_and_completeness():
    def reader():
        for i in range(10):
            yield {"x": np.full((2, 2), i, np.float32)}

    feeder = DeviceFeeder(reader, capacity=2, device=CPU)
    got = list(feeder)
    assert all(isinstance(b["x"], torch.Tensor) for b in got)
    assert [int(b["x"][0, 0]) for b in got] == list(range(10))


def test_device_feeder_prefetches_ahead():
    produced = []

    def reader():
        for i in range(6):
            produced.append(i)
            yield {"x": np.zeros((1,), np.float32)}

    feeder = iter(DeviceFeeder(reader, capacity=3, device=CPU).start())
    next(feeder)  # consume one
    deadline = time.time() + 5
    # producer should run ahead: 1 consumed + 3 queued + 1 blocked-in-put
    while len(produced) < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 4, f"no prefetch overlap: produced={produced}"
    assert len(list(feeder)) == 5


def test_device_feeder_propagates_reader_error():
    def reader():
        yield {"x": np.zeros((1,), np.float32)}
        raise ValueError("boom in reader")

    feeder = iter(DeviceFeeder(reader, capacity=2, device=CPU).start())
    next(feeder)
    with pytest.raises(ValueError, match="boom in reader"):
        next(feeder)


def test_device_feeder_restartable_and_default_place():
    def reader():
        for i in range(3):
            yield {"x": np.full((1,), i, np.float32)}

    feeder = DeviceFeeder(reader, capacity=2, device=CPU)
    assert len(list(feeder)) == 3
    assert len(list(feeder)) == 3  # fresh pass after exhaustion
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceFeeder(reader)


def test_device_feeder_reset_mid_pass():
    """reset() while the producer is parked on a full queue stops it
    within the join timeout; a fresh pass starts from the first batch."""
    def reader():
        for i in range(50):
            yield {"x": np.full((1,), i, np.float32)}

    feeder = DeviceFeeder(reader, capacity=2, device=CPU)
    it = iter(feeder)
    assert [float(next(it)["x"][0]) for _ in range(3)] == [0.0, 1.0, 2.0]
    thread = feeder._thread
    feeder.reset()
    assert not thread.is_alive()
    with pytest.raises(StopIteration):
        next(feeder)
    assert float(next(iter(feeder))["x"][0]) == 0.0
    feeder.reset()


def test_feeder_retries_transient_producer_error_with_fast_forward(
        tmp_path):
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    batches = _feed_batches(4)
    chaos.arm("feeder:producer", times=2)
    f = DeviceFeeder(lambda: batches, retryable=(chaos.ChaosKilled,),
                     max_retries=3, backoff_s=0.001, event_log=log,
                     device=CPU)
    got = list(f)
    assert len(got) == 4 and f.retries == 2
    for want, have in zip(batches, got):
        np.testing.assert_array_equal(have["x"].numpy(), want["x"])
    log.close()
    kinds = [e["event"] for e in
             observe.read_events(str(tmp_path / "ev.jsonl"))]
    assert kinds.count("feeder_retry") == 2
    assert {"feeder_retry", "feeder_stall"} <= set(observe.FEED_EVENTS)
    # the reopened reader skips what was already handed out
    it = f._reopen(3)
    np.testing.assert_array_equal(next(it)["x"], batches[3]["x"])


def test_feeder_retry_exhaustion_and_nonretryable_errors():
    chaos.arm("feeder:producer", times=10)
    f = DeviceFeeder(lambda: _feed_batches(3),
                     retryable=(chaos.ChaosKilled,), max_retries=2,
                     backoff_s=0.001, device=CPU)
    with pytest.raises(chaos.ChaosKilled):
        list(f)
    assert f.retries == 2  # bounded: gave up after max_retries
    chaos.clear()

    def bad_reader():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise ValueError("boom")

    f = DeviceFeeder(lambda: bad_reader(), max_retries=5, device=CPU)
    with pytest.raises(ValueError, match="boom"):
        list(f)
    assert f.retries == 0


def test_feeder_stall_watchdog_emits_and_recovers(tmp_path):
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    chaos.arm_delay("feeder:producer", 0.4, times=1)
    f = DeviceFeeder(lambda: _feed_batches(3), stall_timeout_s=0.05,
                     event_log=log, device=CPU)
    assert len(list(f)) == 3  # the stalled pass still completes
    assert f.stalls >= 1
    log.close()
    stalls = [e for e in observe.read_events(str(tmp_path / "ev.jsonl"))
              if e["event"] == "feeder_stall"]
    assert stalls and stalls[0]["capacity"] == 2
    assert "queue_depth" in stalls[0]
    assert stalls[0]["producer_alive"] in (True, False)


def test_feeder_validate_quarantines_bad_batches(tmp_path):
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    batches = _feed_batches(4)
    poisoned = {"x": batches[1]["x"].copy()}
    poisoned["x"][0, 0] = np.nan
    drifted = {"x": batches[2]["x"].astype(np.float64)}
    stream = [batches[0], poisoned, drifted, batches[3]]
    f = DeviceFeeder(lambda: stream, validate=True, event_log=log,
                     device=CPU)
    got = list(f)
    assert len(got) == 2 and f.quarantined == 2
    np.testing.assert_array_equal(got[0]["x"].numpy(), batches[0]["x"])
    np.testing.assert_array_equal(got[1]["x"].numpy(), batches[3]["x"])
    log.close()
    fq = [e for e in observe.read_events(str(tmp_path / "ev.jsonl"))
          if e["event"] == "feed_quarantined"]
    assert [p["problems"][0]["problem"] for p in fq] == [
        "nonfinite", "signature_drift"]


def test_pyreader_trains_model():
    bs = 4
    main, startup = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[bs, 8], append_batch_size=False)
        y = layers.data("y", shape=[bs, 1], append_batch_size=False)
        pred = layers.fc(x, size=1)
        loss = layers.reduce_mean(layers.square(pred - y))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    twin = pt.Scope()
    for n, v in scope.vars.items():
        twin.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    w = np.random.RandomState(0).rand(8, 1).astype(np.float32)

    def batches():
        r = np.random.RandomState(1)
        for _ in range(20):
            xv = r.rand(bs, 8).astype(np.float32)
            yield xv, xv @ w

    reader = PyReader(feed_list=[x, y], capacity=3, place=CPU)
    reader.decorate_batch_generator(batches)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for feed in reader]
    assert len(losses) == 20 and losses[-1] < losses[0]
    # the same run fed from memory gives the same losses, bit for bit
    again = [float(exe.run(main, feed={"x": a, "y": b}, fetch_list=[loss],
                           scope=twin)[0].reshape(()))
             for a, b in batches()]
    assert again == losses


def test_pyreader_validates_arity_and_takes_seq_len():
    reader = PyReader(feed_list=["a", "b"], capacity=1, place=CPU)
    reader.decorate_batch_generator(
        lambda: iter([(np.zeros(1),)]))  # 1 array for 2 vars
    with pytest.raises(ValueError, match="feed vars"):
        next(iter(reader))
    reader.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        w = layers.data("w", shape=[6], dtype="int64", lod_level=1)
        lab = layers.data("lab", shape=[1], dtype="int64")
    reader = PyReader(feed_list=[w, lab], capacity=2, place=CPU)
    assert reader._names == ["w", "w.seq_len", "lab"]
    reader.decorate_batch_generator(lambda: iter([(
        np.ones((2, 6), np.int64), np.array([3, 6], np.int32),
        np.zeros((2, 1), np.int64))]))
    (feed,) = list(reader)
    assert feed["w.seq_len"].tolist() == [3, 6]


def test_device_feeder_threads_end():
    before = threading.active_count()
    for _ in range(3):
        list(DeviceFeeder(lambda: _feed_batches(2), device=CPU))
    time.sleep(0.2)
    assert threading.active_count() <= before
