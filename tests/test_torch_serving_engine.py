"""paddle_tpu_torch.serving.ServingEngine (with its DynamicBatcher,
BucketConfig and ServingStats) and contrib.serve against the JAX
package's, on the CPU, over models the reference saved:

- the same request stream through both packages' engines, dense (an
  MLP) and ragged (a `.seq_len` companion the engine synthesizes), gives
  per-request outputs within TOL (float32, other summation orders), and
  equal to the port's Predictor on each request alone at its bucket;
- zero compiles after the bucket-ladder warmup; `snapshot()` and
  `health()` have the reference's key sets;
- `BucketMissError.as_dict()` equal across packages (dense shape,
  over-long and empty sequences);
- QueueFullError shedding, deadline drops before dispatch, drain, and
  the breaker opening under `chaos.FlakyPredictor` (the CircuitOpenError
  wire form's keys equal the reference's), then closing on a probe;
- serving events carry one run id, and `set_replica_id` stamps them;
- `contrib.serve()` returns a started engine (the fit planner of ROADMAP
  A step 11 records itself skipped) whose metrics and alerts hooks work.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu.serving as jserving
import paddle_tpu_torch as tf
from paddle_tpu_torch.observe import read_events, runtime_stats
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (BucketConfig, BucketMissError,
                                      CircuitBreaker, CircuitOpenError,
                                      DeadlineExceededError,
                                      ExecutorFailureError, QueueFullError,
                                      ServingClosedError, ServingEngine)

torch.set_num_threads(2)

TOL = 1e-5


def _save(d, body, feeds):
    main, startup = jf.Program(), jf.Program()
    scope = jf.Scope()
    with jf.program_guard(main, startup), jf.scope_guard(scope):
        out = body(jf)
        exe = jf.Executor()
        exe.run(startup)
        jf.io.save_inference_model(d, feeds, [out], exe,
                                   main_program=main)
    return d


def _mlp(fluid):
    x = fluid.layers.data("x", shape=[16], append_batch_size=True)
    h = fluid.layers.fc(x, size=32, act="relu")
    return fluid.layers.fc(h, size=4)


def _ragged(fluid):
    x = fluid.layers.data("x", shape=[-1, 4], dtype="float32",
                          append_batch_size=True, lod_level=1)
    pooled = fluid.layers.sequence_pool(x, pool_type="sum")
    return fluid.layers.fc(pooled, size=3)


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    return _save(str(tmp_path_factory.mktemp("serve_mlp")), _mlp, ["x"])


@pytest.fixture(scope="module")
def ragged_dir(tmp_path_factory):
    return _save(str(tmp_path_factory.mktemp("serve_ragged")), _ragged,
                 ["x", "x.seq_len"])


def _cpu(d):
    return tf.AnalysisConfig(d).disable_gpu()


def _engine(d, **kw):
    kw.setdefault("buckets", BucketConfig((1, 2, 4, 8)))
    kw.setdefault("max_wait_ms", 10)
    kw.setdefault("queue_capacity", 64)
    return ServingEngine(_cpu(d), {"x": np.zeros(16, np.float32)}, **kw)


def _ref_engine(d, **kw):
    kw.setdefault("buckets", jserving.BucketConfig((1, 2, 4, 8)))
    kw.setdefault("max_wait_ms", 10)
    kw.setdefault("queue_capacity", 64)
    return jserving.ServingEngine(d, {"x": np.zeros(16, np.float32)}, **kw)


def _stream(engine, feeds, threads=4):
    """Submit `feeds` from `threads` concurrent callers; outputs in
    request order."""
    outs = [None] * len(feeds)

    def client(k):
        for i in range(k, len(feeds), threads):
            outs[i] = engine.infer(feeds[i], timeout_s=120)[0]

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return outs


def test_dense_stream_matches_the_reference(mlp_dir):
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(16).astype(np.float32)} for _ in range(12)]
    ref = _ref_engine(mlp_dir).start()
    want = _stream(ref, feeds)
    jsnap, jhealth = ref.stats.snapshot(), ref.health()
    ref.close()
    eng = _engine(mlp_dir).start()
    warm = eng.stats.snapshot()["warmup"]
    assert warm["buckets"] == 4 and warm["compiles"] == 4
    snap0 = runtime_stats.snapshot()
    got = _stream(eng, feeds)
    assert runtime_stats.delta(snap0)["compiles"] == 0
    snap, health = eng.stats.snapshot(), eng.health()
    eng.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    # each request equals the port's Predictor on it alone, bucket 1
    pred = tf.Predictor(_cpu(mlp_dir))
    for g, f in zip(got, feeds):
        np.testing.assert_allclose(g, pred.run({"x": f["x"][None]})[0][0],
                                   rtol=TOL, atol=TOL)
    assert snap["post_warmup_compiles"] == 0 and snap["completed"] == 12
    assert set(snap) == set(jsnap)
    assert set(snap["e2e_ms"]) == set(jsnap["e2e_ms"])
    assert set(health) == set(jhealth)
    assert health["post_warmup_compiles"] == 0
    assert 0 < snap["batch_occupancy"] <= 1


def test_ragged_stream_matches_the_reference(ragged_dir):
    rng = np.random.RandomState(3)
    lens = [3, 7, 8, 1, 12, 16, 5, 9]
    feeds = [{"x": rng.rand(n, 4).astype(np.float32)} for n in lens]
    kw = dict(max_wait_ms=20, queue_capacity=32)
    ref = jserving.ServingEngine(
        ragged_dir, {"x": np.zeros((1, 4), np.float32)},
        buckets=jserving.BucketConfig((1, 2, 4, 8), seq_lens=(8, 16)),
        **kw).start()
    want = [f.result(120)[0] for f in [ref.submit(x) for x in feeds]]
    ref.close()
    eng = ServingEngine(_cpu(ragged_dir),
                        {"x": np.zeros((1, 4), np.float32)},
                        buckets=BucketConfig((1, 2, 4, 8), seq_lens=(8, 16)),
                        **kw).start()
    assert eng.stats.snapshot()["warmup"]["compiles"] == 8
    snap0 = runtime_stats.snapshot()
    got = [f.result(120)[0] for f in [eng.submit(x) for x in feeds]]
    assert runtime_stats.delta(snap0)["compiles"] == 0
    s = eng.stats.snapshot()
    eng.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    assert s["padding_waste"] is not None and s["padding_waste"] > 0
    with pytest.raises(ValueError, match="seq_lens"):
        ServingEngine(_cpu(ragged_dir), {"x": np.zeros((1, 4), np.float32)},
                      buckets=BucketConfig((1, 2)))


def _miss(engine, feed):
    with pytest.raises((BucketMissError, jserving.BucketMissError)) as e:
        engine.submit(feed)
    return e.value.as_dict()


def test_bucket_miss_wire_form_is_the_reference(mlp_dir, ragged_dir):
    ref, eng = _ref_engine(mlp_dir).start(), _engine(mlp_dir).start()
    bad = {"x": np.zeros(17, np.float32)}
    assert _miss(eng, bad) == _miss(ref, bad)
    assert eng.batcher.inflight == 0
    assert eng.stats.snapshot()["bucket_misses"] == 1
    with pytest.raises(ValueError):
        eng.submit({"x": np.zeros(16, np.float32), "bogus": 1})
    ref.close()
    eng.close()
    tpl = {"x": np.zeros((1, 4), np.float32)}
    ref = jserving.ServingEngine(
        ragged_dir, tpl, buckets=jserving.BucketConfig((1,), seq_lens=(8,)),
        max_wait_ms=1).start()
    eng = ServingEngine(_cpu(ragged_dir), tpl,
                        buckets=BucketConfig((1,), seq_lens=(8,)),
                        max_wait_ms=1).start()
    for bad in ({"x": np.zeros((9, 4), np.float32)},
                {"x": np.zeros((0, 4), np.float32)},
                {"x": np.zeros((3, 5), np.float32)}):
        assert _miss(eng, bad) == _miss(ref, bad)
    ref.close()
    eng.close()


def test_shedding_deadlines_and_drain(mlp_dir):
    # max_batch_size 16 > capacity 12: the forming batch never fills, so
    # every accepted request parks in the 400 ms window while the
    # overload arrives (a deterministic shed count)
    eng = _engine(mlp_dir, buckets=BucketConfig((1, 2, 4, 16)),
                  queue_capacity=12, max_wait_ms=400).start()
    x = np.zeros(16, np.float32)
    accepted, shed = [], []
    for _ in range(24):
        try:
            accepted.append(eng.submit({"x": x}))
        except QueueFullError as e:
            shed.append(e)
    assert len(accepted) == 12 and len(shed) == 12
    assert shed[0].as_dict()["capacity"] == 12
    assert all(f.result(60)[0].shape == (4,) for f in accepted)
    assert eng.stats.snapshot()["shed"] == 12
    eng.close()

    # a window longer than the deadline: dropped before dispatch
    eng = _engine(mlp_dir, max_wait_ms=80).start()
    fut = eng.submit({"x": x}, deadline_ms=5)
    with pytest.raises(DeadlineExceededError) as ei:
        fut.result(60)
    assert ei.value.as_dict()["queued_ms"] >= 5
    assert eng.stats.snapshot()["deadline_misses"] == 1
    assert eng.infer({"x": x}, timeout_s=60)[0].shape == (4,)
    # drain flushes an open window now, then refuses new work
    eng2 = _engine(mlp_dir, max_wait_ms=2000).start()
    futs = [eng2.submit({"x": x}) for _ in range(5)]
    t0 = time.monotonic()
    assert eng2.drain(timeout_s=30)
    assert time.monotonic() - t0 < 10 and all(f.done() for f in futs)
    with pytest.raises(ServingClosedError):
        eng2.submit({"x": x})
    eng2.close()
    eng.close()
    assert eng.admission.state == "stopped"


def _breaker_burst(engine, x):
    errors = []
    for _ in range(2):
        with pytest.raises(Exception) as e:
            engine.infer({"x": x}, timeout_s=60)
        errors.append(e.value)
    with pytest.raises(Exception) as e:
        engine.submit({"x": x})
    return errors, e.value


def test_breaker_opens_under_flaky_predictor(mlp_dir):
    from paddle_tpu.resilience import chaos as jchaos

    x = np.zeros(16, np.float32)
    clock = [0.0]
    ref = jserving.ServingEngine(
        jchaos.FlakyPredictor(jf.Predictor(mlp_dir), fail_first=2),
        {"x": x}, buckets=jserving.BucketConfig((1,)), max_wait_ms=1,
        breaker=jserving.CircuitBreaker(2, 5.0, clock=lambda: clock[0]))
    ref.start()
    jerrs, jopen = _breaker_burst(ref, x)
    ref.close()
    flaky = chaos.FlakyPredictor(tf.Predictor(_cpu(mlp_dir)), fail_first=2)
    eng = ServingEngine(flaky, {"x": x}, buckets=BucketConfig((1,)),
                        max_wait_ms=1,
                        breaker=CircuitBreaker(2, 5.0,
                                               clock=lambda: clock[0]))
    eng.start()
    errs, opened = _breaker_burst(eng, x)
    assert all(isinstance(e, ExecutorFailureError) for e in errs)
    assert errs[0].as_dict()["error_type"] == "InjectedExecutorError"
    assert [set(e.as_dict()) for e in errs] == [set(e.as_dict())
                                               for e in jerrs]
    assert isinstance(opened, CircuitOpenError)
    assert set(opened.as_dict()) == set(jopen.as_dict())
    assert eng.health()["state"] == "degraded"
    assert flaky.failures_injected == 2
    snap = eng.stats.snapshot()
    assert snap["executor_failures"] == 2 and snap["circuit_rejects"] == 1
    clock[0] = 10.0      # cooldown over: the half-open probe succeeds
    assert eng.infer({"x": x}, timeout_s=60)[0].shape == (4,)
    assert eng.health()["state"] == "running"
    eng.close()


def test_events_serve_and_the_missing_planes(mlp_dir, tmp_path):
    log_path = str(tmp_path / "serving.jsonl")
    eng = tf.contrib.serve(_cpu(mlp_dir), {"x": np.zeros(16, np.float32)},
                           batch_sizes=(1, 4), max_wait_ms=2,
                           log_path=log_path, stats_window=4)
    assert eng._started and eng.buckets.batch_sizes == (1, 4)
    eng.set_replica_id(3)
    assert eng.health()["replica_id"] == 3
    rng = np.random.RandomState(1)
    for _ in range(5):
        eng.infer({"x": rng.rand(16).astype(np.float32)}, timeout_s=60)
    assert eng.fit_plan["skipped"]
    # the metrics and alerts plane (observe.registry, alerts): the
    # engine's stats scraped over /metrics, the serving rule pack
    reg = eng.metrics_registry()
    assert reg is eng.metrics_registry()
    snap = reg.snapshot()
    assert snap["serving_completed_total"]["samples"][0]["value"] == 5
    assert snap["serving_completed_total"]["samples"][0]["labels"] == \
        {"scope": "engine"}
    alerts = eng.enable_alerts(start=False)
    assert alerts is eng.enable_alerts()
    assert sorted(r.id for r in alerts.rules) == [
        "serving_e2e_p99", "serving_error_rate",
        "serving_post_warmup_compiles"]
    alerts.evaluate()
    assert alerts.signals()["serving_post_warmup_compiles"]["value"] == 0
    srv = eng.start_metrics_server()
    assert srv is eng.start_metrics_server()
    with urllib.request.urlopen(srv.url + "/metrics", timeout=5) as r:
        assert b"serving_e2e_ms_bucket" in r.read()
    with urllib.request.urlopen(srv.url + "/alerts", timeout=5) as r:
        assert json.loads(r.read())["evaluations"] == 1
    eng.close()
    assert eng._metrics_server is None
    events = read_events(log_path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_begin" and kinds[-1] == "run_end"
    for k in ("serving_start", "serving_warmup", "serving_window",
              "serving_drain"):
        assert k in kinds, k
    assert "serving_compile_post_warmup" not in kinds
    assert len({e["run_id"] for e in events}) == 1
    drain = [e for e in events if e["event"] == "serving_drain"][-1]
    assert drain["replica_id"] == 3 and drain["completed"] == 5
    assert drain["post_warmup_compiles"] == 0
    off = ServingEngine(_cpu(mlp_dir), {"x": np.zeros(16, np.float32)},
                        memory_budget_bytes=False).start()
    assert off.fit_plan is None
    off.close()
