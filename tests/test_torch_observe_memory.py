"""The port's memory plane (paddle_tpu_torch/observe/memory.py) against
the reference's (paddle_tpu/observe/memory.py), and the serving engines'
memory gates.

- On the reference's Adam MLP (tests/test_observe_memory.py:35-64) built
  in both packages: named state rows carry their exact bytes and
  buckets; `plan_fit`'s params / optimizer_state / feeds breakdown
  equals the reference's as integers; the timeline's peak is the
  report's; the chrome-trace export loads; `memory_table` is sorted and
  truncated.
- `plan_fit` predicts the port's own measured peak (the ledger's, on
  the CPU) within PLAN_FIT_REL_TOL at a 16x extrapolation; a
  probe-sized candidate is exact; an uninferrable batch raises.
- The ServingEngine's four gate cases of the reference
  (tests/test_observe_memory.py:301-373) and the DecodeEngine's three
  (raises before the pool exists, fits, `num_pages == num_slots`
  skipped), each with an explicit `memory_budget_bytes`.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

import paddle_tpu_torch as tf
import torch_twin as tw
from paddle_tpu_torch.observe.memory import BUCKETS, PLAN_FIT_REL_TOL


def _mlp_adam(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[16], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, size=32, act="relu")
    pred = layers.fc(h, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


FEED = {"x": np.zeros((8, 16), np.float32),
        "y": np.zeros((8, 1), np.float32)}


@pytest.fixture(scope="module")
def mlp():
    twins = tw.twins(_mlp_adam)
    main, scope, exe, loss = twins["port"]
    rep = tf.observe.memory_report(main, feed=FEED, fetch_list=[loss],
                                   scope=scope, exe=exe)
    return rep, twins


def test_named_state_rows_exact(mlp):
    rep, _ = mlp
    by_param = {r["param"]: r for r in rep["rows"] if r["param"]}
    assert by_param["fc_0.w_0"]["bytes"] == 16 * 32 * 4 == 2048
    assert by_param["fc_0.w_0"]["bucket"] == "params"
    assert by_param["fc_1.w_0"]["bytes"] == 32 * 4
    assert by_param["fc_0.w_0.moment1"]["bucket"] == "optimizer_state"
    assert by_param["fc_0.w_0.moment2"]["bytes"] == 2048
    assert by_param["x"]["bucket"] == "activations"
    assert by_param["x"]["bytes"] == 8 * 16 * 4
    br = rep["breakdown"]
    assert set(BUCKETS) <= set(br) and "donated" in br
    params_exact = (16 * 32 + 32 + 32 * 1 + 1) * 4
    assert br["params"] == params_exact
    assert br["optimizer_state"] >= 2 * params_exact
    assert br["gradients"] > 0 and br["activations"] > 0
    # the step replaced the parameters and moments: donated
    assert br["donated"] >= br["params"]
    op_types = {r["op_type"] for r in rep["rows"] if r["op_type"]}
    assert "mul" in op_types
    assert rep["source"] == "ledger"
    assert rep["allocator_peak_bytes"] is None


def test_plan_fit_breakdown_equals_reference(mlp):
    _, twins = mlp
    cand = {"x": np.zeros((32, 16), np.float32),
            "y": np.zeros((32, 1), np.float32)}
    plans = {}
    for side, fluid in tw.PKGS.items():
        main, scope, exe, loss = twins[side]
        spec = cand if side == "port" else {
            n: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for n, v in cand.items()}
        with fluid.scope_guard(scope):
            plans[side] = fluid.observe.plan_fit(
                main, spec, fetch_list=[loss], scope=scope, exe=exe)
    for key in ("params", "optimizer_state", "feeds"):
        assert plans["port"]["breakdown"][key] == \
            plans["ref"]["breakdown"][key], key
    for key in ("exact", "batch", "probe_batches", "rel_tol"):
        assert plans["port"][key] == plans["ref"][key], key


def test_timeline_and_tables(mlp, tmp_path):
    rep, twins = mlp
    main, scope, exe, loss = twins["port"]
    tl = tf.observe.memory_timeline(main, feed=FEED, fetch_list=[loss],
                                    scope=scope, exe=exe)
    assert tl["peak_live_bytes"] == rep["peak_bytes"] > 0
    lives = [live for _i, live in tl["points"]]
    assert max(lives) == tl["peak_live_bytes"]
    idxs = [i for i, _ in tl["points"]]
    assert idxs == sorted(idxs)
    assert 0 <= tl["peak_index"] < tl["n_instructions"]
    assert tl["live_at_peak"]
    assert sum(s["bytes"] for s in tl["live_at_peak"]) == \
        tl["peak_live_bytes"]
    path = tf.observe.export_chrome_trace(tl, str(tmp_path / "mem.json"))
    with open(path) as f:
        trace = json.load(f)
    assert len([e for e in trace["traceEvents"] if e["ph"] == "C"]) == \
        len(tl["points"])
    peaks = [e for e in trace["traceEvents"] if e["ph"] == "i"]
    assert len(peaks) == 1
    assert peaks[0]["args"]["peak_live_bytes"] == tl["peak_live_bytes"]
    rows = tf.observe.memory_table(main, feed=FEED, fetch_list=[loss],
                                   scope=scope, exe=exe, top=5)
    assert len(rows) == 5
    assert [r["bytes"] for r in rows] == sorted(
        (r["bytes"] for r in rows), reverse=True)
    text = tf.observe.format_memory_table(rep["rows"], top=8)
    assert "fc_0.w_0" in text and "Bucket" in text
    assert "more buffers" in text
    mb = tf.observe.step_mem_breakdown(main, feed=FEED, fetch_list=[loss],
                                       scope=scope, exe=exe)
    assert mb["peak_bytes"] == rep["peak_bytes"]
    assert set(BUCKETS) <= set(mb)


def _transformer(fluid):
    from paddle_tpu_torch.models import transformer

    return transformer.build_model(
        src_vocab_size=1000, trg_vocab_size=1000, max_length=32,
        n_layer=2, n_head=4, d_model=64, d_inner_hid=128, dropout=0.1)


def test_plan_fit_against_measured_peak():
    """16 x the largest probe: the prediction lands within
    PLAN_FIT_REL_TOL of the ledger's peak measured at the candidate."""
    from paddle_tpu_torch.models import transformer

    main, startup, model = tw.build(tf, _transformer)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    cand = transformer.make_fake_batch(64, 32, 1000, 1000)
    plan = tf.observe.plan_fit(main, cand, fetch_list=[model["loss"]],
                               scope=scope, exe=exe, probe_batches=(2, 4))
    assert plan["exact"] is False and plan["batch"] == 64
    assert plan["probe_batches"] == [2, 4]
    actual = tf.observe.memory_report(
        main, feed=cand, fetch_list=[model["loss"]], scope=scope,
        exe=exe)["peak_bytes"]
    rel = abs(plan["predicted_peak_bytes"] - actual) / actual
    assert rel <= PLAN_FIT_REL_TOL, (plan["predicted_peak_bytes"], actual)
    assert plan["breakdown"]["params"] > 0
    assert plan["breakdown"]["optimizer_state"] > 0


def test_plan_fit_probe_sized_exact_and_uninferrable(mlp):
    _, twins = mlp
    main, scope, exe, loss = twins["port"]
    cand = {"x": np.zeros((2, 16), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    plan = tf.observe.plan_fit(main, cand, fetch_list=[loss], scope=scope,
                               exe=exe, probe_batches=(2, 4))
    assert plan["exact"] is True and plan["probe_batches"] == [2]
    assert plan["predicted_peak_bytes"] == tf.observe.memory_report(
        main, feed=cand, fetch_list=[loss], scope=scope,
        exe=exe)["peak_bytes"]
    with pytest.raises(ValueError, match="feed"):
        tf.observe.plan_fit(main, {}, fetch_list=[loss], scope=scope,
                            exe=exe)


# -- the serving engines' gates ----------------------------------------------


@pytest.fixture(scope="module")
def serving_model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mem_serving"))
    main, startup = tf.Program(), tf.Program()
    scope = tf.Scope()
    with tf.program_guard(main, startup), tf.scope_guard(scope):
        x = tf.layers.data("x", shape=[16], append_batch_size=True)
        pred = tf.layers.fc(tf.layers.fc(x, size=32, act="relu"), size=4)
        exe = tf.Executor(tf.CPUPlace())
        exe.run(startup)
        tf.io.save_inference_model(d, ["x"], [pred], exe,
                                   main_program=main)
    return d


def _serving(d, buckets, **kw):
    from paddle_tpu_torch.serving import BucketConfig, ServingEngine

    return ServingEngine(tf.AnalysisConfig(d).disable_gpu(),
                         {"x": np.zeros(16, np.float32)},
                         buckets=BucketConfig(buckets), **kw)


def test_serving_rejects_impossible_bucket(serving_model_dir):
    from paddle_tpu_torch.observe import runtime_stats
    from paddle_tpu_torch.serving import BucketMemoryError

    snap = runtime_stats.snapshot()
    engine = _serving(serving_model_dir, (1, 2, 4, 8),
                      memory_budget_bytes=4096)
    with pytest.raises(BucketMemoryError) as ei:
        engine.start()
    d = ei.value.as_dict()
    assert d["error"] == "bucket_memory"
    assert d["budget_bytes"] == 4096
    assert any(b["batch_size"] == 8 for b in d["offending_buckets"])
    assert all(b["predicted_peak_bytes"] > 4096
               for b in d["offending_buckets"])
    # the ladder was not warmed: the probes record no compile
    assert runtime_stats.delta(snap)["compiles"] == 0


def test_serving_fit_plan_recorded_when_budget_fits(serving_model_dir):
    engine = _serving(serving_model_dir, (1, 2, 4),
                      memory_budget_bytes=10**9)
    engine.start()
    try:
        plan = engine.fit_plan
        assert plan["budget_bytes"] == 10**9
        assert len(plan["buckets"]) == 3
        assert all(b["fits"] for b in plan["buckets"])
        assert [b["exact"] for b in plan["buckets"]] == [True, True, False]
        # the parameters (16*32 + 32 + 32*4 + 4 floats) are counted in
        params = (16 * 32 + 32 + 32 * 4 + 4) * 4
        assert all(b["predicted_peak_bytes"] > params
                   for b in plan["buckets"])
        peaks = [b["predicted_peak_bytes"] for b in plan["buckets"]]
        assert peaks == sorted(peaks) and peaks[0] < peaks[-1]
        out = engine.infer({"x": np.zeros(16, np.float32)}, timeout_s=60)
        assert out[0].shape == (4,)
    finally:
        engine.close()


def test_serving_no_budget_skips_validation(serving_model_dir):
    engine = _serving(serving_model_dir, (1,))
    engine.start()
    try:
        assert engine.fit_plan == {"skipped": "no device budget known",
                                   "budget_bytes": None}
    finally:
        engine.close()


def test_serving_budget_false_disables(serving_model_dir):
    engine = _serving(serving_model_dir, (1,), memory_budget_bytes=False)
    engine.start()
    try:
        assert engine.fit_plan is None
    finally:
        engine.close()


def _decode(budget, num_pages=64, num_slots=4):
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    lm = DecoderLM(vocab_size=32, n_layer=2, n_head=2, d_model=16,
                   d_inner=32, kv_dtype="float32")
    cfg = DecodeConfig(num_slots=num_slots, page_size=4, max_len=32,
                       num_pages=num_pages, prefill_buckets=(8,),
                       kv_dtype="float32")
    return DecodeEngine(lm, cfg, place=tf.CPUPlace(),
                        memory_budget_bytes=budget)


def test_decode_gate_raises_before_the_pool(monkeypatch):
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.serving import DecodeMemoryError

    made = []
    fresh = DecoderLM.fresh_pools

    def spy(self, num_pages, page_size, device):
        made.append(int(num_pages))
        return fresh(self, num_pages, page_size, device)

    monkeypatch.setattr(DecoderLM, "fresh_pools", spy)
    eng = _decode(50_000, num_pages=4096)
    with pytest.raises(DecodeMemoryError) as ei:
        eng.start()
    d = ei.value.as_dict()
    assert d["error"] == "decode_memory" and d["budget_bytes"] == 50_000
    assert d["plan"]["fits"] is False
    # only the two small probe pools were ever made, never the 4096
    assert made == [2, 4]
    # the probes predict the pool's own bytes: 2 layers x K and V
    pool = 2 * 2 * 4096 * 4 * 16 * 4
    assert d["plan"]["predicted_peak_bytes"] > pool
    assert d["plan"]["breakdown"]["pools"] == pool


def test_decode_gate_fits_and_serves():
    eng = _decode(10**9).start()
    try:
        plan = eng.fit_plan
        assert plan["fits"] is True and plan["budget_bytes"] == 10**9
        assert plan["probe_batches"] == [2, 4] and plan["batch"] == 64
        toks = eng.submit(np.array([1, 2, 3], np.int32),
                          max_new_tokens=3).result(timeout=60)
        assert 1 <= len(toks) <= 3
    finally:
        eng.close()


def test_decode_gate_skips_ambiguous_probe_axis():
    eng = _decode(10**9, num_pages=8, num_slots=8).start()
    try:
        assert eng.fit_plan == {"skipped": "num_pages == num_slots "
                                           "(ambiguous probe axis)",
                                "budget_bytes": 10**9}
    finally:
        eng.close()



class _FakeAllocator:
    """torch.cuda's allocator counters for a CPU run: the bytes allocated
    now and the peak since the counter's last reset."""

    def __init__(self, monkeypatch, peak):
        import torch

        from paddle_tpu_torch.observe import memory, monitoring

        self.allocated, self.peak, self.resets = 0, peak, 0
        c = torch.cuda
        monkeypatch.setattr(c, "is_initialized", lambda: True)
        monkeypatch.setattr(c, "current_device", lambda: 0)
        monkeypatch.setattr(c, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(c, "memory_allocated",
                            lambda *a, **k: self.allocated)
        monkeypatch.setattr(c, "max_memory_allocated",
                            lambda *a, **k: self.peak)
        monkeypatch.setattr(c, "reset_peak_memory_stats", self._reset)
        monkeypatch.setattr(monitoring, "_peak_floor", {})
        # the probes take the card's path: an allocator window each
        monkeypatch.setattr(memory, "_on_card", lambda device: True)

    def _reset(self, *a, **k):
        self.peak = self.allocated
        self.resets += 1


def test_peak_gauge_survives_the_engine_gates_probes(monkeypatch,
                                                     serving_model_dir):
    from paddle_tpu_torch.observe import (memory_collector,
                                          peak_memory_bytes)

    def gauge():
        fams = {f.name: f for f in memory_collector()()}
        return fams["memory_peak_bytes"].samples[0][1]

    fake = _FakeAllocator(monkeypatch, peak=5 * 10**9)
    assert peak_memory_bytes() == 5 * 10**9 and gauge() == 5e9
    engine = _serving(serving_model_dir, (1, 2, 4),
                      memory_budget_bytes=10**9)
    engine.start()
    engine.close()
    dec = _decode(10**9).start()
    dec.close()
    # the probes reset the allocator's counter (once a window and once
    # an event), and the process's peak is kept all the same
    assert fake.resets > 8 and fake.peak == 0
    assert peak_memory_bytes() == 5 * 10**9 and gauge() == 5e9


def test_allocator_windows_are_serialised(monkeypatch):
    """Threads probing at once (a Fleet's replicas starting) open one
    allocator window at a time, and the process's peak is the largest
    any thread's work reached."""
    import sys
    import threading

    from paddle_tpu_torch.observe import peak_memory_bytes
    from paddle_tpu_torch.observe.memory import allocator_window

    fake = _FakeAllocator(monkeypatch, peak=0)
    open_now, most, lock = [0], [0], threading.Lock()

    def probe(k):
        for i in range(50):
            with allocator_window("cuda:0") as win:
                with lock:
                    open_now[0] += 1
                    most[0] = max(most[0], open_now[0])
                fake.peak = max(fake.peak, 1000 * k + i)
                win.sample()
                with lock:
                    open_now[0] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=probe, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1
    assert peak_memory_bytes() == 1000 * 15 + 49
