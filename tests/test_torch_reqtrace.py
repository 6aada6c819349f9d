"""Per-request tracing in the port (paddle_tpu_torch/observe/reqtrace.py).

- The reference's unit tests of `RequestTrace`/`ReqTracer`
  (tests/test_observe_reqtrace.py: spans and phases, head sampling, tail
  keep, `max_spans`, the Chrome export), each run over both packages'
  modules, so the two show the same results.
- The port's DecodeEngine with a tracer at `sample_rate=0` on a pool
  sized to force preemption: only the preempted traces are kept, each
  with the preempt marker and two `join_wait` spans.
- Tracing on against off at `sample_rate=0`: the same tokens, the same
  kernel and plain-version call counts, no kernel build after warmup.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from paddle_tpu.observe import reqtrace as jax_reqtrace
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.models.decoder_lm import DecoderLM, make_prompts
from paddle_tpu_torch.observe import ReqTracer, runtime_stats
from paddle_tpu_torch.observe import reqtrace as torch_reqtrace
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

torch.set_num_threads(2)


@pytest.fixture(params=["reference", "port"])
def rt(request):
    """The reqtrace module of one package."""
    return jax_reqtrace if request.param == "reference" else torch_reqtrace


def test_port_exports_the_tracer():
    assert ReqTracer is torch_reqtrace.ReqTracer
    assert torch_reqtrace.TAIL_KEEP_MARKS == jax_reqtrace.TAIL_KEEP_MARKS


def test_trace_spans_and_phase_breakdown(rt):
    tr = rt.ReqTracer(sample_rate=1.0)
    t = tr.new_trace("decode")
    now = time.monotonic()
    t.add("join_wait", now - 0.020, now - 0.010, replica_id=0, slot=1)
    t.add("dispatch", now - 0.010, now - 0.004, kind="prefill",
          replica_id=0, slot=1)
    t.add("dispatch", now - 0.004, now, kind="decode", replica_id=0,
          slot=1, iterations=2)
    assert tr.finish(t) is True
    assert t.keep_reason == "head_sampled"
    ph = t.phase_ms()
    assert ph["join_wait"] == pytest.approx(10.0, rel=0.2)
    assert ph["dispatch"] == pytest.approx(10.0, rel=0.2)
    assert t.replica_ids() == [0]
    summ = tr.phase_summary()
    assert summ["dispatch"]["count"] == 2
    assert summ["join_wait"]["count"] == 1
    wire = t.as_dict()
    assert wire["trace_id"] == t.trace_id
    assert len(wire["spans"]) == 3
    # double finish is idempotent
    assert tr.finish(t) is True
    assert tr.snapshot()["finished"] == 1


def test_head_sampling_deterministic_and_ring_bound(rt):
    tr = rt.ReqTracer(sample_rate=0.25, capacity=8)
    kept = sum(tr.finish(tr.new_trace()) for _ in range(100))
    assert kept == 25  # deterministic 1-in-4, not probabilistic
    assert tr.snapshot()["ring_size"] == 8
    assert len(tr.traces()) == 8
    with pytest.raises(ValueError):
        rt.ReqTracer(sample_rate=1.5)
    with pytest.raises(ValueError):
        rt.ReqTracer(capacity=0)


def test_tail_keep_slow_error_and_marks(rt):
    tr = rt.ReqTracer(sample_rate=0.0, slow_keep_ms=5.0)
    assert tr.finish(tr.new_trace()) is False
    terr = tr.new_trace()
    assert tr.finish(terr, error=RuntimeError("boom")) is True
    assert terr.keep_reason == "error"
    assert terr.error == "RuntimeError: boom"
    for mark in ("failover", "hedge", "abandoned", "preempt",
                 "evacuated"):
        t = tr.new_trace()
        t.point(mark, replica_id=0)
        assert tr.finish(t) is True, mark
        assert t.keep_reason == mark
    slow = tr.new_trace()
    slow.t_create -= 0.050  # 50 ms old
    assert tr.finish(slow) is True
    assert slow.keep_reason == "slow"
    snap = tr.snapshot()
    assert snap["kept"] == snap["tail_kept"] == 7
    assert snap["errors"] == 1


def test_max_spans_bound(rt):
    tr = rt.ReqTracer(max_spans=4)
    t = tr.new_trace()
    now = time.monotonic()
    for i in range(10):
        t.add("dispatch", now, now, slot=i)
    assert len(t.spans) == 4
    assert t.dropped_spans == 6
    tr.finish(t)
    assert t.as_dict()["dropped_spans"] == 6


def test_chrome_export_rows_and_metadata(rt, tmp_path):
    tr = rt.ReqTracer()
    t = tr.new_trace("fleet_decode")
    now = time.monotonic()
    t.add("route", now, now + 0.001)                       # router row
    t.add("dispatch", now + 0.001, now + 0.005, replica_id=0)
    t.add("failover", now + 0.005, now + 0.006,
          from_replica=0, to_replica=1)                    # router row
    t.add("dispatch", now + 0.006, now + 0.010, replica_id=1)
    tr.finish(t)
    path = str(tmp_path / "trace.json")
    out = tr.export_chrome_trace(path)
    with open(path) as f:
        assert json.load(f) == out
    xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0, 1, 2}
    names = {e["pid"]: set() for e in xs}
    for e in xs:
        names[e["pid"]].add(e["name"])
        assert e["args"]["trace_id"] == t.trace_id
        assert e["dur"] >= 1.0
    assert names[0] == {"route", "failover"}
    meta = {e["args"]["name"] for e in out["traceEvents"]
            if e["ph"] == "M"}
    assert meta == {"router", "replica 0", "replica 1"}
    assert tr.export_chrome_trace(window_s=0.0)["traceEvents"] == []


def test_chrome_export_kv_transfer_flow_events(rt):
    tr = rt.ReqTracer()
    t = tr.new_trace("disagg")
    now = time.monotonic()
    t.add("dispatch", now, now + 0.004, replica_id=0)
    t.add("kv_transfer", now + 0.004, now + 0.006,
          from_replica=0, to_replica=1, pages=3, bytes=4096)
    t.add("dispatch", now + 0.006, now + 0.012, replica_id=1)
    tr.finish(t)
    evs = tr.export_chrome_trace()["traceEvents"]
    kv_x = [e for e in evs if e["ph"] == "X" and e["name"] == "kv_transfer"]
    assert len(kv_x) == 1 and kv_x[0]["pid"] == 0
    (s,), (f,) = ([e for e in evs if e["ph"] == ph] for ph in "sf")
    assert s["name"] == f["name"] == "kv_transfer"
    assert s["id"] == f["id"] and s["tid"] == f["tid"]
    assert f["bp"] == "e" and (s["pid"], f["pid"]) == (1, 2)
    assert s["ts"] < f["ts"]
    t2 = tr.new_trace("disagg")
    t2.add("kv_transfer", now, now + 0.001, from_replica=0,
           to_replica=None)
    tr.finish(t2)
    evs2 = tr.export_chrome_trace()["traceEvents"]
    assert len([e for e in evs2 if e["ph"] == "s"]) == 1


# -- the port's engine with a tracer ------------------------------------------

def _engine(tracer=None, num_pages=None, speculate_k=0):
    lm = DecoderLM(vocab_size=32, n_layer=1, n_head=2, d_model=16,
                   d_inner=32, kv_dtype="float32", seed=3)
    cfg = DecodeConfig(num_slots=2, page_size=4, max_len=32,
                       num_pages=num_pages or 16, prefill_buckets=(8,),
                       decode_chunk=2, kv_dtype="float32")
    return DecodeEngine(lm, cfg, memory_budget_bytes=False,
                        place=CPUPlace(), tracer=tracer,
                        speculate_k=speculate_k)


def test_decode_trace_tail_keeps_preemption():
    """sample_rate=0 on a pool sized to force preemption: the only kept
    traces are the preempted ones, with join_wait/dispatch spans, the
    preempt marker, and two join_wait spans (a preempted request
    re-joins)."""
    tracer = ReqTracer(sample_rate=0.0)
    eng = _engine(tracer=tracer, num_pages=9).start()
    prompts = make_prompts(4, 32, min_len=3, max_len=6, seed=1)
    futs = [eng.submit(p, max_new_tokens=18, priority=i)
            for i, p in enumerate(prompts)]
    for f in futs:
        f.result(300)
    eng.close()
    assert eng.stats.preemptions >= 1
    kept = tracer.traces()
    assert kept, "preempted traces must survive sample_rate=0"
    for t in kept:
        assert t.keep_reason == "preempt"
        names = t.span_names()
        assert "preempt" in names and "dispatch" in names, names
        assert len(t.find("join_wait")) >= 2, names
        kinds = {s.attrs["kind"] for s in t.find("dispatch")}
        assert kinds == {"prefill", "decode"}
    assert tracer.phase_summary()["join_wait"]["count"] >= \
        len(prompts) + len(kept)
    assert tracer.snapshot()["finished"] == len(prompts)


@pytest.mark.parametrize("speculate_k", [0, 4])
def test_tracing_changes_no_device_work(speculate_k):
    """Tracing at sample_rate=0 against no tracer: the same tokens, the
    same kernel launches and plain-version calls, no kernel build after
    warmup (spans are host timestamps only)."""
    prompts = make_prompts(3, 32, min_len=3, max_len=6, seed=2)

    def run(tracer):
        eng = _engine(tracer=tracer, speculate_k=speculate_k).start()
        snap = runtime_stats.snapshot()
        kernels.reset_counts()
        with eng._cv:   # all queued before the first admission: the
            #             joins do not depend on thread timing
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        outs = [f.result(300).tolist() for f in futs]
        assert eng.drain(60)
        counts = kernels.counts()
        compiles = runtime_stats.delta(snap)["compiles"]
        eng.close()
        return outs, counts, compiles, eng.stats.post_warmup_compiles()

    tracer = ReqTracer(sample_rate=0.0)
    off, on = run(None), run(tracer)
    assert on[0] == off[0]
    assert on[1] == off[1]
    assert on[1]["plain"]["paged_attention"] > 0
    assert on[2] == off[2] == 0 and on[3] == off[3] == 0
    summ = tracer.phase_summary()
    assert summ["join_wait"]["count"] == len(prompts)
    assert summ["dispatch"]["count"] >= len(prompts)
    if speculate_k:
        assert summ["speculate"]["count"] >= 1
    assert tracer.snapshot()["kept"] == 0
