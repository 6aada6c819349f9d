"""paddle_tpu_torch.observe.registry (MetricsRegistry, the collectors,
MetricsServer) and the rest of observe.events (log rotation, strict
kinds, run ids) against the JAX package on the CPU:

- each adapter collector over the same inputs gives the reference's
  Prometheus exposition text and snapshot, byte for byte (serving and
  decode stats with speculation, a fleet, a disagg fleet, request
  tracing, training telemetry, gang skew, goodput, recovery);
- the process-wide collectors (runtime, process, memory) carry the
  reference's family names and kinds, with the port's own values;
  memory reports "not available" on the CPU;
- a raising collector is isolated as `observe_collector_up 0`;
- MetricsServer's /metrics, /healthz, /alerts (404 until attached)
  routes; the ServingEngine's, Fleet's and Trainer's registries are in
  their own files;
- RunEventLog(max_bytes=) rolls like the reference's, strict kinds raise
  and warn like the reference's.
"""

from __future__ import annotations

import json
import os
import types
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observe import events as jevents
from paddle_tpu.observe import registry as jreg
from paddle_tpu.observe.monitoring import LatencyHistogram as JHist
from paddle_tpu.observe.reqtrace import ReqTracer as JTracer
from paddle_tpu.serving import DecodeStats as JDecodeStats
from paddle_tpu.serving import DisaggStats as JDisaggStats
from paddle_tpu.serving import FleetStats as JFleetStats
from paddle_tpu.serving import ServingStats as JServingStats
from paddle_tpu_torch.observe import events as tevents
from paddle_tpu_torch.observe import registry as treg
from paddle_tpu_torch.observe.monitoring import LatencyHistogram as THist
from paddle_tpu_torch.observe.reqtrace import ReqTracer as TTracer
from paddle_tpu_torch.serving import (DecodeStats, DisaggStats, FleetStats,
                                      ServingStats)

PKGS = {"port": dict(reg=treg, hist=THist, tracer=TTracer,
                     decode=DecodeStats, serving=ServingStats,
                     fleet=FleetStats, disagg=DisaggStats),
        "ref": dict(reg=jreg, hist=JHist, tracer=JTracer,
                    decode=JDecodeStats, serving=JServingStats,
                    fleet=JFleetStats, disagg=JDisaggStats)}


def _decode_stats(p):
    s = p["decode"]()
    s.configure_speculation(2)
    s.record_submit()
    s.record_submit()
    s.record_prefill(2, [12.5, 40.0])
    s.record_decode(4, 2, 4, 7, 5, 24, 3.5)
    s.record_verify(4, 3, [1, 0])
    s.record_import()
    s.record_preemption()
    s.record_done()
    return s


def _serving_stats(p):
    s = p["serving"]()
    s.record_submit(3)
    s.record_batch(2, 4, 8.0, 16.0, 5.0)
    s.record_done(11.0)
    s.record_shed()
    s.record_reload(3.25)
    return s


class _Breaker:
    state = "closed"


def _handle(rid, phase=None, dead=False):
    h = types.SimpleNamespace(replica_id=rid, inflight=rid + 1,
                              routed=3 * rid, failures=rid, dead=dead,
                              breaker=_Breaker(), phase=phase)
    h.routable = lambda: not h.dead
    return h


def _fleet(p):
    st = p["fleet"]()
    st.record_submit()
    st.record_done(4.0)
    st.record_failover()
    return types.SimpleNamespace(kind="decode", stats=st, model_version=2,
                                 replicas=[_handle(0), _handle(1, dead=True)])


def _disagg(p):
    st = p["disagg"]()
    st.record_submit()
    st.record_ttft(30.0)
    st.record_handoff(3, 1234, 2.5)
    st.record_failover("decode")
    st.record_done(50.0)
    pre, dec = _handle(0, "prefill"), _handle(1, "decode")
    merged = {"prefill": _decode_stats(p), "decode": _decode_stats(p)}
    return types.SimpleNamespace(
        stats=st, prefill=[pre], decode=[dec], model_version=1,
        workers=lambda: [pre, dec],
        merged_stats=lambda phase=None: merged[phase or "decode"])


def _tracer(p):
    tr = p["tracer"](sample_rate=1.0)
    for i in range(3):
        t = tr.new_trace("decode")
        t.add("join_wait", 0.0, 0.002 * (i + 1), replica_id=0)
        t.add("dispatch", 0.0, 0.010, replica_id=0, kind="prefill")
        tr.finish(t)
    return tr


def _telemetry():
    return types.SimpleNamespace(
        steps=10, loss_last=2.5, loss_mean=2.75, grad_norm_last=1.5,
        update_norm_last=0.25, loss_scale=32768.0, nonfinite_grad_steps=1,
        nonfinite_loss_steps=0, skipped_update_steps=1,
        groups={"fc_0": {"grad_norm": 1.0, "param_norm": 4.0,
                         "update_ratio": 0.01},
                "emb": {"grad_norm": 0.5, "param_norm": 2.0}})


_GOODPUT = {"wall_s": 10.0, "goodput": 0.75, "steps": 8, "replay_steps": 1,
            "fractions": {"step": 0.75, "compile": 0.2, "idle": 0.05},
            "categories_s": {"step": 7.5, "compile": 2.0, "idle": 0.5},
            "mean_step_s": 0.9375, "effective_mfu": None,
            "straggler_est_s": None}
_RECOVERY = {"rollbacks": 1, "budget": 3, "halted": 0, "skip_streak": 2,
             "quarantined_batches": 4, "quarantine_windows": 1,
             "verified_serials": 2}
_SKEW = {"steps": {0: 10, 1: 8}, "rates": {0: 2.0, 1: 1.5},
         "max_lag_steps": 2, "median_rate": 1.75, "slow_ranks": [1]}

COLLECTORS = {
    "decode_stats": lambda p: p["reg"].serving_stats_collector(
        _decode_stats(p), scope="engine"),
    "decode_stats_callable": lambda p: p["reg"].serving_stats_collector(
        lambda: _decode_stats(p), scope="fleet"),
    "serving_stats": lambda p: p["reg"].serving_stats_collector(
        _serving_stats(p)),
    "fleet": lambda p: p["reg"].fleet_collector(_fleet(p)),
    "disagg": lambda p: p["reg"].disagg_collector(_disagg(p)),
    "tracer": lambda p: p["reg"].tracer_collector(_tracer(p), job="x"),
    "telemetry": lambda p: p["reg"].telemetry_collector(_telemetry),
    "telemetry_none": lambda p: p["reg"].telemetry_collector(lambda: None),
    "gang": lambda p: p["reg"].gang_collector(lambda: _SKEW, job="g"),
    "goodput": lambda p: p["reg"].goodput_collector(lambda: _GOODPUT),
    "goodput_none": lambda p: p["reg"].goodput_collector(lambda: None),
    "recovery": lambda p: p["reg"].recovery_collector(lambda: _RECOVERY),
    "recovery_none": lambda p: p["reg"].recovery_collector(lambda: None),
}


def _registry(p, name):
    reg = p["reg"].MetricsRegistry()
    reg.register(name, COLLECTORS[name](p))
    return reg


@pytest.mark.parametrize("name", sorted(COLLECTORS))
def test_exposition_equals_the_reference(name):
    got, want = (_registry(PKGS[k], name) for k in ("port", "ref"))
    text = got.prometheus_text()
    assert text == want.prometheus_text()
    assert got.snapshot() == want.snapshot()
    assert "observe_collector_up" in text


def test_histogram_le_buckets_are_the_histogram_prefix_sums():
    h = THist()
    for v in (0.5, 1.0, 2.0, 2.0, 150.0):
        h.record(v)
    reg = treg.MetricsRegistry().register(
        "h", lambda: [treg.histogram("lat_ms", "latency", h)])
    fam = reg.snapshot()["lat_ms"]["samples"][0]
    assert fam["count"] == 5 and fam["buckets"][-1][1] == 5
    cums = [c for _, c in fam["buckets"]]
    assert cums == sorted(cums)
    assert 'lat_ms_bucket{le="+Inf"} 5' in reg.prometheus_text()


@pytest.mark.parametrize("name", ["runtime", "process", "memory"])
def test_process_wide_families_are_the_reference_names(name):
    fn = f"{name}_collector"
    got = {f.name: f.kind for f in getattr(treg, fn)()()}
    want = {f.name: f.kind for f in getattr(jreg, fn)()()}
    if name == "process":       # ru_maxrss is platform-dependent in both
        got.pop("process_max_rss_bytes", None)
        want.pop("process_max_rss_bytes", None)
    assert got == want


def test_memory_not_available_on_the_cpu():
    snap = treg.metrics_snapshot()
    assert snap["memory_stats_available"]["samples"][0]["value"] == 0
    assert snap["memory_peak_bytes"]["samples"] == []
    assert snap["memory_budget_bytes"]["samples"] == []
    assert sorted(treg.default_registry.collector_names()) == \
        ["memory", "process", "runtime"]


def test_sick_collector_is_isolated():
    reg = treg.standard_collectors(treg.MetricsRegistry())

    def boom():
        raise RuntimeError("sick")

    reg.register("sick", boom)
    up = {s["labels"]["collector"]: s["value"]
          for s in reg.snapshot()["observe_collector_up"]["samples"]}
    assert up == {"memory": 1.0, "process": 1.0, "runtime": 1.0,
                  "sick": 0.0}
    reg.unregister("sick")
    assert "sick" not in reg.collector_names()


def test_family_validation():
    with pytest.raises(ValueError):
        treg.MetricFamily("bad-name", "gauge")
    with pytest.raises(ValueError):
        treg.MetricFamily("x", "summary")
    with pytest.raises(ValueError):
        treg.gauge("x").add_histogram(THist())
    with pytest.raises(ValueError):
        treg.histogram("x").add(1.0)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_metrics_server_routes():
    reg = treg.standard_collectors(treg.MetricsRegistry())
    srv = treg.MetricsServer(reg, health_fn=lambda: {"ok": 1}).start()
    try:
        status, ctype, body = _get(srv.url + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "runtime_xla_compiles_total" in body
        assert json.loads(_get(srv.url + "/healthz")[2]) == {"ok": 1}
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url + "/alerts")
        srv.alerts_fn = lambda: {"firing": ["r"]}
        assert json.loads(_get(srv.url + "/alerts")[2]) == {"firing": ["r"]}
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url + "/nope")
    finally:
        srv.close()
    assert srv.host == "127.0.0.1" and srv.port > 0


def _records(path):
    return [r["event"] for r in tevents.read_events(path)]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_event_log_rotation(tmp_path, pkg):
    ev = tevents if pkg == "port" else jevents
    path = str(tmp_path / "run.jsonl")
    with pytest.raises(ValueError):
        ev.RunEventLog(path, max_bytes=100)
    log = ev.RunEventLog(path, max_bytes=1024, run_id="abc")
    for i in range(12):
        log.event("serving_window", i=i, pad="x" * 100)
    log.close()
    assert log.rotations >= 1
    first = _records(path)
    assert first[0] == "run_rotate"
    assert first[-1] == "run_end"
    rolled = _records(path + ".1")
    assert set(rolled) <= {"run_begin", "serving_window", "run_rotate"}
    assert os.path.getsize(path) <= 1024


def test_strict_kinds_and_registration(tmp_path):
    log = tevents.RunEventLog(str(tmp_path / "k.jsonl"))
    with pytest.raises(ValueError, match="not registered"):
        log.event("serving_typo_kind")
    prev = tevents.set_strict_kinds(False)
    try:
        with pytest.warns(UserWarning, match="not registered"):
            log.event("serving_typo_kind2")
    finally:
        tevents.set_strict_kinds(prev)
    tevents.register_event_kinds("serving_custom_kind")
    log.event("serving_custom_kind")
    for kinds in ("DISAGG_EVENTS", "ALERT_EVENTS", "FLIGHT_EVENTS"):
        assert getattr(tevents, kinds) == getattr(jevents, kinds)
        for k in getattr(tevents, kinds):
            log.event(k)
    log.close()
    recs = tevents.read_events(str(tmp_path / "k.jsonl"))
    assert "git_sha" in recs[0] and recs[0]["event"] == "run_begin"
    rid = tevents.new_run_id()
    assert len(rid) == 12 and int(rid, 16) >= 0
    assert tevents.git_sha(cwd=str(tmp_path)) is None
