"""paddle_tpu_torch.observe.alerts (AlertEngine, the rules, the rule
packs) and observe.flightrec (FlightRecorder) against the JAX package on
the CPU:

- each rule's state machine under an injected clock and scripted
  snapshots walks the reference's transitions step for step, with the
  reference's values (threshold with hysteresis and for/resolve
  durations, counter rates, multiwindow burn rates, anomaly z-scores
  with a frozen baseline, "no data" holding state);
- an AlertEngine over a registry: the same transition events (strict
  kinds), signals(), state() and the `alerts` exposition as the
  reference's engine; rule-error isolation; the background thread;
- the five rule packs' rule ids, kinds, targets and severities equal the
  reference's;
- a FlightRecorder bundle's file map and manifest equal the reference's
  for the same sources, with the rate limit, count cap, byte budget,
  watchdog and crash hooks as the reference's.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

import pytest

from paddle_tpu.observe import alerts as ja
from paddle_tpu.observe import events as jevents
from paddle_tpu.observe import flightrec as jflight
from paddle_tpu.observe import registry as jreg
from paddle_tpu_torch.observe import alerts as ta
from paddle_tpu_torch.observe import events as tevents
from paddle_tpu_torch.observe import flightrec as tflight
from paddle_tpu_torch.observe import registry as treg

MODS = {"port": (ta, tevents, tflight, treg),
        "ref": (ja, jevents, jflight, jreg)}


def _fam(kind, value):
    return {"kind": kind, "help": "",
            "samples": [{"labels": {}, "value": value}]}


def _g(name, v):
    return {name: _fam("gauge", v)}


def _c(name, v):
    return {name: _fam("counter", v)}


def _ratio(bad, tot):
    return {"bad": _fam("counter", bad), "tot": _fam("counter", tot)}


def _hist(p99_edge_counts):
    return {"lat_ms": {"kind": "histogram", "help": "", "samples": [
        {"labels": {"phase": "a"}, "count": p99_edge_counts[-1][1],
         "sum_ms": 0.0, "buckets": [list(x) for x in p99_edge_counts]}]}}


SCENARIOS = {
    "threshold_hysteresis": (
        lambda m: m.ThresholdRule("hot", "load", op=">", threshold=5.0,
                                  clear=3.0),
        [(_g("load", v), t) for t, v in
         enumerate([1.0, 10.0, 4.0, 2.0, 6.0])]),
    "threshold_for_resolve_durations": (
        lambda m: m.ThresholdRule("hot", "load", threshold=5.0,
                                  for_duration_s=2.0,
                                  resolve_duration_s=1.0),
        [(_g("load", v), t) for t, v in
         [(0.0, 9.0), (1.0, 9.0), (2.5, 9.0), (3.0, 1.0), (4.5, 1.0)]]),
    "threshold_pending_unbreach": (
        lambda m: m.ThresholdRule("hot", "load", threshold=5.0,
                                  for_duration_s=10.0),
        [(_g("load", v), t) for t, v in
         [(0.0, 9.0), (1.0, 1.0), (2.0, 9.0), (5.0, 9.0), (13.0, 9.0)]]),
    "no_data_holds": (
        lambda m: m.ThresholdRule("hot", "load", threshold=5.0),
        [(_g("load", 10.0), 0.0), ({}, 1.0), (_g("load", 1.0), 2.0)]),
    "threshold_rate_window": (
        lambda m: m.ThresholdRule("fo", "fleet_failovers_total", op=">",
                                  threshold=0.0, window_s=60.0),
        [(_c("fleet_failovers_total", v), t) for t, v in
         [(0.0, 0), (1.0, 0), (2.0, 1), (30.0, 1), (63.0, 1)]]),
    "histogram_percentile": (
        lambda m: m.ThresholdRule(
            "p99", m.MetricSelector("lat_ms", labels={"phase": "a"},
                                    percentile=99),
            op=">", threshold=50.0, clear=40.0),
        [(_hist([(10.0, 5), (100.0, 6)]), 0.0),
         (_hist([(10.0, 500), (100.0, 501)]), 1.0)]),
    "burn_rate": (
        lambda m: m.BurnRateRule("err", "bad", "tot", slo=0.01,
                                 long_window_s=300.0, short_window_s=30.0),
        [(_ratio(b, n), t) for t, b, n in
         [(0.0, 0, 0), (10.0, 0, 100), (20.0, 5, 200), (55.0, 5, 400)]]),
    "burn_rate_spike": (
        lambda m: m.BurnRateRule("err", "bad", "tot", slo=0.5,
                                 long_window_s=100.0, short_window_s=10.0),
        [(_ratio(b, n), t) for t, b, n in
         [(0.0, 0, 0), (1.0, 9, 10), (16.0, 9, 1000), (30.0, 9, 1001)]]),
    "anomaly_above": (
        lambda m: m.AnomalyRule("loss", "training_loss_mean", z=4.0,
                                direction="above", min_samples=3,
                                min_std=0.01),
        [(_g("training_loss_mean", v), float(t)) for t, v in
         enumerate([1.0, 1.1, 0.9, 5.0, 5.0, 1.0])]),
    "anomaly_below_rate": (
        lambda m: m.AnomalyRule("tput", "goodput_steps_total", z=3.0,
                                direction="below", rate=True,
                                window_s=100.0, min_samples=3,
                                min_std=0.01),
        [(_c("goodput_steps_total", v), float(t)) for t, v in
         enumerate([0, 10, 20, 30, 40, 40, 40])]),
    "anomaly_both": (
        lambda m: m.AnomalyRule("gn", "g", z=2.0, direction="both",
                                min_samples=2, min_std=0.1),
        [(_g("g", v), float(t)) for t, v in
         enumerate([1.0, 1.2, 1.1, -3.0, 1.0])]),
}


def _walk(m, name):
    make, script = SCENARIOS[name]
    rule = make(m)
    return [(rule.step(snap, now), rule.state, rule.value,
             rule.fired_count) for snap, now in script], rule.as_dict()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rule_walks_the_reference_transitions(name):
    got, want = _walk(ta, name), _walk(ja, name)
    assert got == want
    kinds = {t for t, *_ in got[0]}
    assert kinds - {None} <= set(tevents.ALERT_EVENTS)


def test_rule_argument_errors():
    with pytest.raises(ValueError, match="op"):
        ta.ThresholdRule("x", "load", op="!=", threshold=1.0)
    with pytest.raises(TypeError, match="source"):
        ta.ThresholdRule("x", 123, threshold=1.0)
    with pytest.raises(ValueError, match="rule_id"):
        ta.ThresholdRule("", "load", threshold=1.0)
    with pytest.raises(ValueError, match="slo"):
        ta.BurnRateRule("x", "bad", "tot", slo=0.0)
    with pytest.raises(ValueError, match="direction"):
        ta.AnomalyRule("x", "v", direction="sideways")
    with pytest.raises(ValueError, match="histogram"):
        ta.snapshot_value(_hist([(1.0, 1)]), "lat_ms")
    assert repr(ta.MetricSelector("f", {"a": 1}, 99)) == \
        repr(ja.MetricSelector("f", {"a": 1}, 99))


class _Registry:
    def __init__(self):
        self.snap = _g("load", 1.0)

    def snapshot(self):
        if isinstance(self.snap, Exception):
            raise self.snap
        return self.snap


def _engine_run(pkg, path):
    m, ev, _, reg_mod = MODS[pkg]
    log = ev.RunEventLog(path)
    reg = _Registry()
    eng = m.AlertEngine(reg, rules=[
        m.ThresholdRule("hot", "load", threshold=5.0, clear=3.0),
        m.ThresholdRule("slow", "load", threshold=7.0, for_duration_s=1.0,
                        severity="ticket")], event_log=log)
    fired = []
    eng.add_firing_hook(lambda r, rec: fired.append(rec["rule"]))
    out = []
    for t, v in enumerate([1.0, 8.0, 8.0, 2.0]):
        reg.snap = _g("load", v)
        out.append([(r.id, k) for r, k in eng.evaluate(now=float(t))])
    reg.snap = RuntimeError("sick")
    out.append(eng.evaluate(now=9.0))
    log.close()
    text = reg_mod.MetricsRegistry().register(
        "alerts", eng.collector()).prometheus_text()
    state = eng.state()
    state.pop("last_eval_ts")
    return (out, fired, eng.signals(), state, text,
            [(r["event"], r.get("rule"), r.get("state"))
             for r in ev.read_events(path) if r["event"].startswith("alert")])


def test_engine_equals_the_reference(tmp_path):
    got = _engine_run("port", str(tmp_path / "t.jsonl"))
    want = _engine_run("ref", str(tmp_path / "j.jsonl"))
    assert got == want
    out, fired, signals, state, text, events = got
    assert out[1] == [("hot", "alert_firing"), ("slow", "alert_pending")]
    assert fired == ["hot", "slow"]
    assert state["eval_errors"] == 1 and state["evaluations"] == 4
    assert 'alerts_fired_total{rule="hot",severity="page"} 1' in text
    assert signals["slow"]["severity"] == "ticket"


def test_engine_rule_isolation_duplicates_and_thread():
    class Bad(ta.AlertRule):
        def observe(self, snapshot, now):
            raise RuntimeError("bad rule")

    reg = _Registry()
    eng = ta.AlertEngine(reg, rules=[Bad("bad"), ta.ThresholdRule(
        "hot", "load", threshold=0.5)], interval_s=0.01)
    assert [(r.id, k) for r, k in eng.evaluate(now=0.0)] == \
        [("hot", "alert_firing")]
    assert eng.eval_errors == 1 and eng.firing() == ["hot"]
    with pytest.raises(ValueError, match="duplicate"):
        eng.add_rule(ta.ThresholdRule("hot", "load"))
    eng.remove_rule("bad")
    assert [r.id for r in eng.rules] == ["hot"]
    with eng:
        assert eng.running
        deadline = time.monotonic() + 5
        while eng.evaluations < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert not eng.running and eng.evaluations >= 3


PACKS = {
    "fleet": lambda m: m.fleet_rule_pack(
        types.SimpleNamespace(replicas=[0, 1, 2]), ttft_p99_ms=900.0),
    "fleet_none": lambda m: m.fleet_rule_pack(),
    "serving": lambda m: m.serving_rule_pack(e2e_p99_ms=250.0),
    "disagg": lambda m: m.disagg_rule_pack(handoff_p99_ms=50.0),
    "speculate": lambda m: m.speculate_rule_pack(min_efficiency=0.5),
    "trainer": lambda m: m.trainer_rule_pack(goodput_floor=0.6),
}


def _pack(m, name):
    return [(type(r).__name__, r.as_dict(), getattr(r, "threshold", None),
             getattr(r, "clear", None), getattr(r, "windows", None),
             repr(getattr(r, "value_fn", None)))
            for r in PACKS[name](m)]


@pytest.mark.parametrize("name", sorted(PACKS))
def test_rule_packs_equal_the_reference(name):
    got, want = _pack(ta, name), _pack(ja, name)
    # a callable source's repr names its module: compare the rest
    strip = [(a, b, c, d, e, f if "Selector" in f else "fn")
             for a, b, c, d, e, f in got]
    assert strip == [(a, b, c, d, e, f if "Selector" in f else "fn")
                     for a, b, c, d, e, f in want]
    assert len({r[1]["id"] for r in got}) == len(got)


def test_packs_silent_without_data_and_fire_on_their_metrics():
    rules = {r.id: r for r in ta.disagg_rule_pack(prefill_wait_p99_ms=10.0)}
    for r in rules.values():
        assert r.step({}, 0.0) is None and r.state == "inactive"
    snap = {"disagg_prefill_wait_ms": {"kind": "histogram", "help": "",
                                       "samples": [{"labels": {},
                                                    "count": 2,
                                                    "sum_ms": 0.0,
                                                    "buckets": [[5.0, 1],
                                                                [40.0, 2]]}]},
            "serving_post_warmup_compiles": _fam("gauge", 1)}
    assert rules["disagg_prefill_wait_p99"].step(snap, 1.0) == \
        "alert_firing"
    assert rules["serving_post_warmup_compiles"].step(snap, 1.0) == \
        "alert_firing"


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sources(pkg, d):
    m, ev, fl, reg_mod = MODS[pkg]
    log = ev.RunEventLog(os.path.join(d, "events.jsonl"))
    log.event("serving_window", completed=3)
    reg = reg_mod.MetricsRegistry().register(
        "g", lambda: [reg_mod.gauge("load", "load", 2.0)])
    eng = m.AlertEngine(reg, rules=[m.ThresholdRule("hot", "load",
                                                    threshold=1.0)])
    tel = types.SimpleNamespace(first_nonfinite_op={"type": "mul"},
                                nonfinite_grad_steps=1,
                                nonfinite_loss_steps=0,
                                skipped_update_steps=1, loss_scale=2.0)
    wd = types.SimpleNamespace(step_deadline_s=5.0, compile_grace_s=60.0,
                               regions=[{"what": "step", "s": 0.1}])
    return log, reg, eng, tel, wd


def _bundle(pkg, d):
    m, ev, fl, _ = MODS[pkg]
    log, reg, eng, tel, wd = _sources(pkg, d)
    clock = _Clock()
    rec = fl.FlightRecorder(os.path.join(d, "flight"), registry=reg,
                            event_log=log, telemetry_fetch=lambda: tel,
                            watchdog=wd, min_interval_s=10.0,
                            max_bundles=2, clock=clock)
    rec.attach_engine(eng)
    eng.evaluate(now=0.0)                # fires: the first bundle
    assert rec.record("manual") is None  # rate-limited
    clock.t = 11.0
    order = []
    hook = rec.watchdog_hook(lambda f: order.append(("prior", len(
        rec.bundles))))
    hook({"kind": "step", "what": "x"})
    assert order == [("prior", 2)]       # captured before the prior hook
    clock.t = 30.0
    assert rec.record("over", force=True) is None   # the count cap
    log.close()
    bundles = []
    for b in rec.bundles:
        with open(os.path.join(b, "MANIFEST.json")) as f:
            man = json.load(f)
        for k in ("ts", "monotonic"):
            man.pop(k)
        man["files"] = sorted(man["files"])
        man["context"].pop("what", None)
        bundles.append((os.path.basename(b), man,
                        sorted(os.listdir(b))))
    return bundles, rec.snapshot()["suppressed"]


def test_flight_bundles_equal_the_reference(tmp_path):
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    got = _bundle("port", str(tmp_path / "t"))
    want = _bundle("ref", str(tmp_path / "j"))
    assert got == want
    (name, man, files), _ = got[0][0], got[1]
    assert name == "bundle_001_alert_hot"
    assert set(files) == {"MANIFEST.json", "events_tail.jsonl",
                          "metrics.json", "alerts.json", "numerics.json",
                          "watchdog.json", "stacks.txt"}
    assert man["errors"] == {} and not man["truncated"]
    assert got[1] == 2


def test_flight_byte_budget_errors_and_crash_hooks(tmp_path):
    reg = treg.MetricsRegistry().register(
        "g", lambda: [treg.gauge("load", "x" * 2000, 1.0)])

    def boom():
        raise RuntimeError("dead source")

    rec = tflight.FlightRecorder(str(tmp_path), registry=reg,
                                 telemetry_fetch=boom,
                                 max_bundle_bytes=1500)
    b = rec.record("tiny")
    with open(os.path.join(b, "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["truncated"] and man["files"]["metrics.json"] == 1500
    assert "stacks.txt" in man["skipped"]
    assert man["errors"]["numerics.json"].startswith("RuntimeError")
    prev = sys.excepthook
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    try:
        rec.install_crash_hooks()
        try:
            raise KeyError("boom")
        except KeyError:
            sys.excepthook(*sys.exc_info())
        assert seen == [KeyError]
        assert os.path.basename(rec.bundles[-1]) == "bundle_002_crash"
        rec.close()
        assert not rec._crash_hooks_installed
    finally:
        sys.excepthook = prev
