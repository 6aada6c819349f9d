"""paddle_tpu_torch.serving.Fleet and the DecodeEngine's fleet surface
(set_replica_id, evacuate, reload) against the JAX package, on the CPU,
with the reference's tiny LM of tests/test_fleet.py (vocab 48, 2
layers, d_model 32, float32 KV) and its PROMPTS and BUDGETS, the port's
engines holding the reference's weights (convert.params_from_arrays):

- a replica killed mid-generation (`chaos.kill_replica`): every token of
  every response equals the REFERENCE's uninterrupted control, with
  zero client failures, the committed prefixes verified, zero
  post-warmup compiles fleet-wide, the dead replica ejected, and one
  trace across both replicas;
- a hot reload under load to the same weights leaves the tokens
  unchanged with zero compiles and tags the new version; a reload to
  DIFFERENT weights (a sharded checkpoint the reference wrote) gives the
  tokens the reference's engine gives after the same reload;
- evacuation descriptors, a scheduler death resolving every future with
  the structured retryable error, a mismatched-shape reload refused;
- the saturated fleet's structured fast reject; a hedge beating a
  `chaos.delay_replica` straggler;
- `DecodeStats`, `ServingStats` and `LatencyHistogram` merges equal the
  reference's;
- a ServingEngine fleet over a saved MLP survives failover and reload.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.models.decoder_lm import DecoderLM as JaxLM
from paddle_tpu.models.decoder_lm import make_prompts
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import AnalysisConfig
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models.decoder_lm import DecoderLM as TorchLM
from paddle_tpu_torch.observe import ReqTracer
from paddle_tpu_torch.observe.monitoring import LatencyHistogram
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (BucketConfig, DecodeConfig,
                                      DecodeEngine,
                                      DecodeReplicaFailedError, DecodeStats,
                                      Fleet, FleetClosedError, FleetConfig,
                                      FleetSaturatedError,
                                      ServingClosedError, ServingEngine,
                                      ServingStats, WeightReloadError)

torch.set_num_threads(2)

VOCAB = 48
PROMPTS = make_prompts(6, VOCAB, min_len=3, max_len=8, seed=21)
BUDGETS = [14, 12, 16, 11, 14, 12]
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner=64,
            kv_dtype="float32", seed=7)
CFG = dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
           prefill_buckets=(8,), decode_chunk=2, kv_dtype="float32")
AFTER = 6   # tokens generated per prompt after the reload to new weights


def _perturbed(arrays):
    rng = np.random.RandomState(5)
    return {n: (a + rng.normal(0, 0.05, a.shape).astype(a.dtype)
                if a.dtype.kind == "f" else a) for n, a in arrays.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's control tokens, a sharded checkpoint of other
    weights written by the reference, and the reference engine's tokens
    after reloading it."""
    from paddle_tpu.core.executor import Executor, scope_guard

    jlm = JaxLM(**ARCH)
    arrays = {n: np.asarray(v) for n, v in jlm.init_params().vars.items()
              if v is not None and n != "__rng_key__"}
    ckpt = str(tmp_path_factory.mktemp("fleet_ckpt"))
    scope = jf.Scope()
    for n, a in _perturbed(arrays).items():
        scope.set_var(n, a)
    with scope_guard(scope):
        jf.io.save_sharded(Executor(), ckpt, main_program=jlm.step["main"])
    eng = jdecode.DecodeEngine(jlm, jdecode.DecodeConfig(**CFG),
                               memory_budget_bytes=False).start()
    control = [eng.generate(p, max_new_tokens=b, timeout_s=300).tolist()
               for p, b in zip(PROMPTS, BUDGETS)]
    eng.reload(ckpt)
    after = [eng.generate(p, max_new_tokens=AFTER, timeout_s=300).tolist()
             for p in PROMPTS[:3]]
    eng.close()
    return {"arrays": arrays, "control": control, "ckpt": ckpt,
            "after": after}


@pytest.fixture(scope="module")
def lm():
    return TorchLM(**ARCH)


def _engine(lm, ref, cfg=None, **kw):
    return DecodeEngine(
        lm, DecodeConfig(**(cfg or CFG)), memory_budget_bytes=False,
        place=CPUPlace(),
        params=params_from_arrays(ref["arrays"], "cpu",
                                  program=lm.step["main"]), **kw)


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos.clear()


def _wait_tokens(engine, n=2):
    deadline = time.monotonic() + 60
    while (engine.stats.tokens_generated < n
           and time.monotonic() < deadline):
        time.sleep(0.002)


def test_replica_kill_keeps_the_reference_control_tokens(lm, ref):
    tracer = ReqTracer(sample_rate=1.0)
    engines = [_engine(lm, ref), _engine(lm, ref)]
    fleet = Fleet(engines, FleetConfig(), tracer=tracer).start()
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    _wait_tokens(engines[0])
    chaos.kill_replica(engines[0])
    resps = [f.result(300) for f in futs]
    snap = fleet.snapshot()
    assert [r.tokens.tolist() for r in resps] == ref["control"]
    assert snap["failed"] == 0 and snap["failovers"] >= 1, snap
    assert snap["parity_checked"] >= 1 and snap["parity_failed"] == 0
    assert snap["ejects"] == 1 and snap["post_warmup_compiles"] == 0
    assert fleet.replicas[0].dead and not fleet.replicas[1].dead
    assert all(r.replica_id == 1 for r in resps if r.failovers)
    killed = next(r for r in resps if r.failovers >= 1)
    assert 0 in killed.hops and killed.hops[-1] == 1, killed.hops
    t = tracer.trace(killed.trace_id)
    assert {0, 1} <= set(t.replica_ids()), t.span_names()
    hop = t.find("failover")[0].attrs
    assert hop["from_replica"] == 0 and hop["to_replica"] == 1
    assert fleet.health()["healthy_replicas"] == 1
    fleet.close()
    with pytest.raises(FleetClosedError):
        fleet.submit(PROMPTS[0])


def test_hot_reload_under_load_same_then_other_weights(lm, ref):
    engines = [_engine(lm, ref), _engine(lm, ref)]
    fleet = Fleet(engines, FleetConfig()).start()
    same = {n: t.clone() for n, t in engines[0]._params.items()}
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    info = fleet.reload(same)
    assert [f.result(300).tokens.tolist() for f in futs] == ref["control"]
    assert info["version"] == 1 and info["compiles"] == 0
    snap = fleet.snapshot()
    assert snap["failed"] == 0 and snap["reloads"] == 2
    assert snap["post_warmup_compiles"] == 0
    post = fleet.generate(PROMPTS[0], max_new_tokens=4, timeout_s=300)
    assert post.model_version == 1
    assert post.tokens.tolist() == ref["control"][0][:4]

    # other weights, from the reference's sharded checkpoint: the
    # reference engine's tokens after the same reload
    info = fleet.reload(ref["ckpt"])
    assert info["version"] == 2 and info["compiles"] == 0
    after = [fleet.generate(p, max_new_tokens=AFTER, timeout_s=300)
             for p in PROMPTS[:3]]
    assert [r.tokens.tolist() for r in after] == ref["after"]
    assert all(r.model_version == 2 for r in after)
    assert ref["after"] != [c[:AFTER] for c in ref["control"][:3]]
    assert all(e.model_version == 2 for e in engines)
    assert fleet.snapshot()["post_warmup_compiles"] == 0
    # the metrics and alerts plane: the router and the fleet-merged
    # engine stats at scrape time, the fleet rule pack
    snap = fleet.metrics_registry().snapshot()
    assert snap["fleet_reloads_total"]["samples"][0]["value"] == \
        fleet.snapshot()["reloads"]
    assert snap["serving_post_warmup_compiles"]["samples"][0]["value"] == 0
    assert {s["labels"]["replica_id"]
            for s in snap["fleet_replica_up"]["samples"]} == {0, 1}
    alerts = fleet.enable_alerts(start=False)
    alerts.evaluate()
    assert alerts.signals()["fleet_replicas_down"]["value"] == 2
    srv = fleet.start_metrics_server()
    assert srv.alerts_fn == alerts.state
    fleet.close()
    assert fleet._metrics_server is None


def test_evacuate_returns_requeueable_descriptors(lm, ref):
    eng = _engine(lm, ref).start()
    futs = [eng.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS[:3], BUDGETS[:3])]
    _wait_tokens(eng)
    descs = eng.evacuate()
    assert len(descs) == 3
    for f, d, p, b in zip(futs, descs, PROMPTS[:3], BUDGETS[:3]):
        wire = f.exception(timeout=10).as_dict()
        assert wire["error"] == "decode_replica_failed"
        assert wire["retryable"] is True and wire["reason"] == "evacuated"
        assert wire["descriptor"]["prompt"] == [int(t) for t in p]
        assert wire["descriptor"]["max_new_tokens"] == b
        assert (wire["descriptor"]["committed_tokens"]
                == len(wire["descriptor"]["generated"]))
    assert eng.stats.snapshot()["evacuations"] == 3
    d0 = max(descs, key=lambda d: d["committed_tokens"])
    i = [list(map(int, p)) for p in PROMPTS].index(d0["prompt"])
    regen = eng.generate(np.asarray(d0["prompt"]),
                         max_new_tokens=d0["max_new_tokens"],
                         timeout_s=300).tolist()
    assert regen == ref["control"][i]
    assert regen[:d0["committed_tokens"]] == d0["generated"]
    eng.close()


def test_scheduler_death_and_refused_reloads(lm, ref):
    eng = _engine(lm, ref)
    eng.set_replica_id(7)
    eng.start()
    futs = [eng.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS[:2], BUDGETS[:2])]
    chaos.kill_replica(eng)
    for f in futs:
        exc = f.exception(timeout=60)
        assert isinstance(exc, DecodeReplicaFailedError)
        wire = exc.as_dict()
        assert wire["retryable"] is True
        assert wire["reason"] == "scheduler_failed"
        assert "ChaosKilled" in wire["cause"] and wire["replica_id"] == 7
    with pytest.raises(ServingClosedError):
        eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.close()

    eng = _engine(lm, ref).start()
    before = eng.generate(PROMPTS[0], max_new_tokens=3,
                          timeout_s=300).tolist()
    bad = {n: np.zeros((3, 3), np.float32) for n in eng._params}
    with pytest.raises(WeightReloadError) as e:
        eng.reload(bad)
    wire = e.value.as_dict()
    assert wire["error"] == "weight_reload" and wire["mismatched"]
    with pytest.raises(WeightReloadError, match="missing"):
        eng.reload({})
    assert eng.model_version == 0
    assert eng.generate(PROMPTS[0], max_new_tokens=3,
                        timeout_s=300).tolist() == before
    # refused while a generation holds a slot (it has produced a token)
    fut = eng.submit(PROMPTS[2], max_new_tokens=36)
    _wait_tokens(eng, eng.stats.tokens_generated + 1)
    with pytest.raises(WeightReloadError, match="evacuate"):
        eng.reload(dict(eng._params))
    fut.result(300)
    eng.close()


def test_saturated_fleet_fast_rejects_structured(lm, ref):
    cfg = dict(CFG, num_slots=1, num_pages=12, prefill_buckets=(8, 16))
    engines = [_engine(lm, ref, cfg, queue_capacity=1) for _ in range(2)]
    fleet = Fleet(engines, FleetConfig()).start()
    futs = [fleet.submit(p, max_new_tokens=20) for p in PROMPTS[:2]]
    with pytest.raises(FleetSaturatedError) as e:
        fleet.submit(PROMPTS[2], max_new_tokens=20)
    wire = e.value.as_dict()
    assert wire["error"] == "fleet_saturated"
    assert {r["reject"] for r in wire["rejects"]} == {"queue_full"}
    assert len(wire["replicas"]) == 2
    assert fleet.stats.snapshot()["saturated"] == 1
    assert all(len(f.result(300).tokens) == 20 for f in futs)
    fleet.close()


def test_hedge_beats_a_straggler(lm, ref):
    tracer = ReqTracer(sample_rate=1.0)
    engines = [_engine(lm, ref), _engine(lm, ref)]
    fleet = Fleet(engines, FleetConfig(hedge_after_ms=100),
                  tracer=tracer).start()
    chaos.delay_replica(engines[0], 1.5)
    t0 = time.monotonic()
    resp = fleet.generate(PROMPTS[0], max_new_tokens=4, timeout_s=300)
    elapsed = time.monotonic() - t0
    assert resp.tokens.tolist() == ref["control"][0][:4]
    assert resp.replica_id == 1 and resp.hedged
    assert elapsed < 1.4, f"hedge did not beat the straggler: {elapsed}"
    snap = fleet.stats.snapshot()
    assert snap["hedges"] >= 1 and snap["hedge_wins"] >= 1
    fleet.close()
    t = tracer.trace(resp.trace_id)
    assert t.has("hedge")
    assert t.find("complete")[0].attrs["replica_id"] == 1
    assert t.find("abandoned")[0].attrs["replica_id"] == 0


def _record_decode(stats_cls):
    a, b = stats_cls(), stats_cls()
    a.record_submit()
    b.record_submit()
    b.record_submit()
    a.record_prefill(2, [1.0, 2.0])
    b.record_prefill(1, [3.0])
    a.record_decode(4, 2, 2, 6, 5, 10, 12.0)
    b.record_decode(2, 1, 2, 2, 8, 10, 4.0)
    a.record_preemption()
    a.record_import()
    b.record_import(2)
    b.record_reload(7.5)
    return a.merge(b).snapshot()


def _record_serving(stats_cls):
    a, b = stats_cls(), stats_cls()
    for s_ in (a, b):
        s_.record_submit(3)
        s_.record_batch(2, 4, 8.0, 16.0, 5.0)
        s_.record_done(11.0)
    b.record_shed()
    b.record_reload(3.25)
    return a.merge(b).snapshot()


def test_stats_merges_equal_the_reference():
    from paddle_tpu.observe.monitoring import LatencyHistogram as JHist
    from paddle_tpu.serving import DecodeStats as JDecodeStats
    from paddle_tpu.serving import ServingStats as JServingStats

    got, want = _record_decode(DecodeStats), _record_decode(JDecodeStats)
    assert got == want and got["imports"] == 3
    assert got["slot_occupancy"] == round(10 / 12, 4)
    assert got["reloads"] == 1 and got["reload_pause_ms"] == 7.5
    assert _record_serving(ServingStats) == _record_serving(JServingStats)
    with pytest.raises(TypeError):
        ServingStats().merge(DecodeStats())
    odd = DecodeStats()
    odd.ttft_ms = LatencyHistogram(bins_per_decade=10)
    with pytest.raises(ValueError):
        DecodeStats().merge(odd)

    rng = np.random.RandomState(0)
    samples = rng.lognormal(1.0, 1.5, (2, 200))
    hists = []
    for cls in (LatencyHistogram, JHist):
        x, y, whole = cls(), cls(), cls()
        for v in samples[0]:
            x.record(v)
            whole.record(v)
        for v in samples[1]:
            y.record(v)
            whole.record(v)
        x.merge(y)
        assert x.summary() == whole.summary()
        hists.append((x.summary(), x.cumulative_buckets()))
    assert hists[0] == hists[1]
    assert hists[0][1][-1][1] == 400


def test_serving_fleet_failover_and_reload(tmp_path):
    d = str(tmp_path / "mlp")
    main, startup = jf.Program(), jf.Program()
    with jf.program_guard(main, startup), jf.scope_guard(jf.Scope()):
        x = jf.layers.data("x", shape=[16], append_batch_size=True)
        pred = jf.layers.fc(jf.layers.fc(x, size=32, act="relu"), size=4)
        exe = jf.Executor()
        exe.run(startup)
        jf.io.save_inference_model(d, ["x"], [pred], exe,
                                   main_program=main)
    xs = np.random.RandomState(3).rand(8, 16).astype(np.float32)
    refs = jf.Predictor(d).run({"x": xs})[0]

    def mk():
        return ServingEngine(AnalysisConfig(d).disable_gpu(),
                             {"x": np.zeros(16, np.float32)},
                             buckets=BucketConfig((1, 2, 4)),
                             max_wait_ms=2.0)

    engines = [mk(), mk()]
    fleet = Fleet(engines, FleetConfig()).start()
    chaos.kill_replica(engines[0])  # the next dispatch on 0 fails once
    resps = [fleet.infer({"x": xs[i]}, timeout_s=120) for i in range(8)]
    for i, r in enumerate(resps):
        np.testing.assert_allclose(r.outputs[0], np.asarray(refs[i]),
                                   rtol=1e-5, atol=1e-5)
    snap = fleet.snapshot()
    assert snap["failed"] == 0 and snap["failovers"] >= 1
    assert snap["post_warmup_compiles"] == 0
    assert all(not h.dead for h in fleet.replicas)
    live = engines[0].predictor._params
    info = fleet.reload({n: v.numpy() * 2 for n, v in live.items()})
    assert info["version"] == 1 and info["compiles"] == 0
    r = fleet.infer({"x": xs[0]}, timeout_s=120)
    assert r.model_version == 1
    assert not np.allclose(r.outputs[0], np.asarray(refs[0]))
    assert fleet.snapshot()["post_warmup_compiles"] == 0
    fleet.close()


def test_kernel_counts_survive_concurrent_launchers():
    """A fleet's replicas count kernel launches from their own scheduler
    threads: kernels.bump loses no update under contention."""
    import sys
    import threading

    from paddle_tpu_torch.ops import kernels

    before = kernels.counts()["composed"]["paged_attention"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launcher():
            for _ in range(2000):
                kernels.bump(kernels.composed_calls, "paged_attention")

        ts = [threading.Thread(target=launcher) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    got = kernels.counts()["composed"]["paged_attention"] - before
    assert got == 16 * 2000
