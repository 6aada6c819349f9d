"""paddle_tpu_torch.serving.disagg (DisaggFleet, PhaseWorker, Autoscaler),
the DecodeEngine's prefill and decode roles, the paged_kv_import scatter
and ModelDrafter.on_import, against the JAX package on the CPU, at the
reference test's scale (tests/test_disagg.py: vocab 48, 2 layers,
d_model 32, 2 slots, pages of 4, one prefill bucket), the port's engines
holding the reference's weights (convert.params_from_arrays):

- a prompt prefilled on a prefill worker and continued on a decode
  worker (with twice the slots, so its steps run in row blocks) gives
  every token of the REFERENCE's unified engine, with zero post-warmup
  compiles and one trace across both workers (`kv_transfer`);
- the handoff package field by field against the reference's package
  for the same request, its rows bit for bit against the reference's
  export gather over the same pool contents (float32, bf16 as bits,
  int8 codes and scales);
- `paged_import_rows` pool -> rows -> pool through another page table,
  bit for bit against the reference's, with a padding entry aliasing a
  live page;
- a decode-worker kill and a prefill-worker kill: the reference's
  tokens, no client failure, the committed prefix verified;
- scale up and down with zero post-warmup compiles;
- `ModelDrafter.on_import`'s draft pool against the reference's;
- the Autoscaler's decisions under the reference test's scripted
  signals and clock, equal to the reference Autoscaler's;
- role and geometry validation.

Tolerances: tokens, packages and the import op bitwise; the draft pool
(float32 K/V written by each package's own prefill) within 1e-5.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.decoder_lm import DecoderLM as JaxLM
from paddle_tpu.models.decoder_lm import make_prompts
from paddle_tpu.ops import paged_kv as jpaged
from paddle_tpu.serving import Autoscaler as JAutoscaler
from paddle_tpu.serving import decode as jdecode
from paddle_tpu.serving import speculate as jspec
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.models.decoder_lm import DecoderLM as TorchLM
from paddle_tpu_torch.observe import ReqTracer, RunEventLog, read_events
from paddle_tpu_torch.ops.paged_kv import paged_import_rows
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (Autoscaler, DecodeConfig,
                                      DecodeEngine, DisaggFleet,
                                      ModelDrafter)
from paddle_tpu_torch.serving.decode import DecodeRequest, _Slot
from paddle_tpu_torch.serving.disagg import DECODE, PREFILL

torch.set_num_threads(2)

VOCAB = 48
PROMPTS = make_prompts(6, VOCAB, min_len=3, max_len=8, seed=21)
BUDGETS = [10, 8, 12, 7, 10, 9]
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner=64,
            seed=7)
CFG = dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
           prefill_buckets=(8,), decode_chunk=2)


def _arrays(jlm):
    return {n: np.asarray(v) for n, v in jlm.init_params().vars.items()
            if v is not None and n != "__rng_key__"}


@pytest.fixture(scope="module")
def ref():
    """The reference's uninterrupted control: the requests through one
    unified engine (greedy), and its weights."""
    jlm = JaxLM(kv_dtype="float32", **ARCH)
    eng = jdecode.DecodeEngine(
        jlm, jdecode.DecodeConfig(kv_dtype="float32", **CFG),
        memory_budget_bytes=False).start()
    control = [eng.generate(p, max_new_tokens=b, timeout_s=300).tolist()
               for p, b in zip(PROMPTS, BUDGETS)]
    eng.close()
    return {"arrays": _arrays(jlm), "control": control}


@pytest.fixture(scope="module")
def lm():
    return TorchLM(kv_dtype="float32", **ARCH)


def _engine(lm, arrays, role="unified", kv="float32", **kw):
    cfg = dict(CFG, num_slots=kw.pop("num_slots", CFG["num_slots"]))
    return DecodeEngine(
        lm, DecodeConfig(kv_dtype=kv, **cfg), role=role,
        memory_budget_bytes=False, place=CPUPlace(),
        params=params_from_arrays(arrays, "cpu", program=lm.step["main"]),
        **kw)


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos.clear()


def _assert_parity(outs, control):
    for i, (r, c) in enumerate(zip(outs, control)):
        assert list(r.tokens) == list(c), (i, list(r.tokens), list(c),
                                           r.hops)


def test_handoff_token_parity_zero_recompiles(lm, ref):
    tracer = ReqTracer(sample_rate=1.0)
    fleet = DisaggFleet([_engine(lm, ref["arrays"], "prefill")],
                        [_engine(lm, ref["arrays"], "decode", num_slots=4)],
                        tracer=tracer).start()
    assert fleet.decode[0].engine.step_row_block == CFG["num_slots"]
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    outs = [f.result(300) for f in futs]
    snap = fleet.snapshot()
    _assert_parity(outs, ref["control"])
    assert snap["failed"] == 0 and snap["parity_failed"] == 0, snap
    assert snap["handoffs"] == len(PROMPTS), snap
    assert snap["pages_transferred"] == sum(-(-len(p) // 4)
                                            for p in PROMPTS)
    assert snap["bytes_transferred"] == sum(
        len(p) * 32 * 4 * 4 for p in PROMPTS)   # 2 layers x K, V; f32
    assert snap["post_warmup_compiles"] == 0, snap
    assert snap["ttft_ms"]["count"] == len(PROMPTS)
    assert fleet.merged_stats(DECODE).snapshot()["imports"] == len(PROMPTS)
    assert fleet.merged_stats(PREFILL).snapshot()["imports"] == 0
    for r in outs:
        assert len(r.hops) == 2
        assert r.hops[0] in {h.replica_id for h in fleet.prefill}
        assert r.hops[1] in {h.replica_id for h in fleet.decode}
    names = tracer.trace(outs[0].trace_id).span_names()
    assert names.index("kv_transfer") > names.index("export"), names
    chrome = tracer.export_chrome_trace()["traceEvents"]
    flows = [e for e in chrome if e.get("cat") == "kv_transfer"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    health = fleet.health()
    assert health["healthy_prefill"] == 1 and health["healthy_decode"] == 1
    assert health["prefill"][0]["phase"] == PREFILL
    fleet.close()


_POOL_NAMES = {"float32": ("kv_k_0",), "bfloat16": ("kv_k_0",),
               "int8": ("kv_k_0", "kv_ks_0")}


def _ref_rows(pools, page_row):
    """The reference's export gather over the given pools."""
    fn = jdecode.DecodeEngine._build_export_fn(None)
    return {n: np.asarray(v) for n, v in fn(
        jnp.asarray(page_row), {n: jnp.asarray(p)
                                for n, p in pools.items()}).items()}


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_handoff_package_matches_reference(kv):
    """One request through a prefill-role engine in each package: every
    field of the package equal; the rows bit for bit against the
    reference's gather over the port's own pool (bf16 as 2-byte
    records)."""
    jlm = JaxLM(kv_dtype=kv, **ARCH)
    arrays = _arrays(jlm)
    jeng = jdecode.DecodeEngine(
        jlm, jdecode.DecodeConfig(kv_dtype=kv, **CFG), role="prefill",
        memory_budget_bytes=False).start()
    want = jeng.submit(PROMPTS[2], max_new_tokens=5).result(300)
    jeng.close()
    tlm = TorchLM(kv_dtype=kv, **ARCH)
    eng = _engine(tlm, arrays, "prefill", kv=kv).start()
    got = eng.submit(PROMPTS[2], max_new_tokens=5).result(300)
    page_row = eng._page_tables[0].copy()
    assert not page_row.any()           # the slot recycled at export
    pools = {n: (p.view(torch.int16).numpy().view(jnp.bfloat16)
                 if p.dtype == torch.bfloat16 else p.numpy())
             for n, p in eng._pools.items()}
    eng.close()
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in ("rows", "export_ms"):
            assert got[k] == want[k], (k, got[k], want[k])
    assert sorted(got["rows"]) == sorted(want["rows"])
    pages = np.zeros_like(page_row)
    pages[:got["n_pages"]] = np.arange(got["n_pages"])  # the first alloc
    gather = _ref_rows(pools, pages)
    for n, rows in got["rows"].items():
        assert rows.shape == want["rows"][n].shape, n
        assert rows.dtype.itemsize == want["rows"][n].dtype.itemsize
        if kv == "bfloat16":
            assert rows.dtype == np.dtype("V2")
        else:
            assert rows.dtype == want["rows"][n].dtype
        np.testing.assert_array_equal(_bits(rows), _bits(gather[n]))
    for n in _POOL_NAMES[kv]:
        # the prompt rows agree with the reference's own prefill
        c = got["committed"]
        np.testing.assert_allclose(
            np.asarray(got["rows"][n][:c].view(np.int16).view(jnp.bfloat16)
                       if kv == "bfloat16" else got["rows"][n][:c],
                       np.float32),
            np.asarray(want["rows"][n][:c], np.float32),
            rtol=0, atol={"float32": 1e-5, "bfloat16": 1e-2}.get(
                kv, 1e-5 if "ks" in n else 1))


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "scales"])
def test_paged_import_rows_roundtrip(kv):
    rng = np.random.RandomState(3)
    n_pages, page, maxp = 9, 4, 3
    c = 1 if kv == "scales" else 6
    t_cap = maxp * page
    if kv == "int8":
        rows = rng.randint(-127, 128, (t_cap, c)).astype(np.int8)
        poison = np.full((n_pages, page, c), -99, np.int8)
    else:
        rows = rng.randn(t_cap, c).astype(np.float32)
        poison = np.full((n_pages, page, c), -99.0, np.float32)
    jdt = jnp.bfloat16 if kv == "bfloat16" else rows.dtype
    tdt = torch.bfloat16 if kv == "bfloat16" else None
    nv = 6                               # 6 committed rows, the rest junk
    pt_a = np.array([2, 5, 0], np.int32)     # padding 0 after 2 live
    pt_b = np.array([0, 1, 0], np.int32)     # padding aliases live page 0

    def port(pool, r, pt):
        tp = torch.from_numpy(pool.copy())
        tr = torch.from_numpy(np.ascontiguousarray(r))
        if tdt is not None:
            tp, tr = tp.to(tdt), tr.to(tdt)
        out = paged_import_rows(tp, tr, torch.from_numpy(pt), nv)
        return out.float().numpy() if tdt is not None else out.numpy()

    def reference(pool, r, pt):
        out = jpaged.paged_import_rows(
            jnp.asarray(pool).astype(jdt), jnp.asarray(r).astype(jdt),
            jnp.asarray(pt), jnp.int32(nv))
        return np.asarray(out.astype(jnp.float32) if tdt is not None
                          else out)

    pool_a = port(poison, rows, pt_a)
    np.testing.assert_array_equal(pool_a, reference(poison, rows, pt_a))
    got_a = pool_a[pt_a].reshape(t_cap, c)
    want = np.asarray(jnp.asarray(rows).astype(jdt).astype(jnp.float32)
                      if tdt is not None else rows)
    np.testing.assert_array_equal(got_a[:nv], want[:nv])
    assert np.all(pool_a[[p for p in range(n_pages) if p not in (2, 5)]]
                  == -99)
    pool_b = port(poison, got_a.astype(rows.dtype), pt_b)
    np.testing.assert_array_equal(
        pool_b, reference(poison, got_a.astype(rows.dtype), pt_b))
    np.testing.assert_array_equal(pool_b[pt_b].reshape(t_cap, c)[:nv],
                                  want[:nv])
    assert np.all(pool_b[2:] == -99)
    # nothing to keep: the pool is unchanged
    tp = torch.from_numpy(poison.copy())
    paged_import_rows(tp, torch.from_numpy(rows), torch.from_numpy(pt_a), 0)
    np.testing.assert_array_equal(tp.numpy(), poison)


def test_decode_worker_kill_token_parity(lm, ref):
    fleet = DisaggFleet([_engine(lm, ref["arrays"], "prefill")],
                        [_engine(lm, ref["arrays"], "decode"),
                         _engine(lm, ref["arrays"], "decode")]).start()
    victim = fleet.decode[0].engine
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    t0 = time.monotonic()
    while victim.stats.tokens_generated < 2 \
            and time.monotonic() - t0 < 60:
        time.sleep(0.002)
    chaos.kill_replica(victim)
    outs = [f.result(300) for f in futs]
    snap = fleet.snapshot()
    _assert_parity(outs, ref["control"])
    assert snap["failed"] == 0, snap
    assert snap["decode_failovers"] >= 1 and snap["parity_failed"] == 0
    assert snap["post_warmup_compiles"] == 0, snap
    assert any(r.failovers > 0 for r in outs)
    assert fleet.decode[0].dead and snap["healthy_decode"] == 1
    fleet.close()


def test_prefill_worker_kill_zero_client_failures(lm, ref):
    fleet = DisaggFleet([_engine(lm, ref["arrays"], "prefill"),
                         _engine(lm, ref["arrays"], "prefill")],
                        [_engine(lm, ref["arrays"], "decode")]).start()
    victim = fleet.prefill[0].engine
    chaos.arm(f"replica:{victim.replica_id}:kill", times=1)
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    outs = [f.result(300) for f in futs]
    snap = fleet.snapshot()
    _assert_parity(outs, ref["control"])
    assert snap["failed"] == 0, snap
    assert snap["prefill_failovers"] >= 1, snap
    assert snap["post_warmup_compiles"] == 0, snap
    fleet.close()


def test_scale_up_down_zero_recompiles(lm, ref):
    fleet = DisaggFleet([_engine(lm, ref["arrays"], "prefill")],
                        [_engine(lm, ref["arrays"], "decode")],
                        decode_factory=lambda: _engine(
                            lm, ref["arrays"], "decode")).start()
    half = len(PROMPTS) // 2
    futs = [fleet.submit(p, max_new_tokens=b)
            for p, b in zip(PROMPTS[:half], BUDGETS[:half])]
    h = fleet.add_worker(DECODE)
    assert h.phase == DECODE and h.engine.step_row_block == 2
    futs += [fleet.submit(p, max_new_tokens=b)
             for p, b in zip(PROMPTS[half:], BUDGETS[half:])]
    outs = [f.result(300) for f in futs]
    snap = fleet.snapshot()
    _assert_parity(outs, ref["control"])
    assert snap["failed"] == 0 and snap["scale_ups"] == 1
    assert snap["post_warmup_compiles"] == 0, snap
    assert fleet.remove_worker(DECODE) == h.replica_id
    assert fleet.snapshot()["scale_downs"] == 1
    with pytest.raises(ValueError):
        fleet.remove_worker(DECODE)     # the last live decode worker
    with pytest.raises(ValueError):
        fleet.add_worker(PREFILL)       # no prefill_factory given
    fleet.close()


def test_model_drafter_on_import_matches_reference(ref):
    """The draft pool after `on_import` of one slot: the raw prompt
    re-prefilled at the slot's pages, as the reference's drafter writes
    it; every other page untouched."""
    prompt, pages, slot = np.asarray(PROMPTS[3], np.int32), [7, 3], 1
    jlm = JaxLM(kv_dtype="float32", **ARCH)
    jeng = jdecode.DecodeEngine(
        jlm, jdecode.DecodeConfig(kv_dtype="float32", **CFG),
        role="decode", speculate_k=2,
        drafter=jspec.ModelDrafter(JaxLM(kv_dtype="float32", **ARCH), 2),
        memory_budget_bytes=False)
    tlm = TorchLM(kv_dtype="float32", **ARCH)
    teng = _engine(tlm, ref["arrays"], "decode", speculate_k=2,
                   drafter=ModelDrafter(
                       TorchLM(kv_dtype="float32", **ARCH), 2,
                       params=params_from_arrays(ref["arrays"], "cpu")))
    pools = []
    for eng, req_cls, slot_cls in ((jeng, jdecode.DecodeRequest,
                                    jdecode._Slot),
                                   (teng, DecodeRequest, _Slot)):
        eng.drafter.start(eng)
        eng._page_tables[slot, :len(pages)] = pages
        eng._slots[slot] = slot_cls(req_cls(prompt, 4), list(pages))
        eng.drafter.on_import(eng, slot)
        pools.append({n: np.asarray(v, np.float32)
                      for n, v in eng.drafter._pools.items()})
    want, got = pools
    assert sorted(got) == sorted(want)
    for n in want:
        rows = got[n][pages].reshape(-1, 32)[:len(prompt)]
        np.testing.assert_allclose(
            rows, want[n][pages].reshape(-1, 32)[:len(prompt)],
            rtol=0, atol=1e-5)
        assert np.abs(rows).max() > 0
        others = [p for p in range(CFG["num_pages"]) if p not in pages]
        assert not got[n][others].any() and not want[n][others].any()


class _FakeFleet:
    """A duck-typed DisaggFleet for the Autoscaler's policy: worker-count
    bookkeeping only (the reference test's)."""

    def __init__(self):
        self.counts = {PREFILL: 1, DECODE: 1}
        self._next = 2
        self._event_log = None

    def live_workers(self, phase):
        return self.counts[phase]

    def add_worker(self, phase):
        self.counts[phase] += 1
        self._next += 1
        return type("H", (), {"replica_id": self._next - 1})()

    def remove_worker(self, phase):
        if self.counts[phase] <= 1:
            raise ValueError("last worker")
        self.counts[phase] -= 1
        return self._next - 1


SCRIPT = [(0.0, True), (5.0, True), (12.0, True), (20.0, False),
          (45.0, False), (55.0, False), (500.0, False)]


def test_autoscaler_decisions_equal_the_reference(tmp_path):
    fire = {"disagg_prefill_wait_p99": {"firing": True, "value": 1500.0}}
    runs = []
    for cls, log in ((Autoscaler, RunEventLog(str(tmp_path / "s.jsonl"))),
                     (JAutoscaler, None)):
        fleet = _FakeFleet()
        sc = cls(fleet, None, max_workers={PREFILL: 2, DECODE: 3},
                 cooldown_s=10.0, quiet_s=30.0, event_log=log)
        steps = [sc.evaluate(now=t, signals=fire if f else {})
                 for t, f in SCRIPT]
        runs.append((steps, dict(fleet.counts), sc.decisions))
        if log is not None:
            log.close()
    assert runs[0] == runs[1]
    steps, counts, decisions = runs[0]
    assert [[d["action"] for d in s] for s in steps] == \
        [["up"], [], [], [], [], ["down"], []]
    assert steps[0][0]["value"] == 1500.0 and counts == {PREFILL: 1,
                                                          DECODE: 1}
    kinds = [e.get("event") for e in read_events(str(tmp_path / "s.jsonl"))]
    assert kinds.count("autoscale_up") == 1
    assert kinds.count("autoscale_down") == 1


def test_role_and_geometry_validation(lm, ref):
    a = ref["arrays"]
    pf, dec = _engine(lm, a, "prefill"), _engine(lm, a, "decode")
    with pytest.raises(ValueError, match="role"):
        DisaggFleet([dec], [dec])
    with pytest.raises(ValueError, match="role"):
        DisaggFleet([pf], [_engine(lm, a)])
    other = DecodeEngine(
        lm, DecodeConfig(num_slots=2, page_size=8, max_len=48,
                         prefill_buckets=(8,), decode_chunk=2,
                         kv_dtype="float32"),
        role="decode", memory_budget_bytes=False, place=CPUPlace())
    with pytest.raises(ValueError, match="geometry"):
        DisaggFleet([pf], [other])
    with pytest.raises(ValueError):
        DisaggFleet([pf], [])
    with pytest.raises(ValueError, match="import_handoff"):
        dec.submit(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(ValueError, match="role='decode'"):
        pf.import_handoff({"kind": "handoff"})
    with pytest.raises(ValueError, match="role"):
        DecodeEngine(lm, DecodeConfig(kv_dtype="float32", **CFG),
                     role="both", place=CPUPlace())
    with pytest.raises(ValueError, match="speculate_k"):
        _engine(lm, a, "prefill", speculate_k=2)


@pytest.mark.parametrize("shape,begin,blk", [((16, 32), 1, 8),
                                             ((5, 32), 1, 8),
                                             ((4, 6, 32), 2, 8),
                                             ((8, 32), 1, 8)])
def test_layer_norm_row_block_statistics(shape, begin, blk):
    """`layer_norm` under a run's row_block (ROADMAP C15) reduces its
    statistics in blocks of `blk` rows: the same outputs, Mean and
    Variance shapes as the unblocked op (on the CPU, whose reductions do
    not depend on the row count, the same bits), and each block's rows
    equal a run of that block alone."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    g = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=g)
    ins = {"X": [x], "Scale": [torch.rand(shape[begin:], generator=g)],
           "Bias": [torch.rand(shape[begin:], generator=g)]}
    attrs = {"begin_norm_axis": begin, "epsilon": 1e-5}
    ln = get_op_impl("layer_norm")
    cpu = torch.device("cpu")
    plain = ln(OpContext(device=cpu), ins, attrs)
    blocked = ln(OpContext(device=cpu, row_block=blk), ins, attrs)
    for k in ("Y", "Mean", "Variance"):
        assert blocked[k][0].shape == plain[k][0].shape
        assert torch.equal(blocked[k][0], plain[k][0]), k
    rows = x.reshape(-1, shape[-1])[:blk]
    alone = ln(OpContext(device=cpu), {**ins, "X": [rows]} if begin == 1 else
               {**ins, "X": [rows.reshape(-1, 1, shape[-1])]},
               attrs if begin == 1 else {**attrs, "begin_norm_axis": 2})
    assert torch.equal(alone["Y"][0].reshape(rows.shape),
                       blocked["Y"][0].reshape(-1, shape[-1])[:len(rows)])
