"""The port's cost plane (paddle_tpu_torch/observe/cost.py, the kernels'
cost registry) against the reference's (paddle_tpu/observe/cost.py,
paddle_tpu/ops/pallas KERNEL_COSTS).

- Each kernel's registered flop formula, over logical dimensions, equals
  the reference's registered function given the matching Pallas operand
  shapes (1e-9 relative), all nine entries and the bf16 paths' names.
- The reference's test Transformer (tests/test_observe_cost.py
  `_transformer_step`) built in both packages from the reference's
  startup values: the reference's row keys, each matmul-bucket op
  type's flops within 5% of the reference's `op_cost_table` (the
  reference's own registry-vs-dense bound), whole-step flops within 10%
  of its `program_costs` (the port's eager step counts dropout's mask
  draw, which the reference's threefry counts as flops, at one flop an
  element), `bucket_summary` losing nothing, and
  `Executor.cost_analysis()["flops"]` equal to `program_costs`'.
- The fused-CE Transformer's `fused_vocab_softmax_ce` row is the
  reference's `vocab_ce_cost`, a stacked-LSTM step's `dynamic_lstm` row
  the reference's `lstm_fwd_cost + lstm_bwd_cost` over all T steps.
- A recorded step leaves the scope, its run counter and the kernels'
  counts as they were; with no profiler or recorder active the executor
  makes no `record_function`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tf
import torch_twin as tw
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import recurrence as jrc
from paddle_tpu.ops.pallas import vocab_ce as jvc
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as pfa  # noqa: F401
from paddle_tpu_torch.ops.kernels import lstm as plk  # noqa: F401
from paddle_tpu_torch.ops.kernels import paged_attention as ppa  # noqa: F401
from paddle_tpu_torch.ops.kernels import vocab_ce as pvc  # noqa: F401

# -- the registry against the reference's -----------------------------------


def _flash_ref(fn, nh, tq, tk, d, backward):
    q, k = ((nh, tq, d), 4), ((nh, tk, d), 4)
    lse = ((nh, 8, tq), 4)
    if not backward:
        return fn([q, k, k], [q, lse])[0]
    return fn([q, k, k, q, q, lse], [k, k])[0]


def _ce_ref(fn, n, d, v, backward):
    h, w, lbl = ((n, d), 4), ((d, v), 4), ((1, n), 4)
    row, stat = ((1, n), 4), ((8, n), 4)
    if not backward:
        return fn([h, w, lbl], [stat, stat, stat])[0]
    return fn([h, w, lbl, row, row], [h])[0]


def _paged_ref(s, hd, page, maxp):
    ops = [((s * maxp,), 4), ((s,), 4), ((s, 1, hd), 4),
           ((64, page, hd), 2), ((64, page, hd), 2)]
    return jpa.paged_attn_cost(ops, [((s, 1, hd), 4)])[0]


SHAPES = {"flash": [(8, 256, 256, 64), (24, 128, 512, 128), (2, 64, 96, 32)],
          "ce": [(128, 64, 512), (1024, 256, 4096), (7, 32, 100)],
          "lstm": [(16, 4, 8), (40, 300, 512)],
          "paged": [(16, 512, 16, 32), (80, 256, 16, 8)]}

ENTRIES = [
    ("flash_attention_fwd", "flash", lambda *a: _flash_ref(
        jfa.flash_fwd_cost, *a, False)),
    ("flash_attention_bwd_dkv", "flash", lambda *a: _flash_ref(
        jfa.flash_dkv_cost, *a, True)),
    ("flash_attention_bwd_dq", "flash", lambda *a: _flash_ref(
        jfa.flash_dq_cost, *a, True)),
    ("vocab_ce_fwd", "ce", lambda *a: _ce_ref(jvc.vocab_ce_fwd_cost, *a,
                                              False)),
    ("vocab_ce_dh", "ce", lambda *a: _ce_ref(jvc.vocab_ce_dh_cost, *a,
                                             True)),
    ("vocab_ce_dw", "ce", lambda *a: _ce_ref(jvc.vocab_ce_dw_cost, *a,
                                             True)),
    ("lstm_fwd", "lstm", lambda t, n, h: jrc.lstm_fwd_cost(
        [((t, n, 4 * h), 4)], [])[0]),
    ("lstm_bwd", "lstm", lambda t, n, h: jrc.lstm_bwd_cost(
        [((t, n, 4 * h), 4)], [])[0]),
    ("paged_attention", "paged", _paged_ref),
]


@pytest.mark.parametrize("name,kind,ref", ENTRIES,
                         ids=[e[0] for e in ENTRIES])
def test_kernel_cost_equals_reference_registry(name, kind, ref):
    names = [name] + ([name + "_bf16"] if name.startswith("flash") else [])
    for dims in SHAPES[kind]:
        want = ref(*dims)
        for n in names:
            got = K.KERNEL_COSTS[n](*dims)
            assert abs(got - want) <= 1e-9 * abs(want), (n, dims, got, want)
    assert set(K.KERNEL_COSTS) == set(K.KERNELS)


def test_reference_attention_and_ce_totals_are_the_registry_sums():
    """The reference's fwd+bwd helpers are the three entries' sums."""
    for nh, tq, tk, d in SHAPES["flash"]:
        if tq != tk:
            continue
        want = jfa.attention_cost(nh, tq, tk, d)[0]
        got = sum(K.KERNEL_COSTS[n](nh, tq, tk, d) for n in (
            "flash_attention_fwd", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq"))
        assert abs(got - want) <= 1e-9 * want
    for n, d, v in SHAPES["ce"]:
        want = jvc.vocab_ce_cost(n, d, v)[0]
        got = sum(K.KERNEL_COSTS[k](n, d, v) for k in (
            "vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw"))
        assert abs(got - want) <= 1e-9 * want


# -- the cost table on the reference's test Transformer ----------------------

FEED_SHAPE = (2, 64, 512, 512)


def _transformer(fluid, **kw):
    from importlib import import_module

    tr = import_module(fluid.__name__ + ".models.transformer")
    return tr.build_model(
        src_vocab_size=512, trg_vocab_size=512, max_length=64, n_layer=2,
        n_head=2, d_model=64, d_inner_hid=128, dropout=0.1,
        use_amp=False, use_flash=True, **kw)


def _feed():
    from paddle_tpu.models import transformer as jt

    return jt.make_fake_batch(*FEED_SHAPE)


def _per_op(rows):
    out = {}
    for r in rows:
        out[r["op_type"]] = out.get(r["op_type"], 0.0) + r["flops"]
    return out


@pytest.fixture(scope="module")
def transformer_tables():
    import jax.numpy as jnp

    twins = tw.twins(_transformer)
    feed = _feed()
    out = {}
    for side, fluid in tw.PKGS.items():
        main, scope, exe, model = twins[side]
        f = {k: jnp.asarray(v) for k, v in feed.items()} \
            if side == "ref" else feed
        with fluid.scope_guard(scope):
            rows = fluid.observe.op_cost_table(
                main, feed=f, fetch_list=[model["loss"]], exe=exe)
            tot = fluid.observe.program_costs(
                main, feed=f, fetch_list=[model["loss"]], exe=exe)
        out[side] = (rows, tot, twins[side], f)
    return out


def test_op_cost_table_rows_against_reference(transformer_tables):
    rows, tot, *_ = transformer_tables["port"]
    ref_rows, ref_tot, *_ = transformer_tables["ref"]
    keys = {"op_type", "bucket", "instructions", "flops",
            "transcendentals", "bytes", "time_ms", "arith_intensity",
            "achieved_flops_frac", "roofline_time_ms"}
    for r in rows:
        assert set(r) == keys == set(ref_rows[0]), sorted(r)
    mm = {r["op_type"] for r in rows if r["bucket"] == "matmul"}
    assert {"mul", "matmul"} <= mm, mm
    kern = {r["op_type"] for r in rows if r["bucket"] == "custom_call"}
    assert kern == {"flash_attention"}, kern
    got, want = _per_op(rows), _per_op(ref_rows)
    gaps = {}
    for op in ("mul", "matmul", "flash_attention"):
        gaps[op] = got[op] / want[op] - 1.0
        assert abs(gaps[op]) <= 0.05, (op, got[op], want[op])
    step_gap = tot["flops"] / ref_tot["flops"] - 1.0
    assert abs(step_gap) <= 0.10, (tot["flops"], ref_tot["flops"])
    # the flash op's rows carry the registry's flops exactly: two heads
    # of 64-token self-attention, the encoder's and the decoder's in each
    # of 2 layers (cross attention is not flash here), fwd + bwd
    nh, t, d = FEED_SHAPE[0] * 2, 64, 32
    one = sum(K.KERNEL_COSTS[n](nh, t, t, d) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"))
    assert got["flash_attention"] == pytest.approx(4 * one, rel=1e-12)
    summary = tf.observe.bucket_summary(rows)
    assert abs(sum(b["flops"] for b in summary.values())
               - sum(r["flops"] for r in rows)) < 1
    assert sum(b["instructions"] for b in summary.values()) == \
        sum(r["instructions"] for r in rows)
    assert "matmul" in tf.observe.format_cost_table(rows)


def test_cost_analysis_is_program_costs(transformer_tables):
    rows, tot, (main, scope, exe, model), feed = \
        transformer_tables["port"]
    ca = exe.cost_analysis(main, feed=feed, fetch_list=[model["loss"]],
                           scope=scope)
    assert ca["flops"] == tot["flops"]
    assert ca["flops"] == sum(r["flops"] for r in rows)
    assert set(ca) == {"flops", "transcendentals", "bytes accessed"}
    assert tot["custom_calls"] == 12       # 4 flash ops x 3 kernels
    assert tot["peak_hbm_bytes"] > 0
    assert tot["allocator_peak_bytes"] is None     # the CPU


def test_fused_ce_row_is_reference_vocab_ce_cost():
    main, startup, model = tw.build(tf, lambda f: _transformer(
        f, use_fused_ce=True))
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    rows = tf.observe.op_cost_table(main, feed=_feed(),
                                    fetch_list=[model["loss"]],
                                    scope=scope, exe=exe)
    ce = [r for r in rows if r["op_type"] == "fused_vocab_softmax_ce"
          and r["bucket"] == "custom_call"]
    n = FEED_SHAPE[0] * FEED_SHAPE[1]
    want = jvc.vocab_ce_cost(n, 64, 512)[0]
    assert len(ce) == 1 and ce[0]["instructions"] == 3
    assert ce[0]["flops"] == pytest.approx(want, rel=1e-12)


def _lstm(fluid, t=16, h=8):
    layers = fluid.layers
    x = layers.data(name="x", shape=[t, 4 * h], dtype="float32",
                    lod_level=1)
    out, _cell = layers.dynamic_lstm(x, size=4 * h, use_peepholes=False)
    last = layers.sequence_pool(out, pool_type="max")
    loss = layers.mean(layers.fc(last, size=1))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return {"loss": loss}


def test_lstm_row_is_trip_multiplied():
    """The reference's LSTM step (tests/test_observe_cost.py:358): the
    dynamic_lstm row carries all T steps of the recurrence, the
    reference's lstm_fwd_cost + lstm_bwd_cost."""
    b, t, h = 4, 16, 8
    twins = tw.twins(_lstm)
    main, scope, exe, out = twins["port"]
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(b, t, 4 * h).astype(np.float32),
            "x.seq_len": np.full((b,), t, np.int32)}
    rows = tf.observe.op_cost_table(main, feed=feed,
                                    fetch_list=[out["loss"]], scope=scope,
                                    exe=exe)
    kern = [r for r in rows if r["op_type"] == "dynamic_lstm"
            and r["bucket"] == "custom_call"]
    want = (jrc.lstm_fwd_cost([((t, b, 4 * h), 4)], [])[0]
            + jrc.lstm_bwd_cost([((t, b, 4 * h), 4)], [])[0])
    assert len(kern) == 1 and kern[0]["flops"] == pytest.approx(want,
                                                                rel=1e-12)
    assert kern[0]["flops"] >= t * 2 * b * h * 4 * h


# -- the caller's world is left alone ----------------------------------------


def _state(scope):
    return {n: (v.clone() if isinstance(v, torch.Tensor) else v)
            for n, v in scope.vars.items()}


def test_recorded_step_leaves_scope_counter_and_counts(transformer_tables):
    _rows, _tot, (main, scope, exe, model), feed = \
        transformer_tables["port"]
    before = _state(scope)
    counts = K.counts()
    fresh = tf.Executor(tf.CPUPlace())        # no memoized record
    with tf.scope_guard(scope):
        fresh.compiled_step(main, feed=feed, fetch_list=[model["loss"]],
                            scope=scope)
        tf.observe.op_cost_table(main, feed=feed,
                                 fetch_list=[model["loss"]], exe=fresh)
        tf.observe.memory_report(main, feed=feed,
                                 fetch_list=[model["loss"]], exe=fresh)
        tf.observe.plan_fit(main, feed, fetch_list=[model["loss"]],
                            exe=fresh, probe_batches=(1, 2))
    after = scope.vars
    assert set(after) == set(before)
    for n, v in before.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(after[n], v), n
        else:
            assert after[n] == v, n
    assert K.counts() == counts


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler or recorder active, a training step and a decode
    step make no record_function (a raising one would fail them)."""
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.observe import trace
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    def boom(*a, **k):
        raise AssertionError("record_function made outside a profile")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert trace.op_scope[0] is None
    main, scope, exe, loss = tw.twins(tw.linreg)["port"]
    for feed in tw.batches(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    lm = DecoderLM(vocab_size=16, n_layer=1, n_head=2, d_model=8,
                   d_inner=16, kv_dtype="float32")
    eng = DecodeEngine(lm, DecodeConfig(num_slots=2, page_size=4,
                                        max_len=16, prefill_buckets=(4,),
                                        kv_dtype="float32"),
                       place=tf.CPUPlace()).start()
    try:
        toks = eng.submit(np.array([1, 2, 3], np.int32),
                          max_new_tokens=3).result(timeout=60)
        assert 1 <= len(toks) <= 3
    finally:
        eng.close()


def test_layout_rows_are_the_copies(transformer_tables):
    """C21: eager transposes are views (noop); the layout bucket holds
    the copies that follow them, charged to their ops."""
    _rows, _tot, (main, scope, exe, model), feed = \
        transformer_tables["port"]
    rec = exe.compiled_step(main, feed=feed, fetch_list=[model["loss"]],
                            scope=scope)
    views = [r for r in rec.rows if r["op_type"] == "transpose"
             and r["name"] == "permute"]
    assert views and all(r["bucket"] == "noop" and r["bytes"] == 0
                         for r in views)
    copies = tf.observe.copyish_instructions(rec)
    assert copies and all(c["bytes"] > 0 for c in copies)
    share = tf.observe.layout_byte_share(rec)
    assert share == pytest.approx(
        sum(c["bytes"] for c in copies) / sum(
            r["bytes"] for r in rec.rows if r["bucket"] != "noop"))
    assert 0.0 < share < 1.0
    assert isinstance(tf.observe.flash_boundary_layout(rec), list)
    mem = rec.memory_analysis()
    assert mem["peak_bytes"] == tf.observe.memory_report(
        compiled=rec)["peak_bytes"]
    assert mem["argument_bytes"] > 0 and mem["allocator_peak_bytes"] is None
