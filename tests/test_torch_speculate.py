"""Speculative decoding in the port against the JAX package, on the CPU.

The same numpy inputs, and the reference's weights carried across by
`paddle_tpu_torch.convert`, go through both packages:

- `speculative_accept`: the port's op against the reference's, exact
  integers (ragged DraftLen with 0 and k, inactive slots);
- the verify program: the port's build, and the reference's `to_dict()`
  loaded in the port, against the reference's on the same feeds and
  float32 pools — accepted and tokens exact, pools within 1e-5;
- engine streams (tests/test_speculate.py's: mid-stream joins, forced
  preemption, a garbage drafter, n-gram determinism) through the port's
  speculative engine: tokens equal to the port's sequential engine's and
  to the reference's speculative engine's, and the `speculation`
  snapshot equal to the reference's;
- the oracle `ModelDrafter` stream: the port's accept histogram equals
  the reference's, which is not all-accept (ROADMAP C7);
- `ngram_propose`'s rules and the constructors' validation, in both
  packages.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.executor import interpret_program as jax_interpret
from paddle_tpu.models.decoder_lm import DecoderLM as JaxLM
from paddle_tpu.models.decoder_lm import make_prompts
from paddle_tpu.serving import DecodeConfig as JaxConfig
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import Drafter as JaxDrafter
from paddle_tpu.serving import ModelDrafter as JaxModelDrafter
from paddle_tpu.serving import NGramDrafter as JaxNGramDrafter
from paddle_tpu.serving import ngram_propose as jax_ngram_propose
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.core.executor import interpret_program
from paddle_tpu_torch.core.program import Program as TorchProgram
from paddle_tpu_torch.models.decoder_lm import DecoderLM as TorchLM
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      DecodeStats, Drafter, ModelDrafter,
                                      NGramDrafter, ngram_propose)

from op_test import run_op
from torch_op_test import run_torch_op_all

torch.set_num_threads(2)

VOCAB = 48
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner=64,
            kv_dtype="float32", seed=7)
K = 4
SPEC_KEYS = ("speculate_k", "verify_dispatches", "drafted_tokens",
             "accepted_tokens", "emitted_tokens", "accept_hist")


def _cfg_kw(**kw):
    base = dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
                prefill_buckets=(8, 16), decode_chunk=4,
                kv_dtype="float32")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    jlm, tlm = JaxLM(**ARCH), TorchLM(**ARCH)
    scope = jlm.init_params()
    arrays = {n: np.asarray(v) for n, v in scope.vars.items()
              if v is not None and n != "__rng_key__"}
    return jlm, tlm, arrays


# -- speculative_accept ------------------------------------------------------

def _accept_case(name):
    if name == "masking":
        # tests/test_speculate.py's case: full match over 3 drafts,
        # DraftLen 1 masking a matching tail, an inactive slot, a first
        # draft mismatching
        return {
            "Drafts": np.array([[5, 7, 2], [4, 6, 6], [1, 1, 1],
                                [9, 3, 3]], np.int32),
            "Predictions": np.array([[5, 7, 2, 8], [4, 6, 6, 1],
                                     [1, 1, 1, 1], [8, 3, 3, 3]],
                                    np.int32),
            "DraftLen": np.array([3, 1, 3, 3], np.int32),
            "Active": np.array([1, 1, 0, 1], np.int32)}
    s = 6
    preds = np.random.RandomState(7).randint(0, 5, (s, K + 1)).astype(
        np.int32)
    drafts = preds[:, :K].copy()
    # slot i: the first mismatch at draft i (i >= K: none)
    for i in range(s):
        if i < K:
            drafts[i, i] = (drafts[i, i] + 1) % 5
    ins = {"Drafts": drafts, "Predictions": preds,
           # ragged: 0 and K among the draft lengths
           "DraftLen": np.array([K, 0, K, 2, K, 1], np.int32)}
    if name == "ragged_inactive":
        ins["Active"] = np.array([1, 1, 0, 1, 1, 0], np.int32)
    return ins


@pytest.mark.parametrize("case", ["masking", "ragged", "ragged_inactive"])
def test_speculative_accept_matches_reference(case):
    ins = _accept_case(case)
    got = run_torch_op_all("speculative_accept", ins)
    for slot in ("Accepted", "Tokens"):
        want = np.asarray(run_op("speculative_accept", ins, out_slot=slot))
        assert got[slot].dtype == np.int32
        np.testing.assert_array_equal(got[slot], want)
    if case == "masking":
        np.testing.assert_array_equal(got["Accepted"], [3, 1, -1, 0])


@pytest.mark.parametrize("m", [12, 14, 4, 3])
def test_mul_row_block_runs_each_block_as_its_own_product(m):
    """OpContext.row_block (the verify run's batch invariance): `mul`
    runs blocks of 4 rows, the last zero-padded to 4, each as its own
    product; row_block off, or no more rows than a block, is one
    product."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    rng = np.random.RandomState(m)
    x = torch.as_tensor(rng.randn(m, 2, 8).astype(np.float32))
    y = torch.as_tensor(rng.randn(16, 5).astype(np.float32))
    mul = get_op_impl("mul")
    got = mul(OpContext(device="cpu", row_block=4), {"X": [x], "Y": [y]},
              {"x_num_col_dims": 1})["Out"][0]
    x2 = x.reshape(m, 16)
    pad = torch.cat([x2, x2.new_zeros(-m % 4, 16)])
    want = torch.cat([b @ y for b in pad.split(4)])[:m]
    assert got.shape == (m, 5) and torch.equal(got, want)
    one = mul(OpContext(device="cpu"), {"X": [x], "Y": [y]}, {})["Out"][0]
    if m <= 4:
        assert torch.equal(got, one)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)


# -- the verify program ------------------------------------------------------

def _verify_feeds(jlm, arrays):
    """Folded verify feeds for 3 slots (committed 5, 9, 2; the third
    inactive), pools of random float32 rows, and drafts grown by k
    reference runs so that slot 0 accepts every draft, slot 1 its first
    two (its third corrupted) and the inactive slot none."""
    rng = np.random.RandomState(3)
    s, k1, page, maxp = 3, K + 1, 4, 4
    committed = np.array([5, 9, 2], np.int32)
    slot_active = np.array([1, 1, 0], np.int32)
    draft_len = np.array([K, 3, 0], np.int32)
    table = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
                     np.int32)
    pools = {n: rng.randn(12, page, ARCH["d_model"]).astype(np.float32)
             for n in jlm.cache_feed_names()}
    cur = rng.randint(1, VOCAB, s).astype(np.int32)
    drafts = rng.randint(1, VOCAB, (s, K)).astype(np.int32)
    ver = jlm.verify(K)

    def feeds(drafts):
        folded = np.zeros((4, s * k1), np.int32)
        pt = np.zeros((s * k1, maxp), np.int32)
        ar = np.arange(k1)
        for i in range(s):
            live = (ar <= draft_len[i]) & (slot_active[i] > 0)
            off = np.where(live, ar, 0)
            b = i * k1
            folded[0, b] = cur[i]
            folded[0, b + 1:b + k1] = drafts[i]
            folded[1, b:b + k1] = committed[i] + off
            folded[2, b:b + k1] = committed[i] + off + 1
            folded[3, b:b + k1] = live
            pt[b:b + k1] = table[i]
        return {"tokens": folded[0], "write_pos": folded[1],
                "lengths": folded[2], "active": folded[3],
                "drafts": drafts, "draft_len": draft_len,
                "slot_active": slot_active, "page_table": pt}

    def ref_preds(drafts):
        env = {n: jnp.asarray(a) for n, a in arrays.items()}
        env.update({n: jnp.asarray(a) for n, a in pools.items()})
        env.update({n: jnp.asarray(a) for n, a in feeds(drafts).items()})
        out = jax_interpret(ver["main"], env, None,
                            fetch_names=(ver["next_token"],))
        return np.asarray(out[ver["next_token"]]).reshape(s, k1)

    for j in range(K):          # grow the accepted chain one draft a run
        drafts[:, j] = ref_preds(drafts)[:, j]
    drafts[1, 2] = (drafts[1, 2] % (VOCAB - 1)) + 1     # slot 1: reject 3rd
    return feeds(drafts), pools


@pytest.mark.parametrize("source", ["port_build", "reference_to_dict"])
def test_verify_program_matches_reference(models, source):
    jlm, tlm, arrays = models
    ver_j = jlm.verify(K)
    feeds, pools = _verify_feeds(jlm, arrays)
    fetch = (ver_j["accepted"], ver_j["tokens"], *ver_j["cache_outs"])

    env = {n: jnp.asarray(a) for n, a in arrays.items()}
    env.update({n: jnp.asarray(a) for n, a in pools.items()})
    env.update({n: jnp.asarray(a) for n, a in feeds.items()})
    want = jax_interpret(ver_j["main"], env, None, fetch_names=fetch)

    if source == "port_build":
        ver_t = tlm.verify(K)
        main = ver_t["main"]
        assert (ver_t["accepted"], ver_t["tokens"], ver_t["cache_outs"],
                ver_t["speculate_k"]) == (ver_j["accepted"],
                                          ver_j["tokens"],
                                          ver_j["cache_outs"], K)
    else:
        main = TorchProgram.from_dict(json.loads(json.dumps(
            ver_j["main"].to_dict())))
    tenv = params_from_arrays(arrays, "cpu", program=tlm.step["main"])
    tenv.update({n: torch.tensor(a) for n, a in pools.items()})
    tenv.update({n: torch.as_tensor(a) for n, a in feeds.items()})
    got = interpret_program(main, tenv, None, fetch_names=fetch,
                            device="cpu")

    acc = got[ver_j["accepted"]].numpy()
    np.testing.assert_array_equal(acc, np.asarray(want[ver_j["accepted"]]))
    np.testing.assert_array_equal(acc, [K, 2, -1])
    np.testing.assert_array_equal(got[ver_j["tokens"]].numpy(),
                                  np.asarray(want[ver_j["tokens"]]))
    for o in ver_j["cache_outs"]:
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]),
                                   rtol=0, atol=1e-5)


# -- engine streams ---------------------------------------------------------

class _ZeroDrafter(Drafter):
    """Worst-case drafter: always proposes k copies of token 0."""

    def __init__(self, k):
        self.k = int(k)

    def draft(self, engine, active_ids):
        s = engine.config.num_slots
        drafts = np.zeros((s, self.k), np.int32)
        draft_len = np.zeros((s,), np.int32)
        for i in active_ids:
            draft_len[i] = self.k
        return drafts, draft_len


class _JaxZeroDrafter(JaxDrafter):
    def __init__(self, k):
        self.k = int(k)

    draft = _ZeroDrafter.draft


def _run(engine, requests):
    engine.start()
    # every request queued before the scheduler admits any: the joins,
    # and so the verify-run count, do not depend on thread timing
    with engine._cv:
        futs = [engine.submit(p, max_new_tokens=b, priority=pr)
                for p, b, pr in requests]
    outs = [f.result(120).tolist() for f in futs]
    assert engine.drain(timeout_s=120)
    snap = engine.stats.snapshot()
    engine.close()
    return outs, snap


def _port_engine(models, cfg_kw, speculate_k=0, drafter=None):
    _, tlm, arrays = models
    return DecodeEngine(
        tlm, DecodeConfig(**cfg_kw), memory_budget_bytes=False,
        place=CPUPlace(), speculate_k=speculate_k, drafter=drafter,
        params=params_from_arrays(arrays, "cpu", program=tlm.step["main"]))


def _stream(name):
    """(config kwargs, [(prompt, budget, priority)], port drafter
    factory, reference drafter factory) of one stream of
    tests/test_speculate.py."""
    if name == "midstream_joins":
        prompts = make_prompts(5, VOCAB, min_len=3, max_len=14, seed=11)
        reqs = [(p, b, 0) for p, b in zip(prompts, [6, 3, 8, 1, 5])]
        return _cfg_kw(), reqs, None, None
    if name == "forced_preemption":
        reqs = [(np.arange(1, 8), 24, 0), (np.arange(2, 9), 24, 5)]
        return (_cfg_kw(max_len=40, num_pages=11, prefill_buckets=(8,)),
                reqs, None, None)
    if name == "garbage_drafter":
        prompts = make_prompts(4, VOCAB, min_len=3, max_len=8, seed=13)
        reqs = [(p, b, 0) for p, b in zip(prompts, [7, 5, 9, 4])]
        return (_cfg_kw(prefill_buckets=(8,)), reqs,
                lambda: _ZeroDrafter(K), lambda: _JaxZeroDrafter(K))
    assert name == "ngram_determinism"
    prompts = make_prompts(4, VOCAB, min_len=3, max_len=14, seed=3)
    reqs = [(p, b, 0) for p, b in zip(prompts, [8, 6, 10, 7])]
    return _cfg_kw(), reqs, None, None


@pytest.mark.parametrize("name", ["midstream_joins", "forced_preemption",
                                  "garbage_drafter", "ngram_determinism"])
def test_speculative_stream_matches_sequential_and_reference(models, name):
    jlm, _, _ = models
    cfg_kw, reqs, port_drafter, ref_drafter = _stream(name)
    seq, _ = _run(_port_engine(models, cfg_kw), reqs)
    got, snap = _run(_port_engine(
        models, cfg_kw, K, port_drafter() if port_drafter else None), reqs)
    ref, ref_snap = _run(JaxEngine(
        jlm, JaxConfig(**cfg_kw), memory_budget_bytes=False,
        speculate_k=K, drafter=ref_drafter() if ref_drafter else None),
        reqs)
    assert got == seq, "speculative tokens diverged from sequential"
    assert got == ref, "port's speculative tokens differ from reference's"
    spec = snap["speculation"]
    assert {k: spec[k] for k in SPEC_KEYS} == \
        {k: ref_snap["speculation"][k] for k in SPEC_KEYS}
    assert snap["post_warmup_compiles"] == 0
    assert spec["emitted_tokens"] + snap["prefill_joins"] == \
        snap["tokens_generated"]
    if name == "forced_preemption":
        assert snap["preemptions"] >= 1, snap
    if name == "garbage_drafter":
        assert spec["emitted_tokens"] == \
            spec["accepted_tokens"] + sum(spec["accept_hist"])
    if name == "ngram_determinism":
        again, snap2 = _run(_port_engine(models, cfg_kw, K), reqs)
        assert again == got
        assert snap2["speculation"] == spec


def test_oracle_model_drafter_matches_reference_histogram(models):
    """A draft model with the target's own architecture and weights.
    The reference's draft loop never writes the last draft's K/V and
    writes past a slot's pages near its budget (ROADMAP C7), so not every
    draft is accepted; the port computes what the reference computes."""
    jlm, tlm, arrays = models
    prompts = make_prompts(3, VOCAB, min_len=3, max_len=8, seed=5)
    reqs = [(p, b, 0) for p, b in zip(prompts, [9, 13, 5])]
    cfg_kw = _cfg_kw(prefill_buckets=(8,))
    seq, _ = _run(_port_engine(models, cfg_kw), reqs)
    drafter = ModelDrafter(TorchLM(**ARCH), k=K,
                           params=params_from_arrays(arrays, "cpu"))
    got, snap = _run(_port_engine(models, cfg_kw, K, drafter), reqs)
    ref, ref_snap = _run(JaxEngine(
        jlm, JaxConfig(**cfg_kw), memory_budget_bytes=False,
        speculate_k=K, drafter=JaxModelDrafter(JaxLM(**ARCH), k=K)), reqs)
    assert got == seq == ref
    spec = snap["speculation"]
    assert spec == ref_snap["speculation"]
    assert spec["accept_hist"] == [2, 0, 1, 1, 3]
    assert spec["accept_rate"] < 1.0
    assert snap["post_warmup_compiles"] == 0


def test_model_drafter_import_hook_names_its_roadmap_item():
    """`on_import` (ROADMAP A step 9b) re-prefills the imported slot's
    raw prompt into the draft pool and refuses a prompt no bucket
    fits; its draft pool against the reference's is in
    test_torch_disagg.py."""
    lm = TorchLM(**ARCH)
    d = ModelDrafter(lm, k=K)
    eng = types.SimpleNamespace(
        config=types.SimpleNamespace(prefill_buckets=(4,), num_slots=2),
        _slots=[None, types.SimpleNamespace(req=types.SimpleNamespace(
            prompt=np.arange(1, 7, dtype=np.int32)))],
        _page_tables=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="fits no prefill bucket"):
        d.on_import(eng, 1)
    seen = []
    d.on_prefill = lambda e, j, tok, sl, li: seen.append(
        (j, tok.tolist(), sl.tolist(), li.tolist()))
    eng._slots[1].req.prompt = np.array([5, 6, 7], np.int32)
    d.on_import(eng, 1)
    assert seen == [([1], [[0, 0, 0, 0], [5, 6, 7, 0]], [0, 3],
                     [[0], [2]])]


# -- ngram_propose and validation --------------------------------------------

_CYCLE_CTX = [int(t) for t in np.random.RandomState(0).randint(0, 6, 40)]


@pytest.mark.parametrize("ctx,k,ngram,want", [
    ([], 4, 3, []),                                   # too short
    ([7], 4, 3, []),
    ([1, 2, 3], 0, 3, []),                            # degenerate k
    ([1, 2, 3, 4, 5], 4, 3, []),                      # no repeat
    ([1, 2, 3, 4, 1, 2, 3], 4, 3, [4, 1, 2, 3]),      # exact 3-gram
    ([7, 9] * 6, 4, 3, [7, 9, 7, 9]),                 # full beats nearer
    ([5, 1, 2, 3, 1, 2, 3], 4, 3, [1, 2, 3]),         # nearest partial
    ([4, 8, 4, 9, 6, 4], 1, 3, [9]),                  # gram backoff
    (_CYCLE_CTX, 4, 3, None),                         # determinism
    (_CYCLE_CTX, 4, 2, None),
])
def test_ngram_propose_matches_reference(ctx, k, ngram, want):
    got = ngram_propose(ctx, k, ngram)
    assert got == jax_ngram_propose(ctx, k, ngram)
    assert got == ngram_propose(list(ctx), k, ngram)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=4, ngram=0)])
def test_ngram_drafter_validation(kw):
    with pytest.raises(ValueError):
        JaxNGramDrafter(**kw)
    with pytest.raises(ValueError):
        NGramDrafter(**kw)


@pytest.mark.parametrize("kw", [
    dict(role="prefill", speculate_k=K),         # no decode steps there
    dict(drafter=NGramDrafter(K)),               # drafter without k
    dict(speculate_k=K, drafter=NGramDrafter(2)),  # k mismatch
    dict(speculate_k=-1),
    dict(role="bogus"),
])
def test_engine_constructor_validation(kw):
    cfg = DecodeConfig(**_cfg_kw())
    with pytest.raises(ValueError):
        DecodeEngine(TorchLM(**ARCH), cfg, place=CPUPlace(), **kw)


def test_stats_speculation_contracts():
    st = DecodeStats()
    with pytest.raises(ValueError):
        st.configure_speculation(0)
    with pytest.raises(RuntimeError):
        st.record_verify(4, 5, [4])      # before configure_speculation
    st.configure_speculation(4)
    st.record_verify(drafted=7, emitted=9, accept_counts=[4, 3])
    with pytest.raises(ValueError):
        st.record_verify(1, 1, [5])      # count outside 0..k
    with pytest.raises(RuntimeError):
        st.configure_speculation(4)      # after verifies recorded
    assert st.accept_hist == [0, 0, 0, 1, 1]
    spec = st.snapshot()["speculation"]
    assert spec["accepted_tokens"] == spec["drafted_tokens"] == 7
    assert spec["accept_rate"] == 1.0
    assert spec["speculation_efficiency"] == round(9 / 10, 4)
