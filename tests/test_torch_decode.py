"""The port's DecodeEngine on the CPU against the JAX package's
DecodeEngine, from the same weights (the JAX startup program's, carried
across by `paddle_tpu_torch.convert`).

float32 KV: the streams of tests/test_paged_decode.py — ragged joins
and leaves, forced preemption, eos — must give the same tokens, request
for request, with zero post-warmup compiles.  bfloat16 KV: one prefill
and one decode step run through both packages' programs, and the logits
are compared within a stated tolerance (tokens need not match: bf16
rounding can flip a near-tie argmax).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.executor import interpret_program as jax_interpret
from paddle_tpu.models.decoder_lm import DecoderLM as JaxLM
from paddle_tpu.models.decoder_lm import make_prompts
from paddle_tpu.serving.decode import DecodeConfig as JaxConfig
from paddle_tpu.serving.decode import DecodeEngine as JaxEngine
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.core.executor import interpret_program
from paddle_tpu_torch.models.decoder_lm import DecoderLM as TorchLM
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

torch.set_num_threads(2)

VOCAB = 48
ARCH = dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=32, d_inner=64,
            seed=7)


def _arrays(jlm):
    scope = jlm.init_params()
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None and n != "__rng_key__"}


@pytest.fixture(scope="module")
def f32():
    jlm = JaxLM(kv_dtype="float32", **ARCH)
    tlm = TorchLM(kv_dtype="float32", **ARCH)
    return jlm, tlm, _arrays(jlm)


def _both_streams(models, cfg_kw, requests):
    """Run `requests` [(prompt, max_new, priority)] through both engines;
    returns (jax tokens, port tokens, port stats snapshot)."""
    jlm, tlm, arrays = models
    results = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            eng = JaxEngine(jlm, JaxConfig(**cfg_kw),
                            memory_budget_bytes=False)
        else:
            eng = DecodeEngine(
                tlm, DecodeConfig(**cfg_kw), memory_budget_bytes=False,
                place=CPUPlace(),
                params=params_from_arrays(arrays, "cpu",
                                          program=tlm.step["main"]))
        eng.start()
        futs = [eng.submit(p, max_new_tokens=b, priority=pr)
                for p, b, pr in requests]
        outs = [f.result(120).tolist() for f in futs]
        assert eng.drain(timeout_s=120)
        snap = eng.stats.snapshot()
        eng.close()
        results.append((outs, snap))
    (jout, jsnap), (tout, tsnap) = results
    assert tsnap["post_warmup_compiles"] == 0
    assert tsnap["completed"] == jsnap["completed"] == len(requests)
    return jout, tout, tsnap


def test_join_stream_matches_jax_engine(f32):
    prompts = make_prompts(5, VOCAB, min_len=3, max_len=14, seed=11)
    budgets = [6, 3, 8, 1, 5]
    jout, tout, snap = _both_streams(
        f32, dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
                  prefill_buckets=(8, 16), decode_chunk=4,
                  kv_dtype="float32"),
        [(p, b, 0) for p, b in zip(prompts, budgets)])
    assert tout == jout
    assert [len(o) for o in tout] == budgets
    assert snap["tokens_generated"] == sum(budgets)
    assert snap["prefills"] >= 3


def test_forced_preemption_matches_jax_engine(f32):
    jout, tout, snap = _both_streams(
        f32, dict(num_slots=2, page_size=4, max_len=40, num_pages=11,
                  prefill_buckets=(8,), decode_chunk=4,
                  kv_dtype="float32"),
        [(np.arange(1, 8), 24, 0), (np.arange(2, 9), 24, 5)])
    assert snap["preemptions"] >= 1, snap
    assert tout == jout


def test_eos_matches_jax_engine(f32):
    jlm, tlm, arrays = f32
    prompts = make_prompts(3, VOCAB, min_len=3, max_len=10, seed=3)
    # an eos that really occurs mid-stream: the 2nd token of request 0
    probe, _, _ = _both_streams(
        f32, dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
                  prefill_buckets=(16,), decode_chunk=4,
                  kv_dtype="float32"), [(prompts[0], 10, 0)])
    eos = probe[0][1]
    jout, tout, _ = _both_streams(
        f32, dict(num_slots=2, page_size=4, max_len=48, num_pages=24,
                  prefill_buckets=(16,), decode_chunk=4, eos_id=eos,
                  kv_dtype="float32"), [(p, 10, 0) for p in prompts])
    assert tout == jout
    assert any(o and o[-1] == eos and len(o) < 10 for o in tout)


def _logits_name(built):
    return next(op.desc.inputs["X"][0]
                for op in built["main"].global_block().ops
                if op.type == "arg_max")


def test_bf16_kv_prefill_and_step_logits():
    """bf16 pools, one prefill (bucket 8, slots of lengths 5 and 8) and
    one decode step.  Tolerance: 5e-3 absolute on logits of magnitude
    ~2-3.  Both packages round the same float32 K/V to bfloat16, and the
    differences seen are ~1e-6; the margin covers a float32 ulp of
    difference in a projection moving an isolated K/V element to the
    neighbouring bfloat16 value (relative step 2^-8)."""
    jlm = JaxLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    tlm = TorchLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    arrays = _arrays(jlm)
    tparams = params_from_arrays(arrays, "cpu", program=tlm.step["main"])
    s, page, p = 2, 4, 8
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, VOCAB, (s, 8)).astype(np.int32)
    seq_len = np.array([5, 8], np.int32)
    feeds = {"tokens": tokens, "seq_len": seq_len,
             "last_idx": (seq_len - 1)[:, None], "page_table": pt}

    jenv = {n: jnp.asarray(a) for n, a in arrays.items()}
    jenv.update({n: jnp.asarray(a) for n, a in feeds.items()})
    jenv.update(jlm.fresh_pools(p, page))
    tenv = dict(tparams)
    tenv.update({n: torch.as_tensor(a) for n, a in feeds.items()})
    tenv.update(tlm.fresh_pools(p, page, "cpu"))

    got, want = [], []
    for mode in ("prefill", "step"):
        jb = jlm.prefill(8) if mode == "prefill" else jlm.step
        tb = tlm.prefill(8) if mode == "prefill" else tlm.step
        name = _logits_name(jb)
        out_j = jax_interpret(jb["main"], dict(jenv), None,
                              fetch_names=(name, *jb["cache_outs"]))
        out_t = interpret_program(tb["main"], dict(tenv), None,
                                  fetch_names=(name, *tb["cache_outs"]),
                                  device="cpu")
        want.append(np.asarray(out_j[name]))
        got.append(out_t[name].numpy())
        # carry the pools, and feed both the same next token
        for n, o in zip(jlm.cache_feed_names(), jb["cache_outs"]):
            jenv[n] = out_j[o]
            tenv[n] = out_t[o]
        nxt = np.argmax(want[-1], axis=-1).astype(np.int32)
        pos = seq_len if mode == "prefill" else seq_len + 1
        step_feeds = {"tokens": nxt, "write_pos": pos,
                      "lengths": pos + 1, "active": np.ones(s, np.int32)}
        jenv.update({n: jnp.asarray(a) for n, a in step_feeds.items()})
        tenv.update({n: torch.as_tensor(a) for n, a in step_feeds.items()})
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3)
