"""The port's data-parallel step (paddle_tpu_torch/parallel/
data_parallel.py) against the reference's at the same mesh size.

The port runs as a gloo group of 4 CPU processes (one RankGroup for the
whole file, tests/torch_dist_harness.py); the reference on conftest's
virtual 8-device mesh, its first 2 or 4 devices.  Both start from the
reference's startup values and take the same numpy feeds.  Losses are
held at rtol 1e-5 and the state (params, optimizer state, batch-norm
moving statistics) at rtol 1e-4 / atol 1e-6 (float32, sums in another
order across the ranks); the int8 exchange within the reference's 1e-2
of the bf16 one, descending, with every rank bit-identical.
"""

import numpy as np
import pytest

import torch_dp_cases as cases
from torch_dp_ref import (assert_ranks_identical, assert_state_close,
                          group_fixture, ref_arrays, ref_train)

group = group_fixture(4)

STEPS = 3


def feeds_for(model, steps=STEPS, batch=None, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        if model == "mlp":
            b = batch or 32
            out.append({"x": rng.randn(b, 16).astype(np.float32),
                        "y": rng.randint(0, 4, (b, 1)).astype(np.int64)})
        elif model in ("reg_mlp", "reg_mlp_adam", "reg_mlp_lars",
                       "sum_mlp"):
            b = batch or 32
            out.append({"x": rng.randn(b, 32).astype(np.float32),
                        "y": rng.randn(b, 1).astype(np.float32)})
        elif model == "bn_net":
            b = batch or 16
            out.append({"x": rng.randn(b, 3, 6, 6).astype(np.float32),
                        "y": rng.randint(0, 4, (b, 1)).astype(np.int64)})
        elif model == "sparse_net":
            out.append({"ids": rng.randint(0, cases.SPARSE_V // 2, (
                cases.SPARSE_B, cases.SPARSE_F)).astype(np.int64),
                "y": rng.rand(cases.SPARSE_B, 1).astype(np.float32)})
        elif model == "transformer":
            from paddle_tpu_torch.models import transformer as tt

            a = cases.TINY_TRANSFORMER
            b = batch or 8
            feed = tt.make_fake_batch(b, a["max_length"],
                                      a["src_vocab_size"],
                                      a["trg_vocab_size"], seed=seed + i)
            # ragged targets: the ranks' token counts differ, so the
            # loss (a ratio of sums) is not the mean of theirs
            feed["src_len"] = rng.randint(1, a["max_length"] + 1,
                                          b).astype(np.int32)
            feed["trg_len"] = rng.randint(1, a["max_length"] + 1,
                                          b).astype(np.int32)
            out.append(feed)
        elif model == "deepfm":
            from paddle_tpu_torch.models import deepfm as dm

            a = cases.TINY_DEEPFM
            out.append(dm.make_fake_batch(batch or 16, a["num_fields"],
                                          a["num_dense"], a["vocab_size"],
                                          seed=seed + i))
        elif model == "bert":
            from paddle_tpu_torch.models import bert as bm

            a = cases.TINY_BERT
            feed = bm.make_fake_batch(batch or 4, a["max_len"],
                                      a["vocab_size"], max_predictions=3,
                                      seed=seed + i)
            feed["mask_weight"][::3, 1:] = 0.0     # ragged masks
            out.append(feed)
    return out


def _port(group, model, feeds, arrays, **kw):
    return assert_ranks_identical(group.run(
        "train", timeout=120, model=model, feeds=feeds, arrays=arrays,
        **kw))


def _submit(group, model, feeds, arrays, **kw):
    """Queue a port run (the ranks run their queued cases in order)
    while the reference computes here; `_take` collects it."""
    return group.submit("train", model=model, feeds=feeds, arrays=arrays,
                        **kw)


def _take(group, handle):
    return assert_ranks_identical(group.collect(handle, timeout=120))


PARITY = [
    # (model, mesh, port/ref strategy kwargs)
    ("mlp", {"dp": 2}, {}),
    ("sum_mlp", {"dp": 2}, {}),
    ("reg_mlp", {"dp": 4}, {"grad_sync": "bf16"}),
    ("mlp", {"dp": 4}, {"reduce": True}),
    ("reg_mlp_adam", {"fsdp": 2}, {}),
    ("reg_mlp_adam", {"dp": 2, "fsdp": 2}, {}),
    ("bn_net", {"dp": 2}, {}),
    ("bn_net", {"dp": 2}, {"grad_sync": "bf16"}),
    ("transformer", {"dp": 2}, {}),
    ("deepfm", {"dp": 2}, {}),
]


def _case_id(model, mesh, kw):
    axes = "x".join(f"{a}{s}" for a, s in mesh.items())
    return f"{model}-{axes}-{'-'.join(kw) or 'default'}"


@pytest.mark.parametrize("model,mesh,kw", PARITY,
                         ids=[_case_id(*c) for c in PARITY])
def test_dp_parity_with_the_reference(group, model, mesh, kw):
    """The same mesh size, the same mode: the port's losses, fetches
    and state against the reference's; every rank bit-identical."""
    feeds = feeds_for(model)
    arrays = ref_arrays(model)
    # the port's ranks run while the reference runs here
    handle = group.submit("train", model=model, feeds=feeds,
                          arrays=arrays, mesh=mesh, **kw)
    _, ref = ref_train(model, feeds, mesh=mesh, arrays=arrays, **kw)
    port = assert_ranks_identical(group.collect(handle, timeout=120))
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-7)
    for p_f, r_f in zip(port["fetches"], ref["fetches"]):
        for a, b in zip(p_f, r_f):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert_state_close(port["state"], ref["state"],
                       skip=("@lr_decay_counter@",))


@pytest.mark.parametrize("model,mesh", [("bn_net", {"dp": 4}),
                                        ("transformer", {"dp": 4}),
                                        ("bert", {"dp": 2})])
def test_global_batch_mode_equals_one_process(group, model, mesh):
    """The default mode computes the global-batch program: a
    batch-norm network's loss, accuracy and moving statistics equal one
    process's on the whole batch; so do the Transformer's and BERT's
    ragged ratio-of-sums losses (the port's own startup values)."""
    feeds = feeds_for(model, seed=3)
    h = group.submit("train", model=model, feeds=feeds, arrays=None)
    single = group.collect(h, timeout=120)[0]
    dp = _port(group, model, feeds, None, mesh=mesh)
    np.testing.assert_allclose(dp["losses"], single["losses"], rtol=1e-5)
    assert_state_close(dp["state"], single["state"])
    for p_f, s_f in zip(dp["fetches"], single["fetches"]):
        for a, b in zip(p_f, s_f):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_forward_program_on_a_mesh(group):
    """A forward-only program (the test clone of the batch-norm
    network) on dp=4: the batch-mean loss and the gathered logits equal
    one process's; every rank the same."""
    feed = feeds_for("bn_net", steps=1)[0]
    got = group.run("infer", model="bn_net", feed=feed,
                    arrays=ref_arrays("bn_net"), mesh={"dp": 4})
    for g in got:
        for a, b in zip(g["dp"], g["single"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g["dp"][1], got[0]["dp"][1])


def test_int8_exchange_within_tolerance_and_bit_identical(group):
    """int8 against the reference's int8 and the port's bf16 (the
    reference's 1e-2), descending, deterministic, ranks bit-identical;
    at dp=2 and dp=4 (the reference's batches, tests/test_grad_sync.py
    :39-44)."""
    feeds = feeds_for("reg_mlp", steps=6, batch=64)
    arrays = ref_arrays("reg_mlp")
    hs = [_submit(group, "reg_mlp", feeds, arrays, mesh=m, grad_sync=g)
          for m, g in (({"dp": 4}, "bf16"), ({"dp": 4}, "int8"),
                       ({"dp": 4}, "int8"), ({"dp": 2}, "int8"))]
    _, ref8 = ref_train("reg_mlp", feeds, mesh={"dp": 4},
                        grad_sync="int8", arrays=arrays)
    bf16, int8, again, two = [_take(group, h) for h in hs]
    for got in (int8, two):
        rel = np.abs(np.subtract(got["losses"], bf16["losses"])) \
            / np.maximum(np.abs(bf16["losses"]), 1e-6)
        assert rel.max() < 1e-2, rel
        assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(int8["losses"], ref8["losses"], rtol=1e-5)
    assert int8["losses"] == again["losses"]
    for n, v in int8["state"].items():
        np.testing.assert_array_equal(again["state"][n], v)
    assert not np.array_equal(int8["losses"], bf16["losses"])


def test_sparse_grads_stay_sparse_under_int8(group):
    """tests/test_grad_sync.py:172-209: the table's SparseGrad is
    gathered, never quantized; untouched rows stay bit-identical; the
    trajectory matches the reference's int8 run."""
    feeds = feeds_for("sparse_net", steps=4)
    arrays = ref_arrays("sparse_net")
    h = _submit(group, "sparse_net", feeds, arrays, mesh={"dp": 4},
                grad_sync="int8", min_quant_numel=1)
    _, ref = ref_train("sparse_net", feeds, mesh={"dp": 4},
                       grad_sync="int8", min_quant_numel=1, arrays=arrays)
    port = _take(group, h)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    table = port["state"]["tbl"]
    V, D = cases.SPARSE_V, cases.SPARSE_D
    np.testing.assert_array_equal(table[V // 2:],
                                  np.full((V - V // 2, D), 0.05, np.float32))
    assert not np.allclose(table[:V // 2], 0.05)
    np.testing.assert_allclose(table, ref["state"]["tbl"], rtol=1e-4,
                               atol=1e-6)


def test_deepfm_sparse_tables_explicit_mode(group):
    """DeepFM's SparseGrad tables under the bf16 exchange.  The
    reference's explicit shard_map cannot trace DeepFM's `auc` on this
    jax (a sharding-context error inside its shard_map), so the port's
    bf16 run is held against the reference's default mode: a mean loss
    over equal slices gives the same gradients either way; the auc
    histograms differ by design (pmean against the global sum)."""
    feeds = feeds_for("deepfm")
    arrays = ref_arrays("deepfm")
    h = _submit(group, "deepfm", feeds, arrays, mesh={"dp": 2},
                grad_sync="bf16")
    _, ref = ref_train("deepfm", feeds, mesh={"dp": 2}, arrays=arrays)
    port = _take(group, h)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert_state_close(port["state"], ref["state"],
                       skip=("auc_0.stat_pos", "auc_0.stat_neg"))


def test_partial_batch_falls_back_exact(group):
    """A final batch that does not divide the data ranks trains
    replicated: every rank computes the whole batch, exactly the one
    process's step (tests/test_grad_sync.py:214-225)."""
    rng = np.random.RandomState(3)
    feeds = feeds_for("reg_mlp", steps=2) + [
        {"x": rng.randn(13, 32).astype(np.float32),
         "y": rng.randn(13, 1).astype(np.float32)}]
    arrays, ref = ref_train("reg_mlp", feeds, mesh={"dp": 4},
                            grad_sync="int8")
    single = group.run("train", model="reg_mlp", feeds=feeds[2:],
                       arrays=arrays)[0]
    for kw in ({}, {"grad_sync": "int8"}):
        port = _port(group, "reg_mlp", feeds, arrays, mesh={"dp": 4}, **kw)
        assert np.isfinite(port["losses"]).all() and len(port["losses"]) == 3
        # the partial batch alone: replicated, the one process's step
        alone = _port(group, "reg_mlp", feeds[2:], arrays, mesh={"dp": 4},
                      **kw)
        assert alone["losses"] == single["losses"]
        for n, v in single["state"].items():
            np.testing.assert_array_equal(alone["state"][n], v)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)


def test_refusals(group):
    """What the reference refuses, refused with its words: params
    sharded over a data axis under grad_sync, accumulation under
    grad_sync; a batch reduction without a cross-rank form names C16.
    A dp x mp mesh runs (its tensor parallelism is
    tests/test_torch_tensor_parallel.py's)."""
    feed = feeds_for("reg_mlp", steps=1)[0]
    arrays = ref_arrays("reg_mlp")
    msgs = {}
    for name, kw in (
            ("zero3", dict(grad_sync="int8", reduce=True, mesh={"dp": 4})),
            ("accum", dict(grad_sync="int8", accum=2, mesh={"dp": 4})),
            ("mp", dict(mesh={"dp": 2, "mp": 2}))):
        msgs[name] = group.run("refusal", model="reg_mlp", feed=feed,
                               arrays=arrays, **kw)[0]
    assert msgs["zero3"].startswith("ValueError") \
        and "sharded over the data ax" in msgs["zero3"]
    assert msgs["accum"].startswith("ValueError") \
        and "accumulation" in msgs["accum"]
    assert msgs["mp"] is None, msgs["mp"]
    # reduce_max over the batch: detected, raised, named (C16); the
    # explicit mode runs it per rank as the reference's shard_map does
    msg = group.run("refusal", model="max_mlp", feed=feed,
                    arrays=ref_arrays("max_mlp"), mesh={"dp": 4})[0]
    assert msg.startswith("NotImplementedError") and "C16" in msg \
        and "reduce_max" in msg
    assert group.run("refusal", model="max_mlp", feed=feed,
                     arrays=ref_arrays("max_mlp"), mesh={"dp": 4},
                     grad_sync="bf16")[0] is None


def test_time_major_batch_refused_where_dim0_is_assumed(group):
    """A time-major tensor (the batch on dim 1): dropout's global mask
    and shape's global shape take the batch as dim 0, so the default
    mode refuses them, naming C16; the explicit mode runs them per rank,
    and the same program without them (means over time) runs."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(32, 4, 8).astype(np.float32),
            "y": rng.randn(32, 1).astype(np.float32)}
    for model, op in (("time_major_dropout", "dropout"),
                      ("time_major_shape", "shape")):
        msg = group.run("refusal", model=model, feed=feed, arrays=None,
                        mesh={"dp": 4})[0]
        assert msg is not None and msg.startswith("NotImplementedError") \
            and "C16" in msg and f"op {op!r}" in msg \
            and "batch dim is not dim 0" in msg, msg
        assert group.run("refusal", model=model, feed=feed, arrays=None,
                         mesh={"dp": 4}, grad_sync="bf16")[0] is None
    assert group.run("refusal", model="time_major", feed=feed, arrays=None,
                     mesh={"dp": 4})[0] is None


def test_accumulation_on_mesh(group):
    """K micro-batches a rank, one exchange: the reference's
    CompiledProgram accumulation on a mesh (tests/test_dist.py:322),
    with batch norm's global statistics a micro-batch."""
    for model in ("mlp", "bn_net"):
        feeds = feeds_for(model, seed=5)
        arrays = ref_arrays(model)
        h = _submit(group, model, feeds, arrays, mesh={"dp": 2}, accum=2)
        _, ref = ref_train(model, feeds, mesh={"dp": 2}, accum=2,
                           arrays=arrays)
        port = _take(group, h)
        np.testing.assert_allclose(port["losses"], ref["losses"],
                                   rtol=1e-5, err_msg=model)
        assert_state_close(port["state"], ref["state"])
        for p_f, r_f in zip(port["fetches"], ref["fetches"]):
            for a, b in zip(p_f, r_f):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_zero_opt_state_bytes_per_rank(group):
    """A ZeRO rank holds ~1/N of the optimizer state's bytes (the Adam
    moments slice; the pow counters stay whole), params whole; lars
    all-reduces its norms over the slices (same trajectory as dp)."""
    feeds = feeds_for("reg_mlp_adam", steps=2)
    arrays = ref_arrays("reg_mlp_adam")
    base = _port(group, "reg_mlp_adam", feeds, arrays, mesh={"dp": 2})
    by_n = {n: _port(group, "reg_mlp_adam", feeds, arrays,
                     mesh={"fsdp": n}) for n in (2, 4)}
    assert base["opt_bytes"] / by_n[2]["opt_bytes"] >= 1.7
    assert base["opt_bytes"] / by_n[4]["opt_bytes"] >= 4 * 0.75
    for got in by_n.values():
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-5)
    feeds = feeds_for("reg_mlp_lars", steps=2)
    arrays = ref_arrays("reg_mlp_lars")
    h = _submit(group, "reg_mlp_lars", feeds, arrays, mesh={"fsdp": 4})
    _, ref = ref_train("reg_mlp_lars", feeds, mesh={"fsdp": 4},
                       arrays=arrays)
    lars = _take(group, h)
    np.testing.assert_allclose(lars["losses"], ref["losses"], rtol=1e-5)
    assert_state_close(lars["state"], ref["state"])


def test_sharded_memory_report_counts_the_zero_slice(group):
    """observe.sharded_memory_report at fsdp = 2: a rank's resident
    optimizer state is its local ZeRO slice, the bytes
    `opt_state_bytes` gives (83,516 on reg_mlp_adam, ROADMAP C7), and
    the recorded step leaves the rank's state as it was."""
    feeds = feeds_for("reg_mlp_adam", steps=2)
    arrays = ref_arrays("reg_mlp_adam")
    res = group.run("sharded_memory", timeout=120, model="reg_mlp_adam",
                    feeds=feeds, arrays=arrays, mesh={"fsdp": 2})
    ranks = [r for r in res if r is not None]
    assert len(ranks) == 2
    for r in ranks:
        assert r["resident_opt"] == r["opt_bytes"] == 83516
        assert r["state_kept"] and r["peak"] > r["resident_opt"]


def test_guard_skips_on_every_rank(group):
    """A NaN in one rank's slice poisons the synchronized gradients:
    every rank's update guard skips the step (the same decision on
    every rank), the params stay where they were on all of them."""
    feeds = feeds_for("reg_mlp", steps=2)
    feeds[1]["x"][20, 3] = np.nan        # rank 2's slice at dp=4
    arrays = ref_arrays("reg_mlp")
    before = group.run("train", model="reg_mlp", feeds=feeds[:1],
                       arrays=arrays, guard=True)[0]
    port = _port(group, "reg_mlp", feeds, arrays, mesh={"dp": 4},
                 guard=True)
    assert np.isnan(port["losses"][1])
    for n in ("fc_0.w_0", "fc_1.w_0", "fc_2.w_0"):
        np.testing.assert_allclose(port["state"][n], before["state"][n],
                                   rtol=1e-5, atol=1e-7)
