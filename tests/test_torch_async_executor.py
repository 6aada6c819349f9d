"""The port's file-shard training path on the CPU: MultiSlot parsing
(paddle_tpu_torch/data/data_feed.py), the shard lease queue
(data/task_queue.py), and AsyncExecutor — the counterparts of
tests/test_async_trainer.py:44-232 and :352-538, each parser and queue
case held exactly against the reference's, and one AsyncExecutor run
held against the reference's (fetch means within 1e-5 relative)."""

import os
import threading

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.data.data_feed import MultiSlotDataFeed as RefFeed
from paddle_tpu.data.task_queue import TaskQueue as RefQueue
from paddle_tpu_torch import layers
from paddle_tpu_torch.data import recordio
from paddle_tpu_torch.data.data_feed import DataFeedDesc, MultiSlotDataFeed
from paddle_tpu_torch.data.task_queue import TaskQueue

from tests.torch_twin import twins

CPU = pt.CPUPlace()
TOL_MEANS = 1e-5      # relative: float32 on both sides, other kernels


def _write_multislot(path, rng, n_lines, vocab=50, as_recordio=False):
    """slots: sparse ids (var len <=5), dense 3-float, label."""
    lines = []
    for _ in range(n_lines):
        k = rng.randint(1, 6)
        ids = rng.randint(0, vocab, k)
        dense = rng.rand(3)
        label = rng.randint(0, 2)
        parts = ([str(k)] + [str(i) for i in ids]
                 + ["3"] + [f"{v:.4f}" for v in dense]
                 + ["1", str(label)])
        lines.append(" ".join(parts))
    if as_recordio:
        with recordio.Writer(path, max_chunk_records=7) as w:
            for line in lines:
                w.write(line.encode())
    else:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def _slots():
    return [{"name": "ids", "type": "uint64", "dense": False, "max_len": 5},
            {"name": "dense", "type": "float", "dense": True, "dim": 3},
            {"name": "label", "type": "uint64", "dense": True, "dim": 1}]


def _desc(batch_size, mod=None):
    cls = DataFeedDesc if mod is None else mod.DataFeedDesc
    return cls.from_slots(_slots(), batch_size=batch_size)


def _shards(tmp_path, n, lines, seed, as_recordio=False):
    rng = np.random.RandomState(seed)
    files = []
    for i in range(n):
        p = os.path.join(tmp_path, f"part-{i}")
        _write_multislot(p, rng, lines, as_recordio=as_recordio)
        files.append(p)
    return files


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# MultiSlotDataFeed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_recordio", [False, True])
def test_multislot_datafeed_parses_as_the_reference(tmp_path, as_recordio):
    from paddle_tpu.data import data_feed as ref_df

    (p,) = _shards(str(tmp_path), 1, 10, seed=0, as_recordio=as_recordio)
    got = list(MultiSlotDataFeed(_desc(4)).batches([p]))
    assert len(got) == 2  # 10 lines, bs 4, trailing 2 dropped
    b = got[0]
    assert b["ids"].shape == (4, 5) and b["ids.seq_len"].shape == (4,)
    assert b["dense"].shape == (4, 3) and b["label"].shape == (4, 1)
    assert (b["ids.seq_len"] >= 1).all()
    _assert_batches_equal(
        got, list(RefFeed(_desc(4, ref_df)).batches([p])))


def test_multislot_uint64_hash_ids(tmp_path):
    p = os.path.join(tmp_path, "part-u")
    with open(p, "w") as f:
        f.write("2 9223372036854775808 3 1 0.5 1 1\n")
    desc = DataFeedDesc.from_slots(
        [{"name": "ids", "dense": False, "max_len": 4},
         {"name": "d", "type": "float", "dense": True, "dim": 1},
         {"name": "label", "dense": True, "dim": 1}], batch_size=1)
    (b,) = list(MultiSlotDataFeed(desc).batches([p]))
    # 2**63 reinterpreted into int64 (bit pattern preserved)
    assert b["ids"][0, 0] == np.uint64(2 ** 63).astype(np.int64)
    assert b["ids"][0, 1] == 3
    (r,) = list(RefFeed(desc).batches([p]))
    _assert_batches_equal([b], [r])


def test_multislot_sparse_requires_max_len_and_counts(tmp_path):
    p = os.path.join(tmp_path, "part-m")
    with open(p, "w") as f:
        f.write("1 7 1 1\n")
    desc = DataFeedDesc.from_slots(
        [{"name": "ids", "dense": False},
         {"name": "label", "dense": True, "dim": 1}], batch_size=1)
    with pytest.raises(ValueError, match="max_len"):
        list(MultiSlotDataFeed(desc).batches([p]))
    with open(p, "w") as f:
        f.write("3 7 1\n")
    with pytest.raises(ValueError, match="declares 3 values"):
        list(MultiSlotDataFeed(desc).batches([p]))


# ---------------------------------------------------------------------------
# TaskQueue: the reference's lease cases, both queues on one scripted
# clock, every answer compared
# ---------------------------------------------------------------------------

def _lease_expiry(q, clock):
    out = [(t1 := q.acquire("w1")).shard, (t2 := q.acquire("w1")).shard,
           q.acquire("w2"), q.all_done()]
    q.complete(t1.task_id, t1.lease)
    clock[0] = 11.0
    t3 = q.acquire("w2")
    out += [t3.shard == t2.shard, t3.failures]
    q.complete(t3.task_id, t3.lease)
    return out + [q.all_done(), len(q.failed_tasks())]


def _max_failures(q, clock):
    t = q.acquire("w")
    out = [q.fail(t.task_id, t.lease)]
    t = q.acquire("w")
    out += [q.fail(t.task_id, t.lease), q.all_done()]
    return out + [[d.shard for d in q.failed_tasks()], q.stats()]


def _stale_reports(q, clock):
    t_old = q.acquire("w1")
    clock[0] = 11.0
    t_new = q.acquire("w2")
    out = [t_new.lease != t_old.lease]
    q.complete(t_old.task_id, t_old.lease)
    out += [q.all_done(), q.fail(t_old.task_id, t_old.lease),
            q.stats(), q.renew(t_old.task_id, t_old.lease),
            q.renew(t_new.task_id, t_new.lease)]
    q.complete(t_new.task_id, t_new.lease)
    return out + [q.all_done(), len(q.failed_tasks())]


def _renew_extends(q, clock):
    t = q.acquire("w")
    clock[0] = 8.0
    out = [q.renew(t.task_id, t.lease)]
    clock[0] = 16.0
    out.append(q.acquire("w2"))
    clock[0] = 30.0                     # now it expires
    t2 = q.acquire("w3")
    out += [t2.failures, t2.worker, t2.lease, q.stats()]
    q.complete(t2.task_id, t2.lease)
    return out + [q.all_done()]


@pytest.mark.parametrize("case,shards,max_failures", [
    (_lease_expiry, ["a", "b"], 3), (_max_failures, ["x"], 2),
    (_stale_reports, ["x"], 3), (_renew_extends, ["x"], 3)])
def test_task_queue_cases_match_the_reference(case, shards, max_failures):
    results = []
    for cls in (RefQueue, TaskQueue):
        clock = [0.0]
        q = cls(shards, lease_timeout=10.0, max_failures=max_failures,
                clock=lambda: clock[0])
        results.append(case(q, clock))
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# AsyncExecutor
# ---------------------------------------------------------------------------

B = 8


def _ctr_model(fluid):
    ls = fluid.layers
    ids = ls.data("ids", shape=[B, 5], dtype="int64",
                  append_batch_size=False, lod_level=1)
    dense = ls.data("dense", shape=[B, 3], append_batch_size=False)
    label = ls.data("label", shape=[B, 1], dtype="int64",
                    append_batch_size=False)
    emb = ls.embedding(ids, size=[50, 8], is_sparse=True)
    pooled = ls.sequence_pool(emb, "sum")
    feat = ls.concat([pooled, dense], axis=1)
    pred = ls.fc(feat, size=2)
    loss = ls.reduce_mean(ls.softmax_with_cross_entropy(pred, label))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _port_model():
    main, startup = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = _ctr_model(pt)
    pt.Executor(CPU).run(startup, scope=scope)
    return main, scope, loss


@pytest.mark.parametrize("as_recordio", [False, True])
def test_async_executor_trains_over_shards(tmp_path, as_recordio):
    files = _shards(str(tmp_path), 4, 24, seed=1, as_recordio=as_recordio)
    main, scope, loss = _port_model()
    aexe = pt.AsyncExecutor(CPU)
    stats = aexe.run(main, _desc(B), files, thread_num=2,
                     fetch=[loss], scope=scope)
    assert np.isfinite(stats[loss.name])
    # 4 files x 24 lines / bs 8 = 12 batches; run again, loss lower
    assert aexe.last_stats["steps"] == 12
    assert aexe.last_stats["parsed_batches"] == 12
    assert len(aexe.last_stats["feeder_queue_depths"]) == 13
    stats2 = aexe.run(main, _desc(B), files, thread_num=2,
                      fetch=[loss], scope=scope)
    assert stats2[loss.name] < stats[loss.name]


def test_async_executor_fetch_means_match_the_reference(tmp_path):
    """thread_num=1 in both packages: the same shards in the same order,
    the same program (to_dict equal) from the reference's startup
    values; two passes."""
    files = _shards(str(tmp_path), 3, 16, seed=2)
    tw = twins(_ctr_model)
    assert tw["ref"][0].to_dict() == tw["port"][0].to_dict()
    runs = {}
    for side, fluid, place in (("ref", jf, None), ("port", pt, CPU)):
        main, scope, _, loss = tw[side]
        aexe = fluid.AsyncExecutor(place)
        desc = fluid.DataFeedDesc.from_slots(_slots(), batch_size=B)
        runs[side] = [aexe.run(main, desc, files, thread_num=1,
                               fetch=[loss.name], scope=scope)[loss.name]
                      for _ in range(2)]
    np.testing.assert_allclose(runs["port"], runs["ref"], rtol=TOL_MEANS)
    assert runs["port"][1] < runs["port"][0]


def test_async_executor_validates():
    main = pt.Program()
    aexe = pt.AsyncExecutor(CPU)
    with pytest.raises(ValueError):
        aexe.run(main, _desc(4), [], thread_num=2, fetch=[])
    with pytest.raises(ValueError):
        aexe.run(main, _desc(4), ["x"], thread_num=0, fetch=[])
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.AsyncExecutor()


def test_async_executor_surfaces_shard_errors(tmp_path):
    (good,) = _shards(str(tmp_path), 1, 16, seed=5)
    missing = os.path.join(tmp_path, "does-not-exist")
    main, startup = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.program_guard(main, startup):
        dense = layers.data("dense", shape=[B, 3], append_batch_size=False)
        loss = layers.reduce_mean(dense)
    pt.Executor(CPU).run(startup, scope=scope)
    desc = DataFeedDesc.from_slots(
        [{"name": "ids", "dense": False, "max_len": 5, "used": False},
         {"name": "dense", "type": "float", "dense": True, "dim": 3},
         {"name": "label", "dense": True, "dim": 1, "used": False}],
        batch_size=B)
    with pytest.raises(RuntimeError, match="shard reader failed"):
        pt.AsyncExecutor(CPU).run(main, desc, [good, missing],
                                  thread_num=2, fetch=[loss], scope=scope)


def test_async_executor_does_not_hang_on_stalled_worker(tmp_path):
    """A parser thread stalled forever: its shard re-leases, the run
    completes, no deadlock waiting for the stalled thread's _STOP."""
    files = _shards(str(tmp_path), 3, 16, seed=8)
    main, scope, loss = _port_model()
    release = threading.Event()
    stalled = {"hit": False}
    orig = MultiSlotDataFeed.batches

    def stalling_batches(self, paths):
        # first thread to grab a shard stalls until the run finishes
        if not stalled["hit"]:
            stalled["hit"] = True
            release.wait(timeout=60)
        return orig(self, paths)

    MultiSlotDataFeed.batches = stalling_batches
    try:
        stats = pt.AsyncExecutor(CPU).run(
            main, _desc(B), files, thread_num=2, fetch=[loss],
            scope=scope, shard_lease_timeout=1.0, shard_max_failures=10)
    finally:
        release.set()
        MultiSlotDataFeed.batches = orig
    assert np.isfinite(stats[loss.name])
    assert stalled["hit"]


def test_async_executor_survives_worker_crash(tmp_path):
    """A shard whose parse fails transiently re-leases and retries; the
    run still covers every file (at-least-once re-delivery)."""
    files = _shards(str(tmp_path), 4, 16, seed=7)
    main, scope, loss = _port_model()
    flaky = {"left": 2}
    flaky_lock = threading.Lock()
    orig = MultiSlotDataFeed.batches

    def flaky_batches(self, paths):
        with flaky_lock:
            crash = flaky["left"] > 0
            if crash:
                flaky["left"] -= 1
        if crash:
            raise OSError(f"simulated shard read failure for {paths}")
        return orig(self, paths)

    aexe = pt.AsyncExecutor(CPU)
    MultiSlotDataFeed.batches = flaky_batches
    try:
        stats = aexe.run(main, _desc(B), files, thread_num=2,
                         fetch=[loss], scope=scope,
                         shard_lease_timeout=30.0, shard_max_failures=3)
    finally:
        MultiSlotDataFeed.batches = orig
    assert np.isfinite(stats[loss.name])
    assert flaky["left"] == 0  # the failures actually happened
    assert aexe.last_stats["steps"] == 8
