"""AsyncExecutor: file-shard training with a threaded host pipeline —
the port of paddle_tpu/async_executor.py.

The analog of the reference AsyncExecutor (reference:
paddle/fluid/framework/async_executor.cc:72-234 — per-thread
ExecutorThreadWorker instances each parsing a file shard and running the
program op-by-op; python/paddle/fluid/async_executor.py wrapper).

As in paddle_tpu, the thread pool parses file shards and one training
step consumes a merged queue through a `DeviceFeeder`
(data/pipeline.py), which copies each batch to the card ahead of its
step; the card runs the steps one after another.  Shards are walked once
per `run`, fetch vars are averaged over the run, and parsing overlaps
the steps.  The parser threads share the interpreter lock with the
thread that dispatches the steps (the Executor interprets the program
op by op): `last_stats` keeps the parse time and the queue depths a run
saw, to show how far the host holds the card back.

The Baidu-pslib distributed-KV path (async_executor.cc init_server/
init_worker) is not ported, as in the reference: sharded embedding
tables (parallel/, SparseGrad) replace the parameter server.

Shard dispatch goes through a lease queue (data/task_queue.py — the
in-process analog of the Go master's task service,
go/master/service.go:106,341): a parser thread that dies or stalls
returns its shard for another worker, with at-least-once re-delivery
and max_failures retirement.  Multi-trainer dispatch (the Go master
served leases over RPC to many trainers) is a non-goal, as in the
reference: each trainer parses the part of the file list it is given.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.executor import Executor, Scope, global_scope, scope_guard
from .core.program import Program
from .data.data_feed import DataFeedDesc, MultiSlotDataFeed
from .data.pipeline import DeviceFeeder


class AsyncExecutor:
    """reference: python/paddle/fluid/async_executor.py AsyncExecutor.

    place: CUDAPlace(id) or CPUPlace(); None means CUDAPlace(0) and
    raises when CUDA is not available, as the Executor does."""

    def __init__(self, place=None, run_mode: str = ""):
        self.place = place
        self._exe = Executor(place)
        self.last_stats: Dict[str, object] = {}

    def run(self, program: Program, data_feed: DataFeedDesc,
            filelist: Sequence[str], thread_num: Optional[int] = None,
            fetch: Sequence = (), mode: str = "", debug: bool = False,
            scope: Optional[Scope] = None,
            report_every: int = 100,
            shard_lease_timeout: float = 300.0,
            shard_max_failures: int = 3) -> Dict[str, float]:
        """Train over `filelist` once.  thread_num parser threads split
        the shards (reference async_executor.cc: files round-robin over
        threads; default FLAGS.paddle_num_threads); fetch vars are
        averaged and (debug=True) printed every `report_every` steps.
        Returns {fetch_name: mean_over_run}.  `last_stats` then holds
        the run's steps, the parser threads' seconds spent parsing and
        the batches they parsed, and the depth of the merged queue and
        of the DeviceFeeder's queue at each get.
        """
        if thread_num is None:
            from .flags import FLAGS

            thread_num = int(FLAGS.paddle_num_threads)
        if thread_num < 1:
            raise ValueError("thread_num must be >= 1")
        if not filelist:
            raise ValueError("empty filelist")
        feed_parser = MultiSlotDataFeed(data_feed)
        fetch_names = [f if isinstance(f, str) else f.name for f in fetch]

        import queue as queue_mod
        import threading
        import time as time_mod

        from .data.decorator import _ReaderError
        from .data.task_queue import TaskQueue

        # Shards dispatch through a lease queue instead of a static
        # round-robin split (reference analog: the Go master's task
        # service, go/master/service.go:106,341): a parser thread that
        # dies or stalls past its lease returns its shard for another
        # worker, so one bad thread no longer strands a slice of the
        # dataset.  Delivery is AT-LEAST-ONCE — a retried shard can
        # re-emit batches that already reached the device queue.
        n_workers = min(thread_num, len(filelist))
        tq = TaskQueue(list(filelist), lease_timeout=shard_lease_timeout,
                       max_failures=shard_max_failures)

        merged: "queue_mod.Queue" = queue_mod.Queue(maxsize=4 * n_workers)
        stats_lock = threading.Lock()
        parse = [0.0, 0]          # parser seconds, batches parsed
        merged_depths: List[int] = []
        _STOP = object()
        abort = threading.Event()

        _LOST = object()

        def _put(item, keepalive=None):
            """Returns True when enqueued, False when aborting, _LOST
            when the keepalive reports the lease is gone.  keepalive
            runs every wait iteration so consumer BACKPRESSURE (full
            queue during a long compile/step) keeps the lease alive —
            lease time measures a dead parser, not a slow consumer."""
            while not abort.is_set():
                if keepalive is not None and not keepalive():
                    return _LOST
                try:
                    merged.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker(widx):
            try:
                while not abort.is_set():
                    task = tq.acquire(f"parser-{widx}")
                    if task is None:
                        if tq.all_done():
                            break
                        time_mod.sleep(0.02)
                        continue
                    try:
                        lost = False
                        keepalive = (lambda t=task:
                                     tq.renew(t.task_id, t.lease))
                        batches = iter(feed_parser.batches([task.shard]))
                        while True:
                            t0 = time_mod.perf_counter()
                            batch = next(batches, None)
                            with stats_lock:
                                parse[0] += time_mod.perf_counter() - t0
                            if batch is None:
                                break
                            with stats_lock:
                                parse[1] += 1
                            r = _put(batch, keepalive=keepalive)
                            if r is _LOST:
                                lost = True  # re-leased elsewhere
                                break
                            if r is False:
                                tq.fail(task.task_id, task.lease)
                                return
                            # heartbeat per batch too (fast consumers
                            # never hit the _put wait loop)
                            if not tq.renew(task.task_id, task.lease):
                                lost = True
                                break
                        if not lost:
                            tq.complete(task.task_id, task.lease)
                    except BaseException as e:  # noqa: BLE001
                        if not tq.fail(task.task_id, task.lease):
                            # retired after max_failures: surface on the
                            # consumer (reference: ExecutorThreadWorker
                            # aborts on reader errors) — never silently
                            # truncate the dataset
                            _put(_ReaderError(e))
                            return
                _put(_STOP)
            except BaseException as e:  # noqa: BLE001
                _put(_ReaderError(e))

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n_workers)]
        for t in threads:
            t.start()

        def reader():
            # termination must NOT require a _STOP from every worker: a
            # truly stalled thread never sends one (its shard re-leases
            # to others) — exit once the queue has drained after every
            # shard completed or retired; retired shards raise in the
            # end-of-run failed_tasks() check even if their in-flight
            # _ReaderError loses this race
            done = 0
            while done < len(threads):
                merged_depths.append(merged.qsize())
                try:
                    item = merged.get(timeout=0.2)
                except queue_mod.Empty:
                    if tq.all_done() and merged.empty():
                        return
                    continue
                if item is _STOP:
                    done += 1
                    continue
                if isinstance(item, _ReaderError):
                    raise RuntimeError(
                        "async_executor shard reader failed"
                    ) from item.error
                yield item

        feeder = DeviceFeeder(reader, capacity=4, device=self._exe.device)
        totals = {n: 0.0 for n in fetch_names}
        steps = 0
        target_scope = scope or global_scope()
        try:
            with scope_guard(target_scope):
                for feed in feeder:
                    vals = self._exe.run(program, feed=feed,
                                         fetch_list=list(fetch_names))
                    steps += 1
                    for n, v in zip(fetch_names, vals):
                        totals[n] += float(np.asarray(v).reshape(-1)[0])
                    if debug and steps % report_every == 0:
                        stats = ", ".join(
                            f"{n}={totals[n] / steps:.6f}"
                            for n in fetch_names)
                        print(f"[async_executor] step {steps}: {stats}")
        finally:
            # on any consumer-side exit, unblock and reap BOTH sides:
            # parser threads parked on merged.put (abort flag + drain)
            # AND the DeviceFeeder producer parked on merged.get (one
            # _STOP per worker completes reader()'s done-count)
            abort.set()
            try:
                while True:
                    merged.get_nowait()
            except queue_mod.Empty:
                pass
            for _ in threads:
                try:
                    merged.put_nowait(_STOP)
                except queue_mod.Full:
                    break
            feeder.reset()
            for t in threads:
                t.join(timeout=5)
        self.last_stats = {"steps": steps, "parse_s": parse[0],
                           "parsed_batches": parse[1],
                           "merged_queue_depths": merged_depths,
                           "feeder_queue_depths": list(feeder.queue_depths)}
        dead = tq.failed_tasks()
        if dead:
            raise RuntimeError(
                "async_executor: shards retired after "
                f"{tq.max_failures} failed leases (data NOT fully "
                f"consumed): {[t.shard for t in dead]}")
        if steps == 0:
            raise RuntimeError(
                "no batches produced — check filelist contents and the "
                "DataFeedDesc batch_size vs shard sizes")
        return {n: totals[n] / steps for n in fetch_names}
