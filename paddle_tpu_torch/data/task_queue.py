"""Lease-based shard dispatch for data workers: the port of
paddle_tpu/data/task_queue.py, pure Python and unchanged.

The analog of the reference's Go master task service
(reference: go/master/service.go:106 partition() splitting RecordIO
chunks into tasks, :341 the todo/pending/done queues with lease
timeouts — a task leased to a worker that never reports back re-queues
for another worker; repeated failures retire the task).

Here the queue is in-process (threaded parser workers share one
process; multi-trainer data dispatch splits the file list by trainer
instead of a Go RPC master — divergence note in async_executor.py): workers acquire
shard leases, renew by finishing, and a worker that dies or stalls past
its lease returns the shard to the todo queue.  Delivery is
AT-LEAST-ONCE like the reference master: a retried shard may re-emit
batches already consumed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Task:
    task_id: int
    shard: object
    failures: int = 0
    lease_deadline: float = 0.0
    worker: Optional[str] = None
    lease: int = 0          # token: identifies WHICH lease is current


@dataclass
class _State:
    todo: List[Task] = field(default_factory=list)
    pending: Dict[int, Task] = field(default_factory=dict)
    done: List[Task] = field(default_factory=list)
    dead: List[Task] = field(default_factory=list)


class TaskQueue:
    """Thread-safe shard lease queue.

    acquire(worker) -> Task or None (None = nothing to hand out right
    now; poll again until all_done).  complete(task_id) retires a task;
    fail(task_id) (or lease expiry) re-queues it until max_failures,
    after which the task is dead and `failed_tasks` reports it —
    callers must surface that rather than silently dropping data
    (reference service.go:341 moves a task failing too often to the
    failed list)."""

    def __init__(self, shards, lease_timeout: float = 60.0,
                 max_failures: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.lease_timeout = float(lease_timeout)
        self.max_failures = int(max_failures)
        self._lock = threading.Lock()
        self._s = _State(todo=[Task(i, s) for i, s in enumerate(shards)])

    # -- internals (call with lock held) --------------------------------
    def _reap_expired(self):
        now = self._clock()
        expired = [t for t in self._s.pending.values()
                   if t.lease_deadline <= now]
        for t in expired:
            del self._s.pending[t.task_id]
            self._fail_locked(t)

    def _fail_locked(self, t: Task):
        t.failures += 1
        t.worker = None
        if t.failures >= self.max_failures:
            self._s.dead.append(t)
        else:
            self._s.todo.append(t)

    # -- worker API -----------------------------------------------------
    def acquire(self, worker: str = "") -> Optional[Task]:
        """Returns a SNAPSHOT of the leased task — the lease token must
        not change under the worker when the queue re-issues the task
        to someone else after expiry."""
        import dataclasses

        with self._lock:
            self._reap_expired()
            if not self._s.todo:
                return None
            t = self._s.todo.pop(0)
            t.worker = worker
            t.lease += 1
            t.lease_deadline = self._clock() + self.lease_timeout
            self._s.pending[t.task_id] = t
            return dataclasses.replace(t)

    def _current(self, task_id: int, lease: int) -> Optional[Task]:
        """The pending task iff `lease` is still the CURRENT lease —
        a worker whose lease expired and was re-issued must not affect
        the new owner's lease (its reports are stale)."""
        t = self._s.pending.get(task_id)
        return t if t is not None and t.lease == lease else None

    def renew(self, task_id: int, lease: int) -> bool:
        """Heartbeat: extend a live lease (workers renew per emitted
        batch, so lease time measures parser PROGRESS, not consumer
        backpressure).  False = the lease was lost (expired/re-issued);
        the worker should stop emitting from this shard."""
        with self._lock:
            t = self._current(task_id, lease)
            if t is None:
                return False
            t.lease_deadline = self._clock() + self.lease_timeout
            return True

    def complete(self, task_id: int, lease: int):
        with self._lock:
            t = self._current(task_id, lease)
            if t is not None:
                del self._s.pending[task_id]
                self._s.done.append(t)

    def fail(self, task_id: int, lease: int) -> bool:
        """Report a failed lease; returns True when the task will be
        retried (or the report was stale — someone else owns the task
        now), False when the task is retired as dead."""
        with self._lock:
            t = self._current(task_id, lease)
            if t is None:
                return True  # stale report: not this worker's problem
            del self._s.pending[task_id]
            self._fail_locked(t)
            return t.failures < self.max_failures

    # -- observers ------------------------------------------------------
    def all_done(self) -> bool:
        with self._lock:
            self._reap_expired()
            return not self._s.todo and not self._s.pending

    def failed_tasks(self) -> List[Task]:
        with self._lock:
            return list(self._s.dead)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            self._reap_expired()
            return {"todo": len(self._s.todo),
                    "pending": len(self._s.pending),
                    "done": len(self._s.done),
                    "dead": len(self._s.dead)}
