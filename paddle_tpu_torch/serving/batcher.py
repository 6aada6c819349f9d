"""Dynamic micro-batcher: request queue → batches → futures.

The port of paddle_tpu/serving/batcher.py, unchanged: it never touches
the device.  Serving throughput is batch occupancy: one bs-32 run costs
barely more host time than one bs-1 run, so the win is collecting
concurrent requests into one program run.  The batcher implements the
TF-Serving shape:

- `submit()` is called from any thread; it admission-checks under the
  queue lock (fast-reject load shedding happens HERE, in the caller's
  thread, in microseconds) and returns a `concurrent.futures.Future`,
- a single worker thread forms batches: dispatch fires on whichever
  comes first — `max_batch_size` requests collected, or `max_wait_ms`
  elapsed since the batch opened (latency bound under light load),
- expired requests are dropped *before* dispatch with
  `DeadlineExceededError` — device time is never spent on a request
  whose caller has already timed out,
- responses demultiplex back through each request's future; a dispatch
  error fails the whole batch's futures (never silently drops them).

The batcher is shape-agnostic: padding, bucket selection, and the
actual predictor call live in the engine's dispatch function
(`engine.py _dispatch`), which enters `torch.no_grad()` itself (torch's
grad mode is per thread).  In-flight accounting (queued + forming +
dispatching) is what admission compares against capacity, so the total
number of accepted-but-unresolved requests is hard-bounded.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .admission import (AdmissionController, DeadlineExceededError,
                        ServingClosedError)


class Request:
    """One accepted request: normalized per-example feeds + routing."""

    __slots__ = ("feeds", "future", "deadline", "t_submit", "max_len",
                 "trace")

    def __init__(self, feeds: Dict[str, np.ndarray],
                 deadline: Optional[float] = None,
                 max_len: Optional[int] = None, trace=None):
        self.feeds = feeds
        self.future: Future = Future()
        self.deadline = deadline          # absolute time.monotonic()
        self.t_submit = time.monotonic()
        self.max_len = max_len            # ragged length (None = dense)
        self.trace = trace                # observe.reqtrace.RequestTrace
        #                                   (None when tracing is off)


class DynamicBatcher:
    """Thread-safe queue + one worker thread forming batches.

    dispatch(requests) is the engine callback: it must resolve every
    request's future (result or exception).  The batcher guarantees it
    is only ever called from the worker thread, with 1..max_batch_size
    non-expired requests.
    """

    def __init__(self, dispatch: Callable[[Sequence[Request]], None],
                 admission: AdmissionController, max_batch_size: int,
                 max_wait_ms: float,
                 on_deadline_miss: Optional[Callable[[Request], None]]
                 = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self._dispatch = dispatch
        self._admission = admission
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self._on_deadline_miss = on_deadline_miss
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._inflight = 0        # accepted and not yet resolved/failed
        self._stop = False
        self._flush = False       # drain: close open batch windows now
        self._worker: Optional[threading.Thread] = None

    # -- producer side --------------------------------------------------
    def submit(self, req: Request) -> Future:
        with self._cv:
            self._admission.check(self._inflight)
            self._q.append(req)
            self._inflight += 1
            self._cv.notify_all()
        return req.future

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queue_depth(self) -> int:
        return len(self._q)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._worker is not None:
            raise RuntimeError("batcher already started")
        self._worker = threading.Thread(target=self._loop,
                                        name="serving-batcher",
                                        daemon=True)
        self._worker.start()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Flush open batch windows, wait for in-flight work to resolve.
        The caller must have moved admission to DRAINING first (no new
        submits race the wait).  Returns True when fully drained."""
        end = time.monotonic() + timeout_s
        with self._cv:
            self._flush = True
            self._cv.notify_all()
            while self._inflight > 0:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
        return True

    def shutdown(self, timeout_s: float = 60.0):
        """Stop the worker.  Any request still unresolved (drain not
        called, or drain timed out) fails with ServingClosedError —
        shutdown never strands a future."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            leftovers = list(self._q)
            self._q.clear()
            self._inflight -= len(leftovers)
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(ServingClosedError(
                    "engine shut down before this request was "
                    "dispatched", state=self._admission.state))
        if self._worker is not None:
            self._worker.join(timeout_s)

    # -- worker ---------------------------------------------------------
    def _loop(self):
        while True:
            batch: List[Request] = []
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(0.05)
                if self._stop:
                    return
                # batch window opens on the first request; it closes on
                # max_batch_size, max_wait_ms, or a drain flush
                window_end = time.monotonic() + self.max_wait_ms / 1e3
                while True:
                    while self._q and len(batch) < self.max_batch_size:
                        batch.append(self._q.popleft())
                    if len(batch) >= self.max_batch_size:
                        break
                    if self._flush or self._stop:
                        break
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            if batch:
                self._process(batch)

    def _process(self, batch: List[Request]):
        try:
            now = time.monotonic()
            live: List[Request] = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    # dropped BEFORE dispatch: no device time spent
                    req.future.set_exception(DeadlineExceededError(
                        "deadline expired while queued",
                        queued_ms=round((now - req.t_submit) * 1e3, 3)))
                    if self._on_deadline_miss is not None:
                        self._on_deadline_miss(req)
                else:
                    live.append(req)
            if live:
                try:
                    self._dispatch(live)
                except BaseException as e:  # noqa: BLE001 — must not
                    #                         kill the worker thread
                    for req in live:
                        if not req.future.done():
                            req.future.set_exception(e)
        finally:
            with self._cv:
                self._inflight -= len(batch)
                self._cv.notify_all()
