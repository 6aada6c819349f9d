"""Device-fed input pipeline: the port of paddle_tpu/data/pipeline.py —
feed admission, the `DeviceFeeder` (background host→device prefetch) and
the `PyReader` facade.

reference: paddle/fluid/operators/reader/buffered_reader.cc:1 (pinned-
memory double buffering), reader/create_py_reader_op.cc +
lod_tensor_blocking_queue.h (a Python thread feeding a blocking queue the
graph's read op pops), python/paddle/fluid/layers/io.py py_reader:633,
double_buffer:1002.

Design: a daemon thread pulls host batches from the user's reader and
starts their host→device copies at once, then parks the batch in a
bounded queue; the training loop pops ready feed dicts, so the steady
state step time is max(compute, transfer) rather than their sum.  Where
the reference's `jax.device_put` is asynchronous and safe across threads
by itself, the port's copy to a CUDA device is made so explicitly
(`_place`):

1. the producer pins the host arrays (`pin_memory()`);
2. copies them with `.to(device, non_blocking=True)` on a copy stream of
   the feeder's own;
3. records an event after the copies, which the consumer makes its
   current stream wait on before it hands the batch out (`_ready`);
4. marks each tensor with `record_stream` on the consumer's stream, so
   the caching allocator does not give its memory to the next copy while
   a step still reads it.

A batch asked for the card is never kept on the host.  `device` None
means CUDAPlace(0) and raises without CUDA, as the Executor does; the
tests pass `CPUPlace()`.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .decorator import _ReaderError

_STOP = object()

# producer-exception classes retried by default: the transient I/O
# family (a flaky remote filesystem / dataset service).  A ValueError
# from a broken reader is NOT transient — it reproduces on replay, so
# retrying it would just burn the budget before the same _ReaderError.
DEFAULT_RETRYABLE: Tuple[type, ...] = (ConnectionError, TimeoutError)

# the reference's join timeout for a producer that outlives reset()
JOIN_TIMEOUT_S = 5.0


def feed_signature(batch: Dict[str, Any]) -> Dict[str, Tuple[str, int]]:
    """The per-feed (dtype, ndim) signature validation locks onto
    after the first accepted batch (in the reference a drift would
    retrace the jitted step; in the port it would feed the step a batch
    of another kind than every batch before it)."""
    return {n: (str(np.asarray(v).dtype), int(np.asarray(v).ndim))
            for n, v in batch.items()}


def validate_feed_batch(batch: Dict[str, Any],
                        signature: Optional[Dict[str, Tuple[str, int]]]
                        = None) -> List[Dict[str, Any]]:
    """Host-side admission check of a batch of host arrays, shared by
    DeviceFeeder(validate=True) and Trainer(validate_feed=True): every
    float feed must be finite,
    and (with a locked signature) dtypes/ndims must match the first
    accepted batch.  Returns a list of structured problems (empty =
    admit) — the payload of the `feed_quarantined` event."""
    problems: List[Dict[str, Any]] = []
    for name, v in batch.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            finite = np.isfinite(arr)
            if not finite.all():
                problems.append(
                    {"name": name, "problem": "nonfinite",
                     "bad_values": int(arr.size - int(finite.sum()))})
        if signature is not None:
            want = signature.get(name)
            got = (str(arr.dtype), int(arr.ndim))
            if want is None:
                problems.append({"name": name,
                                 "problem": "unknown_feed"})
            elif want != got:
                problems.append({"name": name,
                                 "problem": "signature_drift",
                                 "want": list(want),
                                 "got": list(got)})
    if signature is not None:
        for name in sorted(set(signature) - set(batch)):
            problems.append({"name": name, "problem": "missing_feed"})
    return problems


def _feed_device(device) -> torch.device:
    """A Paddle place (None: CUDAPlace(0)), or a torch device."""
    from .. import CPUPlace, CUDAPlace
    from ..core.executor import place_device

    if device is None or isinstance(device, (CPUPlace, CUDAPlace)):
        return place_device(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        return place_device(CUDAPlace(dev.index or 0))
    return dev


class _Placed:
    """A batch whose copies were issued: its tensors on the feeder's
    device and, on a CUDA device, the event recorded after the copies."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


class DeviceFeeder:
    """Iterator of device-resident feed dicts ({name: torch.Tensor}) with
    background prefetch (paddle_tpu/data/pipeline.py:82-307).

    reader: callable returning an iterable of feed dicts
            ({name: np.ndarray}) — one dict per step.
    capacity: max in-flight prefetched batches (2 = classic double
              buffering; raise it to ride out producer jitter).
    device: where the batches go: a place (None: CUDAPlace(0)) or a
            torch device.
    validate: host-side admission check (validate_feed_batch) before
              any copy is spent — a poisoned batch is dropped with a
              `feed_quarantined` event + counter instead of reaching
              the step.
    retryable: exception classes the producer treats as TRANSIENT:
               instead of killing the pass via _ReaderError it
               re-opens the reader, fast-forwards past the batches
               already produced (the reader must be deterministic —
               the same contract checkpoint resume already imposes),
               and retries with exponential backoff, up to
               max_retries consecutive failures.
    stall_timeout_s: producer-stall watchdog on the CONSUMER side — a
               `next()` that waits longer than this emits a loud
               `feeder_stall` event (queue depth attached) and keeps
               waiting, instead of blocking the training loop
               silently.
    event_log: an observe.RunEventLog for the feeder_* /
               feed_quarantined events (stderr otherwise).

    `queue_depths` keeps the queue's depth at each `next()` of the
    current pass (before its pop).
    """

    def __init__(self, reader: Callable[[], Iterable[Dict[str, Any]]],
                 capacity: int = 2, device=None, validate: bool = False,
                 retryable: Optional[Tuple[type, ...]] = None,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 stall_timeout_s: Optional[float] = None,
                 event_log=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self._reader = reader
        self._capacity = capacity
        self.device = _feed_device(device)
        self._validate = bool(validate)
        self._retryable = (DEFAULT_RETRYABLE if retryable is None
                           else tuple(retryable))
        self._max_retries = int(max_retries)
        self._backoff_s = float(backoff_s)
        self._stall_timeout_s = stall_timeout_s
        self._event_log = event_log
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._signature: Optional[Dict[str, Tuple[str, int]]] = None
        self._copy_stream = None
        self._speed_test_item = None
        self.quarantined = 0   # admission-rejected batches (validate)
        self.retries = 0       # transient producer errors survived
        self.stalls = 0        # feeder_stall events emitted
        self.queue_depths: List[int] = []

    def _emit(self, kind: str, **fields):
        if self._event_log is not None:
            self._event_log.event(kind, **fields)
        else:
            print(f"DeviceFeeder {kind}: "
                  + " ".join(f"{k}={v}" for k, v in fields.items()),
                  file=sys.stderr)

    # -- lifecycle (py_reader start/reset parity) -----------------------
    def start(self):
        """Begin prefetching a fresh pass over the reader."""
        self.reset()
        self._queue = queue.Queue(maxsize=self._capacity)
        self._stop.clear()
        self.queue_depths = []
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue,), daemon=True)
        self._thread.start()
        return self

    def reset(self):
        """Stop the current pass (reference py_reader.reset).  The
        producer owns its queue reference, so a slow reader that outlives
        the join timeout dies quietly on the stop flag instead of
        crashing on a nulled queue; copies already issued finish on the
        copy stream, and their tensors are dropped with the queue."""
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=JOIN_TIMEOUT_S)
        self._thread = None
        self._queue = None
        # a fresh pass must not serve the previous pass's cached
        # speed-test batch
        self._speed_test_item = None

    # -- producer -------------------------------------------------------
    def _put(self, q: queue.Queue, item) -> bool:
        """Blocking put that aborts when reset() raises the stop flag."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reopen(self, produced: int):
        """Recover a transient producer failure: re-open the reader
        and fast-forward past the batches already handed downstream —
        the deterministic-reader contract checkpoint resume already
        imposes makes the replayed prefix identical."""
        it = iter(self._reader())
        for _ in range(produced):
            next(it)
        return it

    def _place(self, batch: Dict[str, Any]) -> _Placed:
        """Issue the batch's host→device copies (the counterpart of the
        reference's asynchronous `jax.device_put`)."""
        host = {n: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, copy=True))
                for n, v in batch.items()}
        if self.device.type != "cuda":
            return _Placed({n: t.to(self.device) for n, t in host.items()},
                           None)
        with torch.cuda.stream(self._copy_stream):
            placed = {n: t.pin_memory().to(self.device, non_blocking=True)
                      for n, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _Placed(placed, event)

    def _producer(self, q: queue.Queue):
        from ..resilience import chaos

        produced = 0     # batches handed to the queue this pass
        attempts = 0     # consecutive transient failures
        try:
            it = iter(self._reader())
            while not self._stop.is_set():
                try:
                    # deterministic fault injection for the retry and
                    # stall-watchdog proofs (tests + chip_smoke)
                    chaos.delaypoint("feeder:producer")
                    chaos.failpoint("feeder:producer")
                    batch = next(it)
                except StopIteration:
                    self._put(q, _STOP)
                    return
                except self._retryable as e:
                    attempts += 1
                    if attempts > self._max_retries:
                        raise
                    self.retries += 1
                    self._emit("feeder_retry", attempt=attempts,
                               max_retries=self._max_retries,
                               produced=produced,
                               error=f"{type(e).__name__}: {e}")
                    time.sleep(self._backoff_s * (2 ** (attempts - 1)))
                    it = self._reopen(produced)
                    continue
                attempts = 0
                if self._validate:
                    problems = validate_feed_batch(batch,
                                                   self._signature)
                    if problems:
                        self.quarantined += 1
                        self._emit("feed_quarantined",
                                   produced=produced,
                                   quarantined=self.quarantined,
                                   problems=problems)
                        continue
                    if self._signature is None:
                        self._signature = feed_signature(batch)
                if not self._put(q, self._place(batch)):
                    return
                produced += 1
        except BaseException as e:  # surfaced on the consumer side
            self._put(q, _ReaderError(e))

    # -- consumer -------------------------------------------------------
    def __iter__(self):
        if self._queue is None:
            self.start()
        return self

    def _get(self):
        """Queue pop with the producer-stall watchdog: waiting past
        stall_timeout_s emits a loud `feeder_stall` (queue depth +
        cumulative wait attached) and keeps waiting — the starved
        consumer is diagnosable without killing the pass."""
        self.queue_depths.append(self._queue.qsize())
        if not self._stall_timeout_s:
            return self._queue.get()
        waited = 0.0
        while True:
            try:
                return self._queue.get(timeout=self._stall_timeout_s)
            except queue.Empty:
                waited += self._stall_timeout_s
                self.stalls += 1
                self._emit("feeder_stall",
                           queue_depth=self._queue.qsize(),
                           capacity=self._capacity,
                           waited_s=round(waited, 3),
                           producer_alive=(
                               self._thread is not None
                               and self._thread.is_alive()))

    def _ready(self, item: _Placed) -> Dict[str, torch.Tensor]:
        """The batch, safe to use on the consumer's current stream."""
        if item.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.event)
            for t in item.batch.values():
                t.record_stream(stream)
        return item.batch

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._queue is None:
            raise StopIteration
        from ..flags import FLAGS

        if FLAGS.reader_queue_speed_test_mode:
            # non-destructive mode (reference
            # FLAGS_reader_queue_speed_test_mode): serve the first batch
            # forever so consumer-side throughput excludes producer cost
            if self._speed_test_item is None:
                self._speed_test_item = self._get()
            item = self._speed_test_item
        else:
            item = self._get()
        if item is _STOP:
            self._queue = None
            self._thread = None
            raise StopIteration
        if isinstance(item, _ReaderError):
            self._queue = None
            raise item.error
        return self._ready(item)


class PyReader:
    """fluid-style py_reader facade (reference layers/io.py:633;
    paddle_tpu/data/pipeline.py:310-372): declare feed vars once,
    decorate with a batch generator, iterate device-resident batches.

        reader = PyReader(feed_list=[img, label], capacity=4)
        reader.decorate_batch_generator(my_batches)
        for feed in reader:
            exe.run(main, feed=feed, fetch_list=[loss])

    `place` is the batches' device (None: CUDAPlace(0)).
    """

    def __init__(self, feed_list: Sequence, capacity: int = 2,
                 place=None):
        self._names: List[str] = []
        for v in feed_list:
            name = v if isinstance(v, str) else v.name
            self._names.append(name)
            # sequence inputs (lod_level > 0) need their .seq_len
            # companion fed too: expect it as the next tuple slot
            # (mirrors DataFeeder, data/data_feeder.py)
            if (not isinstance(v, str)
                    and getattr(v.desc, "lod_level", 0) > 0):
                self._names.append(f"{name}.seq_len")
        self._capacity = capacity
        self._place = place
        self._feeder: Optional[DeviceFeeder] = None
        self._gen = None

    def decorate_batch_generator(self, generator):
        """generator: callable -> iterable of tuples/lists/dicts of numpy
        batches aligned with feed_list."""
        names = self._names

        def reader():
            for item in generator():
                if isinstance(item, dict):
                    yield item
                else:
                    if len(item) != len(names):
                        raise ValueError(
                            f"batch has {len(item)} arrays for "
                            f"{len(names)} feed vars {names}")
                    yield dict(zip(names, item))

        self._gen = reader
        return self

    decorate_paddle_reader = decorate_batch_generator

    def start(self):
        if self._gen is None:
            raise RuntimeError("decorate_batch_generator first")
        self._feeder = DeviceFeeder(self._gen, capacity=self._capacity,
                                    device=self._place)
        self._feeder.start()
        return self

    def reset(self):
        if self._feeder is not None:
            self._feeder.reset()
            self._feeder = None

    def __iter__(self):
        if self._feeder is None:
            self.start()
        return iter(self._feeder)
