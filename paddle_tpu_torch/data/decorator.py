"""Reader decorators: the port of paddle_tpu/data/decorator.py (plain
Python; the port keeps its own copy).

reference: python/paddle/reader/decorator.py:58-338 — a reader is a
zero-arg callable returning an iterable of samples; decorators compose
readers.  `shuffle(seed=)` draws from a private `random.Random(seed)`
exactly as the reference's does, so one seed gives one order in both
packages — what a Trainer's bit-exact resume needs from its reader.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import List


def map_readers(func, *readers):
    """Apply func elementwise across readers (decorator.py map_readers)."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Pool-shuffle with a bounded buffer (decorator.py shuffle).

    With `seed` the shuffle order is drawn from a PRIVATE
    `random.Random(seed)` re-seeded on every `reader_()` call — the
    stream is then a pure function of (seed, underlying reader), so a
    process killed and relaunched replays the exact same feed order.
    contrib.Trainer's bit-exact resume guarantee requires deterministic
    readers; the seedless form uses the global RNG and is NOT
    resume-safe (documented in docs/RESILIENCE.md)."""

    def reader_():
        rng = _random.Random(seed) if seed is not None else _random
        buf: List = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return reader_


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment: bool = True):
    """Zip readers into tuple samples (decorator.py compose)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iters = itertools.zip_longest(*rs)
        for outputs in iters:
            if check_alignment and any(o is None for o in outputs):
                raise RuntimeError("readers have different lengths")
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size: int):
    """Background-thread prefetch buffer (decorator.py buffered) — the
    host-side analog of the reference's double-buffer reader op."""

    end = object()

    def reader_():
        q: queue.Queue = queue.Queue(maxsize=size)

        def fill():
            try:
                for sample in reader():
                    q.put(sample)
                q.put(end)
            except BaseException as e:  # propagate to the consumer
                q.put(_ReaderError(e))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            sample = q.get()
            if sample is end:
                break
            if isinstance(sample, _ReaderError):
                raise sample.error
            yield sample

    return reader_


class _ReaderError:
    """Exception carrier across reader threads."""

    def __init__(self, error: BaseException):
        self.error = error


def firstn(reader, n: int):
    def reader_():
        yield from itertools.islice(reader(), n)

    return reader_


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (paddle.batch)."""

    def reader_():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return reader_


def xmap_readers(mapper, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Parallel map over a thread pool (decorator.py xmap_readers)."""

    end = object()

    def reader_():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
                for _ in range(process_num):
                    in_q.put(end)
            except BaseException as e:
                out_q.put(_ReaderError(e))

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                try:
                    out_q.put((i, mapper(sample)))
                except BaseException as e:
                    out_q.put(_ReaderError(e))
                    return

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, _ReaderError):
                raise item.error
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return reader_


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run each reader in its OWN process and interleave their samples
    (reference: python/paddle/reader/decorator.py multiprocess_reader —
    process count == reader count, merged through a queue or pipes).
    Readers must be picklable (top-level functions / closures over
    picklable state).  Samples pass through a multiprocessing.Queue
    (use_pipe=False) or one Pipe per reader (use_pipe=True, the
    reference default); order across readers is arrival order."""
    import multiprocessing

    if not isinstance(readers, (list, tuple)) or not readers:
        raise ValueError("multiprocess_reader needs a non-empty list "
                         "of readers")
    _END = "__multiprocess_reader_end__"
    _ERR = "__multiprocess_reader_err__"

    def _work(r, emit):
        # a crashed child must SURFACE, not masquerade as exhaustion —
        # the parent re-raises instead of training on truncated data
        try:
            for sample in r():
                emit(sample)
            emit(_END)
        except Exception as e:  # noqa: BLE001 — crossing processes
            emit((_ERR, f"{type(e).__name__}: {e}"))

    def _handle(item):
        """→ ('end'|'err'|'sample', payload)."""
        if isinstance(item, str) and item == _END:
            return "end", None
        if (isinstance(item, tuple) and len(item) == 2
                and item[0] == _ERR):
            raise RuntimeError(
                f"multiprocess_reader: child reader failed: {item[1]}")
        return "sample", item

    def _queue_reader():
        q = multiprocessing.Queue(queue_size)
        procs = [multiprocessing.Process(target=_work,
                                         args=(r, q.put), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            kind, item = _handle(q.get())
            if kind == "end":
                finished += 1
            else:
                yield item
        for p in procs:
            p.join()

    def _pipe_reader():
        conns, procs = [], []
        for r in readers:
            parent, child = multiprocessing.Pipe(duplex=False)
            p = multiprocessing.Process(target=_work,
                                        args=(r, child.send),
                                        daemon=True)
            p.start()
            conns.append(parent)
            procs.append(p)
        live = list(conns)
        while live:
            for conn in list(live):
                if not conn.poll(0.01):
                    continue
                kind, item = _handle(conn.recv())
                if kind == "end":
                    live.remove(conn)
                else:
                    yield item
        for p in procs:
            p.join()

    return _pipe_reader if use_pipe else _queue_reader


class Fake:
    """Cache the FIRST sample of a reader and replay it `data_num`
    times (reference decorator.py:509 — frozen-feed speed testing;
    bench.py's data_mode="frozen" is the device-side analog)."""

    def __init__(self):
        self.data = None

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            for _ in range(data_num):
                yield self.data

        return fake_reader
