"""Profiling: `fluid.profiler`.

The port of paddle_tpu/profiler.py (reference:
python/paddle/fluid/profiler.py:221, the profiler context manager, with
RecordEvent ranges and the CUPTI device tracer).  `profiler(...)` runs
`torch.profiler` over the enclosed region, with CUDA activity on the
card, while the executor marks every op (observe/trace.py `op_ranges`);
the trace is written as chrome-trace JSON under `profile_path`, and with
`sorted_key` the fluid per-op time table is printed from it.

A profile taken with CUDA activity that records no device event raises:
a CPU-only table would hide that the card did nothing.

On the card the recording opens `CARD_WINDOW_PAD_S` before the region
and closes that long after it.  The profiler keeps only device records
inside its window on the host's clock, and a trace's kernel times have
read up to 125 ms off the host's (ROADMAP C22): a kernel at the region's
edge stays inside the window all the same.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

# the reference's /tmp/profile, under this process's temporary directory
DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "profile")

_running = {"prof": None, "ranges": None, "path": None, "cuda": False}

# the idle margin on each side of a profiled region on the card: twice
# the largest offset between a trace's kernel and launch times read so
# far (chip_profiler_repeat.py, chip_smoke.py's Kineto warnings)
CARD_WINDOW_PAD_S = 0.25


def _activities(state: str):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = str(state).upper() != "CPU" and torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts, cuda


def start_profiler(state: str = "All",
                   profile_path: str = DEFAULT_PATH):
    """Start recording (fluid's start_profiler): `state` "CPU" records
    the host only; "GPU"/"All" add the card's activity when CUDA is
    available."""
    import torch

    from .observe.trace import op_ranges

    if _running["prof"] is not None:
        raise RuntimeError("a profiler is already running")
    os.makedirs(profile_path, exist_ok=True)
    acts, cuda = _activities(state)
    ranges = op_ranges(ranges=True).__enter__()
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except BaseException:
        ranges.__exit__(None, None, None)
        raise
    if cuda:
        torch.cuda.synchronize()
        time.sleep(CARD_WINDOW_PAD_S)
    _running.update(prof=prof, ranges=ranges, path=profile_path,
                    cuda=cuda)


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None) -> str:
    """Stop recording, write the trace and (with `sorted_key`) print the
    per-op table.  Returns the trace's path."""
    import torch

    prof, ranges = _running["prof"], _running["ranges"]
    if prof is None:
        raise RuntimeError("no profiler is running")
    path = profile_path or _running["path"]
    cuda = _running["cuda"]
    _running.update(prof=None, ranges=None, path=None, cuda=False)
    try:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(CARD_WINDOW_PAD_S)
        prof.__exit__(None, None, None)
    finally:
        ranges.__exit__(None, None, None)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(out)
    if cuda:
        from .observe.trace import device_events, event_counts

        if not any(card for *_rest, card in device_events(path)):
            # which of the host's launches and the card's records the
            # trace kept tells a region that launched nothing from
            # records the profiler lost (ROADMAP C22)
            raise RuntimeError(
                f"the profile under {path!r} recorded no CUDA activity: "
                f"no kernel of the profiled region reached its trace "
                f"(events by category {event_counts(path)})")
    if sorted_key:
        print_profile_summary(path, sorted_key)
    return out


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: str = DEFAULT_PATH):
    """Drop-in for fluid.profiler.profiler: records the enclosed region
    and, with `sorted_key` ("total"/"calls"/"max"/"min"/"ave"), prints
    the per-op time table after it."""
    start_profiler(state, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def print_profile_summary(profile_path: str = DEFAULT_PATH,
                          sorted_key: str = "total"):
    """Print the per-op time table of the newest trace under
    `profile_path`."""
    from .observe import trace as _trace

    print(_trace.format_op_table(profile_path, sorted_key=sorted_key))


def profile_table(profile_path: str = DEFAULT_PATH):
    """The per-op rows of the newest trace (op_type/calls/total_ms/
    avg_ms/max_ms/min_ms/ratio)."""
    from .observe import trace as _trace

    return _trace.op_time_table(profile_path)


@contextlib.contextmanager
def record_event(name: str):
    """RecordEvent (platform/profiler.h:72): a named host range in the
    trace."""
    import torch

    with torch.profiler.record_function(name):
        yield


def cuda_profiler(*args, **kwargs):
    raise NotImplementedError(
        "cuda_profiler drives nvprof, which the port does not use; use "
        "profiler()/record_event, which record the card's kernels "
        "through torch.profiler")


class Timer:
    """Host-side timer (platform/timer.h) for benchmark reporting."""

    def __init__(self):
        self._start = None
        self.elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()

    def pause(self):
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self):
        self._start = None
        self.elapsed = 0.0
