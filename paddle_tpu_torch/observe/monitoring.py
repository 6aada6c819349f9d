"""Host-side runtime accounting: compile counters and latency histograms.

The port of the jax-free half of paddle_tpu/observe/monitoring.py.  On
the TPU the expensive host-side events were XLA compiles; here they are
the builds of the hand-written CUDA kernels (`nvcc`, in
ops/kernels/_build.py), which record themselves as compiles.  So a kernel
built after a serving engine's warmup shows up as
`post_warmup_compiles > 0`, the same loud signal as a shape leak in the
reference.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional

_FIELDS = ("compiles", "compile_time_s")


class RuntimeStats:
    """Monotonic counters for the process; use snapshot()/delta() to
    attribute a region (a warmup, a telemetry window)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0           # kernel builds
        self.compile_time_s = 0.0   # their total wall time

    def record_compile(self, duration_s: float):
        with self._lock:
            self.compiles += 1
            self.compile_time_s += float(duration_s)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {f: getattr(self, f) for f in _FIELDS}

    def delta(self, since: Dict[str, Any]) -> Dict[str, Any]:
        now = self.snapshot()
        return {f: now[f] - since.get(f, 0) for f in _FIELDS}


runtime_stats = RuntimeStats()


class LatencyHistogram:
    """Fixed log-spaced latency histogram with percentile estimates.

    Log-spaced bins (default 20/decade from 10 µs to 60 s, about 7%
    relative resolution) hold counts only, so record() is O(1) and
    memory is constant.  percentile() returns the upper edge of the bin
    holding the rank — a <=7% overestimate, never an underestimate.
    Thread-safe.
    """

    def __init__(self, lo_ms: float = 0.01, hi_ms: float = 60000.0,
                 bins_per_decade: int = 20):
        if not (0 < lo_ms < hi_ms):
            raise ValueError("need 0 < lo_ms < hi_ms")
        self._lo = lo_ms
        self._k = bins_per_decade
        self._nbins = (int(math.ceil(
            math.log10(hi_ms / lo_ms) * bins_per_decade)) + 2)
        # bin 0 catches < lo_ms; the last bin catches >= hi_ms
        self._counts = [0] * self._nbins
        self._lock = threading.Lock()
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def _bin(self, ms: float) -> int:
        if ms < self._lo:
            return 0
        idx = int(math.log10(ms / self._lo) * self._k) + 1
        return min(idx, self._nbins - 1)

    def _edge(self, idx: int) -> float:
        # upper edge of bin idx (bin 0's edge is lo_ms itself)
        return self._lo * 10.0 ** (idx / self._k)

    def record(self, ms: float):
        ms = float(ms)
        with self._lock:
            self._counts[self._bin(ms)] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100] -> latency ms (bin upper edge), None if empty."""
        with self._lock:
            if self.count == 0:
                return None
            rank = p / 100.0 * self.count
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    # never report past the observed max (the top bins
                    # are coarse)
                    return min(self._edge(i), self.max_ms)
            return self.max_ms

    def summary(self) -> Dict[str, Any]:
        """{count, mean_ms, sum_ms, max_ms, p50_ms, p95_ms, p99_ms}."""
        with self._lock:
            count, total, mx = self.count, self.sum_ms, self.max_ms
        out: Dict[str, Any] = {"count": count}
        out["sum_ms"] = round(total, 3)
        out["mean_ms"] = round(total / count, 3) if count else None
        out["max_ms"] = round(mx, 3) if count else None
        for p in (50, 95, 99):
            v = self.percentile(p)
            out[f"p{p}_ms"] = round(v, 3) if v is not None else None
        return out
