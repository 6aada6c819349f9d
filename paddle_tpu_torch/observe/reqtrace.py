"""Per-request tracing: the port of paddle_tpu/observe/reqtrace.py.

Aggregate percentiles answer "how slow is the service"; they cannot
answer "why was THIS request slow" — under continuous batching the
interesting pathologies are per-request (a mid-stream join that waited
for pages, a preemption) and vanish into a p99.  This module is the
host-side tracer the serving stack threads a `RequestTrace` through:

- **spans are host timestamps at queue boundaries only** — submit, slot
  admission, dispatch start/return.  Nothing here touches the device:
  zero extra kernel launches, zero kernel builds, the same programs
  whether tracing is on or off (tests/test_torch_reqtrace.py).
- **head sampling + tail-based keep** — `sample_rate` head-samples the
  normal traffic (deterministic 1-in-round(1/rate)), but every trace is
  recorded until it finishes and is force-kept when it turns out to
  matter: an error, a failover/hedge/preemption marker, or an
  end-to-end time over `slow_keep_ms`.  `sample_rate=0` keeps exactly
  the pathologies.
- **bounded memory** — kept traces land in a ring (`capacity`); spans
  per trace are capped (`max_spans`, drops counted).
- **exact phase aggregation regardless of sampling** — every finished
  trace folds its span durations into per-phase `LatencyHistogram`s
  (`phase_summary()`), so join_wait/dispatch percentiles cover ALL
  requests even at sample_rate=0.
- **one timeline** — `export_chrome_trace()` renders the kept window as
  a chrome://tracing / Perfetto JSON: rows (pids) are replicas (the
  router is its own row), one line per trace.

Span taxonomy: decode uses `join_wait` / `dispatch` (kind=prefill|
decode, one per chunk or verify round; `speculate` beside each verify
round) plus `preempt` / `evacuated` / `rejected` point markers; the
fleet router (serving/fleet.py) adds `route` and `failover` spans and
`hedge`, `abandoned` and `complete` markers; the disagg `kv_transfer`
comes with its slice (ROADMAP queue A step 9b).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from .monitoring import LatencyHistogram

# a span/point with one of these names force-keeps its trace at
# finish(): these are exactly the per-request pathologies aggregate
# percentiles hide
TAIL_KEEP_MARKS = ("failover", "hedge", "abandoned", "preempt",
                   "evacuated")


def new_trace_id() -> str:
    """16 hex chars, unique per request (not per attempt: the id is
    what ties a failover's hops together)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One phase of one request: a named [t0, t1) host interval with
    attributes (replica_id/slot/bucket/...).  Timestamps are
    time.monotonic() seconds; durations are exact, absolute times are
    only comparable within one process."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Dict[str, Any]):
        self.name = name
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.attrs = attrs

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "t0": round(self.t0, 6),
               "dur_ms": round(self.duration_ms, 3)}
        if self.attrs:
            out.update(self.attrs)
        return out

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration_ms:.3f}ms, "
                f"{self.attrs})")


class RequestTrace:
    """Host-side trace of one logical request across replicas.

    Thread-safe append-only: the submit thread, batcher/scheduler
    threads, and fleet callbacks all add spans to the same trace.  The
    trace object itself travels with the request (a field on the
    engine-side Request / the router-side _FleetRequest), so no
    context-propagation machinery is needed — the repo is one process.
    """

    __slots__ = ("trace_id", "kind", "t_create", "t_finish", "spans",
                 "head_sampled", "finished", "kept", "keep_reason",
                 "error", "dropped_spans", "fleet_owned", "_max_spans",
                 "_lock")

    def __init__(self, kind: str = "request", head_sampled: bool = True,
                 max_spans: int = 512,
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.kind = kind
        self.t_create = time.monotonic()
        self.t_finish: Optional[float] = None
        self.spans: List[Span] = []
        self.head_sampled = bool(head_sampled)
        self.finished = False
        self.kept = False
        self.keep_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.dropped_spans = 0
        self.fleet_owned = False   # the router finishes it, engines
        #                            only add spans
        self._max_spans = int(max_spans)
        self._lock = threading.Lock()

    # -- recording ------------------------------------------------------
    def add(self, name: str, t0: float, t1: float, **attrs: Any
            ) -> Optional[Span]:
        """Record one completed phase from explicit monotonic
        timestamps (the engines know their queue-boundary stamps
        already — e.g. Request.t_submit — so spans are added
        retroactively in one call, no begin/end pairing across
        threads)."""
        sp = Span(name, t0, t1, attrs)
        with self._lock:
            if len(self.spans) >= self._max_spans:
                self.dropped_spans += 1
                return None
            self.spans.append(sp)
        return sp

    def point(self, name: str, **attrs: Any) -> Optional[Span]:
        """Instantaneous marker (preempt / hedge / abandoned ...)."""
        now = time.monotonic()
        return self.add(name, now, now, **attrs)

    # -- reading --------------------------------------------------------
    @property
    def duration_ms(self) -> float:
        end = self.t_finish if self.t_finish is not None \
            else time.monotonic()
        return (end - self.t_create) * 1e3

    def span_names(self) -> List[str]:
        with self._lock:
            return [s.name for s in self.spans]

    def find(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def has(self, name: str) -> bool:
        with self._lock:
            return any(s.name == name for s in self.spans)

    def replica_ids(self) -> List[int]:
        """Distinct replica_id attrs across spans, in first-seen order
        — the hop chain a chrome export renders as rows."""
        seen: List[int] = []
        with self._lock:
            for s in self.spans:
                r = s.attrs.get("replica_id")
                if r is not None and r not in seen:
                    seen.append(r)
        return seen

    def phase_ms(self) -> Dict[str, float]:
        """Total milliseconds per span name (the per-request phase
        breakdown)."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = out.get(s.name, 0.0) + s.duration_ms
        return {k: round(v, 3) for k, v in out.items()}

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [s.as_dict() for s in self.spans]
        return {"trace_id": self.trace_id, "kind": self.kind,
                "duration_ms": round(self.duration_ms, 3),
                "error": self.error, "kept": self.kept,
                "keep_reason": self.keep_reason,
                "dropped_spans": self.dropped_spans,
                "spans": spans}

    def __repr__(self):
        return (f"RequestTrace({self.trace_id}, {self.kind}, "
                f"{len(self.spans)} spans, "
                f"{self.duration_ms:.1f}ms)")


class ReqTracer:
    """The per-request tracing plane one serving component owns (a
    Fleet, or a directly-used engine).

        tracer = ReqTracer(sample_rate=0.01, slow_keep_ms=500)
        fleet = Fleet(engines, config, tracer=tracer)
        ...
        tracer.phase_summary()       # exact percentiles per phase
        tracer.export_chrome_trace("trace.json", window_s=60)

    sample_rate: head-sampling fraction of NORMAL traces kept
        (deterministic: every round(1/rate)-th).  0 keeps only the
        tail (slow/error/failover/...); 1 keeps everything.
    slow_keep_ms: tail-keep any trace slower end-to-end than this
        (None disables the latency criterion).
    capacity: kept-trace ring bound (oldest evicted).
    max_spans: per-trace span cap (chunked decode generates one
        dispatch span per chunk; a 10k-token generation must not
        grow without bound).
    """

    def __init__(self, sample_rate: float = 1.0, capacity: int = 512,
                 slow_keep_ms: Optional[float] = None,
                 max_spans: int = 512):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError("sample_rate must be in [0, 1]")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if slow_keep_ms is not None and slow_keep_ms <= 0:
            raise ValueError("slow_keep_ms must be > 0")
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self.slow_keep_ms = slow_keep_ms
        self.max_spans = int(max_spans)
        self._ring: deque = deque(maxlen=self.capacity)
        self._phase_hists: Dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()
        self._seq = 0
        # lifetime counters (the reqtrace_* metrics family)
        self.started = 0
        self.finished = 0
        self.kept = 0
        self.tail_kept = 0     # kept ONLY because of a tail criterion
        self.errors = 0

    # -- trace lifecycle ------------------------------------------------
    def _head_sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        period = max(1, int(round(1.0 / self.sample_rate)))
        return self._seq % period == 0

    def new_trace(self, kind: str = "request") -> RequestTrace:
        with self._lock:
            head = self._head_sample()
            self._seq += 1
            self.started += 1
        return RequestTrace(kind=kind, head_sampled=head,
                            max_spans=self.max_spans)

    def finish(self, trace: RequestTrace,
               error: Optional[BaseException] = None) -> bool:
        """Close one trace: stamp the end, fold span durations into
        the exact per-phase histograms, decide keep (head sample OR
        tail criteria) and ring it.  Idempotent — a failover path may
        race a late engine resolution; the first finish wins."""
        with trace._lock:
            if trace.finished:
                return trace.kept
            trace.finished = True
            trace.t_finish = time.monotonic()
            if error is not None:
                trace.error = f"{type(error).__name__}: {error}"
            spans = list(trace.spans)
        marks = [s.name for s in spans if s.name in TAIL_KEEP_MARKS]
        reason = None
        if trace.error is not None:
            reason = "error"
        elif marks:
            reason = marks[0]
        elif (self.slow_keep_ms is not None
              and trace.duration_ms >= self.slow_keep_ms):
            reason = "slow"
        keep = trace.head_sampled or reason is not None
        trace.kept = keep
        trace.keep_reason = reason if reason is not None else (
            "head_sampled" if keep else None)
        with self._lock:
            self.finished += 1
            if trace.error is not None:
                self.errors += 1
            for s in spans:
                h = self._phase_hists.get(s.name)
                if h is None:
                    h = self._phase_hists[s.name] = LatencyHistogram()
                h.record(s.duration_ms)
            if keep:
                self.kept += 1
                if reason is not None and not trace.head_sampled:
                    self.tail_kept += 1
                self._ring.append(trace)
        return keep

    # -- reading --------------------------------------------------------
    def traces(self, window_s: Optional[float] = None
               ) -> List[RequestTrace]:
        """Kept traces, oldest first; `window_s` restricts to traces
        finished within the last window_s seconds."""
        with self._lock:
            out = list(self._ring)
        if window_s is not None:
            cut = time.monotonic() - window_s
            out = [t for t in out
                   if t.t_finish is not None and t.t_finish >= cut]
        return out

    def trace(self, trace_id: str) -> Optional[RequestTrace]:
        with self._lock:
            for t in self._ring:
                if t.trace_id == trace_id:
                    return t
        return None

    def phase_summary(self) -> Dict[str, Dict[str, Any]]:
        """{phase: LatencyHistogram.summary()} over EVERY finished
        trace (sampling only affects which traces are retained whole,
        never these aggregates)."""
        with self._lock:
            hists = dict(self._phase_hists)
        return {name: h.summary() for name, h in sorted(hists.items())}

    def phase_histograms(self) -> Dict[str, LatencyHistogram]:
        """The live per-phase histograms (the metrics registry's
        histogram source; treat as read-only)."""
        with self._lock:
            return dict(self._phase_hists)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"started": self.started, "finished": self.finished,
                    "kept": self.kept, "tail_kept": self.tail_kept,
                    "errors": self.errors,
                    "ring_size": len(self._ring),
                    "capacity": self.capacity,
                    "sample_rate": self.sample_rate}

    # -- chrome trace export --------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None,
                            window_s: Optional[float] = None
                            ) -> Dict[str, Any]:
        """Render the kept window as a chrome://tracing JSON.

        Rows: pid = replica (span attr `replica_id`; spans without one
        — the router's route/failover bookkeeping — land on the
        "router" row), tid = one line per trace within its replica row,
        so concurrent requests stack instead of overlapping.  A
        failed-over request's single trace_id therefore draws its
        queue/dispatch spans on replica A's row, the failover hop, and
        the completion spans on replica B's row — one timeline for a
        ragged stream under chaos.  Timestamps are µs relative to the
        oldest exported trace.

        Disagg handoffs additionally render as chrome FLOW events: a
        `kv_transfer` span (router row; from_replica/to_replica attrs)
        emits an `s`/`f` arrow pair from the prefill worker's row to
        the decode worker's row, so one trace_id draws
        prefill-row → transfer arrow → decode-row."""
        traces = self.traces(window_s)
        events: List[Dict[str, Any]] = []
        if not traces:
            out = {"traceEvents": [], "displayTimeUnit": "ms"}
            if path:
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(out, f)
            return out
        base = min(t.t_create for t in traces)
        ROUTER_PID = 0
        pids = {None: ROUTER_PID}

        def pid_of(replica_id):
            if replica_id not in pids:
                pids[replica_id] = int(replica_id) + 1
            return pids[replica_id]

        flow_id = 0
        for tid, t in enumerate(traces, start=1):
            with t._lock:
                spans = list(t.spans)
            for s in spans:
                ev: Dict[str, Any] = {
                    "name": s.name, "ph": "X", "cat": t.kind,
                    "ts": round((s.t0 - base) * 1e6, 1),
                    "dur": max(round((s.t1 - s.t0) * 1e6, 1), 1.0),
                    "pid": pid_of(s.attrs.get("replica_id")),
                    "tid": tid,
                    "args": {"trace_id": t.trace_id, **s.attrs},
                }
                if t.error:
                    ev["args"]["trace_error"] = t.error
                events.append(ev)
                if s.name == "kv_transfer" \
                        and s.attrs.get("from_replica") is not None \
                        and s.attrs.get("to_replica") is not None:
                    # the handoff arrow: flow start on the prefill
                    # worker's row, flow finish on the decode
                    # worker's row, tied by a shared id
                    flow_id += 1
                    common = {"name": "kv_transfer",
                              "cat": "kv_transfer", "tid": tid,
                              "id": flow_id,
                              "args": {"trace_id": t.trace_id}}
                    events.append({
                        **common, "ph": "s",
                        "ts": round((s.t0 - base) * 1e6, 1),
                        "pid": pid_of(s.attrs["from_replica"])})
                    events.append({
                        **common, "ph": "f", "bp": "e",
                        "ts": round((s.t1 - base) * 1e6, 1),
                        "pid": pid_of(s.attrs["to_replica"])})
        for replica_id, pid in pids.items():
            name = ("router" if replica_id is None
                    else f"replica {replica_id}")
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "args": {"name": name}})
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(out, f)
        return out
