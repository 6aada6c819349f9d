"""Serving telemetry: the port of paddle_tpu/serving/stats.py
(`ServingStats`, `DecodeStats`).

`ServingStats` (the dynamic-batching ServingEngine):

- **latency percentiles** — per-request end to end (submit -> future
  resolved) and per-batch run time, as LatencyHistograms;
  `exec_per_req_ms` spreads the batches' run time over their requests.
- **occupancy + padding waste** — real requests per bucket slot, and
  the share of padded elements that carried no data (batch padding +
  ragged sequence padding).
- **robustness counters** — shed (queue-full fast rejects), deadline
  misses (dropped before dispatch), bucket misses, executor failures,
  breaker rejects, hot reloads (count and worst pause).
- **compile hygiene** — runs at an unwarmed signature and kernel builds
  after warmup (runtime_stats) must stay ZERO in steady state.

`DecodeStats` (the continuous-batching DecodeEngine):

- **TTFT vs TPOT** — time-to-first-token (submit -> the prefill that
  produced the request's first token) and time-per-output-token (decode
  chunk wall time amortized over the tokens it produced), as separate
  LatencyHistograms.
- **iteration-level occupancy** — active slots per decode iteration over
  the slot budget.
- **KV page-pool utilization** — allocated pages over the pool, sampled
  at every dispatch (mean + peak).
- **preemptions** — slots evicted because the pool ran dry; evacuations
  and reloads for the fleet; KV-page handoff imports on a disagg decode
  worker.
- **compile hygiene** — as above.
- **speculation** — with `configure_speculation(k)`: verify runs,
  drafted/accepted/emitted tokens and the k+1-bin histogram of accepted
  drafts per slot-verify.

Both `merge()` another replica's stats exactly (histograms bin-wise,
counters summed, gauges maxed): the fleet's aggregation surface.
Snapshots emit as `serving_window` / `serving_decode_window` events
every `window` completed requests and at drain.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..observe.events import RunEventLog
from ..observe.monitoring import LatencyHistogram, runtime_stats


class ServingStats:
    """Thread-safe serving counters + histograms + event emission."""

    def __init__(self, event_log: Optional[RunEventLog] = None,
                 window: int = 256):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._lock = threading.Lock()
        self._event_log = event_log
        self.window = int(window)
        self.e2e_ms = LatencyHistogram()
        self.exec_ms = LatencyHistogram()
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.deadline_misses = 0
        self.bucket_misses = 0
        self.executor_failures = 0   # failed dispatches (batches)
        self.circuit_rejects = 0     # fast-rejects while DEGRADED
        self.batches = 0
        self._slots = 0           # sum of bucket batch sizes dispatched
        self._real = 0            # sum of real requests dispatched
        self._elems_real = 0.0    # element-level fill (ragged-aware)
        self._elems_padded = 0.0
        self.max_queue_depth = 0
        self.reloads = 0             # hot weight swaps applied
        self.reload_pause_ms = 0.0   # worst single swap pause
        self.warmup: Dict[str, Any] = {}
        self._rt_base: Optional[Dict[str, Any]] = None
        self._merged_compiles = 0  # post-warmup compiles folded in by
        #                            merge() from other replicas' stats
        self._emitted_at = 0      # completed count at last window emit
        self._compiles_reported = 0

    # -- recording ------------------------------------------------------
    def record_warmup(self, n_buckets: int, compiles: int,
                      compile_s: float, seconds: float):
        with self._lock:
            self.warmup = {"buckets": n_buckets, "compiles": compiles,
                           "compile_s": round(compile_s, 3),
                           "seconds": round(seconds, 3)}
            # post-warmup compile accounting starts here
            self._rt_base = runtime_stats.snapshot()
        self._emit("serving_warmup", **self.warmup)

    def record_submit(self, queue_depth: int):
        with self._lock:
            self.submitted += 1
            if queue_depth > self.max_queue_depth:
                self.max_queue_depth = queue_depth

    def _bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def record_shed(self):
        self._bump("shed")

    def record_deadline_miss(self):
        self._bump("deadline_misses")

    def record_bucket_miss(self):
        self._bump("bucket_misses")

    def record_executor_failure(self):
        self._bump("executor_failures")

    def record_circuit_reject(self):
        self._bump("circuit_rejects")

    def record_batch(self, n_real: int, bucket_batch: int,
                     elems_real: float, elems_padded: float,
                     exec_ms: float):
        with self._lock:
            self.batches += 1
            self._real += n_real
            self._slots += bucket_batch
            self._elems_real += elems_real
            self._elems_padded += elems_padded
        self.exec_ms.record(exec_ms)

    def record_done(self, e2e_ms: float):
        self.e2e_ms.record(e2e_ms)
        self._bump("completed")

    def record_reload(self, pause_ms: float):
        with self._lock:
            self.reloads += 1
            if pause_ms > self.reload_pause_ms:
                self.reload_pause_ms = float(pause_ms)

    # -- reading --------------------------------------------------------
    def post_warmup_compiles(self) -> int:
        """Compiles since warmup finished (must stay 0 in steady state),
        plus any folded in by merge() from other replicas."""
        base = 0 if self._rt_base is None \
            else runtime_stats.delta(self._rt_base)["compiles"]
        return base + self._merged_compiles

    def reset_compile_base(self):
        """Restart the post-warmup compile window NOW.  The fleet start
        path needs this: runtime_stats is process-global, so replica
        K's warmup would otherwise land inside replica 0's post-warmup
        window and break the zero-compile contract for a fleet that
        never leaked a shape."""
        with self._lock:
            self._rt_base = runtime_stats.snapshot()
            self._merged_compiles = 0
            self._compiles_reported = 0

    def merge(self, other: "ServingStats") -> "ServingStats":
        """Fold another replica's counters and histograms into this one
        IN PLACE (and return self).  Histograms merge exactly, counters
        sum, gauges (max_queue_depth, reload_pause_ms) take the max.
        Mixing stats classes (DecodeStats into ServingStats) is
        rejected."""
        if type(other) is not type(self):
            raise TypeError(
                f"cannot merge {type(other).__name__} into "
                f"{type(self).__name__} (config mismatch)")
        # histograms first: a bin-config mismatch must reject BEFORE
        # any counter has been folded
        self.e2e_ms.merge(other.e2e_ms)
        self.exec_ms.merge(other.exec_ms)
        with other._lock:
            o = {f: getattr(other, f) for f in (
                "submitted", "completed", "shed", "deadline_misses",
                "bucket_misses", "executor_failures", "circuit_rejects",
                "batches", "reloads", "_slots", "_real", "_elems_real",
                "_elems_padded")}
            o_depth = other.max_queue_depth
            o_pause = other.reload_pause_ms
        o_compiles = other.post_warmup_compiles()
        with self._lock:
            for f, v in o.items():
                setattr(self, f, getattr(self, f) + v)
            if o_depth > self.max_queue_depth:
                self.max_queue_depth = o_depth
            if o_pause > self.reload_pause_ms:
                self.reload_pause_ms = o_pause
            self._merged_compiles += o_compiles
        return self

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "deadline_misses": self.deadline_misses,
                "bucket_misses": self.bucket_misses,
                "executor_failures": self.executor_failures,
                "circuit_rejects": self.circuit_rejects,
                "batches": self.batches,
                "max_queue_depth": self.max_queue_depth,
                "reloads": self.reloads,
                "reload_pause_ms": round(self.reload_pause_ms, 3),
                "batch_occupancy": round(self._real / self._slots, 4)
                if self._slots else None,
                "padding_waste": round(
                    1.0 - self._elems_real / self._elems_padded, 4)
                if self._elems_padded else None,
            }
            if self.warmup:
                out["warmup"] = dict(self.warmup)
        ex = self.exec_ms.summary()
        out["e2e_ms"] = self.e2e_ms.summary()
        out["exec_ms"] = ex
        # dispatch-amortized compute latency: total run time spread over
        # the requests it served
        out["exec_per_req_ms"] = (round(ex["sum_ms"] / out["completed"], 3)
                                  if out["completed"] else None)
        out["post_warmup_compiles"] = self.post_warmup_compiles()
        return out

    # -- emission -------------------------------------------------------
    def maybe_emit(self):
        """Emit a serving_window event every `window` completed
        requests, plus a loud event the first time a post-warmup
        compile is observed."""
        emit_window = False
        with self._lock:
            if self.completed - self._emitted_at >= self.window:
                self._emitted_at = self.completed
                emit_window = True
        compiles = self.post_warmup_compiles()
        if compiles > self._compiles_reported:
            self._compiles_reported = compiles
            self._emit("serving_compile_post_warmup",
                       post_warmup_compiles=compiles)
        if emit_window:
            self.emit()

    def emit(self, kind: str = "serving_window", **extra: Any):
        snap = self.snapshot()
        snap.update(extra)
        self._emit(kind, **snap)
        return snap

    def _emit(self, kind: str, **fields: Any):
        if self._event_log is not None:
            self._event_log.event(kind, **fields)


class DecodeStats:
    """Thread-safe decode counters + histograms + event emission."""

    def __init__(self, event_log: Optional[RunEventLog] = None,
                 window: int = 64):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._lock = threading.Lock()
        self._event_log = event_log
        self.window = int(window)
        self.ttft_ms = LatencyHistogram()
        self.tpot_ms = LatencyHistogram()
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.deadline_misses = 0
        self.bucket_misses = 0
        self.circuit_rejects = 0
        self.executor_failures = 0
        self.preemptions = 0
        self.evacuations = 0        # requests pulled off this replica
        #                             (scheduler death / weight roll)
        self.reloads = 0            # hot weight swaps applied
        self.reload_pause_ms = 0.0  # worst single swap pause
        self.prefills = 0           # prefill dispatches
        self.prefill_joins = 0      # requests admitted via those
        self.imports = 0            # KV-page handoff imports accepted
        #                             (role="decode" workers only)
        self.decode_dispatches = 0  # chunked decode dispatches
        self.decode_iterations = 0  # step runs across them
        self.tokens_generated = 0
        self._slot_steps = 0.0      # sum(active_slots * iterations)
        self._cap_steps = 0.0       # sum(num_slots * iterations)
        self._util_sum = 0.0        # allocated/pool, per dispatch
        self._util_samples = 0
        self.peak_pages_in_use = 0
        # speculative decoding: sized by configure_speculation(k);
        # accept_hist bin a = slot-verifies with exactly a drafts
        # accepted (k+1 bins)
        self.spec_k = 0
        self.accept_hist: list = []
        self.verify_dispatches = 0  # speculative verify runs
        self.drafted_tokens = 0     # proposals scored (post-cap)
        self.accepted_tokens = 0    # proposals accepted
        self.spec_emitted_tokens = 0  # tokens committed by verifies
        self.warmup: Dict[str, Any] = {}
        self._rt_base: Optional[Dict[str, Any]] = None
        self._merged_compiles = 0
        self._emitted_at = 0
        self._compiles_reported = 0

    # -- recording ------------------------------------------------------
    def record_warmup(self, executables: int, compiles: int,
                      compile_s: float, seconds: float):
        with self._lock:
            self.warmup = {"executables": executables,
                           "compiles": compiles,
                           "compile_s": round(compile_s, 3),
                           "seconds": round(seconds, 3)}
            self._rt_base = runtime_stats.snapshot()
        self._emit("serving_decode_warmup", **self.warmup)

    def _bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def record_submit(self):
        self._bump("submitted")

    def record_shed(self):
        self._bump("shed")

    def record_deadline_miss(self):
        self._bump("deadline_misses")

    def record_bucket_miss(self):
        self._bump("bucket_misses")

    def record_circuit_reject(self):
        self._bump("circuit_rejects")

    def record_executor_failure(self):
        self._bump("executor_failures")

    def record_preemption(self, n: int = 1):
        self._bump("preemptions", n)

    def record_evacuation(self, n: int = 1):
        self._bump("evacuations", n)

    def record_reload(self, pause_ms: float):
        with self._lock:
            self.reloads += 1
            if pause_ms > self.reload_pause_ms:
                self.reload_pause_ms = float(pause_ms)

    def record_done(self):
        self._bump("completed")

    def record_prefill(self, joins: int, ttfts_ms) -> None:
        with self._lock:
            self.prefills += 1
            self.prefill_joins += joins
            # each join's prefill produced that request's FIRST token
            self.tokens_generated += joins
        for ms in ttfts_ms:
            self.ttft_ms.record(ms)

    def record_import(self, n: int = 1):
        """A decode-role worker accepted a KV-page handoff (the first
        token was produced, and counted, on the prefill worker, so
        imports add no tokens here; the fleet-merged totals stay
        exact)."""
        self._bump("imports", n)

    def configure_speculation(self, k: int):
        """Size the accepted-token histogram for speculate_k = k
        (called once by the engine before any verify records)."""
        if int(k) < 1:
            raise ValueError(f"speculate k must be >= 1, got {k}")
        with self._lock:
            if self.verify_dispatches:
                raise RuntimeError(
                    "configure_speculation after verifies recorded")
            self.spec_k = int(k)
            self.accept_hist = [0] * (self.spec_k + 1)

    def record_verify(self, drafted: int, emitted: int,
                      accept_counts) -> None:
        """One speculative verify run: `drafted` proposals scored (sum
        of post-cap draft lengths), `emitted` tokens committed, and
        per-active-slot accepted counts (each 0..k) binned into the
        histogram."""
        with self._lock:
            if not self.spec_k:
                raise RuntimeError("record_verify before "
                                   "configure_speculation")
            counts = [int(a) for a in accept_counts]
            for a in counts:  # validate before mutating: a bad record
                if not 0 <= a <= self.spec_k:  # must not tear counters
                    raise ValueError(
                        f"accepted count {a} outside 0..{self.spec_k}")
            self.verify_dispatches += 1
            self.drafted_tokens += int(drafted)
            self.spec_emitted_tokens += int(emitted)
            for a in counts:
                self.accepted_tokens += a
                self.accept_hist[a] += 1

    def record_decode(self, iterations: int, active_slots: int,
                      num_slots: int, tokens: int, pages_in_use: int,
                      num_pages: int, elapsed_ms: float):
        with self._lock:
            self.decode_dispatches += 1
            self.decode_iterations += int(iterations)
            self.tokens_generated += int(tokens)
            self._slot_steps += float(active_slots) * iterations
            self._cap_steps += float(num_slots) * iterations
            self._util_sum += (pages_in_use / num_pages
                               if num_pages else 0.0)
            self._util_samples += 1
            if pages_in_use > self.peak_pages_in_use:
                self.peak_pages_in_use = int(pages_in_use)
        if tokens:
            # dispatch-amortized per-token latency
            self.tpot_ms.record(elapsed_ms / tokens)

    # -- reading --------------------------------------------------------
    def post_warmup_compiles(self) -> int:
        """Kernel builds since warmup finished (must stay 0), plus any
        folded in by merge() from other replicas."""
        base = 0 if self._rt_base is None \
            else runtime_stats.delta(self._rt_base)["compiles"]
        return base + self._merged_compiles

    def reset_compile_base(self):
        """Restart the post-warmup compile window NOW (see
        ServingStats.reset_compile_base — the fleet start path)."""
        with self._lock:
            self._rt_base = runtime_stats.snapshot()
            self._merged_compiles = 0
            self._compiles_reported = 0

    def merge(self, other: "DecodeStats") -> "DecodeStats":
        """Fold another replica's decode telemetry into this one IN
        PLACE (and return self): TTFT/TPOT histograms merge exactly,
        counters sum, occupancy/utilization accumulators sum (the merged
        ratios stay exact weighted means), peaks take the max.
        Stats-class and histogram-bin config mismatches are rejected.
        runtime_stats is process-global, so N same-process replicas that
        each saw a post-warmup build report it N times in the merged sum:
        an over-count in the direction the zero-compile contract wants."""
        if type(other) is not type(self):
            raise TypeError(
                f"cannot merge {type(other).__name__} into "
                f"{type(self).__name__} (config mismatch)")
        if other.spec_k and self.spec_k and other.spec_k != self.spec_k:
            raise ValueError(
                f"cannot merge speculation histograms with different k "
                f"({self.spec_k} vs {other.spec_k})")
        self.ttft_ms.merge(other.ttft_ms)
        self.tpot_ms.merge(other.tpot_ms)
        with other._lock:
            o = {f: getattr(other, f) for f in (
                "submitted", "completed", "shed", "deadline_misses",
                "bucket_misses", "circuit_rejects", "executor_failures",
                "preemptions", "evacuations", "reloads", "prefills",
                "prefill_joins", "imports", "decode_dispatches",
                "decode_iterations", "tokens_generated",
                "verify_dispatches", "drafted_tokens", "accepted_tokens",
                "spec_emitted_tokens", "_slot_steps",
                "_cap_steps", "_util_sum", "_util_samples")}
            o_peak = other.peak_pages_in_use
            o_pause = other.reload_pause_ms
            o_spec_k = other.spec_k
            o_hist = list(other.accept_hist)
        o_compiles = other.post_warmup_compiles()
        with self._lock:
            for f, v in o.items():
                setattr(self, f, getattr(self, f) + v)
            if o_peak > self.peak_pages_in_use:
                self.peak_pages_in_use = o_peak
            if o_pause > self.reload_pause_ms:
                self.reload_pause_ms = o_pause
            if o_spec_k:
                if not self.spec_k:  # adopt a speculating replica's k
                    self.spec_k = o_spec_k
                    self.accept_hist = [0] * (o_spec_k + 1)
                self.accept_hist = [a + b for a, b in
                                    zip(self.accept_hist, o_hist)]
            self._merged_compiles += o_compiles
        return self

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "deadline_misses": self.deadline_misses,
                "bucket_misses": self.bucket_misses,
                "circuit_rejects": self.circuit_rejects,
                "executor_failures": self.executor_failures,
                "preemptions": self.preemptions,
                "evacuations": self.evacuations,
                "reloads": self.reloads,
                "reload_pause_ms": round(self.reload_pause_ms, 3),
                "prefills": self.prefills,
                "prefill_joins": self.prefill_joins,
                "imports": self.imports,
                "decode_dispatches": self.decode_dispatches,
                "decode_iterations": self.decode_iterations,
                "tokens_generated": self.tokens_generated,
                "slot_occupancy": round(
                    self._slot_steps / self._cap_steps, 4)
                if self._cap_steps else None,
                "kv_page_utilization": round(
                    self._util_sum / self._util_samples, 4)
                if self._util_samples else None,
                "peak_pages_in_use": self.peak_pages_in_use,
            }
            if self.spec_k:
                slot_verifies = sum(self.accept_hist)
                out["speculation"] = {
                    "speculate_k": self.spec_k,
                    "verify_dispatches": self.verify_dispatches,
                    "drafted_tokens": self.drafted_tokens,
                    "accepted_tokens": self.accepted_tokens,
                    "emitted_tokens": self.spec_emitted_tokens,
                    "accept_rate": round(
                        self.accepted_tokens / self.drafted_tokens, 4)
                    if self.drafted_tokens else None,
                    "accept_hist": list(self.accept_hist),
                    # emitted tokens over the verify rows paid for (each
                    # slot-verify runs k+1 folded rows): 1.0 means every
                    # row committed a token
                    "speculation_efficiency": round(
                        self.spec_emitted_tokens /
                        (slot_verifies * (self.spec_k + 1)), 4)
                    if slot_verifies else None,
                }
            if self.warmup:
                out["warmup"] = dict(self.warmup)
        out["ttft_ms"] = self.ttft_ms.summary()
        out["tpot_ms"] = self.tpot_ms.summary()
        out["post_warmup_compiles"] = self.post_warmup_compiles()
        return out

    # -- emission -------------------------------------------------------
    def maybe_emit(self):
        emit_window = False
        with self._lock:
            if self.completed - self._emitted_at >= self.window:
                self._emitted_at = self.completed
                emit_window = True
        compiles = self.post_warmup_compiles()
        if compiles > self._compiles_reported:
            self._compiles_reported = compiles
            self._emit("serving_compile_post_warmup",
                       post_warmup_compiles=compiles,
                       component="decode_engine")
        if emit_window:
            self.emit()

    def emit(self, kind: str = "serving_decode_window", **extra: Any):
        snap = self.snapshot()
        snap.update(extra)
        self._emit(kind, **snap)
        return snap

    def _emit(self, kind: str, **fields: Any):
        if self._event_log is not None:
            self._event_log.event(kind, **fields)
