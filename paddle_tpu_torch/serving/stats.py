"""Decode-serving telemetry: the port of paddle_tpu/serving/stats.py
`DecodeStats` (without the fleet-merge part, which belongs to the fleet
slice, ROADMAP queue A item 7).

- **TTFT vs TPOT** — time-to-first-token (submit -> the prefill that
  produced the request's first token) and time-per-output-token (decode
  chunk wall time amortized over the tokens it produced), as separate
  LatencyHistograms.
- **iteration-level occupancy** — active slots per decode iteration over
  the slot budget.
- **KV page-pool utilization** — allocated pages over the pool, sampled
  at every dispatch (mean + peak).
- **preemptions** — slots evicted because the pool ran dry.
- **compile hygiene** — kernel builds after warmup (runtime_stats) must
  stay ZERO in steady state.
- **speculation** — with `configure_speculation(k)`: verify runs,
  drafted/accepted/emitted tokens and the k+1-bin histogram of accepted
  drafts per slot-verify.

Snapshots emit as `serving_decode_window` events every `window`
completed requests and at drain.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..observe.events import RunEventLog
from ..observe.monitoring import LatencyHistogram, runtime_stats


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
        self.evacuations = 0        # requests pulled off the engine
        #                             (scheduler death / shutdown)
        self.prefills = 0           # prefill dispatches
        self.prefill_joins = 0      # requests admitted via those
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
        """Kernel builds since warmup finished (must stay 0)."""
        if self._rt_base is None:
            return 0
        return runtime_stats.delta(self._rt_base)["compiles"]

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
                "prefills": self.prefills,
                "prefill_joins": self.prefill_joins,
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
