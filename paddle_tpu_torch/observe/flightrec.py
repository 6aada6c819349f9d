"""Diagnostic flight recorder: the port of
paddle_tpu/observe/flightrec.py.

When an SLO rule fires, the dispatch watchdog declares a hang, or the
process dies on an unhandled exception, the signals that explain it are
resident in this process (event log, metrics registry, kept request
traces, the goodput ledger, the latched nonfinite provenance, thread
stacks) and gone the moment the process is.  The FlightRecorder writes
them to a diagnostic bundle directory at the moment of the trigger:

    <dir>/bundle_<seq>_<reason>/
        MANIFEST.json     trigger, context, wall/monotonic ts, file map
        events_tail.jsonl last N event-log records
        metrics.json      full MetricsRegistry snapshot
        alerts.json       AlertEngine.state() (when attached)
        reqtrace.json     kept-trace chrome export (chrome://tracing)
        goodput.json/.txt ledger report + rendered table
        numerics.json     first-nonfinite provenance (when latched)
        watchdog.json     DispatchWatchdog guarded-region history
        stacks.txt        faulthandler dump of every thread

Triggers: `AlertEngine` firing transitions (`attach_engine`), the
`resilience/watchdog.py` `on_hang` callback (`watchdog_hook` chains an
existing one), unhandled crashes (`install_crash_hooks` wraps
sys.excepthook; an atexit sweep catches a crash whose bundle write was
itself interrupted), and manual `record(reason)`.

Bounded by construction: `min_interval_s` rate-limits bundle writes,
`max_bundles` caps the count, and `max_bundle_bytes` caps each bundle —
capture stops mid-bundle once the budget is spent, recorded in the
manifest.  Every section is isolated: a failing source becomes an
`errors` entry in the manifest, never a lost bundle.  Pure host: every
source is an existing host-side snapshot surface, and nothing is
launched on the device.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

_SEQ_LOCK = threading.Lock()


def _sanitize(reason: str) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "_"
                  for c in reason.strip())
    return (out or "trigger")[:48]


class FlightRecorder:
    """Rate-limited, size-bounded diagnostic bundle writer.

        rec = FlightRecorder(dir, registry=fleet.metrics_registry(),
                             event_log=log, tracer=tracer)
        rec.attach_engine(alert_engine)     # bundle on firing alerts
        wd = DispatchWatchdog(..., on_hang=rec.watchdog_hook(prior))
        rec.install_crash_hooks()           # sys.excepthook + atexit

    Sources are all optional; only the attached ones land in bundles.
    `telemetry_fetch` returns the newest StepTelemetry (numerics
    provenance rides it); `goodput` is a GoodputLedger; `watchdog` a
    DispatchWatchdog (its `regions` history is the state captured).
    """

    def __init__(self, directory: str, *, registry=None, event_log=None,
                 tracer=None, goodput=None,
                 telemetry_fetch: Optional[Callable[[], Any]] = None,
                 watchdog=None, min_interval_s: float = 60.0,
                 max_bundles: int = 8,
                 max_bundle_bytes: int = 4 << 20,
                 event_tail_lines: int = 200,
                 clock: Callable[[], float] = time.monotonic):
        self.directory = directory
        self.registry = registry
        self.event_log = event_log
        self.tracer = tracer
        self.goodput = goodput
        self.telemetry_fetch = telemetry_fetch
        self.watchdog = watchdog
        self.alert_engine = None
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self.max_bundle_bytes = int(max_bundle_bytes)
        self.event_tail_lines = int(event_tail_lines)
        self.clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_record_t: Optional[float] = None
        self.bundles: List[str] = []      # written bundle dirs
        self.suppressed = 0               # rate/count-limited triggers
        self._crash_hooks_installed = False
        self._prev_excepthook = None
        self._crash_pending = False       # excepthook fired, bundle
        #                                   write unconfirmed (atexit
        #                                   sweep retries)

    # -- trigger wiring ---------------------------------------------------
    def attach_engine(self, engine) -> "FlightRecorder":
        """Bundle on every alert_firing transition (the engine's hook
        runs on the alert thread — host-only by the engine's own
        contract)."""
        self.alert_engine = engine

        def on_firing(rule, record):
            self.record(f"alert_{rule.id}", context=record)

        engine.add_firing_hook(on_firing)
        return self

    def watchdog_hook(self, prior: Optional[Callable[[Dict[str, Any]],
                                                     None]] = None
                      ) -> Callable[[Dict[str, Any]], None]:
        """An `on_hang` callable for resilience.DispatchWatchdog that
        records a bundle THEN calls `prior` (e.g. Trainer's
        gang-poison closure) — capture first: the poison path may end
        the process."""

        def on_hang(fields: Dict[str, Any]) -> None:
            try:
                self.record(f"hang_{fields.get('kind', 'step')}",
                            context=fields)
            finally:
                if prior is not None:
                    prior(fields)

        return on_hang

    def install_crash_hooks(self) -> "FlightRecorder":
        """Wrap sys.excepthook (bundle on unhandled exception, then
        chain the previous hook) and register an atexit sweep that
        writes the crash bundle if the excepthook's own write never
        completed (a dying interpreter can interrupt it)."""
        if self._crash_hooks_installed:
            return self
        self._crash_hooks_installed = True
        self._prev_excepthook = sys.excepthook

        def hook(exc_type, exc, tb):
            self._crash_pending = True
            try:
                self.record(
                    "crash",
                    context={"exc_type": exc_type.__name__,
                             "exc": str(exc),
                             "traceback": "".join(
                                 traceback.format_exception(
                                     exc_type, exc, tb))[-8192:]},
                    force=True)
                self._crash_pending = False
            finally:
                (self._prev_excepthook or sys.__excepthook__)(
                    exc_type, exc, tb)

        sys.excepthook = hook
        atexit.register(self._atexit_sweep)
        return self

    def uninstall_crash_hooks(self) -> None:
        if not self._crash_hooks_installed:
            return
        self._crash_hooks_installed = False
        if sys.excepthook is not self._prev_excepthook \
                and self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        try:
            atexit.unregister(self._atexit_sweep)
        except Exception:  # noqa: BLE001
            pass

    def _atexit_sweep(self) -> None:
        if self._crash_pending:
            self.record("crash_atexit", force=True)

    def close(self) -> None:
        self.uninstall_crash_hooks()

    # -- capture ----------------------------------------------------------
    def record(self, reason: str,
               context: Optional[Dict[str, Any]] = None,
               force: bool = False) -> Optional[str]:
        """Write one bundle; returns its directory, or None when
        rate-limited / count-capped (`suppressed` counts those).
        `force` bypasses the rate limit (crash paths — the process is
        ending, the bundle is the whole point) but never the count
        cap."""
        now = self.clock()
        with self._lock:
            if len(self.bundles) >= self.max_bundles:
                self.suppressed += 1
                return None
            if (not force and self._last_record_t is not None
                    and now - self._last_record_t < self.min_interval_s):
                self.suppressed += 1
                return None
            self._last_record_t = now
            self._seq += 1
            seq = self._seq
        bundle = os.path.join(
            self.directory, f"bundle_{seq:03d}_{_sanitize(reason)}")
        os.makedirs(bundle, exist_ok=True)
        manifest: Dict[str, Any] = {
            "reason": reason, "seq": seq,
            "ts": round(time.time(), 3),
            "monotonic": round(now, 3),
            "context": context or {},
            "max_bundle_bytes": self.max_bundle_bytes,
            "files": {}, "errors": {}, "skipped": [],
            "truncated": False,
        }
        budget = [self.max_bundle_bytes]

        def write(name: str, data: bytes) -> None:
            if budget[0] <= 0:
                manifest["skipped"].append(name)
                manifest["truncated"] = True
                return
            if len(data) > budget[0]:
                data = data[:budget[0]]
                manifest["truncated"] = True
            path = os.path.join(bundle, name)
            with open(path, "wb") as f:
                f.write(data)
            budget[0] -= len(data)
            manifest["files"][name] = len(data)

        def section(name: str, fn: Callable[[], Optional[bytes]]
                    ) -> None:
            try:
                data = fn()
            except Exception as e:  # noqa: BLE001 — a dead source must
                manifest["errors"][name] = (  # not lose the bundle
                    f"{type(e).__name__}: {e}")
                return
            if data is not None:
                write(name, data)

        section("events_tail.jsonl", self._events_tail)
        section("metrics.json", self._metrics)
        section("alerts.json", self._alerts)
        section("reqtrace.json", self._reqtrace)
        section("goodput.json", self._goodput_json)
        section("goodput.txt", self._goodput_table)
        section("numerics.json", self._numerics)
        section("watchdog.json", self._watchdog_state)
        section("stacks.txt", self._stacks)
        with open(os.path.join(bundle, "MANIFEST.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, default=str)
        with self._lock:
            self.bundles.append(bundle)
        if self.event_log is not None:
            try:
                self.event_log.event(
                    "flight_record", reason=reason, path=bundle,
                    seq=seq, truncated=manifest["truncated"],
                    errors=sorted(manifest["errors"]))
            except Exception:  # noqa: BLE001
                pass
        return bundle

    # -- sections (each returns bytes or None) ----------------------------
    def _events_tail(self) -> Optional[bytes]:
        path = getattr(self.event_log, "path", None)
        if not path or not os.path.exists(path):
            return None
        # bounded tail read: never slurp a multi-GB log into memory
        max_bytes = max(self.event_tail_lines * 4096, 1 << 16)
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            chunk = f.read()
        lines = chunk.splitlines()
        if size > max_bytes and lines:
            lines = lines[1:]  # first line may be torn by the seek
        return b"\n".join(lines[-self.event_tail_lines:]) + b"\n"

    def _metrics(self) -> Optional[bytes]:
        if self.registry is None:
            return None
        return json.dumps(self.registry.snapshot(), indent=1,
                          default=str).encode("utf-8")

    def _alerts(self) -> Optional[bytes]:
        if self.alert_engine is None:
            return None
        return json.dumps(self.alert_engine.state(), indent=1,
                          default=str).encode("utf-8")

    def _reqtrace(self) -> Optional[bytes]:
        if self.tracer is None:
            return None
        return json.dumps(self.tracer.export_chrome_trace(),
                          default=str).encode("utf-8")

    def _goodput_json(self) -> Optional[bytes]:
        if self.goodput is None:
            return None
        return json.dumps(self.goodput.report(), indent=1,
                          default=str).encode("utf-8")

    def _goodput_table(self) -> Optional[bytes]:
        if self.goodput is None:
            return None
        from .goodput import format_goodput_table

        return format_goodput_table(self.goodput.report()) \
            .encode("utf-8")

    def _numerics(self) -> Optional[bytes]:
        if self.telemetry_fetch is None:
            return None
        tel = self.telemetry_fetch()
        if tel is None or getattr(tel, "first_nonfinite_op", None) \
                is None:
            return None
        return json.dumps(
            {"first_nonfinite_op": tel.first_nonfinite_op,
             "nonfinite_grad_steps": tel.nonfinite_grad_steps,
             "nonfinite_loss_steps": tel.nonfinite_loss_steps,
             "skipped_update_steps": tel.skipped_update_steps,
             "loss_scale": tel.loss_scale},
            indent=1, default=str).encode("utf-8")

    def _watchdog_state(self) -> Optional[bytes]:
        if self.watchdog is None:
            return None
        return json.dumps(
            {"step_deadline_s": self.watchdog.step_deadline_s,
             "compile_grace_s": self.watchdog.compile_grace_s,
             "regions": self.watchdog.regions[-50:]},
            indent=1, default=str).encode("utf-8")

    def _stacks(self) -> Optional[bytes]:
        import faulthandler
        import io

        # faulthandler needs a real fd; round-trip through a temp file
        import tempfile

        with tempfile.TemporaryFile() as f:
            try:
                faulthandler.dump_traceback(file=f, all_threads=True)
            except Exception:  # noqa: BLE001 — fall back to traceback
                buf = io.StringIO()
                for tid, frame in sys._current_frames().items():
                    buf.write(f"# thread {tid}\n")
                    buf.write("".join(traceback.format_stack(frame)))
                return buf.getvalue().encode("utf-8")
            f.seek(0)
            return f.read()

    # -- views ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"bundles": list(self.bundles),
                    "suppressed": self.suppressed,
                    "max_bundles": self.max_bundles,
                    "min_interval_s": self.min_interval_s,
                    "directory": self.directory}
