"""Structured run events: an append-only JSONL log with provenance.

The port of paddle_tpu/observe/events.py.  One JSON object per line,
flushed whole, so the file is valid to tail mid-run; `max_bytes` rolls
the file to `<path>.1` (one generation kept) with a `run_rotate` marker
opening the fresh file.  `bind()` gives a view that stamps fixed fields
(a fleet replica's `replica_id`) into every record, so N replicas share
one log and stay attributable.  Kinds under the dashboard prefixes
(`_VALIDATED_PREFIXES`, the reference's list) are checked against the
registries below, since a typo'd kind would silently drop off every
dashboard filter: unknown ones raise, or warn once after
`set_strict_kinds(False)`.  (The reference warns unless strict, and its
tests run strict; the port is strict unless told otherwise.)
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid
import warnings
from typing import Any, Dict, List, Optional

# the dynamic-batching ServingEngine's event kinds (docs/SERVING.md)
SERVING_EVENTS = (
    "serving_start",                # engine config at start()
    "serving_memory_plan",          # pre-warmup bucket-ladder fit plan
    "serving_warmup",               # bucket-ladder warmup summary
    "serving_window",               # periodic stats snapshot
    "serving_compile_post_warmup",  # LOUD: a signature ran unwarmed
    "serving_drain",                # final snapshot at drain
    "serving_breaker_open",         # LOUD: executor failure burst —
    #                                 admission flipped to DEGRADED
    "serving_breaker_close",        # half-open probe succeeded; RUNNING
    "serving_reload",               # hot weight swap applied (version,
    #                                 pause_ms)
)

# the decode engine's event kinds (docs/SERVING.md §decode)
DECODE_EVENTS = (
    "serving_decode_start",        # engine geometry at start()
    "serving_decode_memory_plan",  # the plan_fit gate's verdict
    "serving_decode_speculate",    # speculative engine: k and drafter
    "serving_decode_warmup",       # warmup summary
    "serving_decode_window",       # periodic DecodeStats snapshot
    "serving_decode_drain",        # final snapshot at drain
    "serving_decode_preempt",      # a slot was evicted (pool dry)
    "serving_decode_evacuate",     # requests pulled off the replica
    #                                (weight roll / scheduler death)
    "serving_decode_reload",       # hot weight swap applied
    "serving_compile_post_warmup",  # LOUD: a kernel built after warmup
    "serving_breaker_open",        # LOUD: executor failure burst
    "serving_breaker_close",       # half-open probe succeeded
)

# speculative-decoding event kinds: the drafter armed at start()
# (`serving_decode_speculate` stays in DECODE_EVENTS too, where the port
# registered it first)
SPECULATE_EVENTS = (
    "serving_decode_speculate",
    "serving_speculate_window",    # a speculation snapshot (the
    #                                reference's; the port emits its
    #                                accept rates in decode windows)
)

# serving-fleet event kinds (docs/SERVING.md §fleet): the router
# fronting N engine replicas; engines stamp their own events with
# replica_id through RunEventLog.bind
FLEET_EVENTS = (
    "serving_fleet_start",     # fleet config at start(): kind, replicas
    "serving_fleet_failover",  # LOUD: an in-flight request was pulled
    #                            off a replica and requeued on a
    #                            survivor (committed-token count rides)
    "serving_fleet_eject",     # LOUD: a replica was removed from
    #                            routing (scheduler death / manual)
    "serving_fleet_hedge",     # a slow attempt got a duplicate on
    #                            another replica (idempotent only)
    "serving_fleet_saturated",  # LOUD: every replica fast-rejected —
    #                            the structured whole-fleet shed
    "serving_fleet_reload",    # one roll: begin/done phases + version
    "serving_fleet_reload_replica",  # per-replica swap: pause_ms,
    #                                  evacuated count
    "serving_fleet_window",    # periodic fleet-merged stats snapshot
    "serving_fleet_close",     # final merged snapshot at close
)

# resilience event kinds (docs/RESILIENCE.md): checkpoint fallback,
# save telemetry, and preemption-drain lifecycle, emitted by
# contrib.Trainer
RESILIENCE_EVENTS = (
    "ckpt_fallback",        # a serial was skipped (torn/corrupt), with
    #                         the structured CheckpointError as_dict()
    "ckpt_resume",          # resumed; fallback=True when not newest
    "ckpt_resume_failed",   # NO valid serial existed — fresh start
    "ckpt_save",            # one save: snapshot_ms (blocking) vs
    #                         write_ms (background) + bytes + async flag
    "ckpt_async_error",     # LOUD: a background write failed (the
    #                         structured CheckpointWriteError as_dict())
    "preempt_drain",        # SIGTERM/SIGINT received: finishing the
    #                         in-flight step, then emergency-saving
    "ckpt_emergency",       # the drain path's final checkpoint landed
)

# disaggregated prefill/decode serving (serving/disagg.py): the phase
# router, the KV-page handoff, and the SLO-driven autoscaler's decisions
DISAGG_EVENTS = (
    "serving_disagg_start",       # fleet topology at start()
    "serving_disagg_handoff",     # one KV-page hop: from_replica ->
    #                               to_replica, pages, bytes, handoff_ms
    "serving_disagg_failover",    # LOUD: a worker died mid-request — the
    #                               raw prompt re-prefills on a survivor
    #                               (phase + committed tokens)
    "serving_disagg_eject",       # LOUD: a worker removed from routing
    "serving_disagg_saturated",   # LOUD: one phase's workers all shed
    "serving_disagg_worker_join",   # zero-reject scale-up landed
    "serving_disagg_worker_leave",  # zero-reject scale-down retired one
    "serving_disagg_window",      # periodic merged stats snapshot
    "serving_disagg_close",       # final snapshot at close
    "kv_transfer",                # also the router-row reqtrace span
    #                               name (registered for grep parity)
    "autoscale_up",               # Autoscaler added a worker: phase,
    #                               rule, observed value
    "autoscale_down",             # Autoscaler removed one after quiet_s
)

# input admission (Trainer(validate_feed=True)); the reference's
# DeviceFeeder kinds `feeder_retry` and `feeder_stall` come with it
# (ROADMAP A step 12)
FEED_EVENTS = (
    "feed_quarantined",   # admission rejected a poisoned batch
    #                       (non-finite / signature drift) before it
    #                       reached the device
)

# the gang kinds this package emits: the dispatch watchdog's record.
# The health plane's and the supervisor's kinds come with them
# (ROADMAP A step 11)
GANG_EVENTS = (
    "step_hang",       # dispatch watchdog: a step blew its budget —
    #                    emitted BEFORE the abort, with the
    #                    first-compile vs hung-step verdict and the
    #                    runtime_stats deltas observed in the region
)

# goodput observability (observe/goodput.py): the wall-clock
# decomposition contrib.Trainer emits at train_end
GOODPUT_EVENTS = (
    "goodput_report",  # the full GoodputLedger.report() dict: wall_s,
    #                    per-category seconds/fractions (sum == wall),
    #                    goodput fraction, replay badput
)

# numerics observability, emitted by contrib.Trainer next to its
# telemetry windows
NUMERICS_EVENTS = (
    "nonfinite_provenance",  # LOUD: a telemetry window latched a
    #                          poisoned step, with the joined first
    #                          nonfinite op, the guard's skip counter
    #                          and the loss scale
)

# alerting (observe/alerts.py): the AlertEngine's rule state-machine
# transitions, the records a pager or dashboard keys off
ALERT_EVENTS = (
    "alert_pending",   # a rule breached; for_duration gating running
    "alert_firing",    # LOUD: the breach persisted — the rule fired
    #                    (value/target/severity attached; the
    #                    FlightRecorder bundles on this transition)
    "alert_resolved",  # the firing rule cleared (hysteresis +
    #                    resolve_duration satisfied)
)

# the flight recorder (observe/flightrec.py)
FLIGHT_EVENTS = (
    "flight_record",   # one diagnostic bundle written: reason, path,
    #                    truncation flag, per-section errors
)

_VALIDATED_PREFIXES = ("serving_", "fleet_", "gang_", "alert_",
                       "flight_", "autoscale_", "recovery_",
                       "feeder_", "feed_")
_KNOWN_KINDS = (set(SERVING_EVENTS) | set(DECODE_EVENTS)
                | set(SPECULATE_EVENTS)
                | set(FLEET_EVENTS) | set(DISAGG_EVENTS)
                | set(RESILIENCE_EVENTS) | set(FEED_EVENTS)
                | set(GANG_EVENTS) | set(GOODPUT_EVENTS)
                | set(NUMERICS_EVENTS) | set(ALERT_EVENTS)
                | set(FLIGHT_EVENTS))
_strict_kinds = [True]
_warned_kinds: set = set()


def set_strict_kinds(flag: bool) -> bool:
    """Unknown validated-prefix kinds raise (True, the port's default)
    or warn once per kind (False).  Returns the previous setting."""
    prev = _strict_kinds[0]
    _strict_kinds[0] = bool(flag)
    return prev


def register_event_kinds(*kinds: str) -> None:
    """Extend the known-kind registry (a subsystem adding a new
    dashboard event registers it here, or in the tuples above when it
    ships in-tree)."""
    _KNOWN_KINDS.update(kinds)


def _validate_kind(kind: str) -> None:
    if not kind.startswith(_VALIDATED_PREFIXES) or kind in _KNOWN_KINDS:
        return
    msg = (f"event kind {kind!r} matches a dashboard prefix "
           f"{_VALIDATED_PREFIXES} but is not registered in observe.events "
           f"— a typo here silently drops the event off every dashboard "
           f"filter; register it with register_event_kinds() or fix the "
           f"name")
    if _strict_kinds[0]:
        raise ValueError(msg)
    if kind not in _warned_kinds:
        _warned_kinds.add(kind)
        warnings.warn(msg, stacklevel=3)


def new_run_id() -> str:
    """Short unique id for one run (12 hex characters)."""
    return uuid.uuid4().hex[:12]


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Current git HEAD (short), or None outside a repository or
    without git."""
    import subprocess

    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=5,
                           cwd=cwd)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = r.stdout.strip()
    return sha if r.returncode == 0 and sha else None


def _backend_info() -> Dict[str, Any]:
    """Device provenance, without initialising CUDA for a log."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"backend": "cpu"}
    return {"backend": "cuda", "n_devices": torch.cuda.device_count(),
            "device_kind": torch.cuda.get_device_name(0)}


class RunEventLog:
    """Append-only JSONL event log for one run.

    Records carry {ts (unix seconds), run_id, event, ...fields}.  The
    first record is `run_begin` with run provenance (git sha, backend,
    and the mesh shape when given); `close()` appends `run_end`.
    Thread-safe: records never interleave.

    `max_bytes`: size-bound the log.  When a record would take the file
    past the bound it rolls to `<path>.1` (one generation kept) and the
    fresh file starts with a `run_rotate` record, so a tailer knows the
    records continue from a rolled file.  Rotation happens under the
    write lock, so concurrent writers never land in a half-rotated file.
    """

    def __init__(self, path: str, run_id: Optional[str] = None,
                 mesh_shape: Optional[Dict[str, int]] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 max_bytes: Optional[int] = None):
        if max_bytes is not None and int(max_bytes) < 1024:
            raise ValueError("max_bytes < 1024 would rotate on nearly "
                             "every record")
        self.path = path
        self.run_id = run_id or new_run_id()
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.rotations = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._bytes = os.path.getsize(path)
        self._wlock = threading.Lock()
        begin: Dict[str, Any] = {"git_sha": git_sha(),
                                 "argv": list(sys.argv)}
        begin.update(_backend_info())
        if mesh_shape:
            begin["mesh_shape"] = dict(mesh_shape)
        begin.update(meta or {})
        self.event("run_begin", **begin)

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Append one event record (flushed immediately)."""
        _validate_kind(kind)
        rec = {"ts": round(time.time(), 3), "run_id": self.run_id,
               "event": kind}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable) + "\n"
        with self._wlock:
            if (self.max_bytes is not None and self._bytes > 0
                    and self._bytes + len(line) > self.max_bytes):
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)
        return rec

    def _rotate_locked(self) -> None:
        """Roll the file to `<path>.1` and open a fresh one with a
        `run_rotate` marker; the caller holds the write lock."""
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a", encoding="utf-8")
        self.rotations += 1
        marker = json.dumps(
            {"ts": round(time.time(), 3), "run_id": self.run_id,
             "event": "run_rotate", "rotations": self.rotations,
             "rolled_to": self.path + ".1"}, default=_jsonable) + "\n"
        self._f.write(marker)
        self._bytes = len(marker)

    def telemetry_window(self, telemetry, **extra: Any) -> Dict[str, Any]:
        """Emit one periodic-fetch window (a StepTelemetry or plain
        dict) plus any runtime-stats fields the caller attaches."""
        fields = (telemetry.as_dict() if hasattr(telemetry, "as_dict")
                  else dict(telemetry))
        fields.update(extra)
        return self.event("telemetry", **fields)

    def serving_window(self, stats, **extra: Any) -> Dict[str, Any]:
        """Emit one serving stats snapshot (a serving.ServingStats or a
        plain dict) — the serving analog of telemetry_window."""
        fields = (stats.snapshot() if hasattr(stats, "snapshot")
                  else dict(stats))
        fields.update(extra)
        return self.event("serving_window", **fields)

    def bind(self, **fields: Any) -> "BoundEventLog":
        """A view over this log that stamps `fields` (e.g. replica_id)
        into every record it emits — the way N serving-engine replicas
        share ONE process log without their events becoming
        indistinguishable.  The view shares the file, write lock, and
        run_id; closing the view is a no-op (the owner closes the
        base)."""
        return BoundEventLog(self, fields)

    def close(self):
        if not self._f.closed:
            self.event("run_end")
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class BoundEventLog:
    """RunEventLog view with fixed fields merged into every record
    (see RunEventLog.bind).  Explicit per-event fields win on key
    collision.  Safe to re-bind (views nest by merging)."""

    def __init__(self, base: RunEventLog, fields: Dict[str, Any]):
        while isinstance(base, BoundEventLog):
            fields = {**base._fields, **fields}
            base = base._base
        self._base = base
        self._fields = dict(fields)

    @property
    def run_id(self) -> str:
        return self._base.run_id

    @property
    def path(self) -> str:
        return self._base.path

    def bind(self, **fields: Any) -> "BoundEventLog":
        return BoundEventLog(self, fields)

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        return self._base.event(kind, **{**self._fields, **fields})

    def telemetry_window(self, telemetry, **extra: Any) -> Dict[str, Any]:
        fields = (telemetry.as_dict() if hasattr(telemetry, "as_dict")
                  else dict(telemetry))
        fields.update(extra)
        return self.event("telemetry", **fields)

    def serving_window(self, stats, **extra: Any) -> Dict[str, Any]:
        fields = (stats.snapshot() if hasattr(stats, "snapshot")
                  else dict(stats))
        fields.update(extra)
        return self.event("serving_window", **fields)

    def close(self):
        """No-op: the view does not own the underlying file."""


def _jsonable(v):
    import numpy as np

    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)



def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event log back into records.  Raises on corrupt
    lines — an event log that silently drops records is worse than one
    that fails loudly (a torn final line from a killed process is the
    one tolerated exception)."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, ln in enumerate(lines):
        if not ln.strip():
            continue
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail from a killed writer
            raise
    return out
