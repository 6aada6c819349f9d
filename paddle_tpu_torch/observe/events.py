"""Structured run events: an append-only JSONL log with provenance.

The port of the part of paddle_tpu/observe/events.py that the serving
engines, the fleet and contrib.Trainer use.  One JSON object per line,
flushed whole, so the file is valid to tail mid-run.  `bind()` gives a
view that stamps fixed fields (a fleet replica's `replica_id`) into
every record, so N replicas share one log and stay attributable.  Kinds under the dashboard
prefixes (`_VALIDATED_PREFIXES`, the reference's list) are checked
against the registries below (a typo'd kind would silently drop off
every dashboard filter): unknown ones raise.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid
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

_VALIDATED_PREFIXES = ("serving_", "fleet_", "gang_", "alert_",
                       "flight_", "autoscale_", "recovery_",
                       "feeder_", "feed_")
_KNOWN_KINDS = (set(SERVING_EVENTS) | set(DECODE_EVENTS)
                | set(FLEET_EVENTS) | set(RESILIENCE_EVENTS)
                | set(FEED_EVENTS) | set(GANG_EVENTS)
                | set(GOODPUT_EVENTS) | set(NUMERICS_EVENTS))


def _validate_kind(kind: str) -> None:
    if kind.startswith(_VALIDATED_PREFIXES) and kind not in _KNOWN_KINDS:
        raise ValueError(f"event kind {kind!r} matches a dashboard prefix "
                         f"{_VALIDATED_PREFIXES} but is not registered in "
                         f"observe.events")


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
    first record is `run_begin` with run provenance (backend, and the
    mesh shape when given); `close()` appends `run_end`.  Thread-safe:
    records never interleave.  `max_bytes` (rotation) raises until
    ROADMAP A step 11.
    """

    def __init__(self, path: str, run_id: Optional[str] = None,
                 mesh_shape: Optional[Dict[str, int]] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 max_bytes: Optional[int] = None):
        if max_bytes is not None:
            raise NotImplementedError(
                "RunEventLog(max_bytes=) (size-bounded log rotation) is "
                "not ported yet: ROADMAP queue A step 11 (host planes)")
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:12]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._wlock = threading.Lock()
        begin: Dict[str, Any] = {"argv": list(sys.argv)}
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
            self._f.write(line)
            self._f.flush()
        return rec

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
