"""Structured run events: an append-only JSONL log with provenance.

The port of the part of paddle_tpu/observe/events.py that the decode
engine and contrib.Trainer use.  One JSON object per line, flushed
whole, so the file is valid to tail mid-run.  Kinds under the dashboard
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

# the decode engine's event kinds (docs/SERVING.md §decode)
DECODE_EVENTS = (
    "serving_decode_start",        # engine geometry at start()
    "serving_decode_speculate",    # speculative engine: k and drafter
    "serving_decode_warmup",       # warmup summary
    "serving_decode_window",       # periodic DecodeStats snapshot
    "serving_decode_drain",        # final snapshot at drain
    "serving_decode_preempt",      # a slot was evicted (pool dry)
    "serving_decode_evacuate",     # requests pulled off the engine
    #                                (scheduler death / shutdown)
    "serving_compile_post_warmup",  # LOUD: a kernel built after warmup
    "serving_breaker_open",        # LOUD: executor failure burst
    "serving_breaker_close",       # half-open probe succeeded
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
_KNOWN_KINDS = (set(DECODE_EVENTS) | set(RESILIENCE_EVENTS)
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

    def close(self):
        if not self._f.closed:
            self.event("run_end")
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


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
