"""Structured run events: an append-only JSONL log with provenance.

The port of the part of paddle_tpu/observe/events.py the decode engine
uses.  One JSON object per line, flushed whole, so the file is valid to
tail mid-run.  Kinds under the `serving_` prefix are checked against the
registry below (a typo'd kind would silently drop off every dashboard
filter): unknown ones raise.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Optional

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

_VALIDATED_PREFIXES = ("serving_",)


def _validate_kind(kind: str) -> None:
    if kind.startswith(_VALIDATED_PREFIXES) and kind not in DECODE_EVENTS:
        raise ValueError(f"event kind {kind!r} matches a dashboard prefix "
                         f"{_VALIDATED_PREFIXES} but is not registered in "
                         f"observe.events.DECODE_EVENTS")


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

