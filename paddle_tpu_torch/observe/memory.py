"""Device memory observability: a live-bytes ledger of one recorded step,
the peak-memory timeline, and the fit planner.

The port of paddle_tpu/observe/memory.py.  The reference reads the
buffer assignment of its one compiled step.  The port has none (ROADMAP
C21): the step recorder of observe/cost.py keeps a ledger instead, over
the same recorded run:

- **The ledger.**  Each storage that an aten op (or a kernel wrapper's
  `torch.empty`) creates is charged to its fluid op, with the index of
  the event that made it; its free is recorded when the storage dies.
  The state the step starts from (copies of the scope's values) and the
  feeds are resident rows, named.  The peak is the largest sum of live
  bytes over the step's events.
- **Buckets** are the reference's five (`BUCKETS`), with donated bytes
  tallied.  Named state classifies by name: parameters, optimizer
  accumulators (the non-Param/Grad operands and outputs of
  `OPTIMIZER_OP_TYPES` ops), feeds as activations, the run counter as
  workspace.  Storages made in the backward are gradients; made by an
  optimizer op, optimizer state; by another op, activations; outside
  every op, workspace.
- **The allocator against the ledger.**  On the card a recorded step
  also reads the caching allocator's peak, during each event and over
  the run (`allocator_window`: `max_memory_allocated` and
  `reset_peak_memory_stats` at each event; the windows are serialised,
  and observe/monitoring.py keeps the process's peak across them).  It
  counts blocks rounded up and cuBLAS workspaces that no aten op
  returns, so it reads above the ledger (C21).
- **The fit planner** (`fit_peaks`, behind `plan_fit` and the serving
  engines' memory gates) keeps the reference's algorithm: two runs at
  small probe sizes, an affine fit, exact when the candidate is
  probe-sized.  Its probe is a recorded run of the step: on the card
  the allocator's peak, on the CPU the ledger's live bytes, during each
  event.  The eager step's peak moves between events as the batch grows
  (the update's state copies at a small batch, the activations at a
  large one), so the fit is made event by event and the prediction is
  the largest extrapolated event.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# device memory by device name prefix, the denominator when the
# allocator reports none (device_memory_budget reads the card's own
# total first): the H100 SXM's 80 GB
DEVICE_HBM_BYTES = {"NVIDIA H100": 80 * 10**9}

# optimizer op types (the reference's observe/memory.py): their ops'
# non-Param/Grad operands and outputs name the optimizer state, the
# population the ZeRO axis shards (parallel/compiler.py)
OPTIMIZER_OP_TYPES = {
    "sgd", "momentum", "lars_momentum", "adam", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "proximal_gd",
    "proximal_adagrad", "average_accumulates", "ema_accumulate",
}

BUCKETS = ("params", "optimizer_state", "gradients", "activations",
           "workspace")

# plan_fit's accuracy bound against a direct measurement on the same
# device (the reference's)
PLAN_FIT_REL_TOL = 0.10


def device_memory_budget(device=None) -> Optional[int]:
    """The card's memory in bytes (`device_memory_stats`'s bytes_limit,
    else DEVICE_HBM_BYTES by its name); None on the CPU or when CUDA was
    never initialised for `device=None` — "no budget known", never a
    guessed card."""
    import torch

    from .monitoring import device_memory_stats

    if device is not None and torch.device(device).type != "cuda":
        return None
    stats = device_memory_stats(device)
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if device is None:
        return None
    name = torch.cuda.get_device_name(torch.device(device))
    for prefix, cap in DEVICE_HBM_BYTES.items():
        if name.startswith(prefix):
            return cap
    return None


def program_var_buckets(program):
    """(param_names, optimizer_state_names) from the program desc (the
    reference's `_program_var_buckets`)."""
    from ..core.program import Parameter

    params, opt = set(), set()
    block = program.global_block()
    for name, var in block.vars.items():
        if isinstance(var, Parameter):
            params.add(name)
    for op in block.ops:
        if op.type not in OPTIMIZER_OP_TYPES:
            continue
        for slot, names in op.desc.inputs.items():
            if slot not in ("Param", "Grad"):
                opt.update(names)
        for slot, names in op.desc.outputs.items():
            if slot != "ParamOut":
                opt.update(names)
    return params, opt - params


def _state_bucket(name: str, params: set, opt: set) -> str:
    from ..core.executor import RNG_STATE_VAR
    from .metrics import TELEMETRY_VAR

    if name in params:
        return "params"
    if name in opt:
        return "optimizer_state"
    if name in (RNG_STATE_VAR, TELEMETRY_VAR):
        return "workspace"
    # other persistable state (batch norm's running stats, counters) is
    # model state, resident as params are
    return "params"


def _temp_bucket(alloc: Dict[str, Any]) -> str:
    op_type = alloc["op_type"]
    if op_type in OPTIMIZER_OP_TYPES:
        return "optimizer_state"
    if alloc["phase"] == "backward":
        return "gradients"
    if op_type is None:
        return "workspace"
    return "activations"


def _bucket(alloc: Dict[str, Any]) -> str:
    return alloc["bucket"] or _temp_bucket(alloc)


def _sweep(record) -> Tuple[List[Tuple[int, int]], int, int]:
    """(points, peak, peak index) of the ledger's live bytes over the
    step's events: at each event, the frees recorded before it, then its
    allocations."""
    delta: Dict[int, List[int]] = {}
    for a in record.allocs:
        delta.setdefault(a["seq"], [0, 0])[1] += a["bytes"]
        if a["free"] is not None:
            delta.setdefault(a["free"], [0, 0])[0] += a["bytes"]
    live = peak = peak_idx = 0
    points: List[Tuple[int, int]] = []
    for k in sorted(delta):
        freed, made = delta[k]
        live -= freed
        live += made
        points.append((k, live))
        if live > peak:
            peak, peak_idx = live, k
    return points, peak, peak_idx


def ledger_peak(record) -> Tuple[int, int]:
    """(peak live bytes, the event index it is reached at)."""
    _points, peak, idx = _sweep(record)
    return int(peak), idx


def _record(program, feed, fetch_list, scope, exe, compiled):
    if compiled is not None:
        return compiled
    if program is None:
        raise ValueError("needs a program or a step record")
    from ..core.executor import Executor

    exe = exe or Executor()
    return exe.compiled_step(program, feed=feed, fetch_list=fetch_list,
                             scope=scope)


def memory_report(program=None, feed=None, fetch_list=None, scope=None,
                  exe=None, compiled=None) -> Dict[str, Any]:
    """The memory ledger of a program's recorded step (`compiled`: a
    StepRecord from `Executor.compiled_step`).

    Returns {rows, peak_bytes, breakdown, source, allocator_peak_bytes}:
    - rows: one per resident state or feed (opcode "parameter", `param`
      its name) and one per storage the step made — {bytes, bucket,
      op_type, opcode (the aten op), instruction, param, donated,
      live_out, allocation (its event index)}, largest first;
    - peak_bytes: the ledger's peak live bytes;
    - breakdown: per-bucket byte sums + "donated" + "peak_bytes";
      the temp buckets' sums are footprints (the ledger frees and makes
      storages over the step, so they may add up past the peak);
    - allocator_peak_bytes: on the card, the caching allocator's peak
      over the same run (None on the CPU)."""
    rec = _record(program, feed, fetch_list, scope, exe, compiled)
    rows: List[Dict[str, Any]] = []
    for a in rec.allocs:
        state = a["phase"] == "state"
        rows.append({
            "bytes": int(a["bytes"]), "bucket": _bucket(a),
            "op_type": a["op_type"],
            "opcode": "parameter" if state else a["name"],
            "instruction": None if state else f"{a['name']}#{a['seq']}",
            "param": a["param"], "donated": bool(a.get("donated")),
            "live_out": a["free"] is None, "allocation": a["seq"]})
    rows.sort(key=lambda r: -r["bytes"])
    peak, _idx = ledger_peak(rec)
    breakdown = {b: 0 for b in BUCKETS}
    donated = 0
    for r in rows:
        breakdown[r["bucket"]] = breakdown.get(r["bucket"], 0) + r["bytes"]
        if r["donated"]:
            donated += r["bytes"]
    breakdown["donated"] = donated
    breakdown["peak_bytes"] = int(peak)
    return {"rows": rows, "peak_bytes": int(peak), "breakdown": breakdown,
            "source": "ledger",
            "allocator_peak_bytes": rec.allocator_peak_bytes}


def memory_table(program=None, feed=None, fetch_list=None, scope=None,
                 exe=None, compiled=None, top: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
    """The rows of `memory_report`, largest first (top=N truncates)."""
    rows = memory_report(program, feed=feed, fetch_list=fetch_list,
                         scope=scope, exe=exe, compiled=compiled)["rows"]
    return rows[:top] if top else rows


def format_memory_table(rows: Sequence[Dict[str, Any]],
                        top: int = 30) -> str:
    """Human-readable top-N buffer report."""
    hdr = (f"{'MB':>10}  {'Bucket':<16}{'Op':<22}{'Opcode':<16}"
           f"{'Param/Instruction':<32}{'Flags'}")
    lines = ["-------> Buffer-level memory attribution <-------", hdr,
             "-" * len(hdr)]
    for r in rows[:top]:
        flags = []
        if r.get("donated"):
            flags.append("donated")
        if r.get("live_out"):
            flags.append("live-out")
        who = r.get("param") or r.get("instruction") or "?"
        lines.append(
            f"{r['bytes'] / 1e6:>10.3f}  {r['bucket']:<16}"
            f"{(r.get('op_type') or '-'):<22}"
            f"{(r.get('opcode') or '-'):<16}{who:<32}"
            f"{','.join(flags)}")
    if len(rows) > top:
        rest = sum(r["bytes"] for r in rows[top:])
        lines.append(f"... ({len(rows) - top} more buffers, "
                     f"{rest / 1e6:.3f} MB)")
    return "\n".join(lines)


def sharded_memory_report(program, feed=None, fetch_list=None,
                          scope=None, exe=None) -> Dict[str, Any]:
    """memory_report of this rank's step of a program compiled with
    `CompiledProgram.with_data_parallel` (one process a rank, C16): the
    resident state is the rank's own, a DTensor's local slice."""
    wrapper = getattr(program, "_compiled_wrapper", None)
    if wrapper is None:
        raise ValueError("sharded_memory_report needs a program "
                         "compiled with CompiledProgram"
                         ".with_data_parallel")
    names = [f.name if hasattr(f, "name") else str(f)
             for f in (fetch_list or [])]
    record = wrapper.compiled_step(dict(feed or {}), names, scope,
                                   exe=exe)
    return memory_report(program=program, compiled=record)


def resident_state_bytes(report: Dict[str, Any],
                         bucket: str = "optimizer_state") -> int:
    """Bytes of a bucket's resident state rows (what must stay on the
    device the whole step), without the step's temporaries."""
    return sum(r["bytes"] for r in report["rows"]
               if r["bucket"] == bucket and r["opcode"] == "parameter")


def step_mem_breakdown(program=None, feed=None, fetch_list=None,
                       scope=None, exe=None) -> Dict[str, Any]:
    """Per-bucket byte sums + peak_bytes + source of a program's step;
    a program compiled over a mesh reports this rank's step."""
    wrapper = getattr(program, "_compiled_wrapper", None)
    if wrapper is not None:
        rep = sharded_memory_report(program, feed=feed,
                                    fetch_list=fetch_list, scope=scope,
                                    exe=exe)
    else:
        rep = memory_report(program, feed=feed, fetch_list=fetch_list,
                            scope=scope, exe=exe)
    out = dict(rep["breakdown"])
    out["source"] = rep["source"]
    return out


def memory_timeline(program=None, feed=None, fetch_list=None, scope=None,
                    exe=None, compiled=None) -> Dict[str, Any]:
    """Live bytes over the recorded step's events.

    Returns {points, peak_live_bytes, peak_index, peak_instruction,
    live_at_peak, resident_bytes, n_instructions, source}; `points` is
    [(event index, live bytes)] at every change, `live_at_peak` the
    storages alive at the peak, largest first.  Its peak is
    memory_report's peak_bytes."""
    rec = _record(program, feed, fetch_list, scope, exe, compiled)
    points, peak, peak_idx = _sweep(rec)
    n = rec.n_events
    alive = [a for a in rec.allocs if a["seq"] <= peak_idx
             and (a["free"] is None or a["free"] > peak_idx)]
    live_at_peak = sorted(
        ({"bytes": a["bytes"], "lo": a["seq"],
          "hi": n - 1 if a["free"] is None else a["free"] - 1,
          "op_type": a["op_type"], "instruction": a["param"] or a["name"],
          "buffers": [a["seq"]]} for a in alive),
        key=lambda s: -s["bytes"])
    made = [a for a in rec.allocs if a["seq"] == peak_idx]
    return {
        "points": points or [(0, 0)],
        "peak_live_bytes": int(peak),
        "peak_index": peak_idx,
        "peak_instruction": made[0]["name"] if made else None,
        "live_at_peak": live_at_peak,
        "resident_bytes": int(sum(a["bytes"] for a in rec.allocs
                                  if a["phase"] == "state")),
        "n_instructions": n,
        "source": "ledger",
    }


def export_chrome_trace(timeline: Dict[str, Any], path: str) -> str:
    """Write the timeline as chrome-trace JSON: counter events over the
    step's events and an instant event at the peak."""
    import json

    events = [{"name": "live_device_bytes", "ph": "C", "pid": 0,
               "tid": 0, "ts": idx, "args": {"bytes": live}}
              for idx, live in timeline["points"]]
    events.append({
        "name": "peak", "ph": "i", "pid": 0, "tid": 0, "s": "g",
        "ts": timeline["peak_index"],
        "args": {"peak_live_bytes": timeline["peak_live_bytes"],
                 "instruction": timeline["peak_instruction"],
                 "top_buffers": [
                     {"bytes": s["bytes"], "op_type": s["op_type"],
                      "instruction": s["instruction"]}
                     for s in timeline["live_at_peak"][:10]]},
    })
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# --------------------------------------------------------------------------
# measured peaks and the fit planner
# --------------------------------------------------------------------------

# one probe window at a time in the process: a window resets the
# allocator's peak counter, which every thread shares.  Allocations that
# other threads make meanwhile (a Fleet's other replicas serving) still
# fall inside it.
_PROBE_LOCK = threading.RLock()


def _on_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


class allocator_window:
    """The caching allocator's peak over a region on one card, above what
    was allocated when the region began (`peak`); `sample()` closes one
    sample, the peak since the last (a step recorder closes one at each
    event), and the region's end closes the last.  Windows are
    serialised process-wide, and the process's own peak survives them
    (observe/monitoring.py `fold_peak`)."""

    def __init__(self, device):
        self.device = device
        self.samples: List[int] = []
        self.base = 0
        self.peak = 0

    def __enter__(self):
        import torch

        from .monitoring import fold_peak

        _PROBE_LOCK.acquire()
        try:
            torch.cuda.synchronize(self.device)
            self.base = int(torch.cuda.memory_allocated(self.device))
            fold_peak(self.device)
        except BaseException:
            _PROBE_LOCK.release()
            raise
        self.samples = []
        return self

    def sample(self) -> int:
        from .monitoring import fold_peak

        v = fold_peak(self.device)
        self.samples.append(v)
        return v

    def __exit__(self, *exc):
        import torch

        try:
            torch.cuda.synchronize(self.device)
            self.sample()
            self.peak = max(self.samples) - self.base
        finally:
            _PROBE_LOCK.release()
        return False


def measure_run(run, device, resident: Dict[str, Any] = ()):
    """One recorded run of `run()` (a cost.StepRecord): the tensors of
    `resident` ({name: tensor} already on the device that the run needs,
    its parameters and feeds) registered in its ledger; on the card also
    the allocator's peak during each event and over the run, above what
    was allocated before it, plus the resident bytes."""
    import torch

    from .cost import StepRecord, StepRecorder

    resident = {n: t for n, t in dict(resident).items()
                if isinstance(t, torch.Tensor)}
    window = allocator_window(device) if _on_card(device) else None
    rec = StepRecorder(window)
    for n, t in resident.items():
        rec.resident(t, n, "params")
    with window or contextlib.nullcontext():
        with rec:
            run()
    held = sum(t.numel() * t.element_size() for t in resident.values())
    return StepRecord(rec, [("state", n) for n in resident], device,
                      window, held if window is not None else 0)


def live_curve(record) -> List[int]:
    """Peak bytes during each of the recorded step's events: the
    allocator's on the card, the ledger's live bytes on the CPU."""
    if record.allocator_curve:
        return list(record.allocator_curve)
    points, _peak, _idx = _sweep(record)
    out, live, i = [], 0, 0
    for k in range(record.n_events):
        while i < len(points) and points[i][0] <= k:
            live = points[i][1]
            i += 1
        out.append(live)
    return out


def record_peak(record) -> int:
    """The peak a plan probes with: the allocator's on the card, the
    ledger's on the CPU."""
    if record.allocator_peak_bytes is not None:
        return int(record.allocator_peak_bytes)
    return ledger_peak(record)[0]


def _extrapolate(r0, r1, b0, b1, size) -> Optional[int]:
    """The largest of the peaks during each event, each extrapolated
    affinely in size from the two probes, or None when the probes' runs
    differ in their events.  The step's peak moves between events as
    the size grows (the optimizer's state copies at a small batch, the
    activations at a large one), so the peaks of the probes alone do
    not extrapolate; each event's peak does."""
    c0, c1 = live_curve(r0), live_curve(r1)
    if not c0 or len(c0) != len(c1):
        return None
    k = (size - b0) / float(b1 - b0)
    return int(round(max(a + (b - a) * k for a, b in zip(c0, c1))))


def fit_peaks(probe, sizes: Sequence[int], probe_sizes: Sequence[int]
              ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Predicted peaks of the step at `sizes` (batch sizes, pool pages)
    from probe runs: `probe(size)` returns a step record
    (`Executor.compiled_step`, `measure_run`).  A size among the one or
    two `probe_sizes` is measured (exact); any other extrapolates each
    event's peak affinely from the two probes and predicts their
    largest (the probes' peaks alone where their runs differ in their
    events).  The fit planner of `plan_fit` and of the serving engines'
    memory gates.

    Returns ([{size, predicted_peak_bytes, exact}], {probe_batches,
    probe_peaks, per_example_bytes, resident_bytes})."""
    ps = sorted({int(s) for s in probe_sizes})
    if len(ps) not in (1, 2) or ps[0] < 1:
        raise ValueError(f"probe sizes must be one or two distinct "
                         f"positive sizes, got {tuple(probe_sizes)}")
    recs = [probe(s) for s in ps]
    peaks = [record_peak(r) for r in recs]
    slope = (peaks[1] - peaks[0]) / float(ps[1] - ps[0]) \
        if len(ps) == 2 else 0.0
    intercept = peaks[0] - slope * ps[0]
    rows = []
    for s in sizes:
        if s in ps:
            pred, exact = peaks[ps.index(s)], True
        else:
            pred = _extrapolate(recs[0], recs[1], ps[0], ps[1], s) \
                if len(ps) == 2 else None
            if pred is None:
                pred = int(round(intercept + slope * s))
            exact = False
        rows.append({"size": int(s), "predicted_peak_bytes": int(pred),
                     "exact": exact})
    return rows, {"probe_batches": ps, "probe_peaks": peaks,
                  "per_example_bytes": int(round(slope)),
                  "resident_bytes": int(round(intercept))}


def _shape_dtype(v) -> Tuple[tuple, Any]:
    import torch

    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    if hasattr(v, "shape") and hasattr(v, "dtype") \
            and not isinstance(v, np.ndarray):
        return tuple(v.shape), v.dtype
    arr = np.asarray(v)
    return arr.shape, arr.dtype


def _itemsize(dtype) -> int:
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _zeros(shape, dtype, name):
    import torch

    fill = 1 if name.endswith(".seq_len") else 0
    if isinstance(dtype, torch.dtype):
        return torch.full(shape, fill, dtype=dtype)
    return np.full(shape, fill, np.dtype(dtype))


def _infer_batch(spec) -> Optional[int]:
    dims = Counter(int(s[0][0]) for s in spec.values() if s[0])
    if not dims:
        return None
    return dims.most_common(1)[0][0]


def plan_fit(program, feed, fetch_list=None, scope=None, exe=None,
             batch: Optional[int] = None,
             probe_batches: Tuple[int, int] = (2, 4),
             budget_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Predict the step's peak device memory for a CANDIDATE feed without
    running the candidate.

    `feed` maps input name to an array, tensor or `FeedSpec` at the
    candidate shape (no data needed).  The planner records the SAME
    program at two small probe batches (zeros; every feed whose leading
    dim equals the candidate batch shrunk, everything else as given) and
    extrapolates the affine peak(b) fit; the probes are memoized by
    `Executor.compiled_step`, so a ladder pays them once.  A probe reads
    the card's allocator, or the ledger on the CPU, after each of the
    step's events: each event's live bytes is extrapolated, and the
    prediction is their largest (the peaks alone where the probes' runs
    differ in their events).

    Returns {predicted_peak_bytes, exact, batch, probe_batches,
    probe_peaks, per_example_bytes, resident_bytes, breakdown, rel_tol,
    budget_bytes, fits, headroom_bytes}; `fits`/`headroom_bytes` are
    None when no budget is known (the argument, else the executor's
    card).  Raises ValueError when the batch axis cannot be inferred
    (pass batch=)."""
    from ..core.executor import Executor, global_scope

    exe = exe or Executor()
    spec = {n: _shape_dtype(v) for n, v in (feed or {}).items()}
    if not spec:
        raise ValueError("plan_fit needs a feed (the candidate shapes; "
                         "programs with no feeds have nothing to scale)")
    batch = batch if batch is not None else _infer_batch(spec)
    if batch is None or batch < 1:
        raise ValueError(f"cannot infer the batch axis from {spec}; "
                         f"pass batch=")
    sc = scope if scope is not None else global_scope()

    def at_batch(b: int) -> Dict[str, Any]:
        out = {}
        for n, (shape, dtype) in spec.items():
            if shape and int(shape[0]) == batch:
                shape = (b,) + tuple(shape[1:])
            out[n] = _zeros(tuple(shape), dtype, n)
        return out

    def probe(b: int):
        return exe.compiled_step(program, feed=at_batch(b),
                                 fetch_list=fetch_list, scope=sc)

    b0, b1 = sorted(int(b) for b in probe_batches)
    if not 0 < b0 < b1:
        raise ValueError(f"probe_batches must be two distinct positive "
                         f"sizes, got {probe_batches}")
    # a probe-sized candidate is measured directly (exact)
    (row,), fit = fit_peaks(probe, [batch],
                            (batch,) if batch <= b1 else (b0, b1))
    predicted = row["predicted_peak_bytes"]

    params, opt = program_var_buckets(program)

    def nbytes(name):
        v = sc.find_var(name)
        if v is None:
            return 0
        try:
            from torch.distributed.tensor import DTensor

            if isinstance(v, DTensor):
                v = v.to_local()
        except ImportError:  # pragma: no cover
            pass
        if hasattr(v, "element_size"):
            return int(v.numel() * v.element_size())
        return int(np.asarray(v).nbytes)

    params_bytes = sum(nbytes(n) for n in params)
    opt_bytes = sum(nbytes(n) for n in opt)
    feed_bytes = int(sum(
        int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)
        for shape, dtype in spec.values()))
    if budget_bytes is None:
        budget_bytes = device_memory_budget(exe.device)
    fits = headroom = None
    if budget_bytes:
        fits = bool(predicted <= budget_bytes)
        headroom = int(budget_bytes - predicted)
    return {
        "predicted_peak_bytes": int(predicted),
        "exact": row["exact"],
        "batch": int(batch),
        **fit,
        "breakdown": {
            "params": params_bytes,
            "optimizer_state": opt_bytes,
            "feeds": feed_bytes,
            "temp": int(max(predicted - params_bytes - opt_bytes
                            - feed_bytes, 0)),
        },
        "rel_tol": PLAN_FIT_REL_TOL,
        "budget_bytes": budget_bytes,
        "fits": fits,
        "headroom_bytes": headroom,
    }
