"""Op ranges and post-trace attribution: the fluid profiler's per-op time
table from a captured `torch.profiler` trace.

The port of paddle_tpu/observe/trace.py.  The reference wraps every op
lowering in a `<op_type>:<op_index>` named scope and joins the device
events of a jax.profiler trace to those scopes through the HLO
metadata.  The port interprets the program eagerly, so it marks the
same names as host ranges instead:

- **Forward.**  While a profiler (`paddle_tpu_torch.profiler`) or a step
  recorder (observe/cost.py, observe/memory.py) is active, the
  executor's `_run_one_op` runs each op inside `scoped` below: a
  `torch.profiler.record_function("<op_type>:<op_index>")` range when a
  profiler records, and the op's label as this thread's current op.
  With neither active `op_scope[0]` is None and `_run_one_op` creates
  nothing.
- **Backward.**  `torch.autograd.grad` runs outside every op range (on
  CUDA on the autograd engine's device thread).  After each op, the
  autograd nodes its outputs' graph gained are tagged with the op's
  label in `node.metadata["fluid_op"]`, so the recorder reads a
  backward aten op's op from `torch._C._current_autograd_node()`, and
  under a profiler each tagged node also opens and closes the op's
  range around its own execution (a pre-hook and a hook): the backward
  kernels land in the same `<op_type>:<op_index>` ranges as the
  forward's, as the reference's `transpose(jvp(...))` scopes do.  The
  engine's event around a node carries that node's op too: the adds
  into the node's inputs' gradient buffers run after its hooks.

A trace is the chrome-trace JSON `torch.profiler` exports under a
profile directory.  On the card each kernel (and memcpy/memset) is
joined to its launch by CUPTI's correlation id and the launch to the
innermost fluid range around it on the launching thread; on the CPU the
outermost aten ops stand in for the device events.  No TensorBoard
import.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

# the executor's op hook: None, or `scoped` while op_ranges() is entered
op_scope = [None]

_lock = threading.Lock()
_active = {"ranges": 0, "tags": 0}
_tls = threading.local()

# the executor's range convention "<op_type>:<op_index>"
_FLUID_SCOPE_RE = re.compile(
    r"(?:^|[/(])([A-Za-z0-9_.\-]+):(\d+)(?=[/)]|$)")
_RANGE_RE = re.compile(r"^[A-Za-z0-9_.\-]+:\d+$")


def fluid_op_of(op_name: str) -> Optional[str]:
    """Innermost `<op_type>:<index>` segment of a scope or range name
    (also inside the reference's `jvp(...)` / `transpose(jvp(...))`
    wrappers), or None when it names no fluid op."""
    hits = _FLUID_SCOPE_RE.findall(op_name or "")
    return hits[-1][0] if hits else None


def current_op() -> Optional[str]:
    """The label "<op_type>:<op_index>" of the op this thread's executor
    is running, None outside every op."""
    return getattr(_tls, "label", None)


class op_ranges:
    """Context manager: while entered, the executor runs every op under
    `scoped`.  `ranges=True` (a profiler) also records each op's range,
    forward and backward; `ranges=False` (a step recorder) only labels
    the ops and their autograd nodes.  Nests; process-wide."""

    def __init__(self, ranges: bool):
        self.ranges = bool(ranges)

    def __enter__(self):
        with _lock:
            _active["ranges" if self.ranges else "tags"] += 1
            op_scope[0] = scoped
        return self

    def __exit__(self, *exc):
        with _lock:
            _active["ranges" if self.ranges else "tags"] -= 1
            if not (_active["ranges"] or _active["tags"]):
                op_scope[0] = None
        return False


def scoped(desc, op_index: int, run):
    """Run one op (`run()`, returning the env) under its label."""
    import torch

    label = f"{desc.type}:{op_index}"
    ranges = _active["ranges"] > 0
    prev = getattr(_tls, "label", None)
    _tls.label = label
    rf = torch.autograd.profiler.record_function(label) if ranges \
        else None
    if rf is not None:
        rf.__enter__()
    try:
        env = run()
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        _tls.label = prev
    if torch.is_grad_enabled():
        _tag_nodes([env.get(n) for n in desc.output_names()], label,
                   ranges)
    return env


def _tag_nodes(values, label: str, ranges: bool) -> None:
    """Tag the autograd nodes that `values`' graphs gained since the
    last tagged op with `label` (and, under a profiler, give each the
    op's range around its execution)."""
    stack = []
    for v in values:
        for t in (v if isinstance(v, tuple) else (v,)):
            fn = getattr(t, "grad_fn", None)
            if fn is not None:
                stack.append(fn)
    while stack:
        node = stack.pop()
        if node is None:
            continue
        md = node.metadata
        if "fluid_op" in md:
            continue
        md["fluid_op"] = label
        if ranges:
            _range_hooks(node, label)
        stack.extend(f for f, _ in node.next_functions)


def _range_hooks(node, label: str) -> None:
    import torch

    open_ranges: List[Any] = []

    def pre(grad_outputs):
        rf = torch.autograd.profiler.record_function(label)
        rf.__enter__()
        open_ranges.append(rf)

    def post(grad_inputs, grad_outputs):
        if open_ranges:
            open_ranges.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


def node_op(node) -> Optional[str]:
    """The label an autograd node was tagged with, or None."""
    if node is None:
        return None
    return node.metadata.get("fluid_op")


# --------------------------------------------------------------------------
# reading a trace
# --------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the CPU's device events: aten ops (not the autograd engine's and the
# nodes' own wrapper events, which open before a backward op's range)
_ATEN_PREFIXES = ("aten::", "c10d::")
# the autograd engine's event around one backward node
_NODE_EVENT = "autograd::engine::evaluate_function"


def trace_files(profile_dir: str) -> List[str]:
    """The chrome-trace JSON files under a profile directory, oldest
    first."""
    files = glob.glob(os.path.join(profile_dir, "*.json"))
    if not files:
        raise FileNotFoundError(f"no trace under {profile_dir!r}")
    return sorted(files, key=os.path.getmtime)


def _load(profile_dir: str) -> List[Dict[str, Any]]:
    """The newest trace's complete ("X") events."""
    with open(trace_files(profile_dir)[-1]) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def event_counts(profile_dir: str) -> Dict[str, int]:
    """The newest trace's complete events by category (`kernel`,
    `cuda_runtime`, `cpu_op`, `user_annotation`, ...)."""
    out: Dict[str, int] = {}
    for e in _load(profile_dir):
        out[e.get("cat")] = out.get(e.get("cat"), 0) + 1
    return out


def _innermost(ranges, queries) -> Dict[Any, Optional[str]]:
    """For each (ts, key) of `queries` (sorted by ts), the label of the
    innermost of `ranges` ((start, end, label) sorted by start, properly
    nested) that holds ts, or None."""
    out: Dict[Any, Optional[str]] = {}
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for ts, key in queries:
        while i < len(ranges) and ranges[i][0] <= ts:
            r = ranges[i]
            while stack and stack[-1][1] < r[0]:
                stack.pop()
            stack.append(r)
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _by_thread(events):
    out: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for e in events:
        out.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    return out


def _node_ranges(events, ranges) -> None:
    """Give each backward node's engine event the label of the op range
    inside it, in `ranges`: the autograd engine adds a node's gradient
    into its inputs' buffers after the node's hooks closed the range,
    and that work is the node's op's too."""
    nodes = _by_thread(e for e in events if e.get("name", "").startswith(
        _NODE_EVENT))
    for k, evs in nodes.items():
        mine = ranges.get(k)
        if not mine:
            continue
        starts = [r[0] for r in mine]
        extra = []
        for e in evs:
            lo = float(e["ts"])
            hi = lo + float(e["dur"])
            i = bisect.bisect_left(starts, lo)
            if i < len(mine) and mine[i][1] <= hi:
                extra.append((lo, hi, mine[i][2]))
        ranges[k] = sorted(mine + extra, key=lambda r: (r[0], -r[1]))


def device_events(profile_dir: str) -> Iterator[Tuple[str, Optional[str],
                                                      float, bool]]:
    """Yield (event name, fluid range label or None, duration ms, on the
    card) for every timed device event of the newest trace: the card's
    kernels, copies and sets when it has any, else the CPU's outermost
    aten ops."""
    events = _load(profile_dir)
    ranges = _by_thread(
        e for e in events if e.get("cat") == "user_annotation"
        and _RANGE_RE.match(e.get("name", "")))
    ranges = {k: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in v) for k, v in ranges.items()}
    _node_ranges(events, ranges)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if dev:
        launches = {}
        for e in events:
            if e.get("cat") in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        queries: Dict[Tuple[Any, Any], List[Tuple[float, int]]] = {}
        for i, e in enumerate(dev):
            la = launches.get((e.get("args") or {}).get("correlation"))
            if la is not None:
                queries.setdefault((la.get("pid"), la.get("tid")),
                                   []).append((float(la["ts"]), i))
        labels: Dict[int, Optional[str]] = {}
        for k, q in queries.items():
            labels.update(_innermost(ranges.get(k, []), sorted(q)))
        for i, e in enumerate(dev):
            yield e["name"], labels.get(i), float(e["dur"]) / 1e3, True
        return
    for k, evs in _by_thread(e for e in events
                             if e.get("cat") == "cpu_op"
                             and e.get("name", "").startswith(
                                 _ATEN_PREFIXES)).items():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        top, end = [], -1.0
        for e in evs:
            if float(e["ts"]) >= end:
                top.append(e)
                end = float(e["ts"]) + float(e["dur"])
        labels = _innermost(ranges.get(k, []),
                            [(float(e["ts"]), i) for i, e in enumerate(top)])
        for i, e in enumerate(top):
            yield e["name"], labels[i], float(e["dur"]) / 1e3, False


def instr_time_table(profile_dir: str) -> Dict[str, Dict[str, Any]]:
    """Per device-event-name measured time of the newest trace, keyed by
    kernel name on the card (aten op name on the CPU):
    {name: {total_ms, calls, op_name}}; `op_name` is the fluid range
    label of the event's last call, None when it had none."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, label, ms, _card in device_events(profile_dir):
        r = out.setdefault(name, {"total_ms": 0.0, "calls": 0,
                                  "op_name": label})
        r["total_ms"] += ms
        r["calls"] += 1
        r["op_name"] = label or r["op_name"]
    return out


def op_time_table(profile_dir: str) -> List[Dict[str, Any]]:
    """Aggregate the newest trace into per-fluid-op-type rows.

    Returns [{op_type, calls, total_ms, avg_ms, max_ms, min_ms, ratio}]
    sorted by total time; device events outside every fluid range
    aggregate under "[unattributed]"."""
    rows: Dict[str, Dict[str, Any]] = {}
    for _name, label, ms, _card in device_events(profile_dir):
        op = fluid_op_of(label) if label else None
        r = rows.setdefault(op or "[unattributed]", {
            "op_type": op or "[unattributed]", "calls": 0,
            "total_ms": 0.0, "max_ms": 0.0, "min_ms": float("inf")})
        r["calls"] += 1
        r["total_ms"] += ms
        r["max_ms"] = max(r["max_ms"], ms)
        r["min_ms"] = min(r["min_ms"], ms)
    out = sorted(rows.values(), key=lambda r: -r["total_ms"])
    total = sum(r["total_ms"] for r in out) or 1.0
    for r in out:
        r["avg_ms"] = r["total_ms"] / r["calls"]
        r["ratio"] = r["total_ms"] / total
        if r["min_ms"] == float("inf"):
            r["min_ms"] = 0.0
    return out


_SORT_KEYS = {"total": "total_ms", "calls": "calls", "max": "max_ms",
              "min": "min_ms", "ave": "avg_ms", "avg": "avg_ms"}


def format_op_table(profile_dir: str,
                    sorted_key: Optional[str] = "total") -> str:
    """The fluid profiler report: one row per fluid op type, sorted by
    `sorted_key` (total/calls/max/min/ave — fluid's vocabulary)."""
    rows = op_time_table(profile_dir)
    key = _SORT_KEYS.get(str(sorted_key).lower(), "total_ms")
    rows = sorted(rows, key=lambda r: -r[key])
    lines = ["------->     Profiling Report     <-------", ""]
    hdr = (f"{'Event':<28}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
           f"{'Max(ms)':>10}{'Min(ms)':>10}{'Ratio':>8}")
    lines += [f"sorted by: {sorted_key}", "", hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['op_type']:<28}{r['calls']:>8}{r['total_ms']:>12.3f}"
            f"{r['avg_ms']:>10.4f}{r['max_ms']:>10.4f}"
            f"{r['min_ms']:>10.4f}{r['ratio']:>8.1%}")
    if not rows:
        lines.append("(no attributable device events in trace)")
    return "\n".join(lines)
