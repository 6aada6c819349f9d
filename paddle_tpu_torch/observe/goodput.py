"""Wall-clock goodput ledger — observe pillar 8: the port of
paddle_tpu/observe/goodput.py.

Of the hours a job held the card, how many went to useful training
steps?  `GoodputLedger` accounts **every second** of a training run's
wall clock into EXCLUSIVE categories:

| category     | meaning                                             |
|--------------|-----------------------------------------------------|
| step         | step time (host dispatch + the device work it waits |
|              | on) — the only *goodput* category                   |
| replay       | steps RE-executed after a crash/relaunch (work that |
|              | already happened once; the restart-replay badput)   |
| compile      | kernel build wall time (`nvcc`, recorded by         |
|              | ops/kernels/_build.py), wherever it struck          |
|              | (re-attributed out of the phase it interrupted)     |
| data_stall   | reader `next()` blocking (input pipeline)           |
| checkpoint   | save time the step loop actually waited out         |
|              | (snapshot + any wait-for-previous + sync writes)    |
| recovery     | divergence-autopilot work: rollback restores, the   |
|              | quarantined batches, reader waits while replaying   |
| barrier_wait | gang waits: the health plane's step-boundary checks |
|              | and the done-rendezvous                             |
| idle         | residual host time (event handlers, logging, loop   |
|              | overhead) — whatever no explicit phase claimed      |

The ledger is PURE HOST: `time.monotonic()` reads at phase boundaries
plus `runtime_stats` snapshots (host counters).  It never touches a
program or a tensor: no launch, no synchronisation.

Exclusivity: phases nest (a checkpoint save inside the train window);
a frame's own time excludes its children's, and kernel-build wall
observed during a frame is re-attributed from that frame's category to
"compile" — so the categories sum to the elapsed wall by construction
("idle" is the residual).  Background work that OVERLAPS the wall (the
async checkpoint writer thread) is recorded on a side channel
(`note_background`) and reported separately — overlapped milliseconds
are deliberately NOT a wall category, which is exactly the async-save
win the checkpoint split (snapshot_ms vs write_ms) measures.

Surfaces: `report()`/`goodput_report()` (goodput fraction +
`effective_mfu` = headline MFU x goodput), `format_goodput_table`,
`export_chrome_trace` (one row per category).  contrib.Trainer threads
it end-to-end and exposes `Trainer.goodput()`.  The registry's
`goodput_collector` comes with the metrics registry (ROADMAP A step
11).
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .monitoring import runtime_stats


def _compile_wall(delta: Dict[str, float]) -> float:
    """The host-side compilation wall a region paid: in the port, the
    `nvcc` builds of the CUDA kernels (ops/kernels/_build.py records
    each as a compile; `trace_time_s` stays 0, nothing is traced), so a
    step that built a kernel keeps its own time dispatch-sized after
    re-attribution."""
    return (delta["compile_time_s"] + delta.get("trace_time_s", 0.0))

# exclusive wall-clock categories; "idle" is the computed residual and
# "compile" is re-attributed out of whichever phase it interrupted
CATEGORIES = ("step", "replay", "compile", "data_stall", "checkpoint",
              "recovery", "barrier_wait", "idle")
# categories a phase() may claim explicitly (everything but the
# residual; "compile" phases are legal for callers that KNOW a region
# is compile, e.g. an explicit warmup — normally it is auto-derived)
PHASE_CATEGORIES = tuple(c for c in CATEGORIES if c != "idle")
# the only useful-work category; everything else is badput
GOODPUT_CATEGORY = "step"

# chrome-trace process id for the training-goodput rows: far above
# reqtrace's pid space (router=0, replica k=k+1) so one merged JSON
# from a serving+training host keeps the rows distinct
GOODPUT_TRACE_PID = 1000


class GoodputLedger:
    """Exclusive wall-clock accounting for one training run.

        ledger = GoodputLedger()
        ledger.open_window()             # wall starts counting
        with ledger.phase("data_stall"):
            batch = next(it)
        with ledger.phase("step", steps=1):
            exe.run(...)
        ledger.close_window()
        ledger.report(mfu=0.32)

    Windows bound the wall clock (`open_window`/`close_window`, or the
    `window()` context manager); phases attribute slices of it.  A
    top-level phase OUTSIDE any window still counts (its elapsed joins
    the wall total) so instrumented waits after train() — e.g. the
    gang done-rendezvous — keep Σ categories == wall.

    Thread contract: phases run on the owning (training) thread;
    `note_background` and `report` are safe from any thread.
    """

    def __init__(self, clock=time.monotonic, max_spans: int = 4096):
        self._clock = clock
        self._lock = threading.Lock()
        self._cats: Dict[str, float] = {c: 0.0 for c in PHASE_CATEGORIES}
        self._counts: Dict[str, int] = {"step": 0, "replay": 0}
        self._frames: List[Dict[str, float]] = []   # phase stack
        self._window_t0: Optional[float] = None
        self._win_rt0: Optional[Dict[str, float]] = None
        self._win_phase_compile = 0.0
        self._closed_wall = 0.0
        self._outside_wall = 0.0
        self._background: Dict[str, float] = {}
        self._spans: collections.deque = collections.deque(
            maxlen=max(16, int(max_spans)))
        self.spans_dropped = 0
        self._replay_info: Optional[Dict[str, Any]] = None

    # -- windows ----------------------------------------------------------
    def open_window(self) -> None:
        """Start counting wall clock (idempotent while open)."""
        with self._lock:
            if self._window_t0 is not None:
                return
            self._window_t0 = self._clock()
            self._win_rt0 = runtime_stats.snapshot()
            self._win_phase_compile = 0.0

    def close_window(self) -> None:
        """Stop the wall clock; backend-compile wall that struck inside
        the window but OUTSIDE any phase (e.g. an eager warmup the
        caller didn't wrap) is attributed to "compile" here."""
        with self._lock:
            if self._window_t0 is None:
                return
            elapsed = self._clock() - self._window_t0
            self._closed_wall += elapsed
            comp = _compile_wall(runtime_stats.delta(self._win_rt0))
            extra = max(comp - self._win_phase_compile, 0.0)
            self._cats["compile"] += min(extra, elapsed)
            self._window_t0 = None
            self._win_rt0 = None
            self._win_phase_compile = 0.0

    @contextlib.contextmanager
    def window(self):
        self.open_window()
        try:
            yield self
        finally:
            self.close_window()

    # -- phases -----------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, category: str, label: Optional[str] = None,
              steps: int = 0):
        """Attribute the enclosed wall time to `category`.

        Nesting-aware: a frame's own time excludes its children's, and
        the backend-compile wall observed during the frame (beyond
        what its children already claimed) moves to "compile" — a step
        phase that triggered a 30 s XLA compile contributes its
        dispatch time to "step" and the 30 s to "compile".  `steps`
        increments the category's step counter (the denominators of
        mean_step_s / replay badput)."""
        if category not in PHASE_CATEGORIES:
            raise ValueError(
                f"unknown goodput category {category!r}; one of "
                f"{PHASE_CATEGORIES}")
        t0 = self._clock()
        rt0 = runtime_stats.snapshot()
        frame = {"child_s": 0.0, "child_compile_s": 0.0}
        self._frames.append(frame)
        try:
            yield
        finally:
            self._frames.pop()
            t1 = self._clock()
            elapsed = max(t1 - t0, 0.0)
            comp = _compile_wall(runtime_stats.delta(rt0))
            own = max(elapsed - frame["child_s"], 0.0)
            own_compile = min(
                max(comp - frame["child_compile_s"], 0.0), own)
            with self._lock:
                self._cats[category] += own - own_compile
                self._cats["compile"] += own_compile
                if steps:
                    self._counts[category] = (
                        self._counts.get(category, 0) + int(steps))
                if self._frames:
                    parent = self._frames[-1]
                    parent["child_s"] += elapsed
                    parent["child_compile_s"] += comp
                elif self._window_t0 is not None:
                    self._win_phase_compile += comp
                else:
                    # top-level phase outside any window: its elapsed
                    # joins the wall so the invariant survives
                    # instrumented waits after train()
                    self._outside_wall += elapsed
                if len(self._spans) == self._spans.maxlen:
                    self.spans_dropped += 1
                self._spans.append((category, label, t0, t1))

    # -- side channels ----------------------------------------------------
    def note_background(self, name: str, seconds: float) -> None:
        """Record work that OVERLAPPED the wall on another thread (the
        async checkpoint writer).  Reported separately — never a wall
        category, so overlapped milliseconds are not double-counted."""
        with self._lock:
            self._background[name] = (
                self._background.get(name, 0.0) + max(float(seconds),
                                                      0.0))

    def note_replay(self, resumed: Iterable[int],
                    crashed: Iterable[int]) -> None:
        """Record the resume→crash cursor window the relaunch will
        re-execute ((epoch, step) pairs); the actual re-executed steps
        are counted by `phase("replay", steps=...)`."""
        with self._lock:
            self._replay_info = {"from": list(resumed),
                                 "to": list(crashed)}

    # -- reads ------------------------------------------------------------
    def wall_s(self) -> float:
        with self._lock:
            w = self._closed_wall + self._outside_wall
            if self._window_t0 is not None:
                w += max(self._clock() - self._window_t0, 0.0)
        return w

    def category_s(self, category: str) -> float:
        if category == "idle":
            return self.report()["categories_s"]["idle"]
        with self._lock:
            return self._cats[category]

    def category_ms(self, category: str) -> float:
        return self.category_s(category) * 1000.0

    def background_ms(self, name: str) -> float:
        with self._lock:
            return self._background.get(name, 0.0) * 1000.0

    def steps(self, category: str = "step") -> int:
        with self._lock:
            return self._counts.get(category, 0)

    def report(self, mfu: Optional[float] = None,
               skew: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The goodput decomposition: categories_s summing to wall_s
        ("idle" = residual), per-category fractions, the goodput
        fraction (step share), replay badput, and — when the headline
        MFU / gang skew are supplied — `effective_mfu` = mfu x goodput
        and an informational straggler estimate (max heartbeat lag x
        mean step time; NOT a wall category, the lag overlaps steps)."""
        wall = self.wall_s()
        with self._lock:
            cats = dict(self._cats)
            counts = dict(self._counts)
            background = dict(self._background)
            replay_info = (dict(self._replay_info)
                           if self._replay_info else None)
            dropped = self.spans_dropped
        explicit = sum(cats.values())
        cats["idle"] = max(wall - explicit, 0.0)
        fractions = {c: (cats[c] / wall if wall > 0 else 0.0)
                     for c in CATEGORIES}
        n_step = counts.get("step", 0)
        n_replay = counts.get("replay", 0)
        mean_step = (cats["step"] / n_step) if n_step else None
        rep: Dict[str, Any] = {
            "wall_s": round(wall, 6),
            "categories_s": {c: round(cats[c], 6) for c in CATEGORIES},
            "fractions": {c: round(fractions[c], 6)
                          for c in CATEGORIES},
            "goodput": round(fractions[GOODPUT_CATEGORY], 6),
            "steps": n_step,
            "replay_steps": n_replay,
            "mean_step_s": (round(mean_step, 6)
                            if mean_step is not None else None),
            "background_ms": {k: round(v * 1000.0, 3)
                              for k, v in sorted(background.items())},
            "spans_dropped": dropped,
        }
        if replay_info is not None:
            rep["replay"] = replay_info
        if mfu is not None:
            rep["mfu"] = float(mfu)
            rep["effective_mfu"] = round(
                float(mfu) * fractions[GOODPUT_CATEGORY], 6)
        if skew:
            lag = skew.get("max_lag_steps")
            if lag and mean_step:
                rep["straggler_est_s"] = round(lag * mean_step, 6)
        return rep

    # -- chrome trace -----------------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None,
                            base: Optional[float] = None
                            ) -> Dict[str, Any]:
        """Render the span ring as chrome://tracing JSON — the
        step-anatomy timeline.  One thread row per category under one
        "training goodput" process (pid 1000, above reqtrace's
        router/replica pids), `ph:"X"` complete events, timestamps µs
        relative to `base` (default: the oldest kept span) — pass the
        same base reqtrace used and the two exports concatenate into
        one serving+training host timeline."""
        with self._lock:
            spans: List[Tuple[str, Optional[str], float, float]] = \
                list(self._spans)
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": GOODPUT_TRACE_PID,
             "args": {"name": "training goodput"}}]
        if spans:
            if base is None:
                base = min(t0 for _, _, t0, _ in spans)
            tids = {c: i for i, c in enumerate(PHASE_CATEGORIES)}
            for cat in sorted({c for c, _, _, _ in spans},
                              key=lambda c: tids.get(c, 99)):
                events.append({"name": "thread_name", "ph": "M",
                               "pid": GOODPUT_TRACE_PID,
                               "tid": tids.get(cat, 99),
                               "args": {"name": cat}})
            for cat, label, t0, t1 in spans:
                events.append({
                    "name": label or cat, "ph": "X", "cat": "goodput",
                    "ts": round((t0 - base) * 1e6, 1),
                    "dur": max(round((t1 - t0) * 1e6, 1), 1.0),
                    "pid": GOODPUT_TRACE_PID,
                    "tid": tids.get(cat, 99),
                    "args": {"category": cat},
                })
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(out, f)
        return out


def goodput_report(ledger: GoodputLedger, mfu: Optional[float] = None,
                   skew: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Module-level alias of `GoodputLedger.report`."""
    return ledger.report(mfu=mfu, skew=skew)


def format_goodput_table(report: Dict[str, Any]) -> str:
    """Align the report into the human table run_ci's smoke prints."""
    lines = [f"{'category':<14}{'seconds':>12}{'fraction':>10}"]
    lines.append("-" * 36)
    cats = report["categories_s"]
    fracs = report["fractions"]
    for c in CATEGORIES:
        lines.append(f"{c:<14}{cats[c]:>12.3f}{fracs[c]:>10.4f}")
    lines.append("-" * 36)
    lines.append(f"{'wall':<14}{report['wall_s']:>12.3f}{1.0:>10.4f}")
    lines.append(f"goodput {report['goodput']:.4f}"
                 f"  steps {report['steps']}"
                 f"  replay_steps {report['replay_steps']}")
    if report.get("mean_step_s") is not None:
        lines.append(f"mean_step_s {report['mean_step_s']:.6f}")
    if report.get("effective_mfu") is not None:
        lines.append(f"mfu {report['mfu']:.4f} -> effective_mfu "
                     f"{report['effective_mfu']:.4f}")
    if report.get("straggler_est_s") is not None:
        lines.append(f"straggler_est_s {report['straggler_est_s']:.3f}"
                     f" (informational; overlaps steps)")
    bg = report.get("background_ms") or {}
    for k, v in sorted(bg.items()):
        lines.append(f"background {k} {v:.1f} ms (overlapped)")
    return "\n".join(lines)
