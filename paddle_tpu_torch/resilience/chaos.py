"""Deterministic fault injection for the resilience subsystem: the
in-process part of paddle_tpu/resilience/chaos.py (:1-281).

Every recovery behavior is proven by injecting its fault, not by
hoping:

- **failpoints** — named kill-switches in the production code path at
  the exact spots a process can die (e.g. `ckpt:before_manifest`
  between the shard write and the manifest write in io.save_sharded).
  Unarmed they are a dict lookup; armed they raise `ChaosKilled`,
  simulating preemption at that instant.
- **delaypoints** — named stalls (`ckpt:write`), the slow-disk
  injection.
- **NaN injection** — poison one named float feed, or step k of a
  reader; the NaN propagates to the loss and every gradient,
  which is exactly the failure mode a bad batch causes.
- **checkpoint corruption** — flip or truncate bytes of a shard
  container so CRC/container verification must catch it, or tear a
  checkpoint by removing its manifest.

- **hang** — an injected host-side stall the step watchdog
  (resilience/watchdog.py) must interrupt.
- **executor faults** — `FlakyPredictor`, a Predictor proxy whose first
  runs fail (the serving breaker's burst).
- **serving replicas** — `kill_replica` arms a fleet replica's
  `replica:{id}:kill` failpoint (its next scheduled iteration or
  dispatch dies through the real failure path), `delay_replica` its
  `replica:{id}:delay` stall (the straggler a hedge must beat).

Injectors are deterministic (step counts, call counts — never random),
so every chaos test is reproducible.  The reference's gang-rank
injectors and `FakeKv` wait for ROADMAP A step 11.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from .errors import ResilienceError


class ChaosKilled(ResilienceError):
    """Raised by an armed failpoint — the simulated process death."""

    kind = "chaos_killed"


# ---------------------------------------------------------------------------
# Failpoints
# ---------------------------------------------------------------------------

_armed: Dict[str, int] = {}
_delays: Dict[str, tuple] = {}  # name -> (seconds, remaining hits)


def arm(name: str, times: int = 1) -> None:
    """Arm failpoint `name` to fire on its next `times` hits."""
    _armed[name] = int(times)


def arm_delay(name: str, seconds: float, times: int = 1) -> None:
    """Arm delaypoint `name` to SLEEP `seconds` on its next `times`
    hits (a failpoint kills; a delaypoint stalls)."""
    _delays[name] = (float(seconds), int(times))


def disarm(name: str) -> None:
    _armed.pop(name, None)
    _delays.pop(name, None)


def clear() -> None:
    """Disarm every failpoint and delaypoint (test teardown)."""
    _armed.clear()
    _delays.clear()


def failpoint(name: str) -> None:
    """Production-code hook: no-op unless `arm(name)` was called, then
    raises ChaosKilled (once per armed count)."""
    left = _armed.get(name)
    if not left:
        return
    if left <= 1:
        _armed.pop(name, None)
    else:
        _armed[name] = left - 1
    raise ChaosKilled(f"failpoint {name!r} fired (simulated death)",
                      failpoint=name)


def delaypoint(name: str) -> None:
    """Production-code hook: no-op unless `arm_delay(name, s)` was
    called, then sleeps the armed duration (once per armed count)."""
    entry = _delays.get(name)
    if not entry:
        return
    seconds, left = entry
    if left <= 1:
        _delays.pop(name, None)
    else:
        _delays[name] = (seconds, left - 1)
    time.sleep(seconds)


def hang(seconds: float) -> None:
    """An injected hang the watchdog must interrupt: a sleep in 50 ms
    slices, so the interpreter runs between them and SIGALRM (main
    thread) or the timer thread's async exception can fire."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# NaN / feed poisoning
# ---------------------------------------------------------------------------

def poison_feed(feed: Dict[str, Any], names: Optional[Iterable[str]]
                = None) -> Dict[str, Any]:
    """Copy of `feed` with NaN written into the first element of each
    named float input (all float inputs when names is None)."""
    out = dict(feed)
    targets = list(names) if names is not None else [
        n for n, v in feed.items()
        if np.asarray(v).dtype.kind == "f"]
    if not targets:
        raise ValueError("no float feed to poison")
    for n in targets:
        arr = np.array(feed[n], copy=True)
        if arr.dtype.kind != "f":
            raise ValueError(f"feed {n!r} is {arr.dtype}, not float")
        arr.reshape(-1)[0] = np.nan
        out[n] = arr
    return out


def nan_reader(reader: Callable[[], Iterable], at_step: int,
               names: Optional[Iterable[str]] = None,
               feed_order: Optional[Iterable[str]] = None
               ) -> Callable[[], Iterator]:
    """Wrap a Trainer-style reader so the batch at index `at_step`
    (0-based, per epoch) is NaN-poisoned.  Tuple batches need
    `feed_order` to name their fields."""

    def wrapped():
        for i, batch in enumerate(reader()):
            if i != at_step:
                yield batch
                continue
            if not isinstance(batch, dict):
                if feed_order is None:
                    raise ValueError("tuple batches need feed_order")
                batch = dict(zip(feed_order, batch))
            yield poison_feed(batch, names)

    return wrapped


# ---------------------------------------------------------------------------
# Checkpoint corruption
# ---------------------------------------------------------------------------

def corrupt_file(path: str, mode: str = "flip",
                 offset_frac: float = 0.5) -> str:
    """Corrupt `path` in place: mode="flip" inverts 64 bytes in the
    middle (container still opens; content/CRC is wrong), mode=
    "truncate" cuts the file in half (container itself unreadable).
    Returns the path."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to corrupt")
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return path
    if mode != "flip":
        raise ValueError(f"unknown corruption mode {mode!r}")
    off = min(max(0, int(size * offset_frac)), size - 1)
    n = min(64, size - off)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def corrupt_shard(ckpt_dir: str, proc: int = 0,
                  mode: str = "flip") -> str:
    """Corrupt one shard container of a sharded checkpoint directory
    (io.py layout: shards_p{proc}.npz)."""
    path = os.path.join(ckpt_dir, f"shards_p{proc}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shard file at {path}")
    return corrupt_file(path, mode=mode)


def tear_checkpoint(ckpt_dir: str) -> None:
    """Make an existing checkpoint directory look like a save that died
    between the shard write and the manifest write (shards present, no
    manifest, no trainer state) — the end-state the
    `ckpt:before_manifest` failpoint produces live."""
    from .. import io as fluid_io

    removed = 0
    for name in (fluid_io.SHARD_MANIFEST, "__trainer_state__.json"):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            os.remove(p)
            removed += 1
    if removed == 0:
        raise FileNotFoundError(
            f"{ckpt_dir} has no manifest/trainer state to tear")


# ---------------------------------------------------------------------------
# Executor faults (serving breaker, watchdog)
# ---------------------------------------------------------------------------

class InjectedExecutorError(ResilienceError):
    """The failure FlakyPredictor injects."""

    kind = "injected_executor_error"


class FlakyPredictor:
    """Predictor proxy whose `run()` fails for the first `fail_first`
    calls (optionally delaying `delay_s` before each call) and then
    behaves normally — a deterministic executor-failure burst.  All
    other attributes (compile_signature, get_input_names, ...) pass
    through, so warmup and shape validation are unaffected."""

    def __init__(self, predictor, fail_first: int = 0,
                 delay_s: float = 0.0):
        self._predictor = predictor
        self.fail_first = int(fail_first)
        self.delay_s = float(delay_s)
        self.calls = 0
        self.failures_injected = 0

    def run(self, feed):
        self.calls += 1
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.calls <= self.fail_first:
            self.failures_injected += 1
            raise InjectedExecutorError(
                f"injected executor failure {self.calls}/"
                f"{self.fail_first}", call=self.calls)
        return self._predictor.run(feed)

    def __getattr__(self, name):
        return getattr(self._predictor, name)


# ---------------------------------------------------------------------------
# Serving-replica faults (serving/fleet.py)
# ---------------------------------------------------------------------------

def _replica_point(engine, what: str) -> str:
    rid = getattr(engine, "replica_id", None)
    if rid is None:
        raise ValueError(
            "engine has no replica_id — chaos replica primitives "
            "target FLEET replicas (Fleet assigns ids at construction, "
            "or call engine.set_replica_id first)")
    return f"replica:{rid}:{what}"


def kill_replica(engine) -> str:
    """Arm the abrupt-death failpoint of one fleet replica: the
    engine's next scheduled iteration raises ChaosKilled exactly where
    an executor crash would land, driving the REAL failure path — a
    DecodeEngine's scheduler dies through `_fail_everything` (every
    in-flight request resolves with the structured retryable
    DecodeReplicaFailedError and a router fails it over); a
    ServingEngine's next dispatch fails the batch with the retryable
    ExecutorFailureError.  Returns the armed failpoint name
    (chaos.disarm(name) cancels)."""
    name = _replica_point(engine, "kill")
    arm(name)
    return name


def delay_replica(engine, seconds: float, times: int = 1) -> str:
    """Arm a per-iteration stall on one fleet replica — the straggler
    a router's hedging must beat.  Returns the delaypoint name."""
    name = _replica_point(engine, "delay")
    arm_delay(name, seconds, times)
    return name
