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

- **gang ranks** — `kill_rank`/`hang_rank`, armed through the
  environment a gang Supervisor passes its workers
  (`arm_kill_rank_env`/`arm_hang_rank_env`), each with an optional
  once-file so a relaunched gang does not fire again.
- **`FakeKv`** — an in-process stand-in for the `torch.distributed.
  TCPStore` client the health plane (resilience/health.py) and the
  checkpoint barrier (io._barrier) call, with a `fail_with` switch: the
  store that stopped answering.

Injectors are deterministic (step counts, call counts — never random),
so every chaos test is reproducible.
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


# ---------------------------------------------------------------------------
# Gang chaos: env-armed per-rank failpoints for worker SUBPROCESSES.  The
# in-process arm()/failpoint() pair cannot reach a worker the supervisor
# spawned; these are armed through the environment the supervisor
# already propagates, and each carries an optional once-file so a
# relaunched gang (same env!) does not re-fire after the restart resumes
# past the arm step.
# ---------------------------------------------------------------------------

KILL_RANK_ENV = "PTPU_CHAOS_KILL_RANK"
KILL_STEP_ENV = "PTPU_CHAOS_KILL_STEP"
KILL_ONCE_ENV = "PTPU_CHAOS_KILL_ONCE_FILE"
HANG_RANK_ENV = "PTPU_CHAOS_HANG_RANK"
HANG_STEP_ENV = "PTPU_CHAOS_HANG_STEP"
HANG_S_ENV = "PTPU_CHAOS_HANG_S"
HANG_ONCE_ENV = "PTPU_CHAOS_HANG_ONCE_FILE"


def _env_armed(rank: int, step: int, rank_env: str, step_env: str,
               once_env: str) -> bool:
    target = os.environ.get(rank_env)
    if target is None or int(target) != int(rank):
        return False
    if int(step) < int(os.environ.get(step_env, "0")):
        return False
    once = os.environ.get(once_env)
    if once:
        if os.path.exists(once):
            return False  # already fired in a previous life
        with open(once, "w") as f:
            f.write(f"fired rank={rank} step={step}\n")
    return True


def kill_rank(rank: int, step: int) -> None:
    """SIGKILL-abrupt self-death when the environment arms this
    (rank, >=step): KILL_RANK_ENV / KILL_STEP_ENV, optional
    KILL_ONCE_ENV sentinel file for fire-exactly-once-across-restarts.
    Call from the worker's step loop — the real preemption the health
    plane must detect (no flush, no cleanup)."""
    import signal

    if _env_armed(rank, step, KILL_RANK_ENV, KILL_STEP_ENV,
                  KILL_ONCE_ENV):
        os.kill(os.getpid(), signal.SIGKILL)


def hang_rank(rank: int, step: int) -> None:
    """Hang this rank for HANG_S_ENV seconds (default 3600 — "forever"
    at test scale) when env-armed for (rank, >=step): the
    alive-but-stuck peer the stall detector / dispatch watchdog must
    catch.  Same once-file contract as kill_rank."""
    if _env_armed(rank, step, HANG_RANK_ENV, HANG_STEP_ENV,
                  HANG_ONCE_ENV):
        hang(float(os.environ.get(HANG_S_ENV, "3600")))


def arm_kill_rank_env(env: dict, rank: int, at_step: int,
                      once_file: Optional[str] = None) -> dict:
    """Fill `env` (in place, returned) with the kill_rank arming —
    the supervisor/test-side pairing of kill_rank()."""
    env[KILL_RANK_ENV] = str(rank)
    env[KILL_STEP_ENV] = str(at_step)
    if once_file:
        env[KILL_ONCE_ENV] = once_file
    return env


def arm_hang_rank_env(env: dict, rank: int, at_step: int,
                      seconds: float = 3600.0,
                      once_file: Optional[str] = None) -> dict:
    """env-side pairing of hang_rank()."""
    env[HANG_RANK_ENV] = str(rank)
    env[HANG_STEP_ENV] = str(at_step)
    env[HANG_S_ENV] = str(seconds)
    if once_file:
        env[HANG_ONCE_ENV] = once_file
    return env


# ---------------------------------------------------------------------------
# Fake store (health-plane unit tests)
# ---------------------------------------------------------------------------

class FakeKv:
    """In-process stand-in for a `torch.distributed.TCPStore` client,
    with the method surface resilience/health.py and io._barrier call:
    `set`, `get` (bytes; a missing key blocks until TIMEOUT_S, then
    raises DistStoreError, as the store does), `check`, `wait`, `add`,
    `compare_set`, `delete_key` and `clone` (another connection to the
    same data).  Detection-window tests inject it
    with a fake clock instead of killing real processes.  Thread-safe;
    `fail_with` makes every call raise (the dead-coordinator
    simulation)."""

    TIMEOUT_S = 1.0  # the store's own timeout, for a wait without one

    def __init__(self):
        import threading

        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.fail_with: Optional[BaseException] = None

    def _maybe_fail(self):
        if self.fail_with is not None:
            raise self.fail_with

    @staticmethod
    def _bytes(value) -> bytes:
        return value if isinstance(value, bytes) else str(value).encode()

    def clone(self) -> "FakeKv":
        """A second connection: the same data, lock and failure switch."""
        return self

    def set(self, key: str, value) -> None:
        self._maybe_fail()
        with self._lock:
            self._data[key] = self._bytes(value)

    def check(self, keys) -> bool:
        self._maybe_fail()
        with self._lock:
            return all(k in self._data for k in keys)

    def wait(self, keys, timeout=None) -> None:
        from torch.distributed import DistStoreError

        self._maybe_fail()
        seconds = (self.TIMEOUT_S if timeout is None
                   else timeout.total_seconds())
        deadline = time.monotonic() + seconds
        while True:
            with self._lock:
                if all(k in self._data for k in keys):
                    return
            if time.monotonic() >= deadline:
                raise DistStoreError(
                    f"wait timeout after {seconds * 1000:.0f}ms, keys: "
                    f"{list(keys)}")
            time.sleep(0.005)
            self._maybe_fail()

    def get(self, key: str) -> bytes:
        self.wait([key])
        with self._lock:
            return self._data[key]

    def add(self, key: str, amount: int) -> int:
        self._maybe_fail()
        with self._lock:
            n = int(self._data.get(key, b"0")) + int(amount)
            self._data[key] = str(n).encode()
            return n

    def compare_set(self, key: str, expected, desired) -> bytes:
        """TCPStore's semantics: a missing key is set only when
        `expected` is empty; otherwise `expected` comes back.  A present
        key is replaced when it equals `expected`; its value comes
        back."""
        self._maybe_fail()
        expected, desired = self._bytes(expected), self._bytes(desired)
        with self._lock:
            if key not in self._data:
                if expected:
                    return expected
                self._data[key] = desired
                return desired
            if self._data[key] == expected:
                self._data[key] = desired
            return self._data[key]

    def delete_key(self, key: str) -> bool:
        self._maybe_fail()
        with self._lock:
            return self._data.pop(key, None) is not None
