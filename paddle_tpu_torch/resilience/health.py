"""Distributed health plane: heartbeats, peer-loss detection, and the
gang poison key — the port of paddle_tpu/resilience/health.py.

The fault this closes: a dead or hung rank strands every survivor
inside the next collective (or a checkpoint barrier) with no host-side
evidence.  The plane rides the `torch.distributed.TCPStore` that
`parallel.init_distributed` opened (`parallel.dist.get_store()`),
entirely on HOST threads between steps.  Nothing here touches the step:
with the plane on, a step makes the same kernel launches and the same
host synchronizations as with it off.

Three cooperating pieces per rank:

- **Heartbeat** (background thread): publishes
  `{rank, step, wall_time, pid, seq}` to `ptpu_health/hb/<rank>` every
  `interval_s` (an overwrite).  The training loop only bumps a local
  step counter (`plane.beat(step)`) — no store call on the step path.
- **HealthMonitor** (background thread): reads every rank's heartbeat,
  done marker and the poison key once a poll.  A peer whose heartbeat
  payload has not changed for `interval * miss_budget` seconds
  (measured on the LOCAL receipt clock — immune to cross-host
  wall-clock skew) is declared lost; a peer heartbeating with a frozen
  `step` for `stall_timeout_s` is declared stalled.  A store that stops
  answering means the process hosting it died — also a peer loss.  On
  detection the monitor writes the **poison key** and latches a
  structured alarm; it also derives per-rank step-rate skew from the
  heartbeats and emits `gang_skew` / `rank_slow` events.
- **Poison key** (`ptpu_health/poison/flag`): any rank (monitor,
  dispatch watchdog, or an explicit `poison_gang` call) writes one
  structured payload; every rank checks it between steps
  (`plane.check()` — a local read, the monitor thread does the store
  calls), so one failure becomes a bounded-time gang-wide abort.
  `io._barrier` polls the same key, so a checkpoint barrier with a dead
  peer fails in seconds, not after its timeout.  Each payload carries a
  unique id and `check()` raises it ONCE: an in-process re-`train()`
  after catching the error resumes instead of re-aborting on the stale
  key.

The TCPStore is not the reference's coordination KV (ROADMAP C24):

- it has no directory read: the ranks are known, so the monitor reads
  `hb/<r>` and `done/<r>` for r < num_ranks one key at a time (no
  listing call needed);
- `get` of a missing key blocks until the store's timeout, so every
  read of a key that may not exist goes through `check` first
  (`read_key`);
- one client connection serializes its calls: the main thread may sit
  inside a barrier's `wait` on the process's store, so the heartbeat
  and the monitor each talk over a connection of their own
  (`connection()`: `clone()`, else a new client to the same host and
  port) — a healthy rank in a long barrier keeps publishing;
- a dead store surfaces as `torch.distributed.DistError`
  (`DistNetworkError`: "Broken pipe", "Failed to recv") on every call:
  `STORE_ERRORS` is what the plane catches, nothing broader;
- the store lives in trainer 0's process unless a Supervisor serves it,
  and dies with it: the done-rendezvous has a second phase
  (`seen/<rank>`) so trainer 0 leaves last, and a rank whose store
  died mid-rendezvous waits for its monitor's verdict.

Everything takes an injectable clock and an injectable store client
(`chaos.FakeKv` in tests), so detection windows are provable without
real process death; the real thing is proven by the multi-process tests
(tests/test_torch_gang.py) and `chip_smoke.py`'s phase 6z.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as _dist

from .errors import (GangError, GangPoisonedError, PeerLostError,
                     PeerStalledError)

# Exit code a worker translates any GangError into (coordinated abort
# after peer loss / poison).  Distinct from PREEMPT_EXIT_CODE (77 — a
# checkpointed drain), the shell's 1/2/126/127, and the 128+signum band:
# a supervisor seeing this knows the gang broke but THIS rank exited
# deliberately and a relaunch resumes from checkpoints.
PEER_LOST_EXIT_CODE = 43

# store namespace
HEALTH_NS = "ptpu_health"
HB_DIR = HEALTH_NS + "/hb/"           # + <rank> -> heartbeat json
POISON_KEY = HEALTH_NS + "/poison/flag"
DONE_DIR = HEALTH_NS + "/done/"       # + <rank> -> orderly-leave marker
SEEN_DIR = HEALTH_NS + "/seen/"       # + <rank> -> saw every done marker

# the rank hosting the store when the ranks host it themselves
# (init_distributed's trainer 0, the reference's NCCLID broadcast root)
COORDINATOR_RANK = 0

# what a store call raises when the store is gone or a wait runs out
STORE_ERRORS = (_dist.DistError, OSError)


def kv_client():
    """The store `parallel.init_distributed` opened, or None
    single-process."""
    from ..parallel.dist import get_store

    return get_store()


def connection(kv, timeout_s: Optional[float] = None):
    """A connection of its own to the store `kv` talks to: `clone()`
    where the store has it, else a new client to its host and port.  A
    `timeout_s` bounds this connection's blocking calls."""
    if hasattr(kv, "clone"):
        conn = kv.clone()
    else:
        conn = _dist.TCPStore(kv.host, kv.port, is_master=False,
                              timeout=kv.timeout)
    if timeout_s is not None and hasattr(conn, "set_timeout"):
        conn.set_timeout(timedelta(seconds=float(timeout_s)))
    return conn


def read_key(kv, key: str) -> Optional[bytes]:
    """A key's value, or None when it does not exist — without waiting:
    the store's `get` of a missing key blocks until its timeout."""
    if not kv.check([key]):
        return None
    return kv.get(key)


def _loads(raw: bytes):
    return json.loads(raw.decode() if isinstance(raw, bytes) else raw)


class HealthConfig:
    """Detection windows, defaulting to FLAGS.heartbeat_interval_s,
    FLAGS.heartbeat_miss_budget and FLAGS.gang_stall_timeout_s as they
    are when the config is built (paddle_tpu/resilience/health.py:
    107-114).

    miss_window_s = interval_s * miss_budget: a peer silent that long
    is lost.  startup_grace_s covers peers that have not published
    their FIRST heartbeat yet (torch import + CUDA init take seconds);
    it defaults to one miss window on top of monitor start.
    """

    def __init__(self, interval_s: Optional[float] = None,
                 miss_budget: Optional[int] = None,
                 stall_timeout_s: Optional[float] = None,
                 poll_interval_s: Optional[float] = None,
                 startup_grace_s: Optional[float] = None,
                 skew_report_every: int = 20,
                 slow_factor: float = 2.0):
        from ..flags import FLAGS

        self.interval_s = float(FLAGS.heartbeat_interval_s
                                if interval_s is None else interval_s)
        self.miss_budget = int(FLAGS.heartbeat_miss_budget
                               if miss_budget is None else miss_budget)
        self.stall_timeout_s = float(
            FLAGS.gang_stall_timeout_s if stall_timeout_s is None
            else stall_timeout_s)
        if self.interval_s <= 0:
            raise ValueError("heartbeat interval must be > 0")
        if self.miss_budget < 1:
            raise ValueError("miss budget must be >= 1")
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else min(self.interval_s, 1.0))
        self.startup_grace_s = float(
            startup_grace_s if startup_grace_s is not None
            else self.miss_window_s)
        self.skew_report_every = max(1, int(skew_report_every))
        self.slow_factor = float(slow_factor)

    @property
    def miss_window_s(self) -> float:
        return self.interval_s * self.miss_budget


# ---------------------------------------------------------------------------
# Poison key
# ---------------------------------------------------------------------------

def _unparseable(raw) -> Dict[str, Any]:
    return {"id": "unparseable", "reason": str(raw), "rank": -1,
            "kind": "manual", "missing_ranks": []}


def write_poison(kv, rank: int, reason: str, kind: str = "manual",
                 missing_ranks: Optional[List[int]] = None,
                 **details: Any) -> Dict[str, Any]:
    """Publish the gang poison payload (overwrite: last writer wins,
    every payload is individually actionable).  Callers that may race
    a dead store catch STORE_ERRORS themselves."""
    payload = {"id": uuid.uuid4().hex[:12], "rank": int(rank),
               "reason": str(reason), "kind": kind,
               "missing_ranks": list(missing_ranks or []),
               "ts": round(time.time(), 3)}
    payload.update(details)
    kv.set(POISON_KEY, json.dumps(payload))
    return payload


def read_poison(kv) -> Optional[Dict[str, Any]]:
    """Non-blocking poison read.  Returns the payload dict or None."""
    raw = read_key(kv, POISON_KEY)
    if raw is None:
        return None
    try:
        return _loads(raw)
    except (TypeError, ValueError):
        return _unparseable(raw)


def clear_poison(kv) -> None:
    kv.delete_key(POISON_KEY)


def poison_gang(reason: str, kind: str = "manual",
                **details: Any) -> Optional[Dict[str, Any]]:
    """Poison via the active plane (or the raw store when no plane is
    up).  Returns the payload, or None when neither exists / the store
    is unreachable."""
    plane = get_health_plane()
    if plane is not None:
        return plane.poison(reason, kind=kind, **details)
    kv = kv_client()
    if kv is None:
        return None
    try:
        return write_poison(kv, rank=-1, reason=reason, kind=kind,
                            **details)
    except STORE_ERRORS:
        return None


# ---------------------------------------------------------------------------
# Heartbeat publisher
# ---------------------------------------------------------------------------

class Heartbeat:
    """Background publisher of this rank's liveness + step counter.

    `beat(step)` is the training loop's only duty — a local int store.
    Publish failures are counted, not raised: the MONITOR turns a store
    that stays unreachable into a structured alarm."""

    def __init__(self, kv, rank: int, config: HealthConfig,
                 clock: Callable[[], float] = time.time):
        self._kv = kv
        self.rank = int(rank)
        self.config = config
        self._clock = clock
        self._step = 0
        self._seq = 0
        self.publish_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, step: int) -> None:
        self._step = int(step)

    def publish_once(self) -> bool:
        self._seq += 1
        payload = {"rank": self.rank, "step": self._step,
                   "wall_time": round(self._clock(), 3),
                   "pid": os.getpid(), "seq": self._seq}
        try:
            self._kv.set(HB_DIR + str(self.rank), json.dumps(payload))
            return True
        except STORE_ERRORS:
            self.publish_failures += 1
            return False

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self.publish_once()  # first beat lands before any step runs

        def _run():
            while not self._stop.wait(self.config.interval_s):
                self.publish_once()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=f"hb-rank{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Detects missing/stalled peers and the poison key; computes
    per-rank step-rate skew.  All state transitions happen in
    `poll_once()` (directly callable with an injected clock for
    deterministic tests); `start()` runs it on a background thread.

    Detection clock: LOCAL receipt time of payload changes, never the
    peer's embedded wall_time — cross-host clock skew can't fake
    liveness or death.  `alarm_wall_time` is the wall time the alarm
    latched (the detection latency's end)."""

    def __init__(self, kv, rank: int, num_ranks: int,
                 config: HealthConfig,
                 clock: Callable[[], float] = time.monotonic,
                 event_log=None):
        self._kv = kv
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.config = config
        self._clock = clock
        self.event_log = event_log
        self._start_t = clock()
        # rank -> (raw payload, local time it last CHANGED)
        self._last_seen: Dict[int, tuple] = {}
        # rank -> (step, local time step last ADVANCED)
        self._step_seen: Dict[int, tuple] = {}
        self._rate: Dict[int, float] = {}
        self._alarm: Optional[Exception] = None
        self._alarm_lock = threading.Lock()
        self.alarm_wall_time: Optional[float] = None
        self.last_poison: Optional[Dict[str, Any]] = None
        self.done_ranks: set = set()
        self.written_poison_id: Optional[str] = None
        self._kv_fail_t: Optional[float] = None
        self._polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- alarm surface ----------------------------------------------------
    def alarm(self) -> Optional[Exception]:
        return self._alarm

    def take_alarm(self) -> Optional[Exception]:
        with self._alarm_lock:
            a, self._alarm = self._alarm, None
        return a

    def _latch(self, exc: Exception) -> None:
        with self._alarm_lock:
            if self._alarm is None:
                self._alarm = exc
                self.alarm_wall_time = time.time()

    def _raise_alarm(self, exc: Exception, event: str,
                     **fields: Any) -> None:
        poison_missing = fields.get("missing_ranks",
                                    fields.get("stalled_ranks", []))
        # poison the gang FIRST (the store may be the thing that died),
        # so peers abort even if this rank wedges before its own exit
        if self.written_poison_id is None:
            try:
                p = write_poison(self._kv, self.rank,
                                 reason=str(exc), kind=exc.kind,
                                 missing_ranks=list(poison_missing))
                self.written_poison_id = p["id"]
            except STORE_ERRORS:
                pass
        # latched before the event: a failing event log cannot keep the
        # verdict from the step loop
        self._latch(exc)
        if self.event_log is not None:
            self.event_log.event(event, rank=self.rank, **fields)

    # -- one poll ---------------------------------------------------------
    def _read_namespace(self):
        """(heartbeat payloads by rank, raw poison or None) — every key
        through `read_key`, done markers into `done_ranks`."""
        beats: Dict[int, bytes] = {}
        for r in range(self.num_ranks):
            raw = read_key(self._kv, HB_DIR + str(r))
            if raw is not None:
                beats[r] = raw
            if r not in self.done_ranks and read_key(
                    self._kv, DONE_DIR + str(r)) is not None:
                self.done_ranks.add(r)
        return beats, read_key(self._kv, POISON_KEY)

    def poll_once(self) -> Optional[Exception]:
        """Read the health namespace once; latch at most one alarm.
        Returns the currently latched alarm (or None)."""
        now = self._clock()
        cfg = self.config
        try:
            raw_beats, raw_poison = self._read_namespace()
        except STORE_ERRORS as e:
            # the store lives in the process hosting it (trainer 0, or
            # the supervisor): sustained unreachability == that
            # process's death (or total network loss — equally fatal to
            # a synchronous gang)
            if self._kv_fail_t is None:
                self._kv_fail_t = now
            elif now - self._kv_fail_t > cfg.miss_window_s:
                self._raise_alarm(
                    PeerLostError(
                        f"distributed store unreachable for "
                        f"{now - self._kv_fail_t:.1f}s (> "
                        f"{cfg.miss_window_s:.1f}s miss window) — the "
                        f"coordinator process (rank {COORDINATOR_RANK}) "
                        f"died or the network partitioned",
                        missing_ranks=[COORDINATOR_RANK],
                        age_s=round(now - self._kv_fail_t, 3),
                        budget_s=cfg.miss_window_s,
                        kv_error=f"{type(e).__name__}: {e}"),
                    "peer_lost", missing_ranks=[COORDINATOR_RANK],
                    kv_unreachable=True)
            return self._alarm
        self._kv_fail_t = None
        self._polls += 1

        beats: Dict[int, Dict[str, Any]] = {}
        for r, raw in raw_beats.items():
            try:
                beats[r] = _loads(raw)
            except (TypeError, ValueError):
                continue
        poison = None
        if raw_poison is not None:
            try:
                poison = _loads(raw_poison)
            except (TypeError, ValueError):
                poison = _unparseable(raw_poison)
        self.last_poison = poison

        missing: List[int] = []
        ages: Dict[int, float] = {}
        stalled: List[tuple] = []
        for r in range(self.num_ranks):
            if r in self.done_ranks:
                continue  # orderly leave: silence is expected, not death
            raw = beats.get(r)
            if raw is None:
                # never published: startup grace from monitor start
                if (r != self.rank and now - self._start_t
                        > cfg.startup_grace_s):
                    missing.append(r)
                    ages[r] = round(now - self._start_t, 3)
                continue
            blob = json.dumps(raw, sort_keys=True)
            prev = self._last_seen.get(r)
            if prev is None or prev[0] != blob:
                self._last_seen[r] = (blob, now)
            step = int(raw.get("step", 0))
            sprev = self._step_seen.get(r)
            if sprev is None or sprev[0] != step:
                if sprev is not None and now > sprev[1]:
                    self._rate[r] = (step - sprev[0]) / (now - sprev[1])
                self._step_seen[r] = (step, now)
            if r == self.rank:
                continue
            age = now - self._last_seen[r][1]
            if age > cfg.miss_window_s:
                missing.append(r)
                ages[r] = round(age, 3)
            elif (cfg.stall_timeout_s > 0
                  and now - self._step_seen[r][1] > cfg.stall_timeout_s):
                stalled.append((r, step))

        if missing and self._alarm is None:
            self._raise_alarm(
                PeerLostError(
                    f"peer rank(s) {missing} stopped heartbeating "
                    f"(silent > {cfg.miss_window_s:.1f}s = "
                    f"{cfg.interval_s:g}s x {cfg.miss_budget} budget)",
                    missing_ranks=missing, age_s=ages,
                    budget_s=cfg.miss_window_s),
                "peer_lost", missing_ranks=missing, age_s=ages)
        elif stalled and self._alarm is None:
            ranks = [r for r, _ in stalled]
            self._raise_alarm(
                PeerStalledError(
                    f"peer rank(s) {ranks} are heartbeating but their "
                    f"step counter froze > {cfg.stall_timeout_s:.1f}s "
                    f"— hung inside a collective?",
                    stalled_ranks=ranks,
                    steps={r: s for r, s in stalled},
                    stall_timeout_s=cfg.stall_timeout_s),
                "peer_stalled", stalled_ranks=ranks)

        if (self._polls % cfg.skew_report_every == 0
                and self.event_log is not None and len(self._rate) >= 2):
            self._emit_skew()
        return self._alarm

    # -- straggler telemetry ---------------------------------------------
    def skew(self) -> Dict[str, Any]:
        """Per-rank step/rate snapshot from the heartbeat stream."""
        steps = {r: s for r, (s, _) in self._step_seen.items()}
        rates = {r: round(v, 4) for r, v in self._rate.items()}
        out: Dict[str, Any] = {"steps": steps, "rates": rates}
        if steps:
            out["max_lag_steps"] = max(steps.values()) - min(steps.values())
        if len(rates) >= 2:
            ordered = sorted(rates.values())
            median = ordered[len(ordered) // 2]
            out["median_rate"] = median
            slow = [r for r, v in rates.items()
                    if median > 0 and v * self.config.slow_factor < median]
            out["slow_ranks"] = slow
        return out

    def _emit_skew(self) -> None:
        s = self.skew()
        self.event_log.event("gang_skew", rank=self.rank, **s)
        for r in s.get("slow_ranks", []):
            self.event_log.event(
                "rank_slow", rank=r, rate=s["rates"][r],
                median_rate=s["median_rate"],
                slow_factor=self.config.slow_factor)

    # -- thread -----------------------------------------------------------
    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self

        def _run():
            while not self._stop.wait(self.config.poll_interval_s):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — latched, not hidden
                    # a monitor that cannot run cannot vouch for the
                    # gang: its failure is this rank's alarm, raised by
                    # the next check()
                    self._latch(GangError(
                        f"health monitor of rank {self.rank} failed: "
                        f"{type(e).__name__}: {e}",
                        monitor_error=f"{type(e).__name__}: {e}"))
                    return

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name=f"health-mon-rank{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# The per-rank plane (heartbeat + monitor + consumption bookkeeping)
# ---------------------------------------------------------------------------

class HealthPlane:
    """One rank's view of the gang: publishes its own liveness,
    watches everyone else's, and converts detections into structured
    exceptions at step boundaries.

        plane = start_health_plane(rank, num_ranks)   # dist.py does this
        ...
        plane.beat(global_step)   # after each step: local int store
        plane.check()             # raises PeerLost/PeerStalled/GangPoisoned

    The heartbeat and the monitor each talk over a connection of their
    own (`connection(kv)`); `kv` itself serves the calling thread's
    `leave()` / `wait_gang_done()`.
    """

    def __init__(self, kv, rank: int, num_ranks: int,
                 config: Optional[HealthConfig] = None, event_log=None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.kv = kv
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.config = config or HealthConfig()
        # a blocking call of the monitor's connection waits no longer
        # than a miss window (a key deleted between check and get)
        self.heartbeat = Heartbeat(connection(kv), rank, self.config,
                                   clock=wall_clock)
        self.monitor = HealthMonitor(
            connection(kv, timeout_s=max(1.0, self.config.miss_window_s)),
            rank, num_ranks, self.config, clock=clock,
            event_log=event_log)
        self._consumed_poison: set = set()
        self._started = False
        self._ledger = None  # observe.GoodputLedger (attach_ledger)

    def start(self) -> "HealthPlane":
        if not self._started:
            self.heartbeat.start()
            self.monitor.start()
            self._started = True
        return self

    def stop(self) -> None:
        self.heartbeat.stop()
        self.monitor.stop()
        self._started = False

    def attach_event_log(self, event_log) -> None:
        """Late-bind a RunEventLog (init_distributed starts the plane
        before any Trainer exists; the Trainer re-points events here)."""
        self.monitor.event_log = event_log

    def attach_ledger(self, ledger) -> None:
        """Late-bind a goodput ledger: the plane's BLOCKING wait —
        wait_gang_done's done-rendezvous — records as barrier_wait, so
        a finished rank's wait for laggards is accounted wall clock."""
        self._ledger = ledger

    # -- step-boundary surface (no store call on this path) ---------------
    def beat(self, step: int) -> None:
        self.heartbeat.beat(step)

    def poison(self, reason: str, kind: str = "manual",
               **details: Any) -> Optional[Dict[str, Any]]:
        """Poison the gang from this rank (dispatch watchdog / manual
        abort), over the monitor's connection: the calling thread may be
        a watchdog's while the main thread is stuck in a store wait.
        Marks the payload self-consumed: the writer already knows — the
        key exists for the OTHER ranks."""
        try:
            p = write_poison(self.monitor._kv, self.rank, reason,
                             kind=kind, **details)
        except STORE_ERRORS:
            return None
        self._consumed_poison.add(p["id"])
        self.monitor.written_poison_id = p["id"]
        return p

    def check(self) -> None:
        """Raise the latched alarm or an unconsumed poison.  Purely
        local (the monitor thread did the store calls).  Each poison id
        and each alarm is raised ONCE — idempotent across an in-process
        re-train(); a peer that is STILL missing re-alarms on a later
        poll, which is correct, not a stale re-raise."""
        alarm = self.monitor.take_alarm()
        if alarm is not None:
            # the monitor's own poison (written at detection) is this
            # alarm in store form: consume it alongside
            if self.monitor.written_poison_id is not None:
                self._consumed_poison.add(self.monitor.written_poison_id)
            raise alarm
        p = self.monitor.last_poison
        if p is not None and p.get("id") not in self._consumed_poison:
            self._consumed_poison.add(p.get("id"))
            raise GangPoisonedError(
                f"gang poisoned by rank {p.get('rank')}: "
                f"{p.get('reason')} (kind={p.get('kind')})", poison=p,
                missing_ranks=p.get("missing_ranks", []))

    def skew(self) -> Dict[str, Any]:
        return self.monitor.skew()

    # -- orderly leave ----------------------------------------------------
    def leave(self) -> None:
        """Announce clean completion: publish this rank's done marker
        so peers stop expecting heartbeats (silence after a leave is
        departure, not death — without this, the first rank to finish
        gets declared lost by every laggard).  A store that is gone is
        left to wait_gang_done and the monitor."""
        try:
            self.kv.set(DONE_DIR + str(self.rank),
                        json.dumps({"rank": self.rank,
                                    "ts": round(time.time(), 3)}))
        except STORE_ERRORS:
            pass

    def wait_gang_done(self, timeout_s: float = 60.0,
                       poll_s: float = 0.25) -> bool:
        """Block until every rank has published its done marker (True)
        or the gang is known broken / the timeout passes (False).  The
        clean-exit rendezvous: callers exit 0 either way — their own
        work is complete — but waiting keeps a finished rank's
        heartbeat alive until the laggards arrive.

        The store may live in trainer 0's process (init_distributed's
        default), and dies with it: so every rank that saw all done
        markers says so (`seen/<rank>`), and trainer 0 returns only once
        every rank has — no peer is left reading a store that is gone."""
        if self._ledger is not None:
            with self._ledger.phase("barrier_wait",
                                    label="wait_gang_done"):
                return self._wait_gang_done(timeout_s, poll_s)
        return self._wait_gang_done(timeout_s, poll_s)

    def _wait_gang_done(self, timeout_s: float, poll_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        if not self._wait_markers(DONE_DIR, deadline, poll_s):
            return False
        try:
            self.kv.set(SEEN_DIR + str(self.rank), "1")
        except STORE_ERRORS:
            return False
        if self.rank != COORDINATOR_RANK:
            return True
        return self._wait_markers(SEEN_DIR, deadline, poll_s)

    def _wait_markers(self, prefix: str, deadline: float,
                      poll_s: float) -> bool:
        while time.monotonic() < deadline:
            if self.monitor.alarm() is not None:
                return False
            p = self.monitor.last_poison
            if p is not None and p.get("id") not in self._consumed_poison:
                return False
            try:
                done = {r for r in range(self.num_ranks)
                        if read_key(self.kv, prefix + str(r)) is not None}
            except STORE_ERRORS:
                # the store died with its host: the gang is broken.  Wait
                # for the monitor's verdict (within a miss window), so the
                # caller's check() names the loss
                done = set()
            if len(done) >= self.num_ranks:
                return True
            time.sleep(poll_s)
        return False


# ---------------------------------------------------------------------------
# Process-wide registry (parallel.init_distributed registers it)
# ---------------------------------------------------------------------------

_plane: Optional[HealthPlane] = None
_plane_lock = threading.Lock()


def start_health_plane(rank: Optional[int] = None,
                       num_ranks: Optional[int] = None, kv=None,
                       config: Optional[HealthConfig] = None,
                       event_log=None, clock=None,
                       wall_clock=None) -> HealthPlane:
    """Create + start the process-wide plane.  Defaults come from the
    process group `init_distributed` started and its store; tests
    inject `kv=chaos.FakeKv()` and explicit rank/num_ranks/clocks."""
    global _plane
    with _plane_lock:
        if _plane is not None:
            return _plane
        if kv is None:
            kv = kv_client()
        if kv is None:
            raise RuntimeError(
                "no distributed store — call parallel.init_distributed "
                "first (or inject kv=)")
        if rank is None or num_ranks is None:
            rank = _dist.get_rank() if rank is None else rank
            num_ranks = (_dist.get_world_size() if num_ranks is None
                         else num_ranks)
        kwargs: Dict[str, Any] = {}
        if clock is not None:
            kwargs["clock"] = clock
        if wall_clock is not None:
            kwargs["wall_clock"] = wall_clock
        _plane = HealthPlane(kv, rank, num_ranks, config=config,
                             event_log=event_log, **kwargs).start()
        return _plane


def get_health_plane() -> Optional[HealthPlane]:
    return _plane


def stop_health_plane() -> None:
    global _plane
    with _plane_lock:
        if _plane is not None:
            _plane.stop()
            _plane = None
