"""Self-healing multi-process gang supervisor: the port of
paddle_tpu/resilience/supervisor.py.

Something has to OWN the worker processes of a synchronous gang.
`Supervisor` spawns the N ranks (a fresh coordinator endpoint per
attempt), watches their exit codes, and on a broken gang kills the
remainder within a grace period and relaunches — each rank resuming
from its newest valid checkpoint through the contrib.Trainer machinery
the workers already carry.

Exit-code registry (the supervisor's whole protocol):

| code                     | meaning                                   |
|--------------------------|-------------------------------------------|
| 0                        | clean completion                          |
| 77  `PREEMPT_EXIT_CODE`  | drained after SIGTERM; emergency ckpt landed — relaunch resumes |
| 43  `PEER_LOST_EXIT_CODE`| deliberate exit after detecting peer loss / poison (GangError) |
| 128+N / negative         | killed by signal N (SIGKILL'd rank, OOM)  |
| anything else            | crash                                     |

Restart policy: every relaunch consumes the `max_restarts` budget;
preempt-drain restarts relaunch immediately (the checkpoint already
landed), failure restarts back off on the deterministic `retry_call`
schedule (base * 2**failures, capped), with an injectable `sleep` so
tests assert the schedule.  Budget exhaustion raises `GangFailedError`
carrying every attempt's per-rank exit codes.  A `finally` sweep
guarantees no orphan processes outlive `run()`.

The supervisor manages processes and sets the PADDLE_TRAINER_* env
contract `parallel.init_distributed` reads (trainer id, world size,
coordinator endpoint); it never touches CUDA.  With
`host_coordinator=True` it serves the gang's `torch.distributed.
TCPStore` itself (one fresh store per attempt).  `python -m
paddle_tpu_torch.resilience.supervisor --nproc N -- <worker command>` is
the command line (the reference's tools/launch_gang.py).
"""

from __future__ import annotations

import argparse
import json
import os
import signal as _signal
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .errors import GangFailedError
from .health import PEER_LOST_EXIT_CODE
from .preempt import PREEMPT_EXIT_CODE


def classify_exit(rc: Optional[int]) -> str:
    """One word per exit code, per the registry above."""
    if rc is None:
        return "running"
    if rc == 0:
        return "ok"
    if rc == PREEMPT_EXIT_CODE:
        return "preempt_drain"
    if rc == PEER_LOST_EXIT_CODE:
        return "peer_lost"
    if rc < 0:
        try:
            return f"signal:{_signal.Signals(-rc).name}"
        except ValueError:
            return f"signal:{-rc}"
    if rc > 128:
        try:
            return f"signal:{_signal.Signals(rc - 128).name}"
        except ValueError:
            return f"signal:{rc - 128}"
    return f"crash:{rc}"


def _free_port(host: str) -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


class GangResult:
    """Outcome of a supervised run: per-attempt exit codes and how
    many relaunches it took."""

    def __init__(self, attempts: List[Dict[str, Any]]):
        self.attempts = attempts
        self.restarts = len(attempts) - 1

    @property
    def ok(self) -> bool:
        return bool(self.attempts) and self.attempts[-1]["reason"] == "ok"

    def as_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "restarts": self.restarts,
                "attempts": self.attempts}


class Supervisor:
    """Spawn-and-heal a gang of `num_workers` processes.

    worker_cmd: the argv to run for every rank, or a callable
        `(rank, num_workers, coordinator) -> argv` for per-rank
        commands.  Each rank's env carries PADDLE_TRAINER_ID /
        PADDLE_TRAINERS / PADDLE_COORDINATOR (fresh port per attempt,
        so a relaunch never races a dying coordinator socket) plus
        `env` overrides.
    log_dir: when set, rank stdout/stderr go to
        `<log_dir>/attempt<k>_rank<r>.out/.err` (default: inherited).
    elastic: relaunch a broken gang at the SURVIVING world size
        (gang elasticity): ranks that died BY SIGNAL
        (SIGKILL, OOM — the machine-lost signature) are treated as
        lost capacity and the next attempt spawns
        `num_workers - lost` ranks (floor 1); deliberate exits
        (peer_lost 43, preempt 77, crashes) relaunch at full size —
        the process died, not the machine.  Workers read the new
        world size from PADDLE_TRAINERS and are expected to reshard
        their state from checkpoints (io.load_sharded is
        mesh-shape-agnostic).  Each shrink is recorded in the attempt
        dict (`shrunk_to`).
    host_coordinator: serve the gang's `torch.distributed.TCPStore` in
        the supervisor process (one fresh store per attempt) instead of
        inside worker rank 0.  This makes EVERY rank killable with
        structured detection by the survivors: with the default
        rank-0-hosted store, killing rank 0 takes the store down and
        the survivors can only report the coordinator lost.  Workers
        need no changes: PADDLE_COORDINATOR points at the supervisor's
        store and PADDLE_COORDINATOR_HOSTED=1 makes every trainer's
        `init_distributed`, rank 0's included, connect as a client.
    sleep: injectable for deterministic backoff tests.
    """

    def __init__(self, worker_cmd: Union[Sequence[str], Callable],
                 num_workers: int, *,
                 max_restarts: Optional[int] = None,
                 grace_s: Optional[float] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 coordinator_host: str = "127.0.0.1",
                 host_coordinator: bool = False,
                 elastic: bool = False,
                 poll_s: float = 0.2,
                 sleep: Callable[[float], None] = time.sleep,
                 event_log=None):
        self.worker_cmd = worker_cmd
        self.num_workers = int(num_workers)
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        # the flags as they are when the supervisor is built
        # (paddle_tpu/resilience/supervisor.py:151-166)
        from ..flags import FLAGS

        self.max_restarts = int(FLAGS.supervisor_max_restarts
                                if max_restarts is None else max_restarts)
        self.grace_s = float(FLAGS.supervisor_grace_s
                             if grace_s is None else grace_s)
        self.backoff_base_s = float(
            FLAGS.supervisor_backoff_base_s if backoff_base_s is None
            else backoff_base_s)
        self.backoff_max_s = float(
            FLAGS.supervisor_backoff_max_s if backoff_max_s is None
            else backoff_max_s)
        self.env = dict(env or {})
        self.log_dir = log_dir
        self.coordinator_host = coordinator_host
        self.host_coordinator = bool(host_coordinator)
        self.elastic = bool(elastic)
        self.poll_s = float(poll_s)
        self.sleep = sleep
        self.event_log = event_log
        self.backoffs_slept: List[float] = []  # test-observable schedule
        self._log_files: List[Any] = []
        self._service = None  # per-attempt hosted store

    def _start_service(self, coordinator: str) -> None:
        """Serve the gang's store here (host_coordinator=True): a fresh
        `TCPStore(is_master=True)` at the attempt's endpoint, not
        waiting for the workers (they join as they start)."""
        from datetime import timedelta

        from torch.distributed import TCPStore

        host, port = coordinator.rsplit(":", 1)
        self._service = TCPStore(host, int(port), self.num_workers,
                                 is_master=True, wait_for_workers=False,
                                 timeout=timedelta(seconds=300))

    def _stop_service(self) -> None:
        # the store's server stops with its last reference; a fresh one
        # serves the next attempt on a fresh port
        self._service = None

    # -- spawning ---------------------------------------------------------
    def _cmd_for(self, rank: int, coordinator: str) -> List[str]:
        if callable(self.worker_cmd):
            return list(self.worker_cmd(rank, self.num_workers,
                                        coordinator))
        return list(self.worker_cmd)

    def _spawn_gang(self, attempt: int) -> Dict[int, subprocess.Popen]:
        port = _free_port(self.coordinator_host)
        coordinator = f"{self.coordinator_host}:{port}"
        if self.host_coordinator:
            self._start_service(coordinator)
        procs: Dict[int, subprocess.Popen] = {}
        for rank in range(self.num_workers):
            env = dict(os.environ)
            env.update(self.env)
            env["PADDLE_TRAINER_ID"] = str(rank)
            env["PADDLE_TRAINERS"] = str(self.num_workers)
            env["PADDLE_COORDINATOR"] = coordinator
            if self.host_coordinator:
                # no worker serves the store: rank 0 connects as a
                # client too (parallel/dist.py COORDINATOR_HOSTED_ENV)
                env["PADDLE_COORDINATOR_HOSTED"] = "1"
            stdout = stderr = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                base = os.path.join(self.log_dir,
                                    f"attempt{attempt}_rank{rank}")
                stdout = open(base + ".out", "w")
                stderr = open(base + ".err", "w")
                self._log_files += [stdout, stderr]
            procs[rank] = subprocess.Popen(
                self._cmd_for(rank, coordinator), env=env,
                stdout=stdout, stderr=stderr)
        if self.event_log is not None:
            self.event_log.event("gang_start", attempt=attempt,
                                 num_workers=self.num_workers,
                                 coordinator=coordinator)
        return procs

    # -- one attempt ------------------------------------------------------
    def _wait_gang(self, procs: Dict[int, subprocess.Popen]
                   ) -> Dict[int, int]:
        """Wait the gang out.  The moment any rank exits non-zero the
        gang is broken and a three-phase teardown starts:

        1. `grace_s` of HANDS OFF — the preferred exit is survivors
           detecting the break themselves (health plane →
           PEER_LOST_EXIT_CODE; the observable, structured path),
        2. SIGTERM stragglers (a preempt_drain worker writes its
           emergency checkpoint and exits 77) + another `grace_s`,
        3. SIGKILL whatever is left.

        Returns {rank: returncode}."""
        codes: Dict[int, int] = {}
        breaking_t: Optional[float] = None
        phase = 0  # 0 = hands off, 1 = terminated, 2 = killed
        while len(codes) < len(procs):
            for rank, p in procs.items():
                if rank in codes:
                    continue
                rc = p.poll()
                if rc is None:
                    continue
                codes[rank] = rc
                if rc != 0 and breaking_t is None:
                    breaking_t = time.monotonic()
            if len(codes) == len(procs):
                break
            if breaking_t is not None and phase < 2:
                overdue = time.monotonic() - breaking_t
                want = 1 if overdue > self.grace_s else 0
                if overdue > 2 * self.grace_s:
                    want = 2
                if want > phase:
                    phase = want
                    for r2, p2 in procs.items():
                        if r2 not in codes and p2.poll() is None:
                            try:
                                if phase == 1:
                                    p2.terminate()
                                else:
                                    p2.kill()
                            except OSError:
                                pass
            time.sleep(self.poll_s)
        for p in procs.values():
            p.wait()  # reap
        return codes

    @staticmethod
    def _attempt_reason(codes: Dict[int, int]) -> str:
        kinds = {r: classify_exit(rc) for r, rc in codes.items()}
        if all(k == "ok" for k in kinds.values()):
            return "ok"
        if any(k == "peer_lost" for k in kinds.values()):
            return "peer_lost"
        if any(k.startswith(("crash", "signal")) for k in kinds.values()):
            return "crash"
        return "preempt_drain"

    # -- the loop ---------------------------------------------------------
    def run(self) -> GangResult:
        """Run the gang to clean completion, relaunching through
        failures until the restart budget runs out (GangFailedError,
        per-attempt exit codes attached).  No orphans survive this
        call."""
        attempts: List[Dict[str, Any]] = []
        failures = 0
        procs: Dict[int, subprocess.Popen] = {}
        try:
            for attempt in range(self.max_restarts + 1):
                attempt_t0 = time.monotonic()
                procs = self._spawn_gang(attempt)
                try:
                    codes = self._wait_gang(procs)
                finally:
                    self._stop_service()
                reason = self._attempt_reason(codes)
                rec = {"attempt": attempt,
                       "exit_codes": dict(sorted(codes.items())),
                       "classified": {r: classify_exit(rc)
                                      for r, rc in sorted(codes.items())},
                       "reason": reason,
                       # attempt wall clock: a broken attempt's whole
                       # duration is restart badput from the job's
                       # point of view (the goodput ledger inside each
                       # worker decomposes the useful part)
                       "duration_s": round(
                           time.monotonic() - attempt_t0, 3)}
                if self.elastic and reason != "ok":
                    # signal deaths = lost capacity (preempted machine);
                    # the next attempt runs with the survivors only and
                    # workers reshard their checkpoints to the new size
                    lost = [r for r, rc in codes.items()
                            if classify_exit(rc).startswith("signal")]
                    new_n = max(1, self.num_workers - len(lost))
                    if new_n != self.num_workers:
                        rec["shrunk_to"] = new_n
                        self.num_workers = new_n
                attempts.append(rec)
                if self.event_log is not None:
                    self.event_log.event(
                        "gang_restart" if reason != "ok" else "gang_end",
                        **rec)
                if reason == "ok":
                    return GangResult(attempts)
                if attempt == self.max_restarts:
                    break
                if reason == "preempt_drain":
                    delay = 0.0  # ckpt landed; resume immediately
                else:
                    delay = min(self.backoff_base_s * (2.0 ** failures),
                                self.backoff_max_s)
                    failures += 1
                self.backoffs_slept.append(delay)
                if delay > 0:
                    self.sleep(delay)
        finally:
            # no-orphans guarantee, however run() exits
            for p in procs.values():
                if p.poll() is None:
                    try:
                        p.kill()
                        p.wait(timeout=10)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
            self._stop_service()
            for f in self._log_files:
                try:
                    f.close()
                except OSError:
                    pass
            self._log_files = []
        err = GangFailedError(
            f"gang failed after {len(attempts)} attempt(s) "
            f"({self.max_restarts} restart budget): last attempt "
            f"exit codes {attempts[-1]['exit_codes']}",
            attempts=attempts, num_workers=self.num_workers,
            max_restarts=self.max_restarts)
        if self.event_log is not None:
            self.event_log.event("gang_failed", **err.as_dict())
        raise err


def launch_gang(worker_cmd, num_workers: int, **kw) -> GangResult:
    """One-call form: Supervisor(...).run()."""
    return Supervisor(worker_cmd, num_workers, **kw).run()


def main(argv=None) -> int:
    """The command line: spawns the worker command once per rank with
    the PADDLE_TRAINER_ID / PADDLE_TRAINERS / PADDLE_COORDINATOR env
    contract (fresh coordinator port per attempt), relaunches a broken
    gang on the deterministic backoff schedule until the restart budget
    runs out.  Prints one `GANG_ATTEMPT {json}` line per attempt and a
    final `GANG_RESULT {json}` (or `GANG_FAILED {json}`); exits 0 on
    clean gang completion, 1 on budget exhaustion."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.resilience.supervisor",
        description=main.__doc__)
    ap.add_argument("--nproc", type=int, default=2,
                    help="gang size (ranks)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="relaunch budget (default "
                         "FLAGS.supervisor_max_restarts)")
    ap.add_argument("--grace-s", type=float, default=None,
                    help="SIGTERM->SIGKILL grace for a broken gang's "
                         "survivors (default FLAGS.supervisor_grace_s)")
    ap.add_argument("--backoff-base-s", type=float, default=None)
    ap.add_argument("--backoff-max-s", type=float, default=None)
    ap.add_argument("--log-dir", default=None,
                    help="per-rank stdout/stderr capture directory "
                         "(default: inherit)")
    ap.add_argument("--host-coordinator", action="store_true",
                    help="serve the gang's store in the supervisor "
                         "(fresh store per attempt) so even rank 0 is "
                         "killable with structured detection")
    ap.add_argument("--elastic", action="store_true",
                    help="relaunch a broken gang at the SURVIVING world "
                         "size (ranks killed by signal are lost "
                         "capacity)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no worker command given (append: -- python worker.py)")
    sup = Supervisor(cmd, args.nproc, max_restarts=args.max_restarts,
                     grace_s=args.grace_s,
                     backoff_base_s=args.backoff_base_s,
                     backoff_max_s=args.backoff_max_s,
                     log_dir=args.log_dir,
                     host_coordinator=args.host_coordinator,
                     elastic=args.elastic)
    try:
        result = sup.run()
    except GangFailedError as e:
        for a in e.details["attempts"]:
            print("GANG_ATTEMPT " + json.dumps(a), flush=True)
        print("GANG_FAILED " + json.dumps(e.as_dict()), flush=True)
        return 1
    for a in result.attempts:
        print("GANG_ATTEMPT " + json.dumps(a), flush=True)
    print("GANG_RESULT " + json.dumps(result.as_dict()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
