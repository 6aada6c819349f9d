"""A group of port processes for the data-parallel tests on the CPU.

The port runs one process per rank (torch.distributed); the reference
runs on conftest's virtual 8-device CPU mesh in the pytest process.  A
`RankGroup` starts N worker processes (`tests/torch_dist_worker.py`)
that join one gloo process group, then runs "cases" on every rank: a
function of `tests/torch_dp_cases.py` (torch, numpy and the port only —
never jax) called with its keyword arguments, its per-rank results
pickled back.  Requests and results ride a TCPStore the pytest process
serves on a port the OS picks, so concurrent test files never collide.

Every wait has its own timeout: a case that does not finish in time (a
hung collective, a dead rank) kills the whole group and fails; the next
case starts a fresh group.  `close()` (the module fixture's teardown)
stops the workers.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta

import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dist_worker.py")


class CaseError(AssertionError):
    pass


class RankGroup:
    def __init__(self, n: int, log_dir: str, bootstrap: str = "store",
                 start_timeout: float = 60.0):
        self.n = n
        self.log_dir = log_dir
        self.bootstrap = bootstrap
        self.start_timeout = start_timeout
        self.store = dist.TCPStore("127.0.0.1", 0, 1, True,
                                   wait_for_workers=False,
                                   timeout=timedelta(seconds=30))
        self.procs = []
        self.generation = 0
        self.k = 0

    # -- lifetime -------------------------------------------------------
    def _spawn(self):
        self.generation += 1
        self.k = 0
        gen = self.generation
        os.makedirs(self.log_dir, exist_ok=True)
        env = dict(os.environ)
        env["OMP_NUM_THREADS"] = "1"
        env.pop("JAX_PLATFORMS", None)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(HERE), HERE] + [p for p in
                                              [env.get("PYTHONPATH")] if p])
        coordinator = f"127.0.0.1:{_free_port()}"
        self.procs = []
        for r in range(self.n):
            if self.bootstrap == "env":
                env.update(PADDLE_TRAINER_ID=str(r),
                           PADDLE_TRAINERS=str(self.n),
                           PADDLE_COORDINATOR=coordinator)
            log = open(os.path.join(self.log_dir,
                                    f"gen{gen}_rank{r}.log"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(self.n),
                 str(self.store.port), str(gen), self.bootstrap],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(HERE)))
            log.close()
        self._wait_keys([f"g{gen}/ready/{r}" for r in range(self.n)],
                        self.start_timeout, "start")

    def _alive(self):
        return self.procs and all(p.poll() is None for p in self.procs)

    def close(self):
        if self.procs and self._alive():
            try:
                self.store.set(f"g{self.generation}/case/{self.k}",
                               pickle.dumps(None))
            except Exception:  # noqa: BLE001
                pass
            deadline = time.monotonic() + 10
            for p in self.procs:
                try:
                    p.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        self.kill()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                pass
        self.procs = []

    def _dump_stacks(self):
        import signal

        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(1.0)

    def _logs(self):
        out = []
        for r in range(self.n):
            path = os.path.join(self.log_dir,
                                f"gen{self.generation}_rank{r}.log")
            try:
                with open(path) as f:
                    text = "".join(ln for ln in f if "socket" not in ln)
                    out.append(f"--- rank {r} ---\n" + text[-4000:])
            except OSError:
                pass
        return "\n".join(out)

    def _wait_keys(self, keys, timeout, what):
        deadline = time.monotonic() + timeout
        for key in keys:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._dump_stacks()
                    logs = self._logs()
                    self.kill()
                    raise CaseError(f"{what}: no {key} within {timeout} s"
                                    f"\n{logs}")
                try:
                    self.store.wait([key], timedelta(
                        seconds=min(1.0, remaining)))
                    break
                except Exception:  # noqa: BLE001 — the store's timeout
                    if not self._alive() and not self.store.check([key]):
                        # a rank died: the others' results may never come
                        codes = [p.poll() for p in self.procs]
                        logs = self._logs()
                        self.kill()
                        raise CaseError(f"{what}: a rank exited ({codes})"
                                        f"\n{logs}")

    # -- cases ----------------------------------------------------------
    def submit(self, fn: str, **kwargs):
        """Start case `fn` on every rank; returns a handle for
        `collect`."""
        if not self._alive():
            self._spawn()
        k = self.k
        self.k += 1
        self.store.set(f"g{self.generation}/case/{k}",
                       pickle.dumps((fn, kwargs)))
        return (self.generation, k, fn)

    def collect(self, handle, timeout: float = 60.0, allow_exit=()):
        """The per-rank results of a submitted case (a list, rank
        order); a rank's error fails the case at once.  `allow_exit`:
        ranks that may end the process on purpose (their result is
        None)."""
        gen, k, fn = handle
        want = {r: f"g{gen}/result/{k}/{r}" for r in range(self.n)
                if r not in allow_exit}
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(got) < len(want) and not errors:
            for r, key in want.items():
                if r not in got and self.store.check([key]):
                    status, res = pickle.loads(self.store.get(key))
                    got[r] = res
                    if status != "ok":
                        errors.append(f"rank {r}: {res}")
            if len(got) == len(want) or errors:
                break
            if time.monotonic() > deadline:
                self._dump_stacks()
                logs = self._logs()
                self.kill()
                late = sorted(set(want) - set(got))
                raise CaseError(f"case {fn}: ranks {late} gave no result "
                                f"within {timeout} s\n{logs}")
            if not allow_exit and not self._alive():
                codes = [p.poll() for p in self.procs]
                logs = self._logs()
                self.kill()
                raise CaseError(f"case {fn}: a rank exited ({codes})\n{logs}")
            time.sleep(0.02)
        if errors:
            self.kill()
            raise CaseError(f"case {fn} failed\n" + "\n".join(errors))
        if allow_exit:
            self.kill()
        return [got.get(r) for r in range(self.n)]

    def run(self, fn: str, timeout: float = 60.0, **kwargs):
        return self.collect(self.submit(fn, **kwargs), timeout)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
