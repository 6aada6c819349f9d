"""The port's gang supervisor (paddle_tpu_torch/resilience/supervisor.py)
on the CPU, against the reference's (paddle_tpu/resilience/supervisor.py,
tests/test_gang.py's supervisor tests).

The workers are tiny `python -c` scripts that import no torch: the
supervisor manages processes and the PADDLE_* env contract only.
`classify_exit` and `backoff_schedule` equal the reference's on the same
inputs; crash restarts back off on the deterministic schedule (through
an injected sleep), budget exhaustion is a structured GangFailedError,
a preempt drain relaunches without backoff, an elastic gang shrinks to
its survivors, and with `host_coordinator=True` the supervisor serves a
fresh store per attempt that every rank (rank 0 too) reaches as a
client (PADDLE_COORDINATOR_HOSTED=1).
"""

from __future__ import annotations

import json
import os
import sys

import pytest

from paddle_tpu.resilience import backoff_schedule as ref_backoff
from paddle_tpu.resilience.supervisor import classify_exit as ref_classify
from paddle_tpu_torch.resilience import (PEER_LOST_EXIT_CODE,
                                         PREEMPT_EXIT_CODE, GangFailedError,
                                         backoff_schedule)
from paddle_tpu_torch.resilience import supervisor as sup_mod
from paddle_tpu_torch.resilience.supervisor import Supervisor, classify_exit

CODES = [None, 0, PREEMPT_EXIT_CODE, PEER_LOST_EXIT_CODE, -9, 137, -15,
         143, 3, 1, 255, -64, 200]


def test_classify_exit_and_backoff_equal_the_reference():
    assert [classify_exit(c) for c in CODES] == \
        [ref_classify(c) for c in CODES]
    assert classify_exit(-9) == "signal:SIGKILL"
    assert classify_exit(PEER_LOST_EXIT_CODE) == "peer_lost"
    for args in ((4, 1.0, 30.0), (6, 1.0, 4.0), (3, 0.2, 1.0)):
        assert backoff_schedule(*args) == ref_backoff(*args)


def test_supervisor_restarts_crashed_gang_with_backoff(tmp_path):
    """Rank 1 crashes on attempt 0 and is clean after; the supervisor
    terminates the survivor, backs off the deterministic schedule, and
    the relaunch succeeds."""
    script = (
        "import os,sys,time\n"
        "d = sys.argv[1]\n"
        "rank = os.environ['PADDLE_TRAINER_ID']\n"
        "assert os.environ['PADDLE_TRAINERS'] == '2'\n"
        "assert ':' in os.environ['PADDLE_COORDINATOR']\n"
        "f = os.path.join(d, 'n_r' + rank)\n"
        "n = int(open(f).read()) if os.path.exists(f) else 0\n"
        "open(f, 'w').write(str(n + 1))\n"
        "if rank == '1' and n == 0:\n"
        "    sys.exit(9)\n"
        "time.sleep(0.2)\n")
    slept = []
    sup = Supervisor([sys.executable, "-c", script, str(tmp_path)], 2,
                     max_restarts=3, grace_s=1.0, backoff_base_s=1.5,
                     backoff_max_s=30.0, sleep=slept.append, poll_s=0.05)
    r = sup.run()
    assert r.ok and r.restarts == 1
    assert r.attempts[0]["reason"] == "crash"
    assert r.attempts[0]["exit_codes"][1] == 9
    assert r.attempts[0]["classified"][1] == "crash:9"
    assert slept == [1.5]


def test_supervisor_budget_exhaustion_is_structured():
    slept = []
    sup = Supervisor([sys.executable, "-c", "import sys; sys.exit(5)"],
                     2, max_restarts=2, grace_s=1.0, backoff_base_s=1.0,
                     sleep=slept.append, poll_s=0.05)
    with pytest.raises(GangFailedError) as ei:
        sup.run()
    d = ei.value.as_dict()
    assert d["error"] == "gang_failed"
    assert len(d["attempts"]) == 3
    for a in d["attempts"]:
        assert a["reason"] == "crash"
        assert set(a["exit_codes"].values()) <= {5, -15, -9}
    assert slept == [1.0, 2.0]


def test_supervisor_preempt_drain_relaunches_without_backoff(tmp_path):
    script = (
        "import os,sys\n"
        "f = os.path.join(sys.argv[1],"
        " 'p_r' + os.environ['PADDLE_TRAINER_ID'])\n"
        "n = int(open(f).read()) if os.path.exists(f) else 0\n"
        "open(f, 'w').write(str(n + 1))\n"
        f"sys.exit({PREEMPT_EXIT_CODE} if n == 0 else 0)\n")
    slept = []
    sup = Supervisor([sys.executable, "-c", script, str(tmp_path)], 2,
                     max_restarts=2, grace_s=1.0, sleep=slept.append,
                     poll_s=0.05)
    r = sup.run()
    assert r.ok and r.restarts == 1
    assert r.attempts[0]["reason"] == "preempt_drain"
    assert sup.backoffs_slept == [0.0] and slept == []


def test_supervisor_elastic_shrinks_to_survivors(tmp_path):
    """A rank that died BY SIGNAL is lost capacity: the relaunch runs
    the survivors; a deliberate exit does not shrink."""
    marker = os.path.join(str(tmp_path), "attempt2.flag")
    script = (
        "import os, signal, sys\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "world = int(os.environ['PADDLE_TRAINERS'])\n"
        f"marker = {marker!r}\n"
        "if world == 2:\n"
        "    if rank == 1:\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    sys.exit(43)\n"
        "open(marker, 'w').write(str(world))\n"
        "sys.exit(0)\n")
    sup = Supervisor([sys.executable, "-c", script], 2, max_restarts=2,
                     grace_s=2.0, backoff_base_s=0.0, elastic=True,
                     poll_s=0.05)
    result = sup.run()
    assert result.ok and result.restarts == 1, result.as_dict()
    assert result.attempts[0]["reason"] == "peer_lost"
    assert result.attempts[0]["shrunk_to"] == 1
    assert list(result.attempts[1]["exit_codes"]) == [0]
    assert open(marker).read() == "1"


def test_host_coordinator_serves_a_store_per_attempt(tmp_path):
    """host_coordinator=True: each attempt's PADDLE_COORDINATOR is a
    fresh port the supervisor's store listens on (a plain socket
    reaches it), PADDLE_COORDINATOR_HOSTED=1 tells rank 0 not to serve
    one, and the event log records the attempts."""
    from paddle_tpu_torch import observe

    script = (
        "import os, socket, sys\n"
        "host, port = os.environ['PADDLE_COORDINATOR'].rsplit(':', 1)\n"
        "socket.create_connection((host, int(port)), timeout=5).close()\n"
        "assert os.environ['PADDLE_COORDINATOR_HOSTED'] == '1'\n"
        "rank = os.environ['PADDLE_TRAINER_ID']\n"
        "f = os.path.join(sys.argv[1], 'c_r' + rank)\n"
        "seen = open(f).read().split() if os.path.exists(f) else []\n"
        "open(f, 'w').write(' '.join(seen + [port]))\n"
        "sys.exit(3 if len(seen) == 0 and rank == '0' else 0)\n")
    log = observe.RunEventLog(str(tmp_path / "sup.jsonl"))
    sup = Supervisor([sys.executable, "-c", script, str(tmp_path)], 2,
                     max_restarts=1, grace_s=1.0, backoff_base_s=0.0,
                     host_coordinator=True, poll_s=0.05, event_log=log,
                     log_dir=str(tmp_path / "logs"))
    r = sup.run()
    log.close()
    assert r.ok and r.restarts == 1
    ports = [open(tmp_path / f"c_r{k}").read().split() for k in "01"]
    assert ports[0] == ports[1] and len(set(ports[0])) == 2
    kinds = [e["event"] for e in observe.read_events(log.path)
             if e["event"].startswith("gang_")]
    assert kinds == ["gang_start", "gang_restart", "gang_start",
                     "gang_end"]
    assert sup._service is None
    assert sorted(os.listdir(tmp_path / "logs")) == sorted(
        f"attempt{a}_rank{k}.{x}" for a in "01" for k in "01"
        for x in ("out", "err"))


def test_command_line(tmp_path, capsys):
    """`python -m paddle_tpu_torch.resilience.supervisor` (here its
    main()): GANG_ATTEMPT lines and GANG_RESULT, exit 0; on budget
    exhaustion GANG_FAILED, exit 1."""
    rc = sup_mod.main(["--nproc", "2", "--max-restarts", "0", "--",
                       sys.executable, "-c", "pass"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert json.loads(out[-1][len("GANG_RESULT "):])["ok"] is True
    assert out[0].startswith("GANG_ATTEMPT ")
    rc = sup_mod.main(["--nproc", "1", "--max-restarts", "0",
                       "--grace-s", "1", "--", sys.executable, "-c",
                       "import sys; sys.exit(4)"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1 and out[-1].startswith("GANG_FAILED ")
