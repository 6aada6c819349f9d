"""One rank of a REAL supervised training gang of the port, on the CPU
(tests/test_torch_gang.py): the counterpart of tests/gang_worker.py.  It
imports torch and paddle_tpu_torch only.

Launched by `resilience.Supervisor`, it reads its identity from the
PADDLE_TRAINER_ID / PADDLE_TRAINERS / PADDLE_COORDINATOR env contract
through `parallel.init_distributed(place=CPUPlace())`, which also starts
the health plane (heartbeats, the peer-loss monitor and the poison key)
on the gang's TCPStore.  Each rank trains its own model on its own
reader (a gang that shares no collective: the health plane, the
checkpoints and the supervisor protocol are the real articles), and
keeps its own checkpoints under <ckpt-root>/rank<k>.

Protocol:
- "STEP <epoch> <step> <unix time>" after every completed step,
- chaos is env-armed (`chaos.kill_rank` / `chaos.hang_rank` with a
  once-file so a relaunched gang does not fire again),
- on a GangError (peer lost / stalled / poisoned) or a poisoned
  checkpoint barrier: "PEER_LOST <json>" (the alarm's wall time
  attached) and exit PEER_LOST_EXIT_CODE,
- on SIGTERM: the Trainer drain path exits PREEMPT_EXIT_CODE,
- on clean completion: the final persistables in <out-root>/rank<k>.npz,
  the goodput report in <out-root>/rank<k>.goodput.json, then the
  done-rendezvous, and "DONE" — unless the rendezvous finds the gang
  broken, which prints the same "PEER_LOST <json>" and exits 43.

--mode barrier_poison: rank 1 writes the poison key and dies; rank 0 is
inside a checkpoint barrier with a 120 s timeout and must get a
CheckpointBarrierPoisonedError within seconds ("BARRIER_POISONED
<json>").
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import layers, observe  # noqa: E402
from paddle_tpu_torch.contrib import (CheckpointConfig,  # noqa: E402
                                      EndStepEvent, Trainer)
from paddle_tpu_torch.data import decorator  # noqa: E402
from paddle_tpu_torch.parallel import init_distributed  # noqa: E402
from paddle_tpu_torch.resilience import (PEER_LOST_EXIT_CODE,  # noqa: E402
                                         CheckpointBarrierPoisonedError,
                                         GangError, TrainingPreempted, chaos,
                                         health)

BATCHES_PER_EPOCH = 12
BATCH = 8


def train_func():
    x = layers.data(name="x", shape=[6], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, size=16, act="relu")
    h = layers.dropout(h, dropout_prob=0.3)
    pred = layers.fc(h, size=1)
    return layers.mean(layers.square_error_cost(pred, y))


def opt_func():
    return fluid.optimizer.Adam(learning_rate=0.01)


def make_reader(rank):
    def base():
        # per-rank deterministic stream (the ranks' trajectories differ)
        r = np.random.RandomState(11 + rank)
        for _ in range(BATCHES_PER_EPOCH):
            yield {"x": r.rand(BATCH, 6).astype(np.float32),
                   "y": r.rand(BATCH, 1).astype(np.float32)}

    return decorator.shuffle(base, 4, seed=29 + rank)


def make_trainer(rank, ckpt_root, log_root=None, step_interval=3):
    return Trainer(
        train_func, opt_func, place=fluid.CPUPlace(),
        checkpoint_config=CheckpointConfig(
            os.path.join(ckpt_root, f"rank{rank}"),
            step_interval=step_interval, epoch_interval=10 ** 6,
            max_num_checkpoints=4),
        telemetry=observe.TelemetryConfig(
            interval=100, log_path=(os.path.join(log_root,
                                                 f"rank{rank}.jsonl")
                                    if log_root else None)),
        preempt_drain=True)


def final_params(trainer):
    return {v.name: trainer.scope.find_var(v.name).numpy()
            for v in trainer.train_program.list_vars() if v.persistable}


def _peer_lost(e, rank, t0, plane, at="train"):
    payload = e.as_dict()
    payload.update(rank=rank, at=at,
                   detected_at_train_s=round(time.monotonic() - t0, 3),
                   alarm_wall_time=plane.monitor.alarm_wall_time)
    print("PEER_LOST " + json.dumps(payload), flush=True)
    os._exit(PEER_LOST_EXIT_CODE)  # skip teardown: a peer is gone


def run_barrier_poison(rank):
    kv = health.kv_client()
    if rank == 1:
        time.sleep(1.5)  # rank 0 is inside the barrier by now
        health.write_poison(kv, rank=1,
                            reason="chaos: deliberate gang abort",
                            kind="manual", missing_ranks=[1])
        sys.stdout.flush()
        os._exit(7)  # abrupt: no barrier arrival, no cleanup
    t0 = time.monotonic()
    try:
        fluid.io._barrier("gang_test:poisoned", timeout_s=120.0)
        print("BARRIER_UNEXPECTED_OK", flush=True)
        os._exit(1)
    except CheckpointBarrierPoisonedError as e:
        payload = e.as_dict()
        payload["elapsed_wall_s"] = round(time.monotonic() - t0, 3)
        print("BARRIER_POISONED " + json.dumps(payload), flush=True)
    os._exit(0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-root", required=True)
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--log-root", required=True)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--pace-s", type=float, default=0.12,
                    help="sleep per step so detection can land mid-train")
    ap.add_argument("--mode", default="train",
                    choices=["train", "barrier_poison"])
    args = ap.parse_args()
    torch.set_num_threads(2)

    rank, _ = init_distributed(place=fluid.CPUPlace())
    plane = health.get_health_plane()
    assert plane is not None, "init_distributed did not start the plane"
    if args.mode == "barrier_poison":
        run_barrier_poison(rank)
        return

    trainer = make_trainer(rank, args.ckpt_root, args.log_root)

    def handler(event):
        if isinstance(event, EndStepEvent):
            gpos = event.epoch * BATCHES_PER_EPOCH + event.step
            print(f"STEP {event.epoch} {event.step} {time.time():.6f}",
                  flush=True)
            chaos.kill_rank(rank, gpos)
            chaos.hang_rank(rank, gpos)
            if args.pace_s > 0:
                time.sleep(args.pace_s)

    t0 = time.monotonic()
    try:
        trainer.train(num_epochs=args.epochs, reader=make_reader(rank),
                      event_handler=handler)
    except TrainingPreempted as e:
        print("PREEMPTED " + json.dumps(e.as_dict()), flush=True)
        os._exit(e.exit_code)
    except (GangError, CheckpointBarrierPoisonedError) as e:
        _peer_lost(e, rank, t0, plane)
    os.makedirs(args.out_root, exist_ok=True)
    np.savez(os.path.join(args.out_root, f"rank{rank}.npz"),
             **final_params(trainer))

    def dump_goodput():
        with open(os.path.join(args.out_root,
                               f"rank{rank}.goodput.json"), "w") as f:
            json.dump(trainer.goodput(), f)

    # orderly leave: announce done and wait for the laggards so a
    # finished rank's silence is never mistaken for death
    plane.leave()
    if not plane.wait_gang_done(timeout_s=60.0):
        try:
            plane.check()
        except (GangError, CheckpointBarrierPoisonedError) as e:
            dump_goodput()
            _peer_lost(e, rank, t0, plane, at="done_wait")
    dump_goodput()
    print("DONE", flush=True)
    os._exit(0)  # skip distributed teardown (a peer may be gone)


if __name__ == "__main__":
    main()
