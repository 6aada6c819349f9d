"""Training worker for the port's crash-chaos tests
(tests/test_torch_preempt.py): a real training subprocess, on the CPU,
that the parent SIGKILLs or SIGTERMs and relaunches.  It imports torch
and paddle_tpu_torch only.

The job carries every piece of state a bit-exact resume must restore,
as tests/preempt_worker.py's does:

- dropout (the executor's run counter `__rng_key__`),
- Adam (moment and beta-power accumulators),
- dynamic loss scaling + the in-step update guard, with a NaN batch at
  a fixed step so the scale and the good/bad/skip counters are all
  non-trivial when the process dies,
- a seeded shuffled reader (the same feed order in every process).

The model is the reference worker's, with its squared error written as
`elementwise_sub`, `elementwise_mul` and `mean` (the port has no
`square_error_cost` yet).

Protocol (the parent is tests/test_torch_preempt.py):
- "STEP <epoch> <step>" on stdout after every completed step,
- on SIGTERM the Trainer drains to an emergency checkpoint and the
  worker exits with resilience.PREEMPT_EXIT_CODE,
- on completion the final persistables and the telemetry accumulator
  land in --out (npz; telemetry fields under "__telemetry__/") and the
  worker prints "DONE".
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
from paddle_tpu_torch.core.executor import RNG_STATE_VAR  # noqa: E402
from paddle_tpu_torch.data import decorator  # noqa: E402
from paddle_tpu_torch.observe.metrics import TELEMETRY_VAR  # noqa: E402
from paddle_tpu_torch.resilience import (TrainingPreempted,  # noqa: E402
                                         chaos)

BATCHES_PER_EPOCH = 12
BATCH = 8
NAN_AT_STEP = 4  # poisons epoch-0 step 4: loss-scale/guard state moves


def train_func():
    x = layers.data(name="x", shape=[6], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(x, size=16, act="relu")
    h = layers.dropout(h, dropout_prob=0.3)
    pred = layers.fc(h, size=1)
    d = layers.elementwise_sub(pred, y)
    return layers.mean(layers.elementwise_mul(d, d))


def opt_func():
    return fluid.amp.decorate(
        fluid.optimizer.Adam(learning_rate=0.01),
        use_dynamic_loss_scaling=True, init_loss_scaling=16.0,
        incr_every_n_steps=3)


def make_reader(n=BATCHES_PER_EPOCH, nan_at=NAN_AT_STEP):
    def base():
        r = np.random.RandomState(5)
        for _ in range(n):
            yield {"x": r.rand(BATCH, 6).astype(np.float32),
                   "y": r.rand(BATCH, 1).astype(np.float32)}

    shuffled = decorator.shuffle(base, 4, seed=13)

    def poisoned():
        for i, b in enumerate(shuffled()):
            yield chaos.poison_feed(b, ["x"]) if i == nan_at else b

    return poisoned


def final_state(trainer):
    """Every persistable, the run counter and the telemetry
    accumulator, as numpy."""
    out = {v.name: trainer.scope.find_var(v.name).numpy()
           for v in trainer.train_program.list_vars() if v.persistable}
    out[RNG_STATE_VAR] = np.int64(trainer.scope.find_var(RNG_STATE_VAR))
    for k, v in trainer.scope.find_var(TELEMETRY_VAR).items():
        out[f"__telemetry__/{k}"] = v.numpy()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--log", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--step-interval", type=int, default=3)
    ap.add_argument("--slow-write-ms", type=float, default=0.0,
                    help="chaos: stretch every background checkpoint "
                         "write so a SIGKILL lands mid-write")
    ap.add_argument("--step-ms", type=float, default=0.0,
                    help="pace: sleep this long after each step, so the "
                         "parent's signal lands at the step it aimed at")
    args = ap.parse_args()
    torch.set_num_threads(1)

    if args.slow_write_ms > 0:
        chaos.arm_delay("ckpt:write", args.slow_write_ms / 1000.0,
                        times=10 ** 6)

    trainer = Trainer(
        train_func, opt_func, place=fluid.CPUPlace(),
        checkpoint_config=CheckpointConfig(
            args.ckpt, step_interval=args.step_interval,
            epoch_interval=10 ** 6,  # step-cadence saves only
            max_num_checkpoints=4, async_save=True),
        telemetry=observe.TelemetryConfig(interval=100,
                                          log_path=args.log),
        preempt_drain=True)

    def handler(event):
        if isinstance(event, EndStepEvent):
            print(f"STEP {event.epoch} {event.step}", flush=True)
            time.sleep(args.step_ms / 1000.0)

    try:
        trainer.train(num_epochs=args.epochs, reader=make_reader(),
                      event_handler=handler)
    except TrainingPreempted as e:
        print("PREEMPTED " + json.dumps(e.as_dict()), flush=True)
        sys.exit(e.exit_code)
    state = final_state(trainer)
    trainer.stop()
    np.savez(args.out, **state)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
