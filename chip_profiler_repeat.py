"""Repeat the port's profiled sessions on one NVIDIA GPU and report, for
each, what its trace holds (ROADMAP C22: a profile that recorded no
CUDA activity).

    python3 chip_profiler_repeat.py [--history N] [--rounds N] [--layers N]
                                    [--minutes M]

First `--history` short `torch.profiler` sessions over a few matmuls
(the many profiled windows that come before phase 6y in chip_smoke.py),
then `--rounds` rounds of phase 6y (a)'s sequence on the bench
Transformer at chip_smoke.py's batch and widths (`--layers` encoder and
decoder layers): phase 6's profile of two steps (`torch.profiler` and
`key_averages`), two steps under `fluid.profiler.profiler`, one step
under it.  Each `fluid.profiler` session's trace is counted by category
(kernels, copies, runtime launches, op ranges) beside the device events
`torch.profiler` itself returned, and a session that raised is named.
Each trace also gives the card's clock against the host's: for every
kernel, its start less its launch's (joined by CUPTI's correlation id),
negative when the kernel reads as started before it was launched, and
the first kernel's start less the trace's first host event.  With
`--minutes`, the rounds go on until that much time has passed.
Writes chip_smoke_out/profiler_repeat.json; the last line is a JSON
summary.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _clocks(path):
    """(kernels, launches matched, min and median of kernel start less
    launch start in us, first kernel less first host event in ms) of
    the newest trace under `path`."""
    import numpy as np

    from paddle_tpu_torch.observe import trace

    events = trace._load(path)
    launch = {(e.get("args") or {}).get("correlation"): float(e["ts"])
              for e in events if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")}
    kern = [e for e in events if e.get("cat") == "kernel"]
    gaps = [float(e["ts"]) - launch[c] for e in kern
            if (c := (e.get("args") or {}).get("correlation")) in launch]
    host = [float(e["ts"]) for e in events if e.get("cat") == "cpu_op"]
    first = (min(float(e["ts"]) for e in kern) - min(host)) / 1e3 \
        if kern and host else None
    return {"kernels": len(kern), "matched": len(gaps),
            "kernel_minus_launch_us": [float(np.min(gaps)),
                                       float(np.median(gaps))]
            if gaps else None,
            "first_kernel_after_host_ms": first}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profiler_repeat: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--history", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--minutes", type=float, default=0.0)
    args = ap.parse_args()

    import shutil

    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.observe.trace import event_counts
    from paddle_tpu_torch.ops.kernels import _build
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    card = cs.card_line()
    cs._set_matmul_flags()
    _build.build()
    dev = torch.device("cuda", 0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.randn(1024, 1024, device=dev)
    t0 = time.perf_counter()
    empty_history = 0
    for _ in range(args.history):
        with profile(activities=acts) as prof:
            for _ in range(8):
                x = torch.tanh(x @ x)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        empty_history += not kern
    hist_s = time.perf_counter() - t0
    main_p, startup, model = cs.build_training(n_layer=args.layers)
    loss = model["loss"]
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(a).to(dev) for n, a in
            transformer.make_fake_batch(
                cs.TRAIN_BATCH, cs.TRAIN_ARCH["max_length"],
                cs.TRAIN_ARCH["src_vocab_size"],
                cs.TRAIN_ARCH["trg_vocab_size"]).items()}

    def step():
        exe.run(main_p, feed=feed, fetch_list=[loss], scope=scope)

    step()
    root = os.path.abspath(os.path.join(cs.OUT_DIR, "profiler_repeat"))
    shutil.rmtree(root, ignore_errors=True)
    sessions = []
    r = 0
    while r < args.rounds or time.perf_counter() - t_start < \
            args.minutes * 60:
        cs._profile_train_step(exe, main_p, feed, loss, scope,
                               label=f"round {r}: phase 6's profile")
        for steps in (2, 1):
            path = os.path.join(root, f"r{r}_s{steps}")
            pt.profiler.start_profiler("All", path)
            prof = pt.profiler._running["prof"]
            for _ in range(steps):
                step()
            err = None
            try:
                pt.profiler.stop_profiler(None, path)
            except RuntimeError as e:
                err = str(e)
            own = sum(e.device_type == DeviceType.CUDA
                      for e in prof.events())
            s = {"round": r, "steps": steps, "raised": err,
                 "t_s": time.perf_counter() - t_start,
                 "trace": event_counts(path), "profiler_device_events": own,
                 "clocks": _clocks(path)}
            sessions.append(s)
            cs.log(f"  round {r}, {steps} step(s): {s}")
            shutil.rmtree(path, ignore_errors=True)
        r += 1
    shutil.rmtree(root, ignore_errors=True)
    failed = [s for s in sessions if s["raised"]]
    skews = [s["clocks"]["kernel_minus_launch_us"][0] for s in sessions
             if s["clocks"]["kernel_minus_launch_us"]]
    summary = {"card": card, "torch": torch.__version__,
               "history_sessions": args.history,
               "history_empty": empty_history, "history_s": hist_s,
               "sessions": len(sessions), "raised": len(failed),
               "layers": args.layers,
               "kernel_minus_launch_us_min": min(skews) if skews else None,
               "sessions_with_a_kernel_before_its_launch":
                   sum(v < 0 for v in skews)}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "profiler_repeat.json"), "w") as f:
        json.dump({"summary": summary, "sessions": sessions}, f, indent=1)
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
