"""In-turn comparison of two checkouts of the port on one NVIDIA GPU.

    python3 chip_ab.py <tree A> <tree B>

Runs, for A, B, B and A in that order, each in its own process with that
tree's own `chip_smoke.py` and `paddle_tpu_torch` (its kernels built from
its own sources): the flash forward alone at the training shapes
(`flash_fwd_at_training_shapes`), phase 6d (the long-context step, 6
timed steps and a profiled window) and phase 6 (the unfused step, 10
timed steps and a profiled window).  Comparing within one call, on one
card, in turns, keeps the card, its power limit and its neighbours the
same for both trees.  A tree is any directory holding a checkout, e.g.
the parent commit unpacked with `git archive` into a directory that
.gitignore lists.

Prints one JSON line per run ({"tag", "tree", "card", "fwd_ms",
"6d_step_ms", "6d_busy_ms", "6_step_ms", "6_busy_ms"}) and writes each
run's full record to chip_smoke_out/ab_<tag>.json.  Exits non-zero when
CUDA is absent or a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def run_one(tree: str, tag: str, out_dir: str) -> dict:
    """One tree's phases, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _build.build()
    rec = {"tag": tag, "tree": tree, "card": card,
           "fwd": cs.flash_fwd_at_training_shapes(dev),
           "6d": cs.phase_train(dev, card, "phase 6d", cs.LONGCTX,
                                batch=cs.LONGCTX_BATCH, steps=6,
                                profile="phase 6d, profiled"),
           "6": cs.phase_train(dev, card, steps=10, profile="phase 6b")}
    with open(os.path.join(out_dir, f"ab_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return {"tag": tag, "tree": tree, "card": card,
            "fwd_ms": {k: r["ms"] for k, r in rec["fwd"].items()},
            "6d_step_ms": rec["6d"]["step_ms"],
            "6d_busy_ms": rec["6d"]["profile"]["device_busy_ms_per_step"],
            "6_step_ms": rec["6"]["step_ms"],
            "6_busy_ms": rec["6"]["profile"]["device_busy_ms_per_step"]}


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":
        print(json.dumps(run_one(*argv[1:])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    out_dir = os.path.abspath("chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    a, b = argv
    for tree, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree, tag, out_dir],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
