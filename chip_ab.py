"""In-turn comparison of two checkouts of the port on one NVIDIA GPU.

    python3 chip_ab.py <tree A> <tree B> [phase ...]

Runs, for A, B, B and A in that order, each in its own process with that
tree's own `chip_smoke.py` and `paddle_tpu_torch` (its kernels built from
its own sources), the named phases of chip_smoke.py:

    fwd     the flash forward alone at the training shapes
            (`flash_fwd_at_training_shapes`)
    kern    the device time (torch.profiler, every kernel one wrapper
            call launches) of the paged kernel on bf16 pools at the
            serving and the long-length decode shapes and of the LSTM
            forward and backward at the stacked-LSTM training shape, on
            the same inputs for both trees (this script's own
            chip_smoke.py makes them; the kernels are the tree's)
    stream  phase 4, the serving stream of 64 requests
    4b      phase 4b, one decode step's host and device-busy time
    4c      phase 4c, the sequential and the speculative (n-gram) stream
    4d      phase 4d, the oracle ModelDrafter stream
    4f      phase 4f, ResNet-50 through the Predictor and the
            ServingEngine (a tree whose chip_smoke.py has it)
    6       the unfused Transformer step (10 timed steps, a profiled window)
    6c      the fused-CE step (10 timed steps, a profiled window)
    6d      the long-context step (6 timed steps, a profiled window)
    6e      the stacked-LSTM step (10 timed steps, a profiled window)
    bwd16   the flash backward pair's bf16 path at phase 3g's five shapes
            (device ms of the dK/dV and the dQ kernel by the profiler;
            the inputs from this script's chip_smoke.py, the forward's
            O and lse from the tree's forward kernel)
    6i      the AMP Transformer step (10 timed steps, a profiled window)
    6j      the AMP BERT-base step (10 timed steps, a profiled window)

With no phase named it runs fwd, 6d and 6.  Comparing within one call,
on one card, in turns, keeps the card, its power limit and its neighbours
the same for both trees.  A tree is any directory holding a checkout,
e.g. the parent commit unpacked with `git archive` into a directory that
.gitignore lists.

Prints one JSON line per run ({"tag", "tree", "card", and per phase its
step time, device-busy time a step and peak memory, the stream's
tokens/s, or the forward's times}) and writes each run's full record to
chip_smoke_out/ab_<tag>.json.  Exits non-zero when CUDA is absent or a
run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = ("fwd", "kern", "stream", "4b", "4c", "4d", "4f", "6", "6c", "6d",
          "6e", "bwd16", "6i", "6j")
DEFAULT = ("fwd", "6d", "6")


def _cases():
    """The chip_smoke.py beside this script, as a module of its own: its
    case functions give both trees the same inputs, and the kernels they
    reach are the tree's (paddle_tpu_torch is imported from sys.path)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_ab_cases", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_device_ms(dev) -> dict:
    """{case: device ms of one wrapper call} for the paged kernel (bf16
    pools, serving and long-length shapes) and the LSTM kernels (T = N =
    128, H = 512)."""
    import torch

    from paddle_tpu_torch.ops.kernels import lstm as lk

    cs = _cases()
    out = {}
    for long in (False, True):
        pk, (q, kc, vc, pt, lens), h, _, _ = cs.paged_case(
            torch.bfloat16, dev, long=long)
        out["paged_long" if long else "paged_serving"] = cs.profiled_call_ms(
            lambda: pk.paged_attention(q, kc, vc, pt, lens, n_head=h),
            iters=100)
        del kc, vc
    t, n, h = cs.LSTM_ARCH["max_len"], cs.LSTM_BATCH, \
        cs.LSTM_ARCH["hidden_dim"]
    ops, cots = cs.lstm_case(dev, t, n, h, seed=40)
    hs, c_s = lk.lstm_fwd(*ops, False)
    out["lstm_fwd"] = cs.profiled_call_ms(lambda: lk.lstm_fwd(*ops, False),
                                          iters=10)
    out["lstm_bwd"] = cs.profiled_call_ms(
        lambda: lk.lstm_bwd(*ops, hs, c_s, *cots, False), iters=10)
    return out


def bf16_backward_device_ms(cs, dev) -> dict:
    """{shape: [dK/dV ms, dQ ms]}: the tree's bf16 backward kernels at
    phase 3g's shapes, by the profiler's device time.  `cs` is the tree's
    chip_smoke, whose kernel names are the tree's own."""
    import torch

    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    names = getattr(cs, "_BWD_BF16_KERNELS", cs._BWD_KERNELS)
    here = _cases()
    h, d = here.TRAIN_ARCH["n_head"], here.TRAIN_ARCH["d_model"] // \
        here.TRAIN_ARCH["n_head"]
    hb = here.BERT_ARCH["n_head"]
    shapes = [("6i causal", here.TRAIN_BATCH, h, 256, d, True),
              ("6i", here.TRAIN_BATCH, h, 256, d, False),
              ("BERT", here.BERT_BATCH, hb, here.BERT_ARCH["max_len"],
               here.BERT_ARCH["d_model"] // hb, False),
              ("D=128 causal", 16, 8, 512, 128, True),
              ("T=8192 causal", here.LONGCTX_BATCH, h, 8192, d, True)]
    out = {}
    for i, (tag, n, nh, t, hd, causal) in enumerate(shapes):
        c = here.bf16_case(dev, n, nh, t, hd, "nhtd", causal, seed=80 + i)
        per = cs.profiled_kernel_ms(
            lambda: fk.flash_attention_bwd(*c["args"], need_dbias=False),
            names, iters=3 if t > 1024 else 20, warmup=1)
        out[tag] = [per[names[0]], per[names[1]]]
        del c
        torch.cuda.empty_cache()
    return out


def _run_phase(cs, name, dev, card):
    if name == "fwd":
        return cs.flash_fwd_at_training_shapes(dev)
    if name == "kern":
        return kernel_device_ms(dev)
    if name == "stream":
        return cs.phase_stream(dev)
    if name == "4b":
        return cs.phase_step_profile(dev)
    if name == "4c":
        return cs.phase_speculative_stream(dev)
    if name == "4d":
        return cs.phase_oracle_stream(dev)
    if name == "4f":
        return cs.phase_serving_engine(dev, card)
    if name == "6":
        return cs.phase_train(dev, card, steps=10, profile="phase 6b")
    if name == "6c":
        return cs.phase_train(dev, card, "phase 6c", dict(use_fused_ce=True),
                              steps=10, profile="phase 6c, profiled")
    if name == "6d":
        return cs.phase_train(dev, card, "phase 6d", cs.LONGCTX,
                              batch=cs.LONGCTX_BATCH, steps=6,
                              profile="phase 6d, profiled")
    if name == "bwd16":
        return bf16_backward_device_ms(cs, dev)
    if name == "6i":
        return cs.phase_train(dev, card, "phase 6i", cs.AMP, steps=10,
                              profile="phase 6i, profiled")
    if name == "6j":
        return cs.phase_train_bert(dev, card, label="phase 6j",
                                   overrides=cs.AMP)
    return cs.phase_train_lstm(dev, card)


def _summary(name, rec):
    if name == "fwd":
        return {"fwd_ms": {k: r["ms"] for k, r in rec.items()}}
    if name == "kern":
        return {"kern_device_ms": rec}
    if name == "stream":
        return {"stream_tokens_per_s": rec["tokens_per_s"],
                "stream_ttft_p50_ms": rec["ttft_ms"]["p50_ms"]}
    if name in ("4c", "4d"):
        return {f"{name}_sequential_tokens_per_s":
                rec["sequential_tokens_per_s"],
                f"{name}_tokens_per_s": rec["tokens_per_s"],
                f"{name}_ttft_p50_ms": rec["ttft_ms"]["p50_ms"]}
    if name == "4f":
        return {"4f_requests_per_s": rec["requests_per_s"],
                "4f_logits_max_rel_err": rec["logits_max_rel_err_vs_single"],
                "4f_tf32_max_rel_err":
                rec["tf32_batch_max_rel_err_vs_single"]}
    if name == "4b":
        return {"4b_step_ms": rec["step_ms"],
                "4b_busy_ms": rec["device_busy_ms_per_step"]}
    if name == "bwd16":
        return {"bwd16_ms": rec}
    return {f"{name}_step_ms": rec["step_ms"],
            f"{name}_busy_ms": rec["profile"]["device_busy_ms_per_step"],
            f"{name}_peak_gb": rec["peak_mem_bytes"] / 1e9}


def run_one(tree: str, tag: str, out_dir: str, phases) -> dict:
    """One tree's phases, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as chip_smoke.py sets it for the AMP phases' bf16 GEMMs
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _build.build()
    rec = {"tag": tag, "tree": tree, "card": card}
    out = {"tag": tag, "tree": tree, "card": card}
    for name in phases:
        rec[name] = _run_phase(cs, name, dev, card)
        out.update(_summary(name, rec[name]))
    with open(os.path.join(out_dir, f"ab_{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return out


def main(argv) -> int:
    if len(argv) == 5 and argv[0] == "--one":
        print(json.dumps(run_one(*argv[1:4], argv[4].split(","))),
              flush=True)
        return 0
    phases = tuple(argv[2:]) or DEFAULT
    if len(argv) < 2 or any(p not in PHASES for p in phases):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    out_dir = os.path.abspath("chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    a, b = argv[:2]
    for tree, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree, tag, out_dir,
                               ",".join(phases)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
