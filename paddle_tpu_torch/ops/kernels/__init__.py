"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

The port's counterpart of paddle_tpu/ops/pallas/: every Pallas TPU
kernel becomes a kernel written for the H100 (`sm_90a`), with a plain
PyTorch version of the same function beside it.  The tensors' device
routes a call — a CUDA tensor always goes to the kernel, a CPU tensor to
the plain version, and a "meta" tensor (shape inference) gets the
kernel's output allocation without any computation.  A kernel never
falls back to its plain version.

`launch_counts` counts kernel launches (incremented by each wrapper right
after its launch, nowhere else) and `plain_calls` counts plain-version
runs, so a caller can show which path a run took.  Every increment goes
through `bump`, under one lock: a serving fleet's replicas launch from
scheduler threads of their own.  A kernel with a bf16
path counts it under its own name (`flash_attention_fwd_bf16` beside
`flash_attention_fwd`).  `composed_calls`
counts the torch compositions that stand where the reference runs an XLA
composition instead of its kernel (the flash_attention op with a bias
that is not a key-padding bias, ops/attention.py; dynamic_lstm with
peepholes or other activations, ops/rnn.py); they are neither a kernel
launch nor a plain-version call.

The same compositions take, on the card, what a kernel does not (a head
dim, a width or a dtype outside its limits) when the op's `use_pallas`
is false, as the reference's own route for such an op is its
composition.  Each kernel module decides that with one pure predicate,
`kernel_takes`, beside the check that its wrapper keeps; with
`use_pallas` true the op goes to the wrapper, which raises.  On the CPU
the plain versions take every shape, so `on_card` keeps that route to
the card.
"""

from __future__ import annotations

import threading
from typing import Dict

KERNELS = ("paged_attention", "flash_attention_fwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd_bf16", "flash_attention_bwd_dkv_bf16",
           "flash_attention_bwd_dq_bf16",
           "vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw",
           "lstm_fwd", "lstm_bwd")
COMPOSED = ("flash_attention", "dynamic_lstm", "fused_vocab_softmax_ce",
            "paged_attention")

# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bytes/s, the dense
# bf16 and TF32 tensor-core rates and the float32 rate outside the tensor
# cores, for the kernels' bounds.  A card below its 700 W limit runs
# slower.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}
plain_calls: Dict[str, int] = {k: 0 for k in KERNELS}
composed_calls: Dict[str, int] = {k: 0 for k in COMPOSED}


def on_card(t) -> bool:
    """Does tensor t lie where the kernels' limits decide an op's route
    (a CUDA device)?"""
    return t.device.type == "cuda"


_count_lock = threading.Lock()


def bump(table: Dict[str, int], name: str) -> None:
    """table[name] += 1, atomically across threads."""
    with _count_lock:
        table[name] += 1


def reset_counts() -> None:
    with _count_lock:
        for k in KERNELS:
            launch_counts[k] = 0
            plain_calls[k] = 0
        for k in COMPOSED:
            composed_calls[k] = 0


def counts() -> Dict[str, Dict[str, int]]:
    return {"launches": dict(launch_counts), "plain": dict(plain_calls),
            "composed": dict(composed_calls)}
