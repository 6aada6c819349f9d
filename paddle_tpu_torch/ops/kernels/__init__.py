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

`KERNEL_COSTS` is the kernels' cost registry (the reference's, in
paddle_tpu/ops/pallas/__init__.py:40-61): each kernel module registers
the flops of its kernels' function, a formula over the call's logical
dimensions, in the reference's dense-equivalent convention (the flops
the dense composition computes once; masked pairs counted, backward
recompute not).  A wrapper reports each call to the step recorder of
observe/cost.py through `charge`, next to its `bump`, on the kernel and
the plain route alike, with the bytes its kernel moves
(`bound_bytes_and_flops`).  A ctypes launch is invisible to torch: this
report is the only way the recorder sees a kernel's work.  `routed`
marks a wrapper whose own aten ops (the plain version's, the kernel
route's output allocations and copies) the recorder does not count
again; the memory ledger still sees what they allocate.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict

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


KERNEL_COSTS: Dict[str, Callable[..., float]] = {}

# the step recorder (observe/cost.py) active in this process, or None
recorder = [None]


def register_kernel_cost(name: str, fn: Callable[..., float]):
    """Declare the flops of kernel `name`'s function (a count name of
    KERNELS): fn(*dims) over the call's logical dimensions."""
    KERNEL_COSTS[name] = fn
    return fn


def charge(name: str, dims, nbytes) -> None:
    """Report one call of kernel `name`'s function, at logical `dims`,
    moving `nbytes` (an int, or a function computing it), to the active
    step recorder.  Nothing happens when none is active."""
    rec = recorder[0]
    if rec is not None:
        rec.kernel_call(name, dims, nbytes)


def routed(fn):
    """A kernel wrapper whose aten ops the active step recorder does not
    count: its kernel's cost reaches the recorder through `charge`."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        rec = recorder[0]
        if rec is None:
            return fn(*args, **kwargs)
        with rec.kernel_region():
            return fn(*args, **kwargs)
    return call


def counts() -> Dict[str, Dict[str, int]]:
    return {"launches": dict(launch_counts), "plain": dict(plain_calls),
            "composed": dict(composed_calls)}


def restore_counts(saved: Dict[str, Dict[str, int]]) -> None:
    """Put back the counts `counts()` returned: a recorded step
    (observe/cost.py) leaves no launch of its own in them."""
    with _count_lock:
        for table, key in ((launch_counts, "launches"),
                           (plain_calls, "plain"),
                           (composed_calls, "composed")):
            table.update(saved[key])
