"""Fused attention op: the port of paddle_tpu/ops/attention.py
`flash_attention`.

Q/K/V arrive (N, H, T, D) — or, with layout="nthd" + the n_head attr,
head-grouped (N, T, H*D), what the attn_qkv projection emits — plus an
optional additive Bias.  The operands' device picks the implementation
(ops/kernels/flash_attention.py): a CUDA tensor always runs the
hand-written Hopper kernel, a CPU tensor the plain PyTorch version.  The
`use_pallas` attr is kept so programs serialize as the reference's do;
it does not route.

The kernel takes a key-padding bias broadcastable to (N, 1, 1, Tk).  The
reference sends richer biases to its XLA composition instead
(paddle_tpu/ops/attention.py:163-172); on CUDA this slice raises for
them (ROADMAP queue A item 3), while the CPU plain version takes any
broadcastable bias.
"""

from __future__ import annotations

from ..core.registry import register_op
from .common import first, opt_in, out
from .kernels.flash_attention import flash_attention_fwd


@register_op("flash_attention")
def flash_attention(ctx, ins, attrs):
    q, k, v = first(ins, "Q"), first(ins, "K"), first(ins, "V")
    bias = opt_in(ins, "Bias")
    layout = attrs.get("layout", "nhtd")
    n_head = attrs.get("n_head", None)
    if layout == "nthd" and not n_head:
        raise ValueError("flash_attention layout='nthd' needs the "
                         "n_head attr (operands are (N, T, H*D))")
    strategy = attrs.get("sequence_parallel", False)
    if strategy not in (False, None, True, "ring", "ulysses"):
        raise ValueError(f"sequence_parallel must be True/'ring'/"
                         f"'ulysses', got {strategy!r}")
    # sequence parallelism needs a mesh with an sp axis, which the port
    # does not have yet: like the reference without one, fall through
    # to the local kernel
    o, _lse = flash_attention_fwd(q, k, v, bias, attrs.get("scale"),
                                  bool(attrs.get("causal", False)),
                                  layout=layout, n_head=n_head)
    return out(Out=o)
