"""Fused attention ops: the port of paddle_tpu/ops/attention.py
`flash_attention` and `fused_vocab_softmax_ce`.

Q/K/V arrive (N, H, T, D) — or, with layout="nthd" + the n_head attr,
head-grouped (N, T, H*D), what the attn_qkv projection emits — plus an
optional additive Bias.  Two routes, chosen by the bias's shape alone,
as the reference's `_kernel_bias_ok` chooses (paddle_tpu/ops/
attention.py:151-172):

- no bias, or a key-padding bias broadcastable to (N, 1, 1, Tk):
  `FlashAttentionFn` (ops/kernels/flash_attention.py) — on a CUDA tensor
  the hand-written Hopper kernels, forward and backward (autograd reaches
  the dK/dV and dQ kernels through it); on a CPU tensor their plain
  versions;
- any other bias (per-head, (Tq, Tk)): `composed_attention` below, the
  port of the reference's XLA compositions `_xla_attention` /
  `_xla_attention_nthd` as ordinary torch ops (differentiable through
  torch autograd, causal keys filled with the reference's -1e9).  It is
  counted in `kernels.composed_calls`, not as a kernel or plain call.

On the card, with `use_pallas` false, operands the kernels do not take
(a head dim outside {32, 64, 128}, a dtype other than float32 or bf16,
or q, k and v of mixed dtypes: `fk.kernel_takes`) also go to
`composed_attention`, counted the same way; with `use_pallas` true they
reach the kernels, which raise.  Where both routes are open `use_pallas`
does not route: bf16 operands (the AMP policy casts Q, K, V and the key
bias of the flash op to bf16) go to the kernels' bf16 paths, whose
semantics are the reference Pallas kernel's on bf16 (float32 scores and
softmax, P rounded to bf16 before P V, O stored bf16), never to the
composed route.

`fused_vocab_softmax_ce` (the final vocabulary projection and the
label-smoothed softmax CE in one op) goes through `VocabCEFn`
(ops/kernels/vocab_ce.py): on a CUDA tensor the forward, dh and dW
kernels, on a CPU tensor their plain versions.  `use_pallas` picks the
reference route's label semantics: true clamps labels into [0, V) as the
Pallas kernel does; false wraps -1 to V-1 and gives a NaN loss outside
[-V, V), as the reference's composition does.  On the card, with
`use_pallas` false, what the kernels do not take (D > 512, a dtype
other than float32) goes to `vk.composed_vocab_ce`, counted in
`kernels.composed_calls`.  `block_t` and `block_v` are kept for
serialization and do not route.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, opt_in, out, weak_scalar
from . import kernels
from .kernels import composed_calls
from .kernels import flash_attention as fk
from .kernels import vocab_ce as vk

CAUSAL_FILL = -1e9      # the reference's XLA compositions' causal fill


def composed_attention(q, k, v, bias, scale, causal, layout="nhtd",
                       n_head=None):
    """softmax(scale * Q K^T + bias [causal-filled]) V as torch ops, for
    either layout — the reference's `_xla_attention` (nhtd) and
    `_xla_attention_nthd`.  Softmax in float32, output in q's dtype; on
    bf16 operands the logits are bf16, scaled by the scale rounded to
    bf16 (as jnp applies a Python scale), and the weights are rounded
    to bf16 before the second product, as in the reference."""
    n, h, t_q, t_k, d = fk.dims(q, k, layout, n_head)
    if layout == "nthd":
        q4 = q.reshape(n, t_q, h, d).transpose(1, 2)
        k4 = k.reshape(n, t_k, h, d).transpose(1, 2)
        v4 = v.reshape(n, t_k, h, d).transpose(1, 2)
    else:
        q4, k4, v4 = q, k, v
    logits = torch.matmul(q4, k4.transpose(-1, -2))
    logits = logits * weak_scalar(scale, logits)
    if bias is not None:
        logits = logits + bias
    if causal:
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits,
                             torch.full((), CAUSAL_FILL, dtype=logits.dtype,
                                        device=q.device))
    weights = torch.softmax(logits.to(torch.float32), dim=-1)
    o = torch.matmul(weights.to(q.dtype), v4)
    if layout == "nthd":
        o = o.transpose(1, 2).reshape(n, t_q, h * d)
    return o


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
    n, h, _, t_k, d = fk.dims(q, k, layout, n_head)
    scale = attrs.get("scale")
    if scale is None:
        scale = d ** -0.5
    causal = bool(attrs.get("causal", False))
    if q.device.type == "meta":
        o, _lse = fk.flash_attention_fwd(q, k, v, bias, scale, causal,
                                         layout=layout, n_head=n_head)
        return out(Out=o)
    if (bias is not None and not fk.key_bias_ok(bias, n, t_k)) or (
            not attrs.get("use_pallas") and kernels.on_card(q)
            and not fk.kernel_takes(q, k, v, d)):
        composed_calls["flash_attention"] += 1
        return out(Out=composed_attention(q, k, v, bias, scale, causal,
                                          layout, n_head))
    o, _lse = fk.flash_attention(q, k, v, bias, scale, causal, layout,
                                 n_head)
    return out(Out=o)


@register_op("fused_vocab_softmax_ce")
def fused_vocab_softmax_ce(ctx, ins, attrs):
    """Loss (...) = per-token label-smoothed CE of Hidden (..., D) @ W
    (D, V) against Label (...), the logits never materialised."""
    hidden, w, label = first(ins, "Hidden"), first(ins, "W"), \
        first(ins, "Label")
    eps = float(attrs.get("epsilon", 0.0))
    if attrs.get("use_pallas", False):
        return out(Loss=vk.fused_vocab_ce(hidden, w, label, eps))
    if kernels.on_card(hidden) and not vk.kernel_takes(hidden, w):
        composed_calls["fused_vocab_softmax_ce"] += 1
        return out(Loss=vk.composed_vocab_ce(hidden, w, label, eps))
    return out(Loss=vk.fused_vocab_ce(hidden, w, label, eps,
                                      fill_labels=True))
