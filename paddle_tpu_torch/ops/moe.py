"""Mixture-of-Experts FFN: the port of paddle_tpu/ops/moe.py (Switch /
GShard routing; no reference Fluid op, no Pallas kernel).

The same function as the reference, computed by index instead of by
one-hot einsums.  The reference builds dense (B, E, C) dispatch and
combine tensors and contracts them with the tokens; at the bench's
widths (16384 tokens, 8 experts, capacity 2560) each is 335 M elements
and the dispatch product alone costs four times the experts' FFN.  Here:

- the routing plan per token and choice: the expert (argmax of the gate
  logits with earlier choices masked out, ties to the lower expert), its
  slot (an exclusive cumsum over the tokens of that expert's choices,
  offset by the slots earlier choices filled) and whether the slot is
  below the capacity C = ceil(B * top_k / E * capacity_factor);
- dispatch: each kept token's row copied into an (E * C, D) buffer at
  expert * C + slot (`index_copy`; dropped tokens go to one spare row
  that is cut off);
- the experts: two batched products over E (`torch.bmm`, as the
  reference's einsums are XLA products, not Pallas kernels);
- combine: each kept choice's expert row gathered back times its gate
  probability (top-2: divided by p1 + p2, the probability mass of the
  chosen experts), the choices added in the reference's k order.

Each output element of the reference's dispatch product has one
non-zero term times 1.0, so the copy gives the same values; top-1
combine is one product, as there.  Top-2 combine adds two products, in
another order than the reference's contraction may (tests state the
tolerance).  Gradients reach X, GateW, W1, B1, W2 and B2 through the
gate probabilities and the copies; the plan carries none.

AuxLoss is the Switch load-balancing loss E * sum_e(fraction_e *
mean_prob_e) over the top-1 argmax of all tokens; Fraction (E,) is the
share of tokens whose top-1 choice is each expert.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import first, opt_in

_ACTS = {"relu": torch.relu, "gelu": torch.nn.functional.gelu,
         "tanh": torch.tanh, "identity": lambda v: v, None: torch.relu}


def _refuse_ep_mesh(ctx):
    """One device runs one token group (the reference's G = 1).  A run
    on a mesh with an `ep` axis (the reference's grouped GShard layout,
    one group per ep shard) is not ported."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is not None and dict(mesh.shape).get("ep", 1) > 1:
        raise NotImplementedError(
            "moe_ffn on an ep mesh (grouped GShard capacity and the "
            "expert all-to-alls) is not ported yet: ROADMAP A step 10 "
            "(parallel)")


def route(logits, top_k, cap):
    """The routing plan of (B, E) float32 gate logits: per choice k, the
    (B,) expert ids, slots within the expert's buffer and whether the
    slot is below `cap`, as the reference assigns them (token order
    within an expert; a later choice's slots after every slot an
    earlier choice filled)."""
    b, e = logits.shape
    used = torch.zeros((b, e), dtype=torch.bool, device=logits.device)
    fill = torch.zeros((e,), dtype=torch.int64, device=logits.device)
    plan = []
    for _ in range(top_k):
        masked = logits.masked_fill(used, float("-inf"))
        idx = torch.argmax(masked, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e)          # int64
        # the exclusive cumsum over the tokens, taken along the last dim
        # of the (E, B) transpose: a scan over the outer dim of (B, E)
        # with E columns took 2.9 ms a layer at B = 16384 on the H100
        before = torch.cumsum(onehot.t().contiguous(), dim=1).t() - onehot
        pos = before.gather(1, idx[:, None])[:, 0] + fill[idx]
        fill = fill + onehot.sum(dim=0)
        plan.append((idx, pos, pos < cap))
        used = used | onehot.to(torch.bool)
    return plan


@register_op("moe_ffn")
def moe_ffn(ctx, ins, attrs):
    """X (..., D); GateW (D, E); W1 (E, D, H); B1 (E, H); W2 (E, H, D);
    B2 (E, D).  Outputs Out (..., D), AuxLoss (1,) and Fraction (E,)."""
    x = first(ins, "X")
    gate_w = first(ins, "GateW")
    w1, b1 = first(ins, "W1"), opt_in(ins, "B1")
    w2, b2 = first(ins, "W2"), opt_in(ins, "B2")
    top_k = int(attrs.get("top_k", 1))
    cap_factor = float(attrs.get("capacity_factor", 1.25))
    act = _ACTS[attrs.get("act", "relu")]
    if top_k not in (1, 2):
        raise ValueError(f"moe_ffn: top_k must be 1 or 2, got {top_k}")
    e = gate_w.shape[1]
    if top_k > e:
        raise ValueError(
            f"moe_ffn: top_k={top_k} needs at least that many experts, "
            f"got E={e} (the second pass would re-route to the same "
            f"expert)")
    _refuse_ep_mesh(ctx)
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    cap = max(1, int(math.ceil(b * top_k / e * cap_factor)))

    logits = torch.matmul(xf, gate_w).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (B, E)
    with torch.no_grad():
        plan = route(logits.detach(), top_k, cap)
    spare = e * cap                          # the dropped tokens' row
    rows = [torch.where(fits, idx * cap + pos, spare)
            for idx, pos, fits in plan]

    buf = xf.new_zeros((spare + 1, d))
    for r in rows:
        buf = buf.index_copy(0, r, xf)
    h = torch.bmm(buf[:spare].reshape(e, cap, d), w1)
    if b1 is not None:
        h = h + b1[:, None, :]
    y_e = torch.bmm(act(h), w2)
    if b2 is not None:
        y_e = y_e + b2[:, None, :]
    y_e = y_e.reshape(spare, d)

    gates = [probs.gather(1, idx[:, None])[:, 0] for idx, _, _ in plan]
    if top_k == 2:
        chosen = gates[0] + gates[1]
        gates = [g / torch.clamp(chosen, min=1e-9) for g in gates]
    yf = None
    for (idx, pos, fits), r, g in zip(plan, rows, gates):
        term = g.to(xf.dtype)[:, None] * y_e.index_select(
            0, r.clamp(max=spare - 1))
        term = torch.where(fits[:, None], term, torch.zeros(
            (), dtype=term.dtype, device=term.device))
        yf = term if yf is None else yf + term

    top1 = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       e).to(torch.float32)
    fraction = top1.mean(dim=0)
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return {"Out": [yf.reshape(lead + (d,))], "AuxLoss": [aux.reshape(1)],
            "Fraction": [fraction]}
