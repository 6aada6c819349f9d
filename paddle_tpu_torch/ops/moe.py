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


def _experts(buf, w1, b1, w2, b2, act, mp=None):
    """The experts' FFN on (E, rows, D) dispatch rows: two batched
    products over E.  `mp`: a tensor-parallel run whose axis splits each
    expert's hidden dim (W1 (E, D, H/mp), W2 (E, H/mp, D)): the
    dispatch rows enter as a copy, the first bias as this rank's chunk
    and the second product's partial sum is all-reduced before B2."""
    if mp is not None:
        from ..parallel.tensor_parallel import (copy_to, reduce_from,
                                                scatter_to)

        if torch.is_grad_enabled() and buf.requires_grad:
            buf = copy_to(buf, mp.tp)
        if b1 is not None:
            b1 = scatter_to(b1, mp.tp, 1)
    h = torch.bmm(buf, w1)
    if b1 is not None:
        h = h + b1[:, None, :]
    y = torch.bmm(act(h), w2)
    if mp is not None:
        y = reduce_from(y, mp.tp)
    if b2 is not None:
        y = y + b2[:, None, :]
    return y


def _combine(plan, rows, probs, y_rows, top_k, dtype, spare):
    """Each kept choice's expert row times its gate probability (top-2:
    over p1 + p2), the choices added in k order."""
    gates = [probs.gather(1, idx[:, None])[:, 0] for idx, _, _ in plan]
    if top_k == 2:
        chosen = gates[0] + gates[1]
        gates = [g / torch.clamp(chosen, min=1e-9) for g in gates]
    yf = None
    for (idx, pos, fits), r, g in zip(plan, rows, gates):
        term = g.to(dtype)[:, None] * y_rows.index_select(
            0, r.clamp(max=spare - 1))
        term = torch.where(fits[:, None], term, torch.zeros(
            (), dtype=term.dtype, device=term.device))
        yf = term if yf is None else yf + term
    return yf


def _plan_rows(logits, top_k, cap, e):
    with torch.no_grad():
        plan = route(logits.detach(), top_k, cap)
    spare = e * cap
    rows = [torch.where(fits, idx * cap + pos, spare)
            for idx, pos, fits in plan]
    return plan, rows, spare


def _log_drops(plans):
    """Append the call's dropped token choices to `drop_log`."""
    if drop_log is not None:
        drop_log.append(sum((~fits).sum() for plan in plans
                            for _, _, fits in plan))


# When a list, each moe_ffn call appends its count of dropped token
# choices, over its groups (on an ep mesh: over this rank's group), a 0-d
# device tensor; tests and chip_smoke read them
drop_log = None


def moe_grouped(xf, gate_w, w1, b1, w2, b2, top_k=1, cap_factor=1.25,
                act=torch.relu, groups=1, mp=None):
    """The op's function on (B, D) tokens in one process, with the
    reference's GShard grouping: the tokens in `groups` contiguous groups
    of B/G, each routed alone with its own capacity C = ceil(B/G * top_k
    / E * capacity_factor); AuxLoss and Fraction over every token.  G = 1
    is the ungrouped op; G = ep is what the op computes on an ep mesh.
    `mp`: see `_experts`.  Returns (Out (B, D), AuxLoss (1,), Fraction
    (E,))."""
    b, d = xf.shape
    e = gate_w.shape[1]
    if b % groups != 0:
        raise ValueError(
            f"moe_ffn on an ep={groups} mesh needs the token count ({b}) "
            f"divisible by ep (per-group GShard capacity)")
    bg = b // groups
    cap = max(1, int(math.ceil(bg * top_k / e * cap_factor)))
    logits = torch.matmul(xf, gate_w).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (B, E)
    # one dispatch buffer for every group: expert e's rows of group g at
    # e * G*C + g * C + slot, so the experts' products run once over
    # (E, G*C, D), the shapes an ep rank runs for its experts
    plans, rows = [], []
    spare = e * groups * cap
    for g in range(groups):
        plan, r, _ = _plan_rows(logits[g * bg:(g + 1) * bg], top_k, cap, e)
        plans.append(plan)
        rows.append([torch.where(
            fits, (idx * groups + g) * cap + pos, spare)
            for idx, pos, fits in plan])
    _log_drops(plans)
    buf = xf.new_zeros((spare + 1, d))
    for g in range(groups):
        for r in rows[g]:
            buf = buf.index_copy(0, r, xf[g * bg:(g + 1) * bg])
    y_e = _experts(buf[:spare].reshape(e, groups * cap, d), w1, b1, w2, b2,
                   act, mp).reshape(spare, d)
    outs = [_combine(plans[g], rows[g], probs[g * bg:(g + 1) * bg], y_e,
                     top_k, xf.dtype, spare) for g in range(groups)]
    yf = outs[0] if groups == 1 else torch.cat(outs)
    return (yf,) + _aux(logits, probs, e)


def _aux(logits, probs, e):
    top1 = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       e).to(torch.float32)
    fraction = top1.mean(dim=0)
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return aux.reshape(1), fraction


def _moe_ep(xf, gate_w, w1, b1, w2, b2, top_k, cap_factor, act, mesh, mp):
    """The op on an ep mesh, this rank's tokens replicated over ep: the
    rank routes token group `ep coordinate` (G = ep), dispatches its rows
    to the experts' ranks (all-to-all over ep), runs its E/ep experts on
    every group's rows, returns them (the inverse all-to-all), combines
    its group and all-gathers the groups.  Every rank computes every
    token's gate logits and probabilities (AuxLoss and Fraction are over
    all of them) and routes its group's rows of them, so a token routes
    on the bits one process gives it.  The experts' products run over
    (E/ep, G*C, D), each expert's rows of every group, as
    `moe_grouped`'s run over (E, G*C, D)."""
    from ..parallel.collectives import all_to_all_grad
    from ..parallel.tensor_parallel import AxisGroup, gather_from, scatter_to

    ep = mesh.shape["ep"]
    ax = AxisGroup(mesh, "ep")
    b, d = xf.shape
    e = gate_w.shape[1]
    if b % ep != 0:
        raise ValueError(
            f"moe_ffn on an ep={ep} mesh needs the token count ({b}) "
            f"divisible by ep (per-group GShard capacity)")
    if w1.shape[0] * ep != e:
        raise ValueError(
            f"moe_ffn on an ep={ep} mesh: the expert weights hold "
            f"{w1.shape[0]} of {e} experts; shard their E dim over ep "
            f"(megatron_transformer_rules(moe_axis='ep'))")
    bg = b // ep
    cap = max(1, int(math.ceil(bg * top_k / e * cap_factor)))
    logits_all = torch.matmul(xf, gate_w).to(torch.float32)
    probs_all = torch.softmax(logits_all, dim=-1)
    aux, fraction = _aux(logits_all, probs_all, e)
    # this rank's group: its tokens, and its rows of every token's gate
    # logits and probabilities (the cotangents all-gathered back)
    xg, lg, pg = (scatter_to(t, ax, 0)
                  for t in (xf, logits_all, probs_all))
    plan, rows, spare = _plan_rows(lg, top_k, cap, e)
    _log_drops([plan])
    buf = xg.new_zeros((spare + 1, d))
    for r in rows:
        buf = buf.index_copy(0, r, xg)
    # (E, C, D) -> this rank's experts' rows of every group (E/ep, G*C, D)
    ex_in = all_to_all_grad(buf[:spare].reshape(e, cap, d), mesh, "ep", 0,
                            1)
    ex_out = _experts(ex_in, w1, b1, w2, b2, act, mp)
    y_e = all_to_all_grad(ex_out, mesh, "ep", 1, 0)
    yg = _combine(plan, rows, pg, y_e.reshape(spare, d), top_k, xf.dtype,
                  spare)
    return gather_from(yg.contiguous(), ax, 0), aux, fraction


class _DataGather(torch.autograd.Function):
    """A rank's token rows -> every data rank's rows (the global batch);
    the backward sums the cotangents of this rank's rows over the data
    ranks (each rank differentiates the whole batch's tokens)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x, dim=0)

    @staticmethod
    def backward(ctx, g):
        dg = ctx.group
        g = dg.all_reduce(g.contiguous())
        rows = g.shape[0] // dg.n
        return g[dg.index * rows:(dg.index + 1) * rows], None


@register_op("moe_ffn")
def moe_ffn(ctx, ins, attrs):
    """X (..., D); GateW (D, E); W1 (E, D, H); B1 (E, H); W2 (E, H, D);
    B2 (E, D).  Outputs Out (..., D), AuxLoss (1,) and Fraction (E,).
    In a data-parallel step (`ctx.cross_rank`) the tokens of every data
    rank route together, as in the reference's global program: this
    rank's rows are gathered, the op runs on all of them and keeps its
    rows.  Under a CompiledProgram whose mesh has an `ep` axis the
    tokens route in G = ep groups (`_moe_ep`)."""
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
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    if x.device.type == "meta":
        return {"Out": [torch.empty_like(x)],
                "AuxLoss": [x.new_empty((1,), dtype=torch.float32)],
                "Fraction": [x.new_empty((e,), dtype=torch.float32)]}
    xf = x.reshape(-1, d)
    dg = ctx.cross_rank
    if dg is not None:
        xf = _DataGather.apply(xf, dg)
    from ..parallel.mesh import get_executing_mesh

    mesh = get_executing_mesh()
    mp = ctx.mp
    if mesh is not None and mesh.shape.get("ep", 1) > 1:
        yf, aux, fraction = _moe_ep(xf, gate_w, w1, b1, w2, b2, top_k,
                                    cap_factor, act, mesh, mp)
    else:
        yf, aux, fraction = moe_grouped(xf, gate_w, w1, b1, w2, b2, top_k,
                                        cap_factor, act, mp=mp)
    if dg is not None:
        rows = yf.shape[0] // dg.n
        yf = yf[dg.index * rows:(dg.index + 1) * rows]
    return {"Out": [yf.reshape(lead + (d,))], "AuxLoss": [aux],
            "Fraction": [fraction]}
