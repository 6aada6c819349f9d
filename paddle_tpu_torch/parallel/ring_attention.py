"""Sequence parallelism: ring attention and Ulysses over the `sp` axis.

The port of paddle_tpu/parallel/ring_attention.py.  The reference's
functions take GLOBAL q/k/v sharded over T inside a shard_map; the port
runs one process a rank, so each function here takes THIS RANK'S chunk
of q, k and v along T and returns this rank's chunk of the output
(ROADMAP C16).  Layouts as in ops/attention.py: "nhtd" (N, H, T, D), or
"nthd" (N, T, H*D) head-grouped with `n_head`.

- **Ring** (`ring_attention`): each rank keeps its T chunk of q; K/V
  chunks go round the ring (send to the next rank, receive from the
  previous) and each chunk runs through the flash kernel
  (`ops/kernels/flash_attention.flash_attention_fwd`: the CUDA kernel on
  the card, its plain version on the CPU) with the chunks' global
  `q_offset`/`k_offset`, returning (o, lse); the chunks are merged
  through their lse as the reference's `_merge` does.  Under `causal` a
  chunk wholly after this rank's queries is skipped: its merge weight
  is exactly 0, so skipping it changes no bit.  The backward
  (`_RingAttention.backward`) is the standard ring backward from the
  final O and lse: each chunk's dQ, dK, dV come from the flash backward
  kernels (`flash_attention_bwd`, the same offsets) with the final O and
  lse, which make P the global attention weights; dQ sums over the
  chunks, and each chunk's dK/dV accumulators travel round the ring with
  it and arrive home after the last step.  No lse cotangent is needed
  (the op does not expose lse).  Exact math both ways; the sums run in
  another order than one process's (tests state the tolerance).
- **Ulysses** (`ulysses_attention`): an all-to-all from the sequence
  axis to the head axis, the flash kernel (`FlashAttentionFn`) on H/sp
  heads over the whole T, and the all-to-all back; each all-to-all's
  backward is the inverse all-to-all.

`offset_launches` counts the flash forward and backward calls that
carry a non-zero offset (on the card each is a kernel launch).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from .collectives import _staged, all_to_all_grad

offset_launches: Counter = Counter()


def _axis_group(mesh, axis):
    group = mesh.group(axis)
    return group, int(mesh.shape[axis]), mesh.coordinate(axis)


def _rotate(tensors, group, n, me):
    """Each tensor sent to the next rank of the ring, the previous
    rank's received (one batch of point-to-point ops)."""
    if group is None or n == 1:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    ops, outs, backs = [], [], []
    for t in tensors:
        t, back = _staged(t.contiguous(), group)
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
        outs.append(r)
        backs.append(back)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o if b is None else o.to(b) for o, b in zip(outs, backs)]


def _lse_view(lse, o, layout, n_head):
    """The kernel's (N*H, Tq) lse broadcastable against o viewed per
    head: nhtd (N, H, Tq, 1); nthd (N, Tq, H, 1)."""
    if layout == "nthd":
        n, t = o.shape[0], o.shape[1]
        return lse.reshape(n, n_head, t).transpose(1, 2).unsqueeze(-1)
    n, h, t = o.shape[0], o.shape[1], o.shape[2]
    return lse.reshape(n, h, t, 1)


def _heads_view(o, layout, n_head):
    if layout == "nthd":
        return o.reshape(o.shape[0], o.shape[1], n_head, -1)
    return o


def _merge(o_a, lse_a, o_b, lse_b, layout, n_head):
    """Two normalized partial attentions combined through their
    logsumexps (the reference's `_merge`): float32 weights (float64 for
    float64 operands), o in o_a's dtype.  lse in the kernel's (N*H, Tq)
    form."""
    m = torch.maximum(lse_a, lse_b)
    wa, wb = torch.exp(lse_a - m), torch.exp(lse_b - m)
    va = _lse_view(wa, o_a, layout, n_head)
    vb = _lse_view(wb, o_a, layout, n_head)
    acc = torch.promote_types(o_a.dtype, torch.float32)
    oa = _heads_view(o_a, layout, n_head).to(acc)
    ob = _heads_view(o_b, layout, n_head).to(acc)
    o = ((oa * va + ob * vb) / (va + vb)).reshape(o_a.shape)
    return o.to(o_a.dtype), m + torch.log(wa + wb)


def _chunk_skipped(causal, q_off, k_off, t_q):
    """A chunk whose every key comes after every query of this rank."""
    return causal and k_off > q_off + t_q - 1


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, me, scale, causal, layout, n_head):
        from ..ops.kernels import flash_attention as fk

        t_axis = 1 if layout == "nthd" else 2
        t_l = q.shape[t_axis]
        q_off = me * t_l
        o = lse = None
        k_cur, v_cur = k, v
        for j in range(n):
            k_off = ((me - j) % n) * t_l
            if not _chunk_skipped(causal, q_off, k_off, t_l):
                if q_off or k_off:
                    offset_launches["flash_attention_fwd"] += 1
                o_j, lse_j = fk.flash_attention_fwd(
                    q, k_cur, v_cur, None, scale, causal, layout, n_head,
                    q_off, k_off)
                lse_j = lse_j.to(torch.promote_types(q.dtype,
                                                     torch.float32))
                if o is None:
                    o, lse = o_j, lse_j
                else:
                    o, lse = _merge(o, lse, o_j, lse_j, layout, n_head)
            if j < n - 1:
                k_cur, v_cur = _rotate((k_cur, v_cur), group, n, me)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (group, n, me, scale, causal, layout, n_head)
        return o

    @staticmethod
    def backward(ctx, do):
        from ..ops.kernels import flash_attention as fk

        q, k, v, o, lse = ctx.saved_tensors
        group, n, me, scale, causal, layout, n_head = ctx.cfg
        t_axis = 1 if layout == "nthd" else 2
        t_l = q.shape[t_axis]
        q_off = me * t_l
        acc = torch.promote_types(q.dtype, torch.float32)
        dq = torch.zeros(q.shape, dtype=acc, device=q.device)
        dk = torch.zeros(k.shape, dtype=acc, device=k.device)
        dv = torch.zeros(v.shape, dtype=acc, device=v.device)
        do = do.contiguous()
        k_cur, v_cur = k, v
        for j in range(n):
            k_off = ((me - j) % n) * t_l
            if not _chunk_skipped(causal, q_off, k_off, t_l):
                if q_off or k_off:
                    offset_launches["flash_attention_bwd"] += 1
                dq_j, dk_j, dv_j, _ = fk.flash_attention_bwd(
                    q, k_cur, v_cur, None, o, lse, do, None, scale, causal,
                    layout, n_head, q_off, k_off)
                dq = dq + dq_j.to(acc)
                dk = dk + dk_j.to(acc)
                dv = dv + dv_j.to(acc)
            # dK/dV travel with their chunk and are home after the
            # last step
            if j < n - 1:
                k_cur, v_cur, dk, dv = _rotate((k_cur, v_cur, dk, dv), group,
                                               n, me)
            else:
                dk, dv = _rotate((dk, dv), group, n, me)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def _layout_dims(q, layout, n_head):
    if layout == "nthd":
        if not n_head:
            raise ValueError("ring/ulysses attention layout='nthd' needs "
                             "n_head")
        return int(n_head), q.shape[-1] // int(n_head)
    return q.shape[1], q.shape[-1]


def ring_attention(q, k, v, mesh, axis: str = "sp", scale=None,
                   causal: bool = False, use_pallas=None, batch_axis=None,
                   layout: str = "nhtd", n_head=None):
    """This rank's chunk of the attention output over the T chunks of
    the `axis` ranks (see the module docstring).  q/k/v: this rank's
    chunks along T.  `use_pallas` and `batch_axis` are the reference's
    arguments: each chunk takes the flash kernel on the card, and the
    batch stays as each rank holds it."""
    del use_pallas, batch_axis
    h, d = _layout_dims(q, layout, n_head)
    if scale is None:
        scale = d ** -0.5
    group, n, me = _axis_group(mesh, axis)
    if q.device.type == "meta":
        return torch.empty_like(q)
    return _RingAttention.apply(q, k, v, group, n, me, float(scale),
                                bool(causal), layout,
                                h if layout == "nthd" else None)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", scale=None,
                      causal: bool = False, use_pallas=None,
                      batch_axis=None, layout: str = "nhtd", n_head=None):
    """Ulysses: all-to-all sequence -> heads, the flash kernel on this
    rank's H/sp heads over the whole T, all-to-all back.  q/k/v: this
    rank's chunks along T; H must divide by the axis size."""
    del use_pallas, batch_axis
    from ..ops.kernels import flash_attention as fk

    h, d = _layout_dims(q, layout, n_head)
    n = int(mesh.shape[axis])
    if h % n != 0:
        raise ValueError(f"Ulysses needs heads ({h}) divisible by mesh "
                         f"axis {axis!r} size ({n})")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "meta":
        return torch.empty_like(q)
    seq, head = (1, 2) if layout == "nthd" else (2, 1)
    qh, kh, vh = (all_to_all_grad(x, mesh, axis, head, seq)
                  for x in (q, k, v))
    oh, _ = fk.flash_attention(qh, kh, vh, None, scale, causal, layout,
                               h // n if layout == "nthd" else None)
    return all_to_all_grad(oh, mesh, axis, seq, head)


def sequence_parallel_attention(q, k, v, mesh, strategy, scale, causal,
                                layout, n_head, axis: str = "sp"):
    """The flash op's route on an `sp` mesh: values outside the op are
    replicated over the axis (as under GSPMD in the reference), so each
    rank takes its T chunk of q/k/v, runs `strategy` ("ring" or
    "ulysses") and gathers the output along T; the gradients take the
    reverse way."""
    from .tensor_parallel import AxisGroup, gather_from, scatter_to

    ax = AxisGroup(mesh, axis)
    t_axis = 1 if layout == "nthd" else 2
    ql, kl, vl = (scatter_to(x, ax, t_axis) for x in (q, k, v))
    fn = ulysses_attention if strategy == "ulysses" else ring_attention
    o = fn(ql, kl, vl, mesh, axis=axis, scale=scale, causal=causal,
           layout=layout, n_head=n_head)
    return gather_from(o.contiguous(), ax, t_axis)
