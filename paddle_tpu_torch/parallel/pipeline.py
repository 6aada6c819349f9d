"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

The port of paddle_tpu/parallel/pipeline.py.  The reference runs S
copies of one stage function inside a shard_map, a `lax.scan` over
n_micro + S - 1 ticks with `ppermute` handing each microbatch's
activation to the next stage, and gets the backward from autodiff.  The
port runs one process a rank, so each rank runs only its own stage:

- forward (`_GPipe.forward`): every microbatch in order; stage 0 takes
  microbatch m of the input, every later stage receives it from the
  stage before (`recv`), runs its stage function under autograd and
  sends the result on (`isend`); the last stage's outputs are
  broadcast to every rank of the axis, so the pipeline's output is
  replicated over it as the reference's out_spec says;
- backward (`_GPipe.backward`): the backwards in reverse microbatch
  order; the last stage takes the cotangent of its outputs (the same on
  every rank), every stage differentiates its saved graph of each
  microbatch and sends the input cotangent back; stage 0 broadcasts the
  input cotangents, so the input's gradient is replicated too.  Each
  rank returns the gradients of its own stage's parameters.

Each rank holds its stage's parameters only: `gpipe`'s `stacked_params`
leaves are this rank's (1, ...) stage slice, the reference's P(axis)
shard (ROADMAP C16); the microbatched input is whole on every rank, or,
with `scatter_inputs=True`, this rank's n_micro/S microbatches, which
the schedule gathers to stage 0.  With `batch_axis` the microbatches
hold this rank's rows of the data axis (each data group pipelines its
own shard); `gpipe_loss_and_grad` then averages the loss and the
gradients over it.  Activations and parameters are pytrees, every leaf
of the activation keeping its shape through every stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .collectives import _gather_list, _staged


def _send(t, dst, group):
    t, _ = _staged(t.detach().contiguous(), group)
    return dist.isend(t, dst, group=group)


def _recv(like, src, group):
    buf, back = _staged(torch.empty_like(like), group)
    dist.recv(buf, src, group=group)
    return buf if back is None else buf.to(back)


def _broadcast(ts, src, group):
    out = []
    for t in ts:
        t, back = _staged(t.contiguous(), group)
        dist.broadcast(t, src, group=group)
        out.append(t if back is None else t.to(back))
    return out


class _GPipe(torch.autograd.Function):
    """flat = the input leaves (n_micro, ...) then this stage's param
    leaves; returns the output leaves (n_micro, ...), replicated."""

    @staticmethod
    def forward(ctx, stage_fn, group, s, me, n_x, *flat):
        xs, params = flat[:n_x], flat[n_x:]
        n_micro = xs[0].shape[0]
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else [0]
        saved, outs, sends = [], [], []
        with torch.enable_grad():
            p_in = [p.detach().requires_grad_(p.requires_grad)
                    for p in params]
            for m in range(n_micro):
                if me == 0:
                    x_in = [x[m] for x in xs]
                else:
                    x_in = [_recv(x[m], ranks[me - 1], group) for x in xs]
                x_in = [t.detach().requires_grad_(t.is_floating_point())
                        for t in x_in]
                y = list(stage_fn(p_in, x_in, m))
                saved.append((x_in, y))
                if me < s - 1:
                    sends += [_send(t, ranks[me + 1], group) for t in y]
                else:
                    outs.append([t.detach() for t in y])
        for req in sends:
            req.wait()
        if me == s - 1:
            out = [torch.stack([o[i] for o in outs]) for i in range(n_x)]
        else:
            out = [torch.empty_like(x) for x in xs]
        if s > 1:
            out = _broadcast(out, ranks[s - 1], group)
        ctx.saved, ctx.p_in = saved, p_in
        ctx.cfg = (group, s, me, ranks, n_micro)
        ctx.xs_meta = [(x.shape, x.dtype) for x in xs]
        return tuple(out)

    @staticmethod
    def backward(ctx, *douts):
        group, s, me, ranks, n_micro = ctx.cfg
        saved, p_in = ctx.saved, ctx.p_in
        pgrads = [None] * len(p_in)
        dx_stage0, sends = [None] * n_micro, []
        for m in reversed(range(n_micro)):
            x_in, y = saved[m]
            if me == s - 1:
                dy = [d[m] if d is not None else torch.zeros_like(t)
                      for d, t in zip(douts, y)]
            else:
                dy = [_recv(t, ranks[me + 1], group) for t in y]
            pairs = [(t, g) for t, g in zip(y, dy) if t.requires_grad]
            wrt_x = [t for t in x_in if t.requires_grad]
            wrt_p = [p for p in p_in if p.requires_grad]
            grads = torch.autograd.grad([t for t, _ in pairs], wrt_x + wrt_p,
                                        [g for _, g in pairs],
                                        allow_unused=True) if pairs else \
                [None] * (len(wrt_x) + len(wrt_p))
            it = iter(grads[:len(wrt_x)])
            dx = [(next(it) if t.requires_grad else None) for t in x_in]
            dx = [torch.zeros_like(t) if g is None else g
                  for t, g in zip(x_in, dx)]
            it = iter(grads[len(wrt_x):])
            for i, p in enumerate(p_in):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        pgrads[i] = g if pgrads[i] is None else pgrads[i] + g
            if me > 0:
                sends += [_send(t, ranks[me - 1], group) for t in dx]
            else:
                dx_stage0[m] = dx
        for req in sends:
            req.wait()
        if me == 0:
            dxs = [torch.stack([d[i] for d in dx_stage0])
                   for i in range(len(ctx.xs_meta))]
        else:
            dxs = [torch.empty(shape, dtype=dtype, device=douts[0].device)
                   for shape, dtype in ctx.xs_meta]
        if s > 1:
            dxs = _broadcast(dxs, ranks[0], group)
        dxs = [d if d.is_floating_point() else None for d in dxs]
        pgrads = [torch.zeros_like(p) if g is None and p.requires_grad
                  else g for p, g in zip(p_in, pgrads)]
        # saved graphs are freed with the context
        ctx.saved = ctx.p_in = None
        return (None, None, None, None, None, *dxs, *pgrads)


def run_schedule(stage_fn, mesh, axis, x_leaves, param_leaves):
    """The GPipe schedule on flat lists: `stage_fn(param_leaves,
    x_leaves_of_one_microbatch, microbatch_index)` -> the same leaves'
    next values; returns the output leaves (n_micro, ...), replicated
    over `axis`."""
    s = int(mesh.shape[axis])
    me = mesh.coordinate(axis) if s > 1 else 0
    group = mesh.group(axis) if s > 1 else None
    return list(_GPipe.apply(stage_fn, group, s, me, len(x_leaves),
                             *x_leaves, *param_leaves))


def gpipe(stage_fn, mesh, axis: str = "pp", batch_axis=None,
          scatter_inputs=None):
    """A pipelined apply `fn(stacked_params, micro_x) -> out`
    (the module docstring): `stage_fn(params_s, x) -> y` with x and y
    pytrees of one structure and shapes; `stacked_params` leaves this
    rank's (1, ...) stage slice; `micro_x` leaves (n_micro, B_micro,
    ...), whole on every rank unless `scatter_inputs` is True.  `out`
    has micro_x's structure, replicated over `axis`."""
    s = int(mesh.shape[axis])

    def pipelined(stacked_params, micro_x):
        x_leaves, x_spec = pytree.tree_flatten(micro_x)
        if not x_leaves:
            raise ValueError("gpipe: micro_x has no array leaves")
        n_micro = x_leaves[0].shape[0]
        if any(leaf.shape[0] != n_micro for leaf in x_leaves):
            raise ValueError(
                "gpipe: every micro_x leaf needs the same leading "
                f"(n_micro) dim; got {[tuple(x.shape) for x in x_leaves]}")
        if scatter_inputs:
            # this rank's n_micro/S microbatches: gathered to the whole
            group = mesh.group(axis) if s > 1 else None
            x_leaves = [torch.cat(_gather_list(x, group, s), dim=0)
                        if group is not None else x for x in x_leaves]
        p_leaves, p_spec = pytree.tree_flatten(stacked_params)
        if any(p.shape[0] != 1 for p in p_leaves):
            raise ValueError(
                "gpipe: stacked_params leaves are this rank's (1, ...) "
                f"stage slice; got {[tuple(p.shape) for p in p_leaves]}")

        def stage(params, xs, _m):
            p = pytree.tree_unflatten([t[0] for t in params], p_spec)
            y = stage_fn(p, pytree.tree_unflatten(list(xs), x_spec))
            return pytree.tree_flatten(y)[0]

        out = run_schedule(stage, mesh, axis, x_leaves, p_leaves)
        return pytree.tree_unflatten(out, x_spec)

    del batch_axis
    return pipelined


def gpipe_loss_and_grad(stage_fn, loss_fn, mesh, axis: str = "pp",
                        batch_axis=None, scatter_inputs=None):
    """(stacked_params, micro_x, micro_y) -> (mean loss, gradients of
    this rank's stage slice) through the pipeline; `loss_fn(out_m, y_m)`
    per microbatch, averaged.  With `batch_axis` the loss and gradients
    are averaged over that data axis too."""
    fwd = gpipe(stage_fn, mesh, axis, batch_axis=batch_axis,
                scatter_inputs=scatter_inputs)

    def loss_and_grad(params, micro_x, micro_y):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        p = pytree.tree_unflatten(leaves, spec)
        with torch.enable_grad():
            out = fwd(p, micro_x)
            n_micro = pytree.tree_flatten(out)[0][0].shape[0]
            if scatter_inputs:
                # the labels arrive scattered as the inputs do
                group = mesh.group(axis) if mesh.shape[axis] > 1 else None
                micro_y = pytree.tree_map(
                    lambda y: torch.cat(_gather_list(
                        y, group, mesh.shape[axis]), 0)
                    if group is not None else y, micro_y)
            losses = [loss_fn(pytree.tree_map(lambda t: t[m], out),
                              pytree.tree_map(lambda t: t[m], micro_y))
                      for m in range(n_micro)]
            loss = torch.stack(losses).mean()
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if batch_axis and mesh.shape.get(batch_axis, 1) > 1:
            from .collectives import _all_reduce

            group, n = mesh.group(batch_axis), mesh.shape[batch_axis]
            loss = _all_reduce(loss, group) / n
            grads = [_all_reduce(g, group) / n for g in grads]
        return loss, pytree.tree_unflatten(list(grads), spec)

    return loss_and_grad
