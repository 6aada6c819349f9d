"""Functional collectives over a mesh axis, on torch.distributed.

The port of paddle_tpu/parallel/collectives.py.  The reference's
functions are shard_map wrappers that take a GLOBAL array sharded on
`shard_dim` and return a global array; the port runs one process per
rank, so each function here takes THIS RANK'S piece and returns this
rank's piece of the result (ROADMAP C16): for `all_reduce` the rank's
shard of the stacked input (size 1 along `shard_dim`) in, the reduced
value out; for `all_gather` a shard in, the whole value out; for
`reduce_scatter` a whole per-rank value in, this rank's chunk of the sum
out.  The group is the mesh axis's (`Mesh.group(axis)`); a one-rank axis
needs none and each function returns its input's value.

Only calls that exist in every torch this package runs on are used: the
list form of `all_gather`, `all_reduce`, `all_to_all_single` and P2P
`batch_isend_irecv`; `reduce_scatter` is an all-reduce then a chunk
(same sums, on every backend).  On a gloo group a CUDA tensor goes
through a host copy (gloo runs most collectives on CPU tensors only):
the path several ranks on one card take, since NCCL refuses two ranks
of one communicator on one device.

The quantized all-reduce (EQuARX, arxiv 2506.17615) keeps the
reference's bits: `torch.round` rounds half to even as `jnp.rint` does,
scales are float32 max|block| / 127 with 1 for a zero block, and every
sum over the ranks runs in rank order, rank 0 first (an all-gather,
then the sum), as XLA's reduction and all-reduce do on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_QUANT_BLOCK = 256
DEFAULT_QUANT_FLOOR = 4096


def _resolve(mesh, axis):
    """(group, n) of `axis` (a name, a tuple of names, or a process
    group) on `mesh` (None: the executing mesh)."""
    if axis is None or isinstance(axis, dist.ProcessGroup):
        n = 1 if axis is None else dist.get_world_size(axis)
        return axis, n
    if mesh is None:
        from .mesh import get_executing_mesh

        mesh = get_executing_mesh()
        if mesh is None:
            raise ValueError(f"collective over {axis!r} needs a mesh: "
                             f"pass mesh= or run under executing_mesh")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return mesh.group(axes), n


def _reduce_op(op: str):
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    if op not in ops and op != "mean":
        raise ValueError(op)
    return ops.get(op, dist.ReduceOp.SUM)


def _staged(x: torch.Tensor, group):
    """(the tensor the group's backend takes, the device to return to or
    None): a CUDA tensor on a gloo group as a host copy."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu(), x.device
    return x, None


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    y = x.detach().clone().contiguous()
    if group is not None:
        t, back = _staged(y, group)
        dist.all_reduce(t, op=_reduce_op(op), group=group)
        y = t if back is None else t.to(back)
    return y


def _gather_list(x: torch.Tensor, group, n: int):
    x = x.detach().contiguous()
    if group is None:
        return [x]
    t, back = _staged(x, group)
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    return out if back is None else [o.to(back) for o in out]


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over dim 0 (one slice a rank)."""
    t, back = _staged(send.contiguous(), group)
    recv = torch.empty_like(t)
    dist.all_to_all_single(recv, t, group=group)
    return recv if back is None else recv.to(back)


def psum(x, axis_name, mesh=None):
    """Sum of every rank's `x` over the axis (the reference's
    lax.psum)."""
    group, _ = _resolve(mesh, axis_name)
    return _all_reduce(x, group)


def all_reduce(x, mesh, axis: str, shard_dim: int = 0, op: str = "sum"):
    """Reduce the ranks' values to one replicated result (the PE
    all-reduce, details/all_reduce_op_handle.cc).  `x` is this rank's
    shard of the reference's stacked input (size 1 along `shard_dim`);
    the result has that dim removed."""
    group, n = _resolve(mesh, axis)
    r = _all_reduce(x, group, op)
    if op == "mean":
        r = r / n
    return r.squeeze(shard_dim)


def all_gather(x, mesh, axis: str, shard_dim: int = 0):
    """This rank's shard in, the whole value out: the ranks' shards
    concatenated along `shard_dim` in axis order."""
    group, n = _resolve(mesh, axis)
    return torch.cat(_gather_list(x, group, n), dim=shard_dim)


def reduce_scatter(x, mesh, axis: str, shard_dim: int = 0):
    """Each rank's whole value in, this rank's chunk of their sum along
    `shard_dim` out (the kReduce build-strategy mode)."""
    group, n = _resolve(mesh, axis)
    r = _all_reduce(x, group)
    if group is None:
        return r
    idx = dist.get_group_rank(group, dist.get_rank())
    return r.chunk(n, dim=shard_dim)[idx].contiguous()


def ppermute(x, mesh, axis: str, perm, shard_dim: int = 0):
    """Send this rank's shard along `perm` ((source, destination) axis
    indices); a rank nobody sends to gets zeros, as lax.ppermute."""
    group, n = _resolve(mesh, axis)
    x = x.detach().contiguous()
    if group is None:
        return x.clone() if any(s == d == 0 for s, d in perm) \
            else torch.zeros_like(x)
    me = dist.get_group_rank(group, dist.get_rank())
    ranks = dist.get_process_group_ranks(group)
    x, back = _staged(x, group)
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out if back is None else out.to(back)


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """Ulysses-style head/sequence exchange: this rank's shard (split
    over `concat_dim`) in, its shard split over `split_dim` out; the
    global value is unchanged."""
    group, n = _resolve(mesh, axis)
    if group is None:
        return x.clone()
    recv = _all_to_all(torch.stack(x.chunk(n, dim=split_dim)), group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """`all_to_all` over `axis`; the backward the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.cfg = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x.contiguous(), mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.cfg
        return (all_to_all(g.contiguous(), mesh, axis, concat_dim,
                           split_dim), None, None, None, None)


def all_to_all_grad(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """`all_to_all` inside autograd: its cotangent takes the inverse
    exchange (Ulysses, ep's dispatch and combine)."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def barrier(mesh, axis: str):
    """Synchronization barrier (the reference's send_barrier /
    fetch_barrier ops): a one-element all-reduce every backend runs.
    Returns the axis size, as the reference's psum of ones."""
    group, n = _resolve(mesh, axis)
    dev = torch.device("cuda", torch.cuda.current_device()) if (
        group is not None and dist.get_backend(group) == "nccl") \
        else torch.device("cpu")
    return _all_reduce(torch.ones((), device=dev), group)


# ---------------------------------------------------------------------------
# Quantized gradient all-reduce (EQuARX, arxiv 2506.17615)
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def quantize_blockwise(x, block_size: int = DEFAULT_QUANT_BLOCK):
    """Symmetric per-block int8 quantization of a (..., block) array:
    scale = max|block| / 127 in float32 (a zero block gets scale 1 so it
    round-trips to exact zeros); round half to even.  Returns (q int8 of
    x.shape, scales float32 of x.shape[:-1])."""
    assert x.shape[-1] == block_size, (x.shape, block_size)
    amax = torch.amax(torch.abs(x), dim=-1)
    scales = torch.where(amax > 0, amax / 127.0,
                         torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_blockwise(q, scales, dtype=torch.float32):
    return q.to(dtype) * scales[..., None].to(dtype)


def _ordered_sum(x, group, n):
    """The sum of the ranks' `x` in rank order, rank 0 first: the same
    bytes on every rank, whatever the backend's all-reduce order."""
    parts = _gather_list(x, group, n)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc


def _exact(x, group, inv, op, n):
    r = _ordered_sum(x, group, n)
    # the reference multiplies by inv cast to the value's dtype (an int
    # mean therefore scales by int(1/n))
    return r * torch.tensor(inv, dtype=torch.float64).to(r.dtype) \
        if op == "mean" else r


def _quantizable(x, n_ranks, block_size, min_quant_numel):
    return (x.is_floating_point()
            and _numel(x.shape) >= max(min_quant_numel,
                                       n_ranks * block_size))


def _chunks(x, n_ranks, block_size):
    size = _numel(x.shape)
    flat = x.to(torch.float32).reshape(-1)
    pad = (-size) % (n_ranks * block_size)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n_ranks, -1, block_size), size


def quantized_all_reduce_local(x, axis, n_ranks: int,
                               block_size: int = DEFAULT_QUANT_BLOCK,
                               min_quant_numel: int = DEFAULT_QUANT_FLOOR,
                               op: str = "mean", mesh=None):
    """Blockwise-int8 all-reduce of this rank's full-shaped partial
    value `x` over `axis` (a mesh axis name or a process group): the
    EQuARX two-phase exchange of the reference.

      phase 1 (reduce-scatter): split into one chunk per rank, quantize
        each chunk per `block_size` block, all_to_all so rank i receives
        everyone's chunk i, dequantize into float32 and sum in rank
        order;
      phase 2 (all-gather): re-quantize the reduced chunk, all_gather
        payload + scales, dequantize.

    Every rank ends with the same bytes: the sums are fixed-order and
    phase 2's gathered bytes are shared.  Falls back to the exact
    all-reduce below `min_quant_numel` elements (or one block a rank)
    and for non-float inputs.  op: "sum" or "mean"."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    group, _ = _resolve(mesh, axis)
    inv = 1.0 / n_ranks if op == "mean" else 1.0
    if not _quantizable(x, n_ranks, block_size, min_quant_numel):
        return _exact(x, group, inv, op, n_ranks)
    orig_dtype = x.dtype
    chunks, size = _chunks(x.detach(), n_ranks, block_size)

    q, scales = quantize_blockwise(chunks, block_size)
    if group is not None:
        q, scales = _all_to_all(q, group), _all_to_all(scales, group)
    deq = dequantize_blockwise(q, scales)
    reduced = deq[0]
    for i in range(1, deq.shape[0]):
        reduced = reduced + deq[i]

    q2, s2 = quantize_blockwise(reduced, block_size)
    q2 = torch.cat(_gather_list(q2, group, n_ranks), dim=0)
    s2 = torch.cat(_gather_list(s2, group, n_ranks), dim=0)
    out = dequantize_blockwise(q2, s2).reshape(-1)[:size]
    return (out * inv).reshape(x.shape).to(orig_dtype)


def quantized_all_reduce_psum(x, axes, n_ranks: int, rank_index=None,
                              block_size: int = DEFAULT_QUANT_BLOCK,
                              min_quant_numel: int = DEFAULT_QUANT_FLOOR,
                              op: str = "mean", mesh=None):
    """The two-phase exchange in its all-reduce-only form (the
    reference's choice for multi-axis data groups): quantize every
    chunk, dequantize locally, all-reduce the float32 payloads, then
    re-quantize all reduced chunks.  Same quantization and error model;
    it moves float32 all-reduce bytes, not int8 payloads.
    `rank_index` is accepted for the reference's signature and
    unused."""
    del rank_index
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    group, _ = _resolve(mesh, axes)
    inv = 1.0 / n_ranks if op == "mean" else 1.0
    if not _quantizable(x, n_ranks, block_size, min_quant_numel):
        return _exact(x, group, inv, op, n_ranks)
    orig_dtype = x.dtype
    chunks, size = _chunks(x.detach(), n_ranks, block_size)
    q, scales = quantize_blockwise(chunks, block_size)
    reduced = _ordered_sum(dequantize_blockwise(q, scales), group, n_ranks)
    q2, s2 = quantize_blockwise(reduced, block_size)
    out = dequantize_blockwise(q2, s2).reshape(-1)[:size]
    return (out * inv).reshape(x.shape).to(orig_dtype)


def quantized_all_reduce(x, mesh, axis: str, shard_dim: int = 0,
                         op: str = "mean",
                         block_size: int = DEFAULT_QUANT_BLOCK,
                         min_quant_numel: int = DEFAULT_QUANT_FLOOR):
    """`all_reduce`'s form of the blockwise-int8 exchange: this rank's
    shard of the stacked per-rank values (size 1 along `shard_dim`) in,
    the reduced value out."""
    _, n = _resolve(mesh, axis)
    return quantized_all_reduce_local(
        x.squeeze(shard_dim), axis, n, block_size=block_size,
        min_quant_numel=min_quant_numel, op=op, mesh=mesh)


class CrossRankSum(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the cotangent: the
    cross-rank reduction of the global-batch program (a replicated value
    computed from every rank's batch shard; see
    parallel/data_parallel.py)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class DataGroup:
    """What an op sees of the data ranks (`OpContext.cross_rank`): the
    process group, its size and this rank's index.  The executor hands
    it to an op only where the op reduces over the batch dim (or runs on
    a ZeRO slice), so the op's own cross-rank branch computes the
    global value."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, int(n), int(index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, differentiable (CrossRankSum)."""
        if self.group is None:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return CrossRankSum.apply(x, self.group)
        return _all_reduce(x, self.group)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _all_reduce(x, self.group, op)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return torch.cat(_gather_list(x, self.group, self.n), dim=dim)


def data_group_of(mesh, axes) -> Optional[DataGroup]:
    """The DataGroup over `axes` of `mesh`, None for one rank."""
    group, n = _resolve(mesh, tuple(axes))
    if n <= 1:
        return None
    return DataGroup(group, n, mesh.rank_index(axes))
