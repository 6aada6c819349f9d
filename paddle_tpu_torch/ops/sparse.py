"""Embedding lookup and id ops: the port of paddle_tpu/ops/sparse.py
(reference: paddle/fluid/operators/lookup_table_op.cc, with its
SelectedRows gradient path; shard_index_op.cc; hash_op.cc)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import fill_index, first, nan_where, out


def _squeezed(ids):
    return ids.reshape(ids.shape[:-1]) \
        if ids.dim() > 1 and ids.shape[-1] == 1 else ids


def gather_rows(w, ids, padding_idx=-1):
    """Rows of w at ids (a trailing 1-dim squeezed); rows at padding_idx
    read 0.  An id outside [0, V) after one wrap of negatives reads a NaN
    row, as the reference's jnp.take does, and never reaches the index
    op."""
    flat_ids = _squeezed(ids)
    idx, bad = fill_index(flat_ids, w.shape[0])
    o = nan_where(bad, w[idx])
    if padding_idx is not None and padding_idx >= 0:
        mask = (flat_ids != padding_idx).unsqueeze(-1)
        o = torch.where(mask, o, torch.zeros((), dtype=o.dtype,
                                             device=o.device))
    return o


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    """Rows of W at Ids.  On the SparseGrad path (core/executor.py) the
    Executor has gathered this op's rows already and differentiates with
    respect to them: the op returns them, with the padding mask applied
    again here so that the gradient at padding positions is zero, as on
    the dense path."""
    ids = first(ins, "Ids")
    padding_idx = attrs.get("padding_idx", -1)
    rows = (ctx.sparse_rows or {}).get(ctx.op_index)
    if rows is None:
        return out(Out=gather_rows(first(ins, "W"), ids, padding_idx))
    if padding_idx is not None and padding_idx >= 0:
        rows = torch.where((_squeezed(ids) != padding_idx).unsqueeze(-1),
                           rows, torch.zeros((), dtype=rows.dtype,
                                             device=rows.device))
    return out(Out=rows)


@register_op("shard_index")
def shard_index(ctx, ins, attrs):
    """An id's index within its shard of index_num // nshards ids when
    the shard is `shard_id`, else ignore_value (floor division and the
    divisor-signed remainder, as jnp's)."""
    x = first(ins, "X")
    size = attrs["index_num"] // attrs["nshards"]
    in_shard = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return out(Out=torch.where(
        in_shard, torch.remainder(x, size),
        torch.full((), attrs.get("ignore_value", -1), dtype=x.dtype,
                   device=x.device)))


_U32 = 0xFFFFFFFF


@register_op("hash")
def hash_op(ctx, ins, attrs):
    """The reference's own uint32 xorshift-multiply hash (not Paddle's
    XXH64), modulo mod_by, as int32.  Computed in int64 masked to 32
    bits (torch's uint32 lacks CUDA shifts and products in some
    builds); a negative id wraps to uint32 as astype(uint32) does."""
    x = first(ins, "X")
    v = x.to(torch.int64) & _U32
    v = v ^ (v >> 16)
    v = (v * 0x45D9F3B) & _U32
    v = v ^ (v >> 16)
    return out(Out=torch.remainder(v, attrs.get("mod_by", 100000))
               .to(torch.int32))
