"""Embedding lookup: the port of paddle_tpu/ops/sparse.py lookup_table
(reference: paddle/fluid/operators/lookup_table_op.cc), forward only."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import fill_index, first, nan_where, out


def gather_rows(w, ids, padding_idx=-1):
    """Rows of w at ids (a trailing 1-dim squeezed); rows at padding_idx
    read 0.  An id outside [0, V) after one wrap of negatives reads a NaN
    row, as the reference's jnp.take does, and never reaches the index
    op."""
    squeeze_last = ids.dim() > 1 and ids.shape[-1] == 1
    flat_ids = ids.reshape(ids.shape[:-1]) if squeeze_last else ids
    idx, bad = fill_index(flat_ids, w.shape[0])
    o = nan_where(bad, w[idx])
    if padding_idx is not None and padding_idx >= 0:
        mask = (flat_ids != padding_idx).unsqueeze(-1)
        o = torch.where(mask, o, torch.zeros((), dtype=o.dtype,
                                             device=o.device))
    return o


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    return out(Out=gather_rows(first(ins, "W"), first(ins, "Ids"),
                               attrs.get("padding_idx", -1)))
