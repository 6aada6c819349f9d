"""Embedding lookup: the port of paddle_tpu/ops/sparse.py lookup_table
(reference: paddle/fluid/operators/lookup_table_op.cc), forward only."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, out


def gather_rows(w, ids, padding_idx=-1):
    squeeze_last = ids.dim() > 1 and ids.shape[-1] == 1
    flat_ids = ids.reshape(ids.shape[:-1]) if squeeze_last else ids
    o = w[flat_ids.to(torch.int64)]
    if padding_idx is not None and padding_idx >= 0:
        mask = (flat_ids != padding_idx).unsqueeze(-1)
        o = torch.where(mask, o, torch.zeros((), dtype=o.dtype,
                                             device=o.device))
    return o


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    return out(Out=gather_rows(first(ins, "W"), first(ins, "Ids"),
                               attrs.get("padding_idx", -1)))
