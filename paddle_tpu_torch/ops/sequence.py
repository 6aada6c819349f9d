"""Sequence ops: the subset of paddle_tpu/ops/sequence.py the ported
slice runs (padded dense + lengths, the reference's LoD replacement)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, out, to_torch_dtype


@register_op("sequence_mask")
def sequence_mask(ctx, ins, attrs):
    x = first(ins, "X")  # lengths (N,) or (N,1)
    lens = x.reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    dtype = to_torch_dtype(attrs.get("out_dtype", "int64"))
    pos = torch.arange(maxlen, device=x.device)
    return {"Y": [(pos[None, :] < lens[:, None]).to(dtype)]}


def sinusoid(pos, d):
    """(len(pos), d) f32 sinusoidal encoding of float positions `pos` —
    the formula of paddle_tpu's add_position_encoding, evaluated in f32
    step by step as the reference does."""
    pos = pos.to(torch.float32)[:, None]
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=pos.device))
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device) * (-log_base / d))
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                     device=pos.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: d // 2])
    return pe


@register_op("add_position_encoding")
def add_position_encoding(ctx, ins, attrs):
    x = first(ins, "X")  # (N, T, D)
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    _, t, d = x.shape
    pe = sinusoid(torch.arange(t, device=x.device), d)
    return out(Out=(alpha * x + beta * pe[None]).to(x.dtype))
