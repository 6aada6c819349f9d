"""Sequence ops: the subset of paddle_tpu/ops/sequence.py the ported
slices run (padded dense + lengths, the reference's LoD replacement)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, opt_in, out, to_torch_dtype


def _reject_nested(ins, op_name):
    """Ops without nested (LoD level-2) support must fail loudly rather
    than silently applying level-1 semantics to the sub-sequence axis
    (only sequence_pool removes a nesting level)."""
    if ins.get("SeqLen2"):
        raise NotImplementedError(
            f"{op_name} does not support nested (lod_level=2) inputs; "
            f"pool the inner level first (sequence_pool)")


@register_op("sequence_pool")
def sequence_pool(ctx, ins, attrs):
    x = first(ins, "X")  # (N, T, D...)
    seq_len = opt_in(ins, "SeqLen")
    seq_len2 = opt_in(ins, "SeqLen2")
    pool = attrs.get("pooltype", "AVERAGE").upper()
    if seq_len2 is not None:
        # nested input (B, S1, S2, D...): pooling removes the innermost
        # level -> (B, S1, D...); the level-1 lengths survive as the
        # output's .seq_len (handled by the layer)
        b, s1 = x.shape[0], x.shape[1]
        sub = {"X": [x.reshape((b * s1,) + tuple(x.shape[2:]))],
               "SeqLen": [seq_len2.reshape(-1)]}
        inner = sequence_pool(ctx, sub, attrs)["Out"][0]
        return {"Out": [inner.reshape((b, s1) + tuple(inner.shape[1:]))],
                "MaxIndex": [torch.zeros((b,), dtype=torch.int32,
                                         device=x.device)]}
    n, t = x.shape[0], x.shape[1]
    if seq_len is None:
        seq_len = torch.full((n,), t, dtype=torch.int32, device=x.device)
    tail = (1,) * (x.dim() - 2)
    valid = (torch.arange(t, device=x.device)[None, :]
             < seq_len[:, None]).reshape((n, t) + tail)
    m = valid.to(x.dtype)
    lens = seq_len.clamp(min=1).to(x.dtype).reshape((n,) + tail)
    if pool == "SUM":
        o = (x * m).sum(dim=1)
    elif pool == "AVERAGE":
        o = (x * m).sum(dim=1) / lens
    elif pool == "SQRT":
        o = (x * m).sum(dim=1) / torch.sqrt(lens)
    elif pool == "MAX":
        lowest = torch.finfo(x.dtype).min if x.dtype.is_floating_point \
            else torch.iinfo(x.dtype).min
        o = torch.where(valid, x, torch.full((), lowest, dtype=x.dtype,
                                             device=x.device)).amax(dim=1)
    elif pool == "FIRST":
        o = x[:, 0]
    elif pool == "LAST":
        idx = (seq_len - 1).clamp(min=0).to(torch.int64)
        idx = idx.reshape((n, 1) + tail).expand((n, 1) + tuple(x.shape[2:]))
        o = torch.gather(x, 1, idx).squeeze(1)
    else:
        raise ValueError(f"unknown pooltype {pool}")
    return {"Out": [o], "MaxIndex": [torch.zeros((n,), dtype=torch.int32,
                                                 device=x.device)]}


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


@register_op("sequence_conv")
def sequence_conv(ctx, ins, attrs):
    """Window convolution over time (reference sequence_conv_op.cc): X
    (N, T, D) with SeqLen, Filter (contextLength * D, num_filters).  The
    steps past each row's length read 0; window k takes the step at
    offset contextStart + k, zero outside [0, T)."""
    _reject_nested(ins, "sequence_conv")
    x = first(ins, "X")
    f = first(ins, "Filter")
    seq_len = opt_in(ins, "SeqLen")
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    n, t, d = x.shape
    if seq_len is not None:
        m = (torch.arange(t, device=x.device)[None, :]
             < seq_len[:, None]).to(x.dtype)
        x = x * m[..., None]
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        if off < 0:
            cols.append(F.pad(x[:, :t + off], (0, 0, -off, 0)))
        elif off > 0:
            cols.append(F.pad(x[:, off:], (0, 0, 0, off)))
        else:
            cols.append(x)
    im = torch.cat(cols, dim=-1)                # (N, T, ctx_len * D)
    return out(Out=(im.reshape(n * t, ctx_len * d) @ f).reshape(n, t, -1))


@register_op("lod_rank_table")
def lod_rank_table(ctx, ins, attrs):
    """Rank a batch of sequences by length, DESCENDING, ties kept in
    batch order — the dense analog of the reference LoDRankTable
    (operators/lod_rank_table_op.cc:19).  The table IS the (B,) int32
    index vector; lengths come from the input's .seq_len companion."""
    _reject_nested(ins, "lod_rank_table")
    sl = opt_in(ins, "SeqLen")
    if sl is None:
        raise ValueError(
            "lod_rank_table requires a level-1 sequence input "
            "(a var with a .seq_len companion)")
    # a stable sort keeps equal lengths in batch order, as the
    # reference's std::stable_sort and jnp.argsort do
    order = torch.argsort(-sl.to(torch.int32), stable=True)
    return out(Out=order.to(torch.int32))


@register_op("reorder_lod_tensor_by_rank")
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """Permute the batch dim of X by a rank table
    (operators/reorder_lod_tensor_by_rank_op.cc:34); the layer reorders
    the .seq_len companion alongside through OutSeqLen."""
    _reject_nested(ins, "reorder_lod_tensor_by_rank")
    x = first(ins, "X")
    rt = first(ins, "RankTable").to(torch.int64)
    outs = {"Out": [x.index_select(0, rt)]}
    sl = opt_in(ins, "SeqLen")
    if sl is not None:
        outs["OutSeqLen"] = [sl.index_select(0, rt)]
    return outs
