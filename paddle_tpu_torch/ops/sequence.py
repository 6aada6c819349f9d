"""Sequence ops: the port of paddle_tpu/ops/sequence.py (reference:
paddle/fluid/operators/sequence_ops/).  Ragged batches are padded dense
(N, T, ...) with an int32 SeqLen (N,) companion, the reference's LoD
replacement: masks and gathers in place of offset iteration, and the
re-packings (sequence_concat, lod_reset) as index arithmetic on the
device."""

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


# ---------------------------------------------------------------------------
# The rest of the sequence family
# ---------------------------------------------------------------------------

def _mask(lengths, t, dtype, tail=0):
    """(N, T) validity of each step under `lengths`, as `dtype`, with
    `tail` trailing unit dims."""
    m = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return m.to(dtype).reshape(tuple(m.shape) + (1,) * tail)


def _full_lengths(x):
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def _gather_steps(x, idx):
    """x (N, T, ...) gathered along time at idx (N, T')."""
    tail = tuple(x.shape[2:])
    idx = idx.to(torch.int64).reshape(tuple(idx.shape) + (1,) * len(tail))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) + tail))


@register_op("sequence_softmax")
def sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's valid steps; 0 past its length (a row of
    length 0 is all 0, and so is its gradient).  X (N, T) or (N, T, 1)."""
    _reject_nested(ins, "sequence_softmax")
    x = first(ins, "X")
    seq_len = opt_in(ins, "SeqLen")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x.reshape(x.shape[:2]) if squeeze else x
    if seq_len is None:
        seq_len = _full_lengths(v)
    m = _mask(seq_len, v.shape[1], torch.bool)
    o = torch.softmax(torch.where(m, v, torch.full_like(v, float("-inf"))),
                      dim=1)
    o = torch.where(m, o, torch.zeros_like(o))
    return out(Out=o[..., None] if squeeze else o)


@register_op("sequence_expand")
def sequence_expand(ctx, ins, attrs):
    """Each row of X repeated along Y's time axis (reference
    sequence_expand_op; padded: X (N, D) or (N, 1, D) broadcast to Y's
    steps).  With a nested Y (YLen2: Y a lod_level=2 batch (N, S1,
    ...)), each X sequence broadcasts across Y's sub-sequence slots: the
    output (N, S1, Tx, ...) has Y's sub-sequence count as its outer
    companion (Length) and X's lengths repeated as its inner one
    (Length2); a dense X (N, D) gives a level-1 output of S1 items."""
    x, y = first(ins, "X"), first(ins, "Y")
    y_len, y_len2 = opt_in(ins, "YLen"), opt_in(ins, "YLen2")
    x_len = opt_in(ins, "SeqLen")
    if y_len2 is not None:
        n, s1 = x.shape[0], y.shape[1]
        o = x[:, None].expand((n, s1) + tuple(x.shape[1:]))
        outer = (y_len.to(torch.int32) if y_len is not None
                 else torch.full((n,), s1, dtype=torch.int32,
                                 device=x.device))
        if x.dim() == 2:
            return {"Out": [o], "Length": [outer]}
        inner = x_len.to(torch.int32) if x_len is not None \
            else _full_lengths(x)
        inner2 = torch.where(
            torch.arange(s1, device=x.device)[None, :] < outer[:, None],
            inner[:, None], torch.zeros_like(inner[:, None]))
        return {"Out": [o], "Length": [outer], "Length2": [inner2]}
    if x.dim() == y.dim():
        return out(Out=x.expand(tuple(y.shape[:2]) + tuple(x.shape[2:])))
    return out(Out=x[:, None].expand((x.shape[0], y.shape[1])
                                     + tuple(x.shape[1:])))


@register_op("sequence_expand_as")
def sequence_expand_as(ctx, ins, attrs):
    return sequence_expand(ctx, ins, attrs)


@register_op("sequence_reverse")
def sequence_reverse(ctx, ins, attrs):
    """Each row's valid prefix reversed in place; the steps past its
    length stay where they are."""
    _reject_nested(ins, "sequence_reverse")
    x = first(ins, "X")
    seq_len = opt_in(ins, "SeqLen")
    if seq_len is None:
        return {"Y": [torch.flip(x, dims=(1,))]}
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    sl = seq_len.to(torch.int64)[:, None]
    return {"Y": [_gather_steps(x, torch.where(idx < sl, sl - 1 - idx,
                                               idx))]}


def _pack_rows(xs, lens, total_t):
    """Per row, each input's valid prefix placed back to back: output
    step j of row i reads input k at j - starts_k(i), the starts being
    the running sums of that row's lengths."""
    n = xs[0].shape[0]
    pos = torch.arange(total_t, device=xs[0].device)[None, :]
    o = torch.zeros((n, total_t) + tuple(xs[0].shape[2:]),
                    dtype=xs[0].dtype, device=xs[0].device)
    start = torch.zeros((n,), dtype=torch.int32, device=xs[0].device)
    for x, ln in zip(xs, lens):
        rel = pos - start[:, None]
        valid = (rel >= 0) & (rel < ln[:, None])
        g = _gather_steps(x, rel.clamp(0, x.shape[1] - 1))
        o = torch.where(valid.reshape(valid.shape + (1,) * (x.dim() - 2)),
                        g, o)
        start = start + ln
    return o


@register_op("sequence_concat")
def sequence_concat(ctx, ins, attrs):
    """The corresponding sequences concatenated (reference
    sequence_concat_op: out_i = x1_i ++ x2_i ++ ...).  Level 1: each
    output row packs every input's valid prefix back to back; Length
    the summed lengths.  Nested (SeqLen2): the sub-sequence lists
    concatenate along the sub-sequence axis, the inner axis padded to
    the widest; Length and Length2 the merged companions."""
    xs = ins["X"]
    lens, lens2 = ins.get("SeqLen"), ins.get("SeqLen2")
    if lens2:
        if lens is None or len(lens) != len(xs):
            raise ValueError("nested sequence_concat needs SeqLen "
                             "(sub-sequence counts) for every input")
        s2 = max(x.shape[2] for x in xs)
        xs_p = [F.pad(x, (0, 0) * (x.dim() - 3) + (0, s2 - x.shape[2]))
                for x in xs]
        total = sum(x.shape[1] for x in xs)
        lens = [ln.to(torch.int32) for ln in lens]
        o = _pack_rows(xs_p, lens, total)
        l2 = _pack_rows([v.to(torch.int32) for v in lens2], lens, total)
        return {"Out": [o], "Length": [sum(lens)], "Length2": [l2]}
    if not lens:
        # no ragged info: every row is whole, a plain concat in time
        return {"Out": [torch.cat(xs, dim=1)],
                "Length": [torch.full((xs[0].shape[0],),
                                      sum(x.shape[1] for x in xs),
                                      dtype=torch.int32,
                                      device=xs[0].device)]}
    if len(lens) != len(xs):
        raise ValueError(f"sequence_concat got {len(xs)} inputs but "
                         f"{len(lens)} SeqLen companions")
    lens = [ln.to(torch.int32) for ln in lens]
    return {"Out": [_pack_rows(xs, lens, sum(x.shape[1] for x in xs))],
            "Length": [sum(lens)]}


@register_op("sequence_pad")
def sequence_pad(ctx, ins, attrs):
    """The padded form is already padded: X cut or extended to
    padded_length, PadValue past each row's length; Length the lengths."""
    _reject_nested(ins, "sequence_pad")
    x = first(ins, "X")
    seq_len = opt_in(ins, "SeqLen")
    pad_value = opt_in(ins, "PadValue")
    padded_length = attrs.get("padded_length", -1)
    t = x.shape[1]
    if seq_len is None:
        seq_len = _full_lengths(x)
    target = padded_length if padded_length and padded_length > 0 else t
    if target > t:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, target - t))
    elif target < t:
        x = x[:, :target]
    m = _mask(seq_len, target, x.dtype, x.dim() - 2)
    fill = pad_value.reshape(()) if pad_value is not None else 0.0
    return {"Out": [x * m + fill * (1 - m)],
            "Length": [seq_len.to(torch.int32)]}


@register_op("sequence_unpad")
def sequence_unpad(ctx, ins, attrs):
    """sequence_pad's inverse in the padded world: the tail past each
    Length zeroed (downstream sequence ops mask again)."""
    x = first(ins, "X")
    length = first(ins, "Length").reshape(-1)
    return out(Out=x * _mask(length, x.shape[1], x.dtype, x.dim() - 2))


@register_op("sequence_slice")
def sequence_slice(ctx, ins, attrs):
    """Row i's steps Offset[i] .. Offset[i] + Length[i], moved to the
    front, 0 after them."""
    x = first(ins, "X")
    offset = first(ins, "Offset").reshape(-1)
    length = first(ins, "Length").reshape(-1)
    t = x.shape[1]
    idx = offset.to(torch.int64)[:, None] + torch.arange(t, device=x.device)
    g = _gather_steps(x, idx.clamp(0, t - 1))
    return out(Out=g * _mask(length, t, x.dtype, x.dim() - 2))


@register_op("sequence_enumerate")
def sequence_enumerate(ctx, ins, attrs):
    """Every window of win_size ids (N, T, win_size), pad_value past the
    row's end."""
    x = first(ins, "X")
    pad_value = attrs.get("pad_value", 0)
    cols = [F.pad(x[:, k:], (0, k), value=pad_value)
            for k in range(attrs["win_size"])]
    return out(Out=torch.stack(cols, dim=-1))


@register_op("sequence_erase")
def sequence_erase(ctx, ins, attrs):
    """The tokens in `tokens` marked -1 (static shapes forbid removing
    them; the SeqLen convention treats negatives as holes)."""
    x = first(ins, "X")
    tokens = attrs.get("tokens", [])
    if not tokens:
        return out(Out=x)
    hit = torch.isin(x, torch.as_tensor(tokens, dtype=x.dtype,
                                        device=x.device))
    return out(Out=torch.where(hit, torch.full_like(x, -1), x))


@register_op("im2sequence")
def im2sequence(ctx, ins, attrs):
    """Image to patch sequence (reference im2sequence_op.cc): NCHW to
    (N, patches, C * kh * kw), each patch channel-major."""
    x = first(ins, "X")
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    ph, pw = attrs.get("paddings", [0, 0, 0, 0])[:2]
    patches = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))
    return out(Out=patches.transpose(1, 2))


@register_op("sequence_scatter")
def sequence_scatter(ctx, ins, attrs):
    """Per-sequence updates added into X's rows (reference
    sequence_ops/sequence_scatter_op.cc): X (N, D), Ids (N, U) column
    ids with IdsLen (N,) the counts, Updates (N, U): Out[n, Ids[n, j]]
    += Updates[n, j] for j < IdsLen[n].  An id wraps once when
    negative and is dropped outside [0, D), as the reference's
    scatter-add."""
    from .common import fill_index

    x = first(ins, "X")
    ids = first(ins, "Ids")
    upd = first(ins, "Updates")
    ids_len = opt_in(ins, "IdsLen")
    n, u = ids.shape
    if ids_len is None:
        ids_len = torch.full((n,), u, dtype=torch.int32, device=x.device)
    idx, bad = fill_index(ids, x.shape[1])
    keep = (torch.arange(u, device=x.device)[None, :]
            < ids_len.to(torch.int32)[:, None]) & ~bad
    upd = torch.where(keep, upd, torch.zeros((), dtype=upd.dtype,
                                             device=upd.device))
    return out(Out=x.scatter_add(1, idx, upd.to(x.dtype)))


@register_op("sequence_reshape")
def sequence_reshape(ctx, ins, attrs):
    """Each sequence's values re-chunked to rows of new_dim (reference
    sequence_ops/sequence_reshape_op.cc): X (N, T, D) with SeqLen ->
    (N, T * D // new_dim, new_dim), OutLen = ceil(seq_len * D /
    new_dim) (a tail that does not fill a row keeps a partial row
    instead of being dropped)."""
    _reject_nested(ins, "sequence_reshape")
    x = first(ins, "X")
    seq_len = opt_in(ins, "SeqLen")
    new_dim = int(attrs["new_dim"])
    n, t, d = x.shape
    if (t * d) % new_dim != 0:
        raise ValueError(f"sequence_reshape: T*D={t * d} not divisible by "
                         f"new_dim {new_dim}")
    if seq_len is None:
        seq_len = _full_lengths(x)
    if d % new_dim != 0 and new_dim % d != 0:
        raise ValueError("new_dim must divide or be divisible by D for "
                         "padded re-chunking to preserve row alignment")
    out_len = -(-(seq_len.to(torch.int32) * d) // new_dim)
    return out(Out=x.reshape(n, (t * d) // new_dim, new_dim),
               OutLen=out_len.to(torch.int32))


@register_op("lod_reset")
def lod_reset(ctx, ins, attrs):
    """A token stream re-segmented under a new LoD (reference
    lod_reset_op.cc: the rows stay, the sequence structure is
    replaced).  The new structure is the static attr `target_lod`
    (offsets): it fixes the padded output's shape.  X is a plain
    (R, ...) stream, one token a row, or a padded (N, T, ...) batch with
    SeqLen whose valid tokens, in batch order, are the stream.  Out
    (len(target_lod) - 1, longest, ...), Length the new lengths."""
    _reject_nested(ins, "lod_reset")
    x = first(ins, "X")
    seq_len = opt_in(ins, "SeqLen")
    target_lod = [int(v) for v in attrs["target_lod"]]
    if len(target_lod) < 2 or target_lod[0] != 0:
        raise ValueError(f"target_lod must start at 0 with >=2 offsets, "
                         f"got {target_lod}")
    new_lens = [b - a for a, b in zip(target_lod, target_lod[1:])]
    if any(ln < 0 for ln in new_lens):
        raise ValueError(f"target_lod must be non-decreasing: {target_lod}")
    total = target_lod[-1]
    dev = x.device
    t_idx = torch.arange(total, device=dev)
    if seq_len is None:
        # the rows are the stream: the new lod must span exactly them
        # (reference lod_reset_op.cc InferShape)
        if total != x.shape[0]:
            raise ValueError(f"lod_reset: target_lod covers {total} rows "
                             f"but X has {x.shape[0]}")
        gathered, tail = x, tuple(x.shape[1:])
    else:
        lens = seq_len.to(torch.int64)
        ends = torch.cumsum(lens, dim=0)
        # the row that holds token t: the count of rows ending at or
        # before it
        row = (t_idx[:, None] >= ends[None, :]).sum(dim=1)
        row = row.clamp(0, x.shape[0] - 1)
        pos = (t_idx - (ends - lens)[row]).clamp(0, x.shape[1] - 1)
        gathered, tail = x[row, pos], tuple(x.shape[2:])
    lod = torch.as_tensor(target_lod, dtype=torch.int64, device=dev)
    seq_of = torch.searchsorted(lod[1:], t_idx, right=True)
    o = torch.zeros((len(new_lens), max(new_lens)) + tail, dtype=x.dtype,
                    device=dev)
    o = o.index_put((seq_of, t_idx - lod[seq_of]), gathered)
    return {"Out": [o], "Length": [torch.as_tensor(
        new_lens, dtype=torch.int32, device=dev)]}
