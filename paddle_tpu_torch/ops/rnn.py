"""Recurrent ops: the port of paddle_tpu/ops/rnn.py (reference:
paddle/fluid/operators/lstm_op.cc, gru_op.cc, lstm_unit_op.cc,
gru_unit_op.cc, lstmp_op.cc).  Batches are padded (N, T, ...) with an
optional SeqLen companion; padded steps are masked so states freeze past
each sequence's end.

Gate layouts follow the reference exactly: dynamic_lstm / lstmp gates are
[candidate, input, forget, output]; lstm_unit gates are [input, forget,
output, candidate]; GRU gates are [update, reset | candidate] with
h = (1-u)*h_prev + u*c.

`dynamic_lstm` has two routes, chosen by its configuration alone:

- peepholes or non-default activations with `use_pallas=False`: the
  composed route on every device, the reference's scan step as a Python
  loop over T of torch ops (differentiable through torch autograd),
  counted in `kernels.composed_calls["dynamic_lstm"]`; on the card the
  same route takes, with `use_pallas=False`, what the kernels do not
  (H > 512 or not a multiple of 4, a dtype other than float32:
  `lk.kernel_takes`);
- everything else: `fused_lstm` (ops/kernels/lstm.py) — on a CUDA tensor
  the hand-written recurrence kernels, forward and backward, on a CPU
  tensor their plain versions.  With `use_pallas=True`, peepholes and
  other activations raise as the reference's kernel path does.

The `unroll` attr is a scheduling hint of the reference's scan and is
kept only so programs serialize as the reference's do.  `dynamic_gru`,
`lstm_unit`, `gru_unit` and `lstmp` have no TPU kernel in the reference
and are composed torch ops here as well, as are `attention_lstm` (its
own gate order, which the LSTM kernels do not take, and an attention
step before each cell) and `row_conv`.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first, opt_in, out
from . import kernels
from .kernels import bump, composed_calls
from .kernels import lstm as lk
from .sequence import _reject_nested

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _zeros(n, d, like):
    return torch.zeros((n, d), dtype=like.dtype, device=like.device)


def _time_major(x, is_reverse):
    """(xs (T, N, ...), the original step index of each work step)."""
    xs = x.transpose(0, 1)
    steps = range(x.shape[1])
    if is_reverse:
        xs = xs.flip(0)
        steps = reversed(steps)
    return xs, list(steps)


def _batch_major(seq, is_reverse):
    s = torch.stack(seq)
    if is_reverse:
        s = s.flip(0)
    return s.transpose(0, 1)


def _freeze(seq_len, tidx, new, old):
    if seq_len is None:
        return new
    return torch.where((tidx < seq_len).reshape(-1, 1), new, old)


def _peepholes(bias, h_dim, use_peepholes, like):
    if bias is not None and use_peepholes:
        peep = bias.reshape(-1)[4 * h_dim: 7 * h_dim]
        return peep[:h_dim], peep[h_dim: 2 * h_dim], peep[2 * h_dim:]
    z = torch.zeros((h_dim,), dtype=like.dtype, device=like.device)
    return z, z, z


def _lstm_cell(gates, c, peep, use_peepholes, gate_act, cell_act, cand_act):
    """One step of the reference's scan body: (h_new, c_new)."""
    w_ic, w_fc, w_oc = peep
    cand, i, f, o = gates.chunk(4, dim=-1)   # reference order
    if use_peepholes:
        i = i + c * w_ic
        f = f + c * w_fc
    i, f = gate_act(i), gate_act(f)
    c_new = f * c + i * cand_act(cand)
    if use_peepholes:
        o = o + c_new * w_oc
    return gate_act(o) * cell_act(c_new), c_new


@register_op("dynamic_lstm")
def dynamic_lstm(ctx, ins, attrs):
    """Input (N, T, 4H), already projected by the preceding fc (the
    reference contract); Weight (H, 4H) recurrent projection; Bias
    (1, 4H), or (1, 7H) with peepholes."""
    _reject_nested(ins, "dynamic_lstm")
    x = first(ins, "Input")
    w = first(ins, "Weight")
    bias = opt_in(ins, "Bias")
    seq_len = opt_in(ins, "SeqLen")
    h0 = opt_in(ins, "H0")
    c0 = opt_in(ins, "C0")
    acts = tuple(attrs.get(k, d) for k, d in (
        ("gate_activation", "sigmoid"), ("cell_activation", "tanh"),
        ("candidate_activation", "tanh")))
    use_peepholes = attrs.get("use_peepholes", False)
    is_reverse = attrs.get("is_reverse", False)
    use_pallas = bool(attrs.get("use_pallas", False))

    n, t, g4 = x.shape
    h_dim = g4 // 4
    if bias is not None:
        x = x + bias.reshape(-1)[: 4 * h_dim]
    h_prev = h0 if h0 is not None else _zeros(n, h_dim, x)
    c_prev = c0 if c0 is not None else _zeros(n, h_dim, x)

    plain_config = not use_peepholes and acts == ("sigmoid", "tanh", "tanh")
    kernel_ok = not kernels.on_card(x) or lk.kernel_takes(x, w, h_prev,
                                                         c_prev)
    if use_pallas or (plain_config and kernel_ok):
        # fused_lstm itself rejects peepholes / other activations loudly;
        # x already carries the bias
        hs_b, cs_b, h_last, c_last = lk.fused_lstm(
            x, w, h0=h_prev, c0=c_prev, seq_len=seq_len,
            is_reverse=is_reverse, use_peepholes=use_peepholes,
            gate_activation=acts[0], cell_activation=acts[1],
            candidate_activation=acts[2])
        return {"Hidden": [hs_b], "Cell": [cs_b],
                "LastH": [h_last], "LastC": [c_last]}

    if x.device.type != "meta":
        bump(composed_calls, "dynamic_lstm")
    gate_act, cell_act, cand_act = (_ACTS[a] for a in acts)
    peep = _peepholes(bias, h_dim, use_peepholes, x)
    xs, steps = _time_major(x, is_reverse)
    hs, cs = [], []
    for k, tidx in enumerate(steps):
        h_new, c_new = _lstm_cell(xs[k] + torch.matmul(h_prev, w), c_prev,
                                  peep, use_peepholes, gate_act, cell_act,
                                  cand_act)
        h_prev = _freeze(seq_len, tidx, h_new, h_prev)
        c_prev = _freeze(seq_len, tidx, c_new, c_prev)
        hs.append(h_prev)
        cs.append(c_prev)
    return {"Hidden": [_batch_major(hs, is_reverse)],
            "Cell": [_batch_major(cs, is_reverse)],
            "LastH": [h_prev], "LastC": [c_prev]}


def _gru_cell(g, h, w, h_dim, gate_act, cand_act):
    """One GRU step from the projected input g (N, 3H): (h_new, ur, c,
    r * h).  Reference convention: h = (1-u)*h_prev + u*candidate."""
    ur = gate_act(g[:, : 2 * h_dim] + torch.matmul(h, w[:, : 2 * h_dim]))
    u, r = ur.chunk(2, dim=-1)
    c = cand_act(g[:, 2 * h_dim:] + torch.matmul(r * h, w[:, 2 * h_dim:]))
    return (1 - u) * h + u * c, ur, c, r * h


@register_op("dynamic_gru")
def dynamic_gru(ctx, ins, attrs):
    """Input (N, T, 3H) pre-projected; Weight is the recurrent
    (H, 3H) = [update|reset | candidate] split like gru_op.cc."""
    _reject_nested(ins, "dynamic_gru")
    x = first(ins, "Input")
    w = first(ins, "Weight")
    bias = opt_in(ins, "Bias")
    seq_len = opt_in(ins, "SeqLen")
    h0 = opt_in(ins, "H0")
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)

    n, t, g3 = x.shape
    h_dim = g3 // 3
    if bias is not None:
        x = x + bias.reshape(-1)
    h = h0 if h0 is not None else _zeros(n, h_dim, x)
    xs, steps = _time_major(x, is_reverse)
    hs = []
    for k, tidx in enumerate(steps):
        h_new = _gru_cell(xs[k], h, w, h_dim, gate_act, cand_act)[0]
        h = _freeze(seq_len, tidx, h_new, h)
        hs.append(h)
    return {"Hidden": [_batch_major(hs, is_reverse)], "LastH": [h]}


@register_op("lstm_unit")
def lstm_unit(ctx, ins, attrs):
    """Single-step LSTM cell (reference lstm_unit_op.cc): X = gates
    (N, 4H) in the order input, forget, output, candidate; C_prev
    (N, H)."""
    x, c_prev = first(ins, "X"), first(ins, "C_prev")
    forget_bias = attrs.get("forget_bias", 0.0)
    i, f, o, cand = x.chunk(4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + \
        torch.sigmoid(i) * torch.tanh(cand)
    return {"C": [c], "H": [torch.sigmoid(o) * torch.tanh(c)]}


_GRU_UNIT_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _gru_unit_act(value, default_name):
    """gru_unit's activation attrs are the reference's enum ids or names."""
    if isinstance(value, int):
        return _ACTS[_GRU_UNIT_ACTS.get(value, default_name)]
    return _ACTS[value]


@register_op("gru_unit")
def gru_unit(ctx, ins, attrs):
    x = first(ins, "Input")
    h_prev = first(ins, "HiddenPrev")
    w = first(ins, "Weight")
    bias = opt_in(ins, "Bias")
    gate_act = _gru_unit_act(attrs.get("gate_activation", 1), "sigmoid")
    cand_act = _gru_unit_act(attrs.get("activation", 2), "tanh")
    g = x if bias is None else x + bias.reshape(-1)
    h, ur, c, reset_h = _gru_cell(g, h_prev, w, h_prev.shape[-1], gate_act,
                                  cand_act)
    return {"Hidden": [h], "Gate": [torch.cat([ur, c], dim=-1)],
            "ResetHiddenPrev": [reset_h]}


@register_op("lstmp")
def lstmp(ctx, ins, attrs):
    """LSTM with recurrent projection (reference lstmp_op.cc): the hidden
    state h (size D) is projected to r (size P) each step and r — not h —
    feeds the recurrence.  Input (N, T, 4D) pre-projected like
    dynamic_lstm; Weight (P, 4D); ProjWeight (D, P); Bias (1, 4D) or
    (1, 7D) with peepholes.  Outputs the projection sequence (N, T, P)
    and the cell sequence (N, T, D)."""
    _reject_nested(ins, "lstmp")
    x = first(ins, "Input")
    w = first(ins, "Weight")
    w_proj = first(ins, "ProjWeight")
    bias = opt_in(ins, "Bias")
    seq_len = opt_in(ins, "SeqLen")
    h0 = opt_in(ins, "H0")
    c0 = opt_in(ins, "C0")
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACTS[attrs.get("proj_activation", "tanh")]
    use_peepholes = attrs.get("use_peepholes", False)
    is_reverse = attrs.get("is_reverse", False)

    n, t, g4 = x.shape
    h_dim = g4 // 4
    if bias is not None:
        x = x + bias.reshape(-1)[: 4 * h_dim]
    peep = _peepholes(bias, h_dim, use_peepholes, x)
    # the initial recurrent input is the projection of H0
    r = proj_act(torch.matmul(h0, w_proj)) if h0 is not None \
        else _zeros(n, w_proj.shape[1], x)
    c = c0 if c0 is not None else _zeros(n, h_dim, x)
    xs, steps = _time_major(x, is_reverse)
    rs, cs = [], []
    for k, tidx in enumerate(steps):
        h_new, c_new = _lstm_cell(xs[k] + torch.matmul(r, w), c, peep,
                                  use_peepholes, gate_act, cell_act,
                                  cand_act)
        r_new = proj_act(torch.matmul(h_new, w_proj))
        r = _freeze(seq_len, tidx, r_new, r)
        c = _freeze(seq_len, tidx, c_new, c)
        rs.append(r)
        cs.append(c)
    return {"Projection": [_batch_major(rs, is_reverse)],
            "Cell": [_batch_major(cs, is_reverse)],
            "LastH": [r], "LastC": [c]}


@register_op("attention_lstm")
def attention_lstm(ctx, ins, attrs):
    """Fused attention-LSTM (reference: operators/attention_lstm_op.cc).
    Each step attends over the sequence's own inputs, conditioned on the
    previous cell: score_j = relu(x_j @ aw[:M] + ab + c_{t-1} @ aw[M:])
    (then relu(scalar * score + scalar_bias) when given), p = softmax
    over the valid j, lstm_x = sum_j p_j x_j, and one LSTM step.
    LSTMWeight is (D + M, 4D) with rows [hidden; input] and gates
    [forget, input, output, candidate] — not the dynamic_lstm kernel's
    order, so the op is composed torch ops, a Python loop over T.
    X is padded (N, T, M) with the SeqLen companion; Hidden and Cell
    (N, T, D) read 0 past each length.  Padded scores are -1e30, not
    -inf, so a length-0 row softmaxes to a finite uniform row (then
    zeroed) instead of NaN."""
    _reject_nested(ins, "attention_lstm")
    x, c_prev = first(ins, "X"), first(ins, "C0")
    h0 = opt_in(ins, "H0")
    aw, ab = first(ins, "AttentionWeight"), opt_in(ins, "AttentionBias")
    a_scalar = opt_in(ins, "AttentionScalar")
    a_scalar_b = opt_in(ins, "AttentionScalarBias")
    lw, lb = first(ins, "LSTMWeight"), first(ins, "LSTMBias")
    seq_len = opt_in(ins, "SeqLen")
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    n, t, m = x.shape
    d = lw.shape[1] // 4
    w_h, w_x = lw[:d], lw[d:]
    aw = aw.reshape(-1)
    aw_x, aw_c = aw[:m], aw[m:]
    steps = torch.arange(t, device=x.device)[None, :]
    valid = (steps < seq_len.reshape(-1, 1)) if seq_len is not None \
        else torch.ones((n, t), dtype=torch.bool, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    att_x = x @ aw_x                                  # (N, T), step-free
    if ab is not None:
        att_x = att_x + ab.reshape(-1)[0]
    h = h0 if h0 is not None else _zeros(n, d, x)
    c = c_prev
    hs, cs = [], []
    for _ in range(t):
        score = torch.clamp(att_x + (c @ aw_c)[:, None], min=0.0)
        if a_scalar is not None:
            score = score * a_scalar.reshape(-1)[0]
            if a_scalar_b is not None:
                score = score + a_scalar_b.reshape(-1)[0]
            score = torch.clamp(score, min=0.0)
        score = torch.where(valid, score, torch.full(
            (), -1e30, dtype=x.dtype, device=x.device))
        p = torch.where(valid, torch.softmax(score, dim=1), zero)
        lstm_x = torch.einsum("nt,ntm->nm", p, x)
        gates = lstm_x @ w_x + h @ w_h + lb.reshape(-1)
        f, i, o, cand = torch.chunk(gates, 4, dim=-1)
        c = gate_act(f) * c + gate_act(i) * cand_act(cand)
        h = gate_act(o) * cell_act(c)
        hs.append(h)
        cs.append(c)
    mask = valid[..., None]
    return {"Hidden": [torch.where(mask, torch.stack(hs, 1), zero)],
            "Cell": [torch.where(mask, torch.stack(cs, 1), zero)]}


@register_op("row_conv")
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution (reference: operators/row_conv_op.cc):
    X (N, T, D), Filter (future_context, D); Out[t] = sum_k X[t + k] *
    Filter[k], zero past the end, added in k order."""
    x, f = first(ins, "X"), first(ins, "Filter")
    k_len, t = f.shape[0], x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, 0, k_len - 1))
    o = torch.zeros_like(x)
    for k in range(k_len):
        o = o + padded[:, k:k + t, :] * f[k]
    return out(Out=o)
