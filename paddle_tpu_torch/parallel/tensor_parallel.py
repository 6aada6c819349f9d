"""Tensor (Megatron) parallelism over the mesh's `mp` axis, one process
a rank.

The reference partitions one global program with GSPMD: its
`megatron_transformer_rules` (parallel/strategies.py) shard the weights
and XLA inserts the collectives, so every result is the one-device
program's.  The port runs each op eagerly on this rank's local tensors,
so a plan carries the placement of every value on the `mp` axis and
turns each op into its local form:

- a value is replicated (no entry), sharded on a dim (`("S", d)`: this
  rank holds chunk `index` of n along d) or a partial sum (`("P",)`:
  the value is the sum of the ranks' tensors);
- state vars take their rule spec's placement (the DataParallelRunner
  hands the step this rank's chunk of each mp-sharded var);
- `mul` with a column-sharded Y (spec (None, "mp")) gives an output
  sharded on its last dim; with a row-sharded Y and X sharded on its
  last dim, a partial sum;
- elementwise ops, activations, dropout without a draw, softmax away
  from the sharded dim, `reshape` and `transpose` that keep the sharded
  dim whole (mapped to its new dim), `slice` away from it and `matmul`
  over a sharded batch dim carry the placement;
- `flash_attention` on head-sharded q/k/v runs the kernel on this
  rank's heads (`n_head / n` in the "nthd" layout);
- `lookup_table` on a vocab-sharded table looks up the ids in its
  range and all-reduces;
- `softmax_with_cross_entropy` on vocab-sharded logits takes the
  vocab-parallel form: the row max all-reduced (max), the sum of exps
  and the label terms all-reduced (sum), the softmax output sharded;
- any other op gathers its sharded inputs and all-reduces its partial
  ones first, then runs replicated: always correct.

Collectives on the forward path are autograd Functions with their
conjugate backward, so `torch.autograd.grad` gives each rank the
gradient of its shard and a replicated value's cotangent is the whole
cotangent on every rank: an all-reduce of a partial sum passes the
cotangent through; a replicated value entering an op whose output is
sharded or partial (`copy`) all-reduces its cotangent; a slice of a
replicated value (`scatter`) all-gathers its cotangent; a gather takes
this rank's chunk of its cotangent.  Each conversion of one value is
made once a run (cached by name and tensor), so the Megatron layout
inserts one forward all-reduce an attention block (after `attn_out`)
and one an MLP block (after `ffn_out`), and one backward all-reduce at
each block's input.  `AxisGroup.last_counts` holds the last step's
collectives by kind, `last_ms` their host time (a fetch's gathers come
after the step and are not counted).
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import Counter
from typing import Any, Dict

import torch

from .collectives import _all_reduce, _gather_list

AXIS = "mp"
SHARDED, PARTIAL = "S", "P"

# ops whose output is computed element by element from one input: they
# carry its placement (a partial sum is reduced first: none of them is
# linear in it apart from scale, which it does not pay to special-case)
UNARY_CARRY = {
    "relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt", "rsqrt",
    "square", "abs", "scale", "cast", "leaky_relu", "softsign",
    "softplus", "elu", "swish", "relu6", "clip", "assign", "sign",
    "brelu", "hard_sigmoid", "logsigmoid", "selu", "cos", "sin", "floor",
    "ceil", "round", "reciprocal", "tanh_shrink", "hard_shrink",
    "softshrink", "thresholded_relu", "stanh", "soft_relu", "pow",
}
ELEMENTWISE = {"elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_div", "elementwise_max", "elementwise_min",
               "elementwise_pow"}

@contextlib.contextmanager
def activated(run):
    """`run` as the executor's tensor-parallel run (its `_run_one_op`
    dispatches every op through `run.run_op`) while the block runs."""
    from ..core.executor import TP_RUN

    token = TP_RUN.set(run)
    try:
        yield run
    finally:
        TP_RUN.reset(token)


def _is_meta(x):
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


class AxisGroup:
    """One axis of a mesh (`mp` for tensor parallelism; the ring's and
    ep's scatters and gathers take `sp` and `ep`): its group, size, this
    rank's index, and the last step's collectives (`counts` by kind,
    `ms` host time)."""

    def __init__(self, mesh, axis: str = AXIS):
        self.axis = axis
        self.n = int(mesh.shape[axis])
        self.index = mesh.coordinate(axis)
        self.group = mesh.group(axis)
        self.counts: Counter = Counter()
        self.ms = 0.0
        self.last_counts: Dict[str, int] = {}
        self.last_ms = 0.0

    def begin_step(self):
        self.counts = Counter()
        self.ms = 0.0

    def end_step(self):
        self.last_counts = dict(self.counts)
        self.last_ms = self.ms

    def run(self, state_place: Dict[str, tuple]) -> "TPRun":
        return TPRun(self, state_place)

    # -- the collectives (counted and timed on real tensors) ------------
    def _timed(self, kind, fn):
        t0 = time.perf_counter()
        out = fn()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.counts[kind] += 1
        return out

    def all_reduce(self, x, kind="all_reduce", op="sum"):
        if _is_meta(x):
            return torch.empty_like(x)
        return self._timed(kind, lambda: _all_reduce(x, self.group, op))

    def all_gather(self, x, dim, kind="all_gather"):
        if _is_meta(x):
            shape = list(x.shape)
            shape[dim] *= self.n
            return x.new_empty(shape)
        return self._timed(kind, lambda: torch.cat(
            _gather_list(x, self.group, self.n), dim=dim))

    def chunk(self, x, dim):
        size = x.shape[dim] // self.n
        return x.narrow(dim, self.index * size, size)


class _ReduceFwd(torch.autograd.Function):
    """Partial sum -> replicated: all-reduce; the cotangent passes
    through (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyBwd(torch.autograd.Function):
    """Replicated value into an op whose output is sharded or partial:
    the identity; the cotangent (this rank's partial) all-reduced
    (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g, "all_reduce_bwd"), None


class _Gather(torch.autograd.Function):
    """Sharded -> replicated: all-gather; the cotangent's chunk."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.chunk(g, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """Replicated -> sharded: this rank's chunk; the cotangent chunks
    all-gathered."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.chunk(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g.contiguous(), ctx.dim,
                                 "all_gather_bwd"), None, None


# the conversions inside autograd, on an AxisGroup: parallel's API for
# the ops (moe_ffn's expert split, ep) and the sequence-parallel route
def reduce_from(x, tp):
    """A partial sum made replicated: all-reduce; the cotangent passes
    through (Megatron's g)."""
    return _ReduceFwd.apply(x, tp)


def copy_to(x, tp):
    """A replicated value read by a sharded or partial product: the
    identity; the cotangent all-reduced (Megatron's f)."""
    return _CopyBwd.apply(x, tp)


def gather_from(x, tp, dim):
    """This rank's chunk along `dim` -> the whole value; the cotangent's
    chunk."""
    return _Gather.apply(x, tp, dim)


def scatter_to(x, tp, dim):
    """A replicated value -> this rank's chunk along `dim`; the cotangent
    chunks all-gathered."""
    return _Scatter.apply(x, tp, dim)


def _differentiable(x):
    return (isinstance(x, torch.Tensor) and torch.is_grad_enabled()
            and x.requires_grad)


def reshape_map(gin, gout, d, n):
    """The dim of `gout` that global dim `d` of `gin` maps to when each
    rank's chunk of d stays a chunk of one output dim (the product of
    the dims before d equal on both sides, the output dim divisible by
    n), else None."""
    before = math.prod(gin[:d])
    acc = 1
    for e, size in enumerate(gout):
        if acc == before and size != 1:
            return e if size % n == 0 else None
        acc *= size
        if acc > before:
            return None
    return None


def _resolve_shape(shape, gin):
    out = [gin[i] if s == 0 else s for i, s in enumerate(shape)]
    if -1 in out:
        known = math.prod(s for s in out if s != -1)
        out[out.index(-1)] = math.prod(gin) // known
    return out


class TPRun:
    """The placements of one forward run (a real run, or a meta run of
    the data-parallel classification) and its conversions' cache."""

    def __init__(self, tp: AxisGroup, state_place: Dict[str, tuple]):
        self.tp = tp
        self.place: Dict[str, tuple] = dict(state_place)
        self._cache: Dict[Any, Any] = {}

    # -- conversions ----------------------------------------------------
    def _cached(self, key, x, make):
        hit = self._cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        y = make()
        self._cache[key] = (x, y)
        return y

    def rep(self, name, x):
        """x as a replicated value."""
        p = self.place.get(name)
        if p is None or not isinstance(x, torch.Tensor):
            return x
        if p[0] == SHARDED:
            return self._cached(("gather", name), x, lambda: gather_from(
                x.contiguous(), self.tp, p[1]))
        return self._cached(("reduce", name), x,
                            lambda: reduce_from(x, self.tp))

    def shard(self, name, x, dim):
        """x sharded on `dim`."""
        p = self.place.get(name)
        if p == (SHARDED, dim):
            return x
        x = self.rep(name, x)
        return self._cached(("scatter", name, dim), x,
                            lambda: scatter_to(x, self.tp, dim))

    def copy(self, name, x):
        """A replicated x read by an op whose output is sharded or
        partial: its cotangent all-reduced."""
        x = self.rep(name, x)
        if not _differentiable(x):
            return x
        return self._cached(("copy", name), x,
                            lambda: copy_to(x, self.tp))

    # -- dispatch ---------------------------------------------------------
    def run_op(self, desc, ins, attrs, call):
        """The outputs of op `desc` on this rank's tensors `ins` (slot ->
        values, in desc.inputs' order); `call(ins, attrs)` runs the op's
        impl.  Records the outputs' placements."""
        names = {slot: list(desc.inputs.get(slot, ())) for slot in ins}
        placed = any(n in self.place for ns in names.values() for n in ns)
        res = None
        if placed:
            handler = _HANDLERS.get(desc.type)
            if handler is not None:
                res = handler(self, desc, ins, names, attrs, call)
            if res is None:
                res = (self._replicated(ins, names, attrs, call), {})
        else:
            res = (call(ins, attrs), {})
        for ns in desc.outputs.values():
            for n in ns:
                self.place.pop(n, None)
        outs, out_place = res
        for slot, p in out_place.items():
            if p is not None:
                for n in desc.outputs.get(slot, ()):
                    self.place[n] = p
        return outs

    def _replicated(self, ins, names, attrs, call):
        new = {slot: [self.rep(n, v) for n, v in zip(names[slot], vals)]
               for slot, vals in ins.items()}
        return call(new, attrs)

    def p(self, names, slot, i=0):
        ns = names.get(slot) or ()
        return self.place.get(ns[i]) if i < len(ns) else None


# -- handlers: (outs, {out slot: placement}) or None for the fallback ----

def _sdim(p):
    return p[1] if p is not None and p[0] == SHARDED else None


def _h_mul(run, desc, ins, names, attrs, call):
    x, y = ins["X"][0], ins["Y"][0]
    xn, yn = names["X"][0], names["Y"][0]
    px, py = run.place.get(xn), run.place.get(yn)
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    if y.dim() != 2 or ync != 1:
        return None
    if py == (SHARDED, 1) and px is None:
        outs = call({"X": [run.copy(xn, x)], "Y": [y]}, attrs)
        return outs, {"Out": (SHARDED, xnc)}
    if py == (SHARDED, 0) and px == (SHARDED, x.dim() - 1) \
            and xnc == x.dim() - 1:
        return call({"X": [x], "Y": [y]}, attrs), {"Out": (PARTIAL,)}
    return None


def _h_elementwise(run, desc, ins, names, attrs, call):
    x, y = ins["X"][0], ins["Y"][0]
    xn, yn = names["X"][0], names["Y"][0]
    if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
        return None
    # a partial sum is reduced first
    if run.place.get(xn, ("",))[0] == PARTIAL:
        x = run.rep(xn, x)
    if run.place.get(yn, ("",))[0] == PARTIAL:
        y = run.rep(yn, y)
    dx, dy = _sdim(run.place.get(xn)), _sdim(run.place.get(yn))
    if x.dim() < y.dim():
        return None
    axis = attrs.get("axis", -1)
    off = x.dim() - y.dim() if axis == -1 else axis
    targets = {d for d in (dx, None if dy is None else dy + off)
               if d is not None}
    if len(targets) != 1:
        return None if targets else (call({"X": [x], "Y": [y]}, attrs),
                                     {"Out": None})
    d = targets.pop()
    if dx is None:
        x = run.shard(xn, x, d) if x.shape[d] > 1 else run.copy(xn, x)
    yd = d - off
    if dy is None:
        y = run.shard(yn, y, yd) if 0 <= yd < y.dim() and \
            y.shape[yd] > 1 else run.copy(yn, y)
    return call({"X": [x], "Y": [y]}, attrs), {"Out": (SHARDED, d)}


def _h_unary(run, desc, ins, names, attrs, call):
    slot = "X" if "X" in ins else next(iter(ins))
    if len(ins) != 1 or len(ins[slot]) != 1:
        return None
    p = run.p(names, slot)
    if _sdim(p) is None:
        return None
    if desc.type == "dropout" and not (attrs.get("is_test", False)
                                       or attrs.get("dropout_prob",
                                                    0.5) == 0.0):
        return None
    outs = call(ins, attrs)
    return outs, {s: p for s in outs}


def _h_softmax(run, desc, ins, names, attrs, call):
    p, x = run.p(names, "X"), ins["X"][0]
    if _sdim(p) is None or attrs.get("axis", -1) % x.dim() == p[1]:
        return None
    return call(ins, attrs), {"Out": p}


def _h_reshape(run, desc, ins, names, attrs, call):
    p, x = run.p(names, "X"), ins["X"][0]
    if _sdim(p) is None or set(ins) - {"X"}:
        return None
    d, n = p[1], run.tp.n
    gin = list(x.shape)
    gin[d] *= n
    gout = _resolve_shape(list(attrs["shape"]), gin)
    e = reshape_map(gin, gout, d, n)
    if e is None:
        return None
    local = list(gout)
    local[e] //= n
    outs = call(ins, dict(attrs, shape=local))
    return outs, {"Out": (SHARDED, e)}


def _h_transpose(run, desc, ins, names, attrs, call):
    p = run.p(names, "X")
    if _sdim(p) is None:
        return None
    perm = list(attrs["axis"])
    return call(ins, attrs), {"Out": (SHARDED, perm.index(p[1]))}


def _h_slice(run, desc, ins, names, attrs, call):
    p, x = run.p(names, "Input"), ins["Input"][0]
    if _sdim(p) is None or set(ins) - {"Input"} or any(
            a % x.dim() == p[1] for a in attrs["axes"]):
        return None
    return call(ins, attrs), {"Out": p}


def _h_matmul(run, desc, ins, names, attrs, call):
    x, y = ins["X"][0], ins["Y"][0]
    xn, yn = names["X"][0], names["Y"][0]
    dx, dy = _sdim(run.place.get(xn)), _sdim(run.place.get(yn))
    if x.dim() != y.dim() or x.dim() < 3:
        return None
    batch = x.dim() - 2
    ds = {d for d in (dx, dy) if d is not None}
    if len(ds) != 1 or ds.pop() >= batch or any(
            run.place.get(m, ("",))[0] == PARTIAL for m in (xn, yn)):
        return None
    d = dx if dx is not None else dy
    if dx is None:
        x = run.shard(xn, x, d) if x.shape[d] > 1 else run.copy(xn, x)
    if dy is None:
        y = run.shard(yn, y, d) if y.shape[d] > 1 else run.copy(yn, y)
    return call({"X": [x], "Y": [y]}, attrs), {"Out": (SHARDED, d)}


def _h_flash(run, desc, ins, names, attrs, call):
    layout = attrs.get("layout", "nhtd")
    hd = 2 if layout == "nthd" else 1
    n = run.tp.n
    strategy = attrs.get("sequence_parallel", False)
    if strategy not in (False, None):
        return None
    q_sharded = _sdim(run.p(names, "Q")) == hd
    n_head = attrs.get("n_head") if layout == "nthd" else \
        ins["Q"][0].shape[1] * (n if q_sharded else 1)
    if not n_head or int(n_head) % n:
        return None
    if not any(_sdim(run.p(names, s)) == hd for s in ("Q", "K", "V")):
        return None
    new = {}
    for s in ("Q", "K", "V"):
        new[s] = [run.shard(names[s][0], ins[s][0], hd)]
    bias = ins.get("Bias") or []
    if bias and bias[0] is not None:
        b, bn = bias[0], names["Bias"][0]
        new["Bias"] = [run.shard(bn, b, 1) if b.dim() == 4 and
                       run.rep(bn, b).shape[1] > 1 else run.copy(bn, b)]
    a = dict(attrs)
    if layout == "nthd":
        a["n_head"] = int(n_head) // n
    return call(new, a), {"Out": (SHARDED, hd)}


def _h_lookup(run, desc, ins, names, attrs, call):
    from ..ops.common import fill_index, nan_where
    from ..ops.sparse import _squeezed

    pw = run.p(names, "W")
    if pw != (SHARDED, 0) or run.p(names, "Ids") is not None:
        return None
    w, ids = ins["W"][0], ins["Ids"][0]
    tp = run.tp
    v_local = w.shape[0]
    flat = _squeezed(ids)
    idx, bad = fill_index(flat, v_local * tp.n)
    local = idx - tp.index * v_local
    hit = (local >= 0) & (local < v_local)
    rows = w[local.clamp(0, v_local - 1)]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    rows = torch.where(hit.unsqueeze(-1), rows, zero)
    o = reduce_from(rows, tp)
    o = nan_where(bad, o)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        o = torch.where((flat != padding_idx).unsqueeze(-1), o, zero)
    return {"Out": [o]}, {"Out": None}


def _h_softmax_ce(run, desc, ins, names, attrs, call):
    """Vocab-parallel softmax CE: lse from the all-reduced row max and
    sum of exps; the label terms summed over the ranks in one
    all-reduce."""
    from ..ops.common import fill_index, nan_where

    p = run.p(names, "Logits")
    lg, label = ins["Logits"][0], ins["Label"][0]
    if p != (SHARDED, lg.dim() - 1) or attrs.get("axis", -1) not in (
            -1, lg.dim() - 1):
        return None
    tp = run.tp
    lbn = names["Label"][0]
    soft = attrs.get("soft_label", False)
    v_local = lg.shape[-1]
    with torch.no_grad():
        m = tp.all_reduce(lg.detach().amax(dim=-1, keepdim=True),
                          "all_reduce_max", op="max")
    e = torch.exp(lg - m)
    total = reduce_from(e.sum(dim=-1, keepdim=True), tp)
    lse = m + torch.log(total)
    eps = float(attrs.get("label_smooth_eps", 0.0) or 0.0)
    zero = torch.zeros((), dtype=lg.dtype, device=lg.device)
    if soft:
        if eps:
            return None
        lab = run.shard(lbn, label, lg.dim() - 1)
        terms = torch.cat([(lab * lg).sum(dim=-1, keepdim=True),
                           lab.sum(dim=-1, keepdim=True)], dim=-1)
        t = reduce_from(terms, tp)
        loss = -(t[..., :1] - t[..., 1:] * lse)
    else:
        label = run.rep(lbn, label)
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        valid = (lbl != attrs.get("ignore_index", -100)).unsqueeze(-1)
        idx, bad = fill_index(torch.where(valid.squeeze(-1), lbl,
                                          torch.zeros_like(lbl)),
                              v_local * tp.n)
        local = idx - tp.index * v_local
        hit = ((local >= 0) & (local < v_local)).unsqueeze(-1)
        picked = torch.where(hit, torch.gather(
            lg, -1, local.clamp(0, v_local - 1).unsqueeze(-1)), zero)
        terms = torch.cat([picked, lg.sum(dim=-1, keepdim=True)], dim=-1)
        t = reduce_from(terms, tp)
        picked = nan_where(bad, t[..., :1] - lse)
        loss = -torch.where(valid, picked, zero)
        if eps:
            smooth = torch.where(valid, lse - t[..., 1:] / (v_local * tp.n),
                                 zero)
            loss = (1.0 - eps) * loss + eps * smooth
    return ({"Loss": [loss], "Softmax": [torch.exp(lg - lse)]},
            {"Loss": None, "Softmax": p})


def _h_moe(run, desc, ins, names, attrs, call):
    """moe_ffn with each expert's hidden dim over mp (W1 (E, D, H) and
    W2 (E, H, D) sharded on H, the rules' moe_axis="ep" form): the op
    splits its experts' FFN (ops/moe.py `_experts`, the run handed to
    it as OpContext.mp); any other placement gathers."""
    if run.p(names, "W1") != (SHARDED, 2) or \
            run.p(names, "W2") != (SHARDED, 1):
        return None
    new = {}
    for slot, vals in ins.items():
        new[slot] = [v if slot in ("W1", "W2") else run.rep(n, v)
                     for n, v in zip(names[slot], vals)]
    return call(new, attrs, mp=run), {}


_HANDLERS = {"mul": _h_mul, "reshape": _h_reshape, "reshape2": _h_reshape,
             "transpose": _h_transpose, "transpose2": _h_transpose,
             "slice": _h_slice, "matmul": _h_matmul,
             "softmax": _h_softmax, "log_softmax": _h_softmax,
             "flash_attention": _h_flash, "lookup_table": _h_lookup,
             "softmax_with_cross_entropy": _h_softmax_ce,
             "moe_ffn": _h_moe}
for _t in ELEMENTWISE:
    _HANDLERS[_t] = _h_elementwise
for _t in UNARY_CARRY | {"dropout"}:
    _HANDLERS[_t] = _h_unary


def logical(tp: AxisGroup, p, x):
    """A value of placement `p` as its logical (replicated) tensor,
    outside autograd (fetches)."""
    if p is None or not isinstance(x, torch.Tensor):
        return x
    if p[0] == SHARDED:
        return tp.all_gather(x.detach().contiguous(), p[1], "fetch")
    return tp.all_reduce(x.detach(), "fetch")


def state_chunk(x, mesh, model_dims):
    """This rank's chunk of a whole state value over its model-axis
    dims [(dim, axis)]."""
    for d, a in model_dims:
        n = mesh.shape[a]
        size = x.shape[d] // n
        x = x.narrow(d, mesh.coordinate(a) * size, size)
    return x.contiguous()


def gather_model_dims(x, mesh, model_dims):
    """The whole value from this rank's chunk over its model-axis dims
    (every rank of each axis group calls it)."""
    for d, a in reversed(model_dims):
        n = mesh.shape[a]
        x = torch.cat(_gather_list(x.contiguous(), mesh.group(a), n), dim=d)
    return x


