"""Control-flow operators: sub-blocks run by host loops over eager ops.

The port of paddle_tpu/ops/control_flow.py (reference:
paddle/fluid/operators/controlflow/while_op.cc:50,125 — runs a sub-block
through a nested Executor; recurrent_op.cc:222; conditional_block_op.cc;
beam_search_op.cc; tensor_array_read_write_op.cc).  Where the reference
traces each sub-block once inside a `lax.while_loop` / `lax.scan` /
`lax.switch` body, the port runs it eagerly, once per iteration, over a
copy of the surrounding env — the reference C++ executor's own model:

- `while`      → a Python loop; each check of the condition is one
                 device→host sync (`.item()`), the only sync the loop
                 makes
- `switch`     → the first true condition's index read on the host (one
                 sync), then only that branch runs, as under lax.switch
- `static_rnn` → a Python loop over the time dimension; torch autograd
                 differentiates through it as jax AD does through the
                 scan
- `dynamic_rnn`→ the same loop with per-example `torch.where` masking on
                 t < seq_len: memories frozen past each row's length,
                 outputs zero there (no host read of the lengths)
- `calc_gradient` → the pruned op span replayed with the inputs as
                 fresh autograd nodes, under the same per-op seeds, and
                 `torch.autograd.grad(..., create_graph=True)`, so a
                 gradient can feed a loss or another gradients()
- tensor arrays→ fixed-capacity (buffer, length) pairs written out of
                 place (`index_copy`), so autograd through array_write /
                 array_read is right; no host read of the index
- `beam_search`/`beam_search_decode` → the dense (batch, beam) step with
                 the ties of lax.top_k (a stable descending sort) and a
                 reverse loop over the parent pointers

Every iteration of a loop draws the same random streams: a sub-block's
ops take their generators from the run's seed material with the block
folded in (OpContext.run_block), never the iteration, as the
reference's body, traced once with one key, does.
"""

from __future__ import annotations

import torch

from ..core.registry import register_macro_op, register_op
from .basic import stable_top_k
from .common import first, out, to_torch_dtype


def _keep_dtype(new, old):
    """The loop carry keeps its dtype, as the reference's does
    (ops/control_flow.py:66-75): a value whose dtype drifted in the body
    is cast back; tensor arrays pass as they are."""
    if isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor) \
            and new.dtype != old.dtype:
        return new.to(old.dtype)
    return new


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

@register_macro_op("while")
def while_op(ctx, env, desc):
    """inputs: Condition (scalar bool var), X (outer reads, for pruning);
    outputs: Out (loop-carried vars: every outer var written in the body);
    attrs: sub_block (block index).

    The carry is [condition] + Out; each iteration runs the sub-block
    over a copy of the surrounding env with the carry spliced in.  The
    condition is read on the host before every iteration and once more
    at the end: one device→host sync a check, none elsewhere.
    """
    cond_name = desc.inputs["Condition"][0]
    out_names = [n for n in desc.outputs.get("Out", []) if n != cond_name]
    carry_names = [cond_name] + out_names
    sub_block = desc.attrs["sub_block"]
    carry = [env[n] for n in carry_names]
    while bool(carry[0].reshape(()).item()):
        e = dict(env)
        e.update(zip(carry_names, carry))
        ctx.run_block(sub_block, e)
        carry = [_keep_dtype(e[n], old)
                 for n, old in zip(carry_names, carry)]
    env.update(zip(carry_names, carry))


# ---------------------------------------------------------------------------
# switch (scalar multi-way conditional; fluid layers.Switch)
# ---------------------------------------------------------------------------

@register_macro_op("switch")
def switch_op(ctx, env, desc):
    """inputs: Conditions (list of scalar bool vars, checked in order);
    outputs: Out (vars any case may write; must pre-exist in env);
    attrs: case_blocks (list of block indices, one per condition),
           default_block (block index or -1).

    The branch index is the first true condition's (or the default's),
    computed on the device and read on the host with one sync; only
    that branch runs, as under the reference's lax.switch.  Each output
    keeps its dtype and shape.
    """
    conds = [env[n] for n in desc.inputs.get("Conditions", [])]
    out_names = desc.outputs.get("Out", [])
    case_blocks = list(desc.attrs["case_blocks"])
    default_block = desc.attrs.get("default_block", -1)
    idx = len(conds)
    if conds:
        flags = torch.stack([c.reshape(()).to(torch.bool) for c in conds])
        flags = torch.cat([flags, flags.new_ones(1)])
        # argmax returns the first maximal index: the first true one
        idx = int(flags.to(torch.int8).argmax().item())
    block_idx = case_blocks[idx] if idx < len(case_blocks) else default_block
    if block_idx < 0:
        return
    e = dict(env)
    ctx.run_block(block_idx, e)
    for n in out_names:
        old = env[n]
        env[n] = torch.as_tensor(e[n], device=old.device).to(
            old.dtype).reshape(old.shape)


# ---------------------------------------------------------------------------
# static_rnn (fluid recurrent_op / StaticRNN)
# ---------------------------------------------------------------------------

def _rnn_attrs(desc):
    a = desc.attrs
    return (a["sub_block"], a.get("step_inputs", []), a.get("memories", []),
            a.get("step_outputs", []), a.get("final_states", []))


@register_macro_op("static_rnn")
def static_rnn_op(ctx, env, desc):
    """attrs:
      sub_block:    block index of the step body
      step_inputs:  [[outer_name, inner_name]]  outer is time-major (T, ...)
      memories:     [[pre_name, post_name, init_name]]
      step_outputs: [[inner_name, outer_name]]  outer gets (T, ...) stacked
      final_states: [[post_name, outer_name]]   (optional)
      unroll:       accepted and ignored: the reference's results do not
                    change with it, and an eager loop has nothing to
                    unroll

    reference: paddle/fluid/operators/recurrent_op.cc:222 — here a
    Python loop over T; torch autograd differentiates through it.
    """
    sub_block, step_inputs, memories, step_outputs, final_states = \
        _rnn_attrs(desc)
    carry = [env[init] for _pre, _post, init in memories]
    xs = [env[outer] for outer, _inner in step_inputs]
    if not xs:
        raise ValueError("static_rnn needs at least one step input")
    ys = [[] for _ in step_outputs]
    for t in range(xs[0].shape[0]):
        e = dict(env)
        for (pre, _post, _init), c in zip(memories, carry):
            e[pre] = c
        for (_outer, inner), x in zip(step_inputs, xs):
            e[inner] = x[t]
        ctx.run_block(sub_block, e)
        carry = [_keep_dtype(e[post], c)
                 for (_pre, post, _init), c in zip(memories, carry)]
        for y, (inner, _outer) in zip(ys, step_outputs):
            y.append(e[inner])
    for (_inner, outer), y in zip(step_outputs, ys):
        env[outer] = torch.stack(y)
    post_to_final = {post: f for (_pre, post, _init), f in zip(memories,
                                                                carry)}
    for post, outer in final_states:
        env[outer] = post_to_final[post]


# ---------------------------------------------------------------------------
# dynamic_rnn (seq_len masking; fluid DynamicRNN without lod_rank_table)
# ---------------------------------------------------------------------------

def _row_mask(active, val):
    """active (B,) bool broadcast over val's trailing dims."""
    return active.reshape(tuple(active.shape) + (1,) * (val.dim() - 1))


@register_macro_op("dynamic_rnn")
def dynamic_rnn_op(ctx, env, desc):
    """Like static_rnn but over padded batch-major sequences (B, T, ...)
    with a per-example length vector: steps past an example's length
    leave its memory unchanged and emit zeros (`torch.where` on
    t < seq_len, on the device).  Replaces the reference's
    lod_rank_table / shrink_rnn_memory reorder-by-length machinery.

    attrs: sub_block, step_inputs [[outer, inner]], memories
    [[pre, post, init]], step_outputs [[inner, outer]], final_states
    [[post, outer]], seq_len (name of the (B,) length var), unroll
    (accepted and ignored, as in static_rnn).  Without step inputs the
    loop runs to max(seq_len), read on the host (one sync).
    """
    sub_block, step_inputs, memories, step_outputs, final_states = \
        _rnn_attrs(desc)
    seq_len = env[desc.attrs["seq_len"]]  # (B,) int
    carry = [env[init] for _pre, _post, init in memories]
    # batch-major (B, T, ...): step t reads x[:, t]
    xs = [env[outer] for outer, _inner in step_inputs]
    t_max = xs[0].shape[1] if xs else int(seq_len.max().item())
    ys = [[] for _ in step_outputs]
    for t in range(t_max):
        active = t < seq_len  # (B,) bool
        e = dict(env)
        for (pre, _post, _init), c in zip(memories, carry):
            e[pre] = c
        for (_outer, inner), x in zip(step_inputs, xs):
            e[inner] = x[:, t]
        ctx.run_block(sub_block, e)
        carry = [torch.where(_row_mask(active, e[post]),
                             e[post].to(c.dtype), c)
                 for (_pre, post, _init), c in zip(memories, carry)]
        for y, (inner, _outer) in zip(ys, step_outputs):
            v = e[inner]
            y.append(torch.where(_row_mask(active, v), v,
                                 torch.zeros_like(v)))
    for (_inner, outer), y in zip(step_outputs, ys):
        env[outer] = torch.stack(y, dim=1)  # back to (B, T, ...)
    post_to_final = {post: f for (_pre, post, _init), f in zip(memories,
                                                                carry)}
    for post, outer in final_states:
        env[outer] = post_to_final[post]


# ---------------------------------------------------------------------------
# calc_gradient (fluid backward.py:613 gradients/calc_gradient)
# ---------------------------------------------------------------------------

def _grad_input(v):
    """A fresh autograd node standing for input value v: a view of v
    when v already has a history (so a gradient of this gradient still
    reaches v's own inputs), else a leaf of v's values."""
    if v.requires_grad:
        return v.view_as(v)
    return v.detach().requires_grad_()


@register_macro_op("calc_gradient")
def calc_gradient_op(ctx, env, desc):
    """Gradients of target vars w.r.t. arbitrary input vars.

    attrs: op_range [start, stop) — the op span of block `block` whose
    replay expresses the targets as a function of the inputs; targets
    and inputs by name.  inputs: TargetGradients (optional cotangents,
    one per target; absent → ones).

    The span is pruned to the inputs→targets path as the reference
    prunes it (fluid _find_op_path_, backward.py:573): ops producing an
    input must not run (they would overwrite the input's node and the
    gradient would be silently zero), and ops off the path must not run
    (they may read names the run never computed).  The kept ops replay
    over a copy of env with the inputs as fresh autograd nodes, each
    under its own program index, so a dropout replays the mask the
    forward drew.  `torch.autograd.grad` runs with create_graph when
    grad mode is on, so the gradient is differentiable: it can feed a
    loss that training differentiates, or a second gradients() (double
    grad).  An input the targets do not depend on gets zeros.
    """
    from ..core.executor import run_ops
    from ..observe.numerics import NUMERICS_BITS_VAR

    target_names = desc.attrs["targets"]
    input_order = desc.attrs["inputs"]
    input_names = set(input_order)
    grad_names = desc.outputs["InputGrads"]
    start, stop = desc.attrs["op_range"]
    span = ctx.program.blocks[desc.attrs.get("block", 0)].ops[start:stop]

    needed = set(target_names)
    keep_rev = []
    for op in reversed(span):
        outs = op.desc.output_names()
        if any(n in needed and n not in input_names for n in outs):
            keep_rev.append(op)
            needed.update(op.desc.input_names())
    ops = list(reversed(keep_rev))
    op_offset = {id(op): start + i for i, op in enumerate(span)}
    tg = desc.inputs.get("TargetGradients", [])

    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = [_grad_input(env[n]) for n in input_order]
        e = dict(env)
        # the replay re-runs ops already bitmapped by the forward
        e.pop(NUMERICS_BITS_VAR, None)
        e.update(zip(input_order, xs))
        for op in ops:
            run_ops([op], e, ctx._seed, start_index=op_offset[id(op)],
                    program=ctx.program, device=ctx.device,
                    row_block=ctx.row_block)
        targets = [e[t] for t in target_names]
        if tg:
            cotangents = [env[n].to(t.dtype) for n, t in zip(tg, targets)]
        else:
            cotangents = [torch.ones_like(t) for t in targets]
        grads = torch.autograd.grad(targets, xs, grad_outputs=cotangents,
                                    create_graph=create_graph,
                                    allow_unused=True)
    env.update((n, torch.zeros_like(x) if g is None else g)
               for n, x, g in zip(grad_names, xs, grads))


# ---------------------------------------------------------------------------
# Tensor arrays (fixed-capacity analog of LoDTensorArray)
# ---------------------------------------------------------------------------
# Representation in env: a 2-tuple (buffer, length) where buffer has shape
# (capacity, *elem_shape) and length is an int32 scalar tracking the
# high-water mark.  Writes are out of place, so an earlier (buffer,
# length) pair stays valid for autograd.
# reference: paddle/fluid/operators/controlflow/tensor_array_read_write_op.cc

def _slot(i, capacity):
    """The (1,) int64 slot of index tensor i, clamped into the buffer as
    lax.dynamic_update_index_in_dim / dynamic_index_in_dim clamp it (a
    CUDA index op would assert on an out-of-range slot)."""
    return i.reshape(1).to(torch.int64).clamp(0, max(capacity - 1, 0))


@register_op("create_array")
def create_array(ctx, ins, attrs):
    shape = tuple(attrs["element_shape"])
    cap = int(attrs["capacity"])
    # int64 narrows to int32, as the reference's canonicalize_dtype
    # does with x64 off
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    buf = torch.zeros((cap,) + shape, dtype=dtype, device=ctx.device)
    return out(Out=(buf, torch.zeros((), dtype=torch.int32,
                                     device=ctx.device)))


@register_op("array_write")
def array_write(ctx, ins, attrs):
    x = first(ins, "X")
    i = first(ins, "I").reshape(()).to(torch.int32)
    buf, length = first(ins, "Array")
    buf = buf.index_copy(0, _slot(i, buf.shape[0]),
                         x.to(buf.dtype).unsqueeze(0))
    return out(Out=(buf, torch.maximum(length, i + 1)))


@register_op("array_read")
def array_read(ctx, ins, attrs):
    buf, _length = first(ins, "Array")
    i = first(ins, "I")
    return out(Out=buf.index_select(0, _slot(i, buf.shape[0])).squeeze(0))


@register_op("array_length")
def array_length(ctx, ins, attrs):
    _buf, length = first(ins, "Array")
    return out(Out=length.reshape((1,)))


@register_op("array_to_tensor")
def array_to_tensor(ctx, ins, attrs):
    """The whole buffer (entries past `length` are zero) and the length."""
    buf, length = first(ins, "Array")
    return out(Out=buf, OutIndex=length.reshape((1,)))


@register_op("max_sequence_len")
def max_sequence_len(ctx, ins, attrs):
    """Max over a (B,) length vector (reference: max_sequence_len_op of
    the lod_rank_table machinery; here lengths are explicit)."""
    return out(Out=first(ins, "SeqLen").max().reshape((1,)))


@register_op("tensor_array_to_tensor")
def tensor_array_to_tensor(ctx, ins, attrs):
    """Concat (default) or stack the tensor-array buffer along `axis`
    (reference: operators/tensor_array_to_tensor_op.cc:154), OutIndex
    holding each entry's size on that axis.  All capacity slots
    participate (unwritten tail entries are zero)."""
    buf, _length = first(ins, "X")
    use_stack = bool(attrs.get("use_stack", False))
    t = buf.shape[0]
    entry = tuple(buf.shape[1:])
    axis = _tat_axis(int(attrs.get("axis", 0)), len(entry), use_stack)
    moved = buf.movedim(0, axis)
    if use_stack:
        return out(Out=moved, OutIndex=torch.ones(
            (t,), dtype=torch.int32, device=buf.device))
    o = moved.reshape(entry[:axis] + (t * entry[axis],) + entry[axis + 1:])
    return out(Out=o, OutIndex=torch.full((t,), entry[axis],
                                          dtype=torch.int32,
                                          device=buf.device))


def _tat_axis(axis: int, rank: int, use_stack: bool) -> int:
    """Validate/normalize tensor_array_to_tensor's axis: stacking
    INSERTS a dim (valid positions 0..rank, like the reference
    StackOp); concatenation needs entries of rank >= 1 and a dim to
    concat on (0..rank-1)."""
    if not use_stack and rank == 0:
        raise ValueError(
            "tensor_array_to_tensor: cannot concat scalar entries — "
            "use use_stack=True to stack them into a vector")
    bound = rank + 1 if use_stack else rank
    if not -bound <= axis < bound:
        raise ValueError(
            f"tensor_array_to_tensor: axis {axis} out of range for "
            f"entry rank {rank} "
            f"({'stack inserts at 0..' + str(rank) if use_stack else 'concat needs 0..' + str(rank - 1)})")
    return axis % bound


# ---------------------------------------------------------------------------
# Beam search (dense batch×beam formulation)
# ---------------------------------------------------------------------------

@register_op("beam_search")
def beam_search(ctx, ins, attrs):
    """One beam expansion step.

    inputs: PreIds (B, K) int — tokens chosen last step
            PreScores (B, K) f32 — cumulative log-probs
            Scores (B, K, V) f32 — log-probs of next-token candidates
    attrs:  beam_size K, end_id, is_first_step (bool: only beam 0 is
            live, others are -1e9 so the first expansion doesn't
            duplicate)
    outputs: SelectedIds (B, K), SelectedScores (B, K), ParentIdx (B, K)

    Finished beams (pre_id == end_id) are frozen: they propagate with
    unchanged score and re-emit end_id.  The K best of the K * V
    candidates by a stable descending sort: among equal totals the lower
    flat index wins, as under the reference's lax.top_k.
    reference: paddle/fluid/operators/beam_search_op.cc:1.
    """
    pre_ids = first(ins, "PreIds")
    pre_scores = first(ins, "PreScores")
    scores = first(ins, "Scores")  # (B, K, V) log-probs
    B, K, V = scores.shape
    end_id = int(attrs.get("end_id", 1))
    neg_inf = torch.full((), -1e9, dtype=scores.dtype, device=scores.device)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)

    finished = pre_ids == end_id  # (B, K)
    # live beams add candidate log-probs; finished beams keep exactly
    # one candidate (end_id) at their frozen score
    expand = pre_scores[:, :, None] + scores  # (B, K, V)
    is_end = torch.arange(V, device=scores.device) == end_id  # (V,)
    frozen = pre_scores[:, :, None] + torch.where(is_end, zero, neg_inf)
    total = torch.where(finished[:, :, None], frozen, expand)
    if attrs.get("is_first_step", False):
        first_beam = (torch.arange(K, device=scores.device) == 0)
        total = torch.where(first_beam[None, :, None], total, neg_inf)
    top_scores, top_idx = stable_top_k(total.reshape(B, K * V), K)
    parent = torch.div(top_idx, V, rounding_mode="floor").to(torch.int32)
    token = (top_idx % V).to(pre_ids.dtype)
    return out(SelectedIds=token, SelectedScores=top_scores,
               ParentIdx=parent)


@register_op("beam_search_decode")
def beam_search_decode(ctx, ins, attrs):
    """Backtrace parent pointers into full sequences.

    inputs: Ids (T, B, K) int — tokens per step; Parents (T, B, K) int;
            NumSteps (scalar int, optional — entries past it are padding)
    attrs:  end_id
    outputs: SentenceIds (B, K, T) — right-padded with end_id.
    reference: beam_search_decode_op.cc (walks LoD links; here a reverse
    loop over the parent-pointer arrays, on the device: the step count
    is compared as a tensor, never read).  A parent index wraps once if
    negative and is clamped into [0, K), as jnp indexing clamps.
    """
    ids = first(ins, "Ids")  # (T, B, K)
    parents = first(ins, "Parents")
    T, B, K = ids.shape
    end_id = int(attrs.get("end_id", 1))
    num_steps = ins.get("NumSteps")
    n = (num_steps[0].reshape(()).to(torch.int32) if num_steps
         else torch.tensor(T, dtype=torch.int32, device=ids.device))
    batch_ix = torch.arange(B, device=ids.device)[:, None]  # (B, 1)
    pad = torch.full((B, K), end_id, dtype=ids.dtype, device=ids.device)
    beam_ix = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        # beam_ix: (B, K) — which beam slot each final hypothesis
        # occupied at step t+1; gather its token at t, hop to its parent
        valid = t < n
        tok = torch.where(valid, ids[t][batch_ix, beam_ix], pad)
        hop = parents[t][batch_ix, beam_ix].to(torch.int64)
        hop = torch.where(hop < 0, hop + K, hop).clamp(0, K - 1)
        beam_ix = torch.where(valid, hop, beam_ix)
        toks.append(tok)
    return out(SentenceIds=torch.stack(toks[::-1], dim=2))
