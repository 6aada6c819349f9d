"""Executor: interpret a Program op by op on torch tensors.

The port of paddle_tpu/core/executor.py (reference:
paddle/fluid/framework/executor.cc — Run:299, the op-by-op hot loop at
:448-455).  Where the reference traces the whole program once into one
`jax.jit` computation, the port runs each op's torch implementation
eagerly on the executor's device — the reference C++ executor's own
model.

Training programs (`append_backward`'s `backward_marker` split) run the
reference's dense branch (paddle_tpu/core/executor.py:396-459,
547-549, 577-582): the ops before the marker that the loss, the
fetches, the update ops or persistable state need (XLA's dead-code
elimination in the reference) run with every trainable parameter as a
fresh autograd leaf, `torch.autograd.grad` of the
squeezed loss gives the gradients, `<param>@GRAD` and `<loss>@GRAD = 1`
are written into the env, and the ops after the marker (optimizer
updates) run under `torch.no_grad()`.  Nothing of the autograd graph
outlives the step.  An is_sparse lookup of a trainable table takes the
reference's SparseGrad path (paddle_tpu/core/executor.py:621-689): the
gradient is taken with respect to the gathered rows, so the table's is
a `SparseGrad` of the touched rows, which the optimizer ops with a
sparse branch update lazily and every other op sees densified.

Gradient accumulation (`Executor.run(accumulation_steps=K)`, the
reference's `_accumulate_gradients`, paddle_tpu/core/executor.py:941-
1063) splits each fed name into K micro-batches along dim 0 and runs
the forward and `torch.autograd.grad` once per micro-batch, so each
micro-batch's graph is freed before the next; the gradients are summed
in float32 and scaled by 1/K once, and the update ops run once.  Each
micro-batch draws its own random streams (its index folded into the op
generators' seed material); the run counter still advances once a
step.  Recompute segments (`recompute_scope`; the reference's
`jax.checkpoint`, :139-278) run each maximal run of consecutive live
forward ops sharing a `__recompute__` tag under
`torch.utils.checkpoint.checkpoint(use_reentrant=False,
preserve_rng_state=False)`: no op draws from the global generator, and
each op's generator is re-seeded from (seed, op index), so the
recomputed dropout masks repeat by construction.  Pipeline tags
(`pipeline_scope`) are inert on one device, as on a reference mesh
without a `pp` axis (:124-134): the ops run in order.  A program
compiled over a mesh (`parallel.CompiledProgram`) runs its step through
the compiled program's `parallel.data_parallel.DataParallelRunner` (the
`dp` argument below): this rank's slice of the feeds, the cross-rank
forms of the ops that reduce over the batch, the gradient exchange, and
the update ops on ZeRO slices; on an `mp` axis every forward op through
the tensor-parallel run `TP_RUN` holds (`_run_one_op`), and on a `pp`
axis each pipeline_scope group as the GPipe schedule
(`_run_forward_pipelined`, `run_ops`), as the reference's run_ops
lifts it (:125-180).

The in-step pieces run in the reference's order
(paddle_tpu/core/executor.py:431-617), each only when the program opted
in: the per-op finite bitmap (observe/numerics.py) is seeded before the
forward and ORed by every op; dynamic loss scaling multiplies the loss
by the device-resident scale before `torch.autograd.grad`, then the
loss and the gradients are unscaled; the update guard
(resilience/guard.py) takes `all_finite` and snapshots what the update
ops write, runs them, and selects every written value back where the
step was not finite; then the telemetry accumulator (observe/
metrics.py), the guard's counters and loss-scale schedule, and the
numerics latch advance.  All of it stays on the device: no host read
during the step.

A program marked by `amp.decorate(...).minimize` carries its bf16 op
lists in `_amp_lists`; every op of every run (forward-only, the training
forward and the update ops, as in the reference's executor.py:306-313)
gets its inputs cast by `amp.cast_ins_for_op` after the densify and
before the op's impl.  In the training forward the casts are autograd
ops on the parameter leaves, so each cotangent is cast back and the
parameter gradients reach the update ops in float32.

Control flow (ops/control_flow.py): a macro op (`while`, `switch`,
`static_rnn`, `dynamic_rnn`, `calc_gradient`) gets the whole env and
its OpDesc and runs its sub-blocks itself (`OpContext.run_block`, on
the run's device, `row_block` and AMP lists), as the reference's
`_run_one_op` dispatches it; it never joins a recompute segment.  A
tensor array is a (buffer, length) pair in the env: the numerics
bitmap skips it, the training step detaches it part by part, the
accumulation's fetch rule merges it part by part, and a fetch returns
it as a pair.

Places follow Paddle's idiom: `CUDAPlace(0)` runs on `cuda:0`,
`CPUPlace()` on the CPU.  `Executor()` without a place means
`CUDAPlace(0)` and raises when CUDA is not available — the CPU runs only
when the caller asks for it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..observe import metrics as _obs_metrics
from ..observe import numerics as _obs_num
from ..observe import trace as _obs_trace
from ..observe.monitoring import dispatch_timer
from ..observe.numerics import NUMERICS_BITS_VAR
from ..resilience import guard as _guard
from .program import Program, Variable, grad_var_name
from .registry import OpContext, get_macro_op_impl, get_op_impl, is_macro_op
from .selected_rows import SparseGrad, densify

# Scope key of the executor's RNG state (the reference's jax PRNG key;
# here the count of runs that drew from it).
RNG_STATE_VAR = "__rng_key__"

# Optimizer ops with a sparse (SelectedRows) branch; every other op sees
# densified gradients (the reference's SPARSE_AWARE_OPS).
SPARSE_AWARE_OPS = {"sgd", "momentum", "adam", "adagrad"}

# The tensor-parallel run of the forward being interpreted
# (parallel/tensor_parallel.py sets it), None off an `mp` mesh.
TP_RUN: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_tp_run", default=None)

# Folded into the seed material of micro-batch k under gradient
# accumulation as 31337 + k (the reference's fold_in(key, 31337 + idx)).
MICRO_SEED_BASE = 31337


class Scope:
    """Name → value store for persistable state (reference: scope.h:48).

    Parent-chain lookup is kept for API parity; values are torch tensors
    on the executor's device.
    """

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: Dict[str, Any] = {}
        self.kids: List["Scope"] = []

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def var(self, name: str):
        """Find-or-create (reference scope.h:56 Var)."""
        if name not in self.vars:
            self.vars[name] = None
        return self.vars[name]

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def set_var(self, name: str, value):
        self.vars[name] = value

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def local_var_names(self) -> List[str]:
        return list(self.vars)

    def drop_kids(self):
        self.kids = []


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def place_device(place) -> torch.device:
    """The torch device of a Paddle place.  None means CUDAPlace(0),
    which needs CUDA: without it this raises instead of falling back to
    the CPU."""
    from .. import CPUPlace, CUDAPlace

    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} requested (the default place) but CUDA is not "
                f"available; pass CPUPlace() to run on the CPU")
        return torch.device("cuda", place.device_id)
    raise TypeError(f"unknown place {place!r}; use CPUPlace() or "
                    f"CUDAPlace(id)")


# ---------------------------------------------------------------------------
# Program interpretation
# ---------------------------------------------------------------------------

def run_ops(ops, env: Dict[str, Any], seed, start_index: int = 0,
            program=None, device=None, row_block=None, dp=None):
    """Run a straight-line op list over `env` (name → tensor), in order
    — the executor hot loop (executor.cc:448).  `seed` is the run's RNG
    seed material (see OpContext.rng), None when no op may draw.
    `device` None means CUDAPlace(0) (`place_device`).  The program's
    bf16 policy (`program._amp_lists`, amp.py), when it has one, casts
    each op's inputs at dispatch.  `row_block`: see OpContext.  `dp`: a
    data-parallel run's DataParallelRunner (the cross-rank ops, the
    update ops on ZeRO slices), None off a mesh."""
    device = _run_device(device)
    amp_lists = getattr(program, "_amp_lists", None)
    groups = {}
    if dp is not None and dp.pp_active:
        from ..parallel.pipeline_engine import pipeline_groups

        groups = dict(pipeline_groups(ops))
    i = 0
    while i < len(ops):
        if i in groups:
            # a pipeline_scope group on a pp mesh: the GPipe schedule
            dp.run_pipelined(ops[i:groups[i]], env, seed, start_index + i,
                             program, device, amp_lists)
            i = groups[i]
            continue
        op, index = ops[i], start_index + i
        i += 1
        if dp is not None and dp.absent and any(
                n in dp.absent for n in op.desc.input_names()):
            # an update op of a pipelined layer another pp stage holds
            continue
        ref = dp.sliced_ref(op.desc) if dp is not None else None
        if ref is not None:
            def run_one(o, e, group, _i=index):
                _run_one_op(o, e, seed, _i, program=program, device=device,
                            amp_lists=amp_lists, row_block=row_block,
                            cross_rank=group)

            dp.run_update_op(op, env, ref, run_one)
            continue
        _run_one_op(op, env, seed, index, program=program,
                    device=device, amp_lists=amp_lists,
                    row_block=row_block,
                    cross_rank=(dp.cross_rank_for(op.desc)
                                if dp is not None else None))
    return env


def _run_one_op(op, env, seed, op_index, program=None, device=None,
                sparse_rows=None, amp_lists=None, row_block=None,
                cross_rank=None):
    """Run one op over env.  While a profiler or a step recorder is
    active (observe/trace.py `op_ranges`), under its
    "<op_type>:<op_index>" label; otherwise nothing else is made."""
    scope = _obs_trace.op_scope[0]
    if scope is None:
        return _dispatch_op(op, env, seed, op_index, program, device,
                            sparse_rows, amp_lists, row_block, cross_rank)
    return scope(op.desc, op_index, lambda: _dispatch_op(
        op, env, seed, op_index, program, device, sparse_rows, amp_lists,
        row_block, cross_rank))


def _dispatch_op(op, env, seed, op_index, program, device, sparse_rows,
                 amp_lists, row_block, cross_rank):
    desc = op.desc
    if is_macro_op(desc.type):
        # control flow (ops/control_flow.py): the impl runs its
        # sub-blocks over env and writes its outputs itself, as the
        # reference's _run_one_op dispatches it (executor.py:296-300);
        # the context carries the run's device, row_block and AMP lists
        # down (OpContext.run_block)
        try:
            ctx = OpContext(seed, op_index=op_index, program=program,
                            device=device, amp_lists=amp_lists,
                            sparse_rows=sparse_rows, row_block=row_block,
                            cross_rank=cross_rank)
            get_macro_op_impl(desc.type)(ctx, env, desc)
        except Exception as exc:
            _reraise_with_op_context(exc, desc, op_index)
        _update_numerics(env, desc, op_index)
        return env
    try:
        impl = get_op_impl(desc.type)
        ins = {slot: [env[n] for n in names]
               for slot, names in desc.inputs.items()}
        if desc.type not in SPARSE_AWARE_OPS:
            ins = {slot: [densify(v) for v in vals]
                   for slot, vals in ins.items()}
        if amp_lists is not None:
            from ..amp import cast_ins_for_op

            ins = cast_ins_for_op(desc.type, ins, amp_lists)
        ctx = OpContext(seed, op_index=op_index, program=program,
                        device=device, amp_lists=amp_lists,
                        sparse_rows=sparse_rows, row_block=row_block,
                        cross_rank=cross_rank)
        tp_run = TP_RUN.get()
        if tp_run is None:
            outs = impl(ctx, ins, desc.attrs)
        else:
            # a tensor-parallel forward: the op on this rank's shards
            def call(i, a, mp=None):
                ctx.mp = mp
                return impl(ctx, i, a)

            outs = tp_run.run_op(desc, ins, desc.attrs, call)
    except Exception as exc:
        _reraise_with_op_context(exc, desc, op_index)
    for slot, names in desc.outputs.items():
        values = outs.get(slot, [])
        if len(values) != len(names):
            raise RuntimeError(
                f"op {desc.type}: output slot {slot!r} produced "
                f"{len(values)} values for {len(names)} names")
        for name, val in zip(names, values):
            env[name] = val
    _update_numerics(env, desc, op_index)
    return env


def _update_numerics(env, desc, op_index):
    """First-nonfinite op provenance (observe/numerics.py): OR this op's
    finite flag into the step bitmap under its program index; the bits
    var is absent unless the program opted in.  A tensor array's
    (buffer, length) pair is skipped, as in the reference."""
    if NUMERICS_BITS_VAR in env:
        env[NUMERICS_BITS_VAR] = _obs_num.update_bits(
            env[NUMERICS_BITS_VAR], op_index,
            [env[n] for n in desc.output_names() if n in env])


def _reraise_with_op_context(exc: Exception, desc, op_index: int):
    """Attach op type/index/io context to a failure — the reference's
    PADDLE_ENFORCE discipline (platform/enforce.h) so a failing op inside
    a 500-op program is locatable.  The original traceback is preserved
    via exception chaining."""
    detail = (
        f"error while running op[{op_index}] {desc.type!r} "
        f"(inputs={desc.inputs}, outputs={desc.outputs}, "
        f"attrs={ {k: v for k, v in desc.attrs.items() if not str(k).startswith('_')} })"
    )
    try:
        new_exc = type(exc)(f"{detail}\n  caused by: {exc}")
    except Exception:  # noqa: BLE001 — exception types with odd ctors
        new_exc = RuntimeError(f"{detail}\n  caused by: {exc!r}")
    raise new_exc from exc


def _live_indices(block, ops, needed):
    """Indices of the ops in `ops` that contribute to the names in
    `needed` or write persistable state, in program order."""
    def is_persistable(name: str) -> bool:
        return block.has_var(name) and block.var(name).persistable

    needed = set(needed)
    keep = []
    for i in range(len(ops) - 1, -1, -1):
        desc = ops[i].desc
        outs = desc.output_names()
        if any(n in needed for n in outs) or any(
                is_persistable(n) for n in outs):
            keep.append(i)
            needed.update(desc.input_names())
    return keep[::-1]


def prune_ops(program: Program, fetch_names):
    """Dead-op elimination: keep ops contributing to fetches or writing
    persistable state (reference analog: framework/prune.cc)."""
    block = program.global_block()
    return [block.ops[i] for i in _live_indices(block, block.ops,
                                                fetch_names)]


def _pruned(program: Program, fetch_names):
    """prune_ops memoized per (program version, fetches): the decode
    engine interprets the same program for every step."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.setdefault("_pruned_ops", {})
    ops = cache.get(key)
    if ops is None:
        ops = cache[key] = prune_ops(program, fetch_names)
    return ops


def _run_device(device) -> torch.device:
    """The device ops run on: `device`, or CUDAPlace(0) when None."""
    return place_device(None) if device is None else torch.device(device)


def interpret_program(program: Program, env: Dict[str, Any], seed,
                      fetch_names=(), device=None, row_block=None,
                      accum_steps: int = 1, feed_names=(), dp=None):
    """Run the program over env: a forward program pruned to what the
    fetches and persistable state need; a training program whole
    (forward, gradients, update ops; training programs are never pruned,
    as in the reference).  `device` None means CUDAPlace(0).
    `row_block` (forward programs): each row computed as in a run of
    `row_block` rows (OpContext).  `accum_steps` K > 1 (training
    programs): the names of `feed_names` split into K micro-batches
    whose gradients are averaged before the update ops run once.  `dp`:
    the DataParallelRunner of a data-parallel run (module docstring)."""
    device = _run_device(device)
    if program._backward_info is None:
        ops = _pruned(program, fetch_names)
        if dp is None:
            return run_ops(ops, env, seed, program=program, device=device,
                           row_block=row_block)
        listed = list(enumerate(ops))
        dp.classify(program, listed, env, feed_names)
        dp.check_plan(program, listed, set(fetch_names))
        with dp.model_run():
            return run_ops(ops, env, seed, program=program, device=device,
                           row_block=row_block, dp=dp)
    return _train_step(program, env, seed, device, fetch_names,
                       accum_steps, feed_names, dp=dp)


def _live_forward(program: Program, fetch_names):
    """Indices of the forward ops (before the backward marker) that the
    loss, the fetches, the update ops or a persistable write need — the
    dead-code elimination the reference gets from XLA under `jit`;
    memoized per (program version, fetches)."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.setdefault("_live_forward", {})
    live = cache.get(key)
    if live is None:
        info = program._backward_info
        block = program.global_block()
        k = info["index"]
        needed = {info["loss"], *fetch_names}
        for op in block.ops[k:]:
            needed.update(op.desc.input_names())
        live = cache[key] = _live_indices(block, block.ops[:k], needed)
    return live


def _find_sparse_lookups(fwd_ops, live, trainable, env):
    """(op_index, table, ids_name, padding_idx) of every live lookup
    eligible for the SparseGrad path, by the reference's rules
    (paddle_tpu/core/executor.py:621-647): is_sparse, a trainable table,
    ids already in the env (a feed or state; ids computed by earlier ops
    fall back to dense), and a table that no other live forward op reads
    (another reader, e.g. a weight-tied projection, needs the dense
    gradient)."""
    candidates, lookups_of = [], {}
    for i in live:
        d = fwd_ops[i].desc
        if d.type == "lookup_table" and d.attrs.get("is_sparse"):
            tbl, ids_n = d.inputs["W"][0], d.inputs["Ids"][0]
            if tbl in trainable and ids_n in env:
                candidates.append((i, tbl, ids_n,
                                   d.attrs.get("padding_idx", -1)))
                lookups_of.setdefault(tbl, set()).add(i)
    shared = {tbl for i in live for tbl, own in lookups_of.items()
              if i not in own and tbl in fwd_ops[i].desc.input_names()}
    return [c for c in candidates if c[1] not in shared]


def _forward_keep(program: Program, fetch_names):
    """Names read after the forward section: the loss, the fetches,
    persistable state and what the update ops consume (the reference's
    `fwd_keep`, paddle_tpu/core/executor.py:420-426).  A recompute
    segment's other outputs are internal and stay inside it.  Memoized
    as `_live_forward` is."""
    key = (program._version, tuple(fetch_names))
    cache = program.__dict__.setdefault("_forward_keep", {})
    keep = cache.get(key)
    if keep is None:
        block = program.global_block()
        info = program._backward_info
        keep = {v.name for v in block.vars.values() if v.persistable}
        keep.update(fetch_names)
        keep.add(info["loss"])
        for op in block.ops[info["index"]:]:
            keep.update(op.desc.input_names())
        cache[key] = keep
    return keep


def _run_forward(fwd_ops, live, env, seed, device, program, rows,
                 amp_lists, keep, dp=None, pipelined=True):
    """Run the live forward ops over env, each under its program index.
    With grad enabled, each maximal run of consecutive live ops sharing
    a `__recompute__` tag (two ops or more: a 1-op run saves nothing)
    runs as one checkpointed segment (`_run_segment`) that returns only
    the names read after it — the suffix read-sets over the live list
    and `keep` (the reference's run_ops, :139-226).  Pipeline tags are
    inert off a pp mesh (and with `pipelined` False, between the groups
    `_run_forward_pipelined` runs): those ops run in order.  A macro
    (control-flow) op never joins a segment (the reference's run_ops,
    :200-204)."""
    if pipelined and dp is not None and dp.pp_active:
        from ..parallel.pipeline_engine import pipeline_groups

        groups = pipeline_groups([fwd_ops[i] for i in live])
        if groups:
            _run_forward_pipelined(fwd_ops, live, env, seed, device,
                                   program, rows, amp_lists, keep, dp,
                                   groups)
            return env
    tags = [None if is_macro_op(fwd_ops[i].desc.type)
            else fwd_ops[i].desc.attrs.get("__recompute__") for i in live]

    def cross(op):
        return dp.cross_rank_for(op.desc) if dp is not None else None

    if not torch.is_grad_enabled() or not any(t is not None for t in tags):
        for i in live:
            _run_one_op(fwd_ops[i], env, seed, i, program=program,
                        device=device, sparse_rows=rows,
                        amp_lists=amp_lists, cross_rank=cross(fwd_ops[i]))
        return env
    n = len(live)
    ends = {j for j in range(1, n + 1) if tags[j - 1] is not None
            and (j == n or tags[j] != tags[j - 1])}
    suffix_reads: Dict[int, set] = {}
    acc = set(keep)
    for j in range(n, 0, -1):
        if j in ends:
            suffix_reads[j] = set(acc)
        acc.update(fwd_ops[live[j - 1]].desc.input_names())
    p = 0
    while p < n:
        q = p + 1
        if tags[p] is not None:
            while q < n and tags[q] == tags[p]:
                q += 1
        if q - p >= 2:
            _run_segment([(i, fwd_ops[i]) for i in live[p:q]], env, seed,
                         device, program, rows, amp_lists,
                         suffix_reads[q], cross)
        else:
            _run_one_op(fwd_ops[live[p]], env, seed, live[p],
                        program=program, device=device, sparse_rows=rows,
                        amp_lists=amp_lists, cross_rank=cross(
                            fwd_ops[live[p]]))
        p = q
    return env


def _run_forward_pipelined(fwd_ops, live, env, seed, device, program, rows,
                           amp_lists, keep, dp, groups):
    """`_run_forward` on a pp mesh: each pipeline_scope group of the
    live ops (`groups`, index pairs into `live`) runs as the GPipe
    schedule (parallel/pipeline_engine.py), the ops between them as
    usual.  The numerics bitmap stays out of the schedule; the group's
    ops set their bits from their outputs after it, as the reference's
    run_ops does."""
    # the names read at or after each group's start and end
    reads_from, acc = {}, set(keep)
    marks = {k for pair in groups for k in pair}
    for j in range(len(live), -1, -1):
        if j < len(live):
            acc.update(fwd_ops[live[j]].desc.input_names())
        if j in marks:
            reads_from[j] = set(acc)
    p = 0
    for i, j in groups + [(len(live), len(live))]:
        if i > p:
            _run_forward(fwd_ops, live[p:i], env, seed, device, program,
                         rows, amp_lists, reads_from.get(i, set(keep)), dp,
                         pipelined=False)
        if i == j:
            break
        bits = env.pop(NUMERICS_BITS_VAR, None)
        dp.run_pipelined([fwd_ops[k] for k in live[i:j]], env, seed,
                         live[i], program, device, amp_lists,
                         downstream_reads=reads_from[j])
        if bits is not None:
            for k in live[i:j]:
                bits = _obs_num.update_bits(
                    bits, k, [env[n] for n in fwd_ops[k].desc.output_names()
                              if n in env])
            env[NUMERICS_BITS_VAR] = bits
        p = j


def _run_segment(seg, env, seed, device, program, rows, amp_lists, keep,
                 cross=lambda op: None):
    """One recompute segment under `torch.utils.checkpoint` (the
    reference's `_run_checkpointed_segment`, :228-278): the tensors it
    reads enter as explicit arguments, other env entries are closed
    over, the numerics bitmap enters and leaves explicitly, and only
    the names in `keep` leave it.  Autograd saves the arguments alone;
    the backward reruns the ops, which draw the same streams (each op's
    generator is made from the seed and its program index)."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    read, written = [], set()
    for _, op in seg:
        for n in op.desc.input_names():
            if n not in written and n in env and n not in read:
                read.append(n)
        written.update(op.desc.output_names())
    out_names = sorted(written & keep)
    if NUMERICS_BITS_VAR in env:
        if NUMERICS_BITS_VAR not in read:
            read.append(NUMERICS_BITS_VAR)
        out_names.append(NUMERICS_BITS_VAR)
    arr_in = [n for n in read if isinstance(env[n], torch.Tensor)]
    other_in = {n: env[n] for n in read if n not in set(arr_in)}

    def seg_fn(*vals):
        local = dict(other_in)
        local.update(zip(arr_in, vals))
        if NUMERICS_BITS_VAR in local:
            # the ops OR into the bitmap in place: on a copy, so the
            # segment's saved argument keeps its version
            local[NUMERICS_BITS_VAR] = local[NUMERICS_BITS_VAR].clone()
        for i, op in seg:
            _run_one_op(op, local, seed, i, program=program, device=device,
                        sparse_rows=rows, amp_lists=amp_lists,
                        cross_rank=cross(op))
        return tuple(local[n] for n in out_names)

    # no early stop: torch ends an early-stopped recompute by raising,
    # and that exception's traceback keeps the segment's recomputed
    # tensors in a reference cycle until the garbage collector runs,
    # which in the backward of a deep stack held most of the memory the
    # recompute was meant to save; the full rerun costs the segment's
    # last ops once more
    with set_checkpoint_early_stop(False):
        outs = checkpoint(seg_fn, *(env[n] for n in arr_in),
                          use_reentrant=False, preserve_rng_state=False)
    env.update(zip(out_names, outs))


def _scalar_loss(fenv, loss_name):
    loss = fenv[loss_name]
    if loss.dim() > 0:
        loss = loss.squeeze()
    if loss.dim() > 0:
        raise ValueError(f"loss {loss_name!r} must have one element, "
                         f"got shape {tuple(fenv[loss_name].shape)}")
    return loss


def _forward_backward(program, env, seed, device, fwd_ops, live, dense,
                      lookups, scale, keep, dp=None):
    """One forward over `env` with the dense parameters `dense` as fresh
    autograd leaves (and, for each SparseGrad lookup, its gathered
    rows), then `torch.autograd.grad` of the (scaled) loss.  Returns
    (loss, dense grads, row grads, env detached); nothing of the graph
    outlives the call."""
    from ..ops.sparse import gather_rows

    loss_name = program._backward_info["loss"]
    # fresh leaves: the scope's own tensors never join the graph
    leaves = [env[p].detach().requires_grad_() for p in dense]
    rows = {i: gather_rows(env[tbl], env[ids_n], pad).detach()
            .requires_grad_() for i, tbl, ids_n, pad in lookups}
    model_run = dp.model_run() if dp is not None \
        else contextlib.nullcontext()
    # a tensor-parallel run stays active through the backward, where a
    # recompute segment runs its ops again
    with torch.enable_grad(), model_run:
        fenv = dict(env)
        fenv.update(zip(dense, leaves))
        _run_forward(fwd_ops, live, fenv, seed, device, program, rows,
                     getattr(program, "_amp_lists", None), keep, dp)
        loss = _scalar_loss(fenv, loss_name)
        if scale is not None:
            # dynamic loss scaling wraps the loss BEFORE autodiff
            loss = loss * scale
        grad_list = torch.autograd.grad(loss, leaves + list(rows.values()),
                                        allow_unused=True)
    env = {n: _detached(v) for n, v in fenv.items()}
    grads = {p: torch.zeros_like(leaf) if g is None else g
             for p, leaf, g in zip(dense, leaves, grad_list)}
    row_grads = [torch.zeros_like(rows[i]) if g is None else g
                 for (i, _, _, _), g in zip(lookups, grad_list[len(dense):])]
    return loss.detach(), grads, row_grads, env


def _detached(v):
    """v without its autograd history: a tensor detached, a tensor
    array's (buffer, length) pair part by part."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, tuple):
        return tuple(_detached(p) for p in v)
    return v


def _train_step(program: Program, env: Dict[str, Any], seed, device,
                fetch_names=(), accum_steps: int = 1, feed_names=(),
                dp=None):
    """The training step (see the module docstring).  The forward runs
    only the ops `_live_forward` keeps, each under its program index, so
    pruning never shifts an op's random stream or its numerics bit.  The
    autograd leaves are the dense parameters and, for each lookup on the
    SparseGrad path, the rows it gathers; a table's gradient is then a
    SparseGrad of its lookups' ids and row gradients.  With
    `accum_steps` > 1 the gradients are `_accumulate_gradients`'.  On a
    mesh (`dp`) this rank's forward and backward run on its slice and
    `dp.exchange` synchronizes the gradients before the update."""
    info = program._backward_info
    ops = program.global_block().ops
    k = info["index"]
    fwd_ops, rest_ops = ops[:k], ops[k:]
    params = [p for p in info["params"] if p in env]
    live = _live_forward(program, fetch_names)
    keep = _forward_keep(program, fetch_names)
    fwd_seed = seed
    if dp is not None and dp.active:
        if dp.explicit and accum_steps > 1:
            raise ValueError(
                "grad_sync cannot compose with gradient accumulation "
                "yet: the explicit exchange would run per micro-batch "
                "(K quantized all-reduces instead of one).  Use "
                "accumulation with the default sync, or grad_sync "
                "without accumulation.")
        listed = [(i, fwd_ops[i]) for i in live]
        dp.classify(program, listed, env, feed_names)
        dp.check_plan(program, listed, keep)
        fwd_seed = dp.fold_seed(seed)
    elif dp is not None:
        dp.plan = None
    # accumulation takes the dense path for every table (the
    # reference's :551-552: SparseGrads do not sum across micro-batches)
    # a table sharded over a model axis takes the dense gradient
    lookups = (_find_sparse_lookups(
        fwd_ops, live, set(params) - (dp.model_sharded() if dp is not None
                                      else set()), env)
        if accum_steps <= 1 else [])
    sparse_tables = {tbl for _, tbl, _, _ in lookups}
    dense = [p for p in params if p not in sparse_tables]
    trainable = {p: env[p] for p in params}   # the pre-update values
    tel = env.get(_obs_metrics.TELEMETRY_VAR)
    num_on = (tel is not None
              and getattr(program, "_telemetry_enabled", False)
              and getattr(program, "_numerics_enabled", False)
              and _obs_num.NONFINITE_WORDS in tel)
    if num_on:
        env[NUMERICS_BITS_VAR] = _obs_num.init_step_bits(len(ops), device)
    guard_cfg = getattr(program, "_update_guard", None)
    scale = None
    if (guard_cfg is not None and guard_cfg.loss_scaling is not None
            and tel is not None):
        scale = tel["loss_scale"].to(torch.float32)
    if accum_steps > 1:
        loss, grads, env = _accumulate_gradients(
            program, env, fwd_seed, device, fwd_ops, live, dense, scale,
            keep, accum_steps, feed_names, fetch_names, dp)
    else:
        loss, grads, row_grads, env = _forward_backward(
            program, env, fwd_seed, device, fwd_ops, live, dense, lookups,
            scale, keep, dp)
        per_table: Dict[str, list] = {}
        for (i, tbl, ids_n, _), g in zip(lookups, row_grads):
            per_table.setdefault(tbl, []).append(
                (env[ids_n].reshape(-1), g.reshape(-1, env[tbl].shape[-1])))
        for tbl, pairs in per_table.items():
            grads[tbl] = SparseGrad(torch.cat([ids for ids, _ in pairs]),
                                    torch.cat([g for _, g in pairs]),
                                    env[tbl].shape)
    with torch.no_grad():
        if dp is not None and dp.active:
            written = {n for i in live
                       for n in fwd_ops[i].desc.output_names()}
            loss, grads, env = dp.exchange(loss, grads, env,
                                           written & keep)
        return _update(program, env, seed, device, rest_ops, k, loss,
                       grads, trainable, guard_cfg, scale, num_on,
                       accumulated=accum_steps > 1, dp=dp)


def _accumulate_gradients(program, env, seed, device, fwd_ops, live, dense,
                          scale, keep, accum_steps, feed_names,
                          fetch_names, dp=None):
    """K-micro-batch gradient accumulation (the reference's
    `_accumulate_gradients`, paddle_tpu/core/executor.py:941-1063), run
    eagerly: the fed names split into K micro-batches along dim 0; micro-
    batch k runs `_forward_backward` with k folded into its seed
    material, so its graph is freed before the next.  Returns (the mean
    of the micro losses, the gradients summed in float32 then scaled by
    1/K, env).  env holds the full-batch feeds, the loss, the fetched
    forward values (a value whose leading dim is the micro batch
    concatenated back to the full batch, any other value averaged), the
    persistable forward outputs that were already in env threaded
    through the micro-batches (batch norm's moving stats: K
    micro-batches compound K updates) and the other forward outputs the
    update ops or the scope read at their last micro-batch's value (the
    lr-schedule value).  The numerics bitmap, ORed in place by every
    op, covers all K."""
    block = program.global_block()
    loss_name = program._backward_info["loss"]
    feeds = {}
    for n in feed_names:
        if n not in env:
            continue
        v = env[n]
        if v.dim() == 0 or v.shape[0] % accum_steps != 0:
            raise ValueError(
                f"gradient accumulation with {accum_steps} steps needs "
                f"feed {n!r} batch dim divisible; got shape "
                f"{tuple(v.shape)}")
        feeds[n] = v.chunk(accum_steps, dim=0)
    if not feeds:
        raise ValueError("gradient accumulation requires batched feeds")
    base_env = {n: v for n, v in env.items() if n not in feeds}
    fwd_out = set()
    for op in fwd_ops:
        fwd_out.update(op.desc.output_names())
    rest_reads = set()
    for op in block.ops[program._backward_info["index"] + 1:]:
        rest_reads.update(op.desc.input_names())
    persist_written = sorted(
        n for n in fwd_out
        if (block.has_var(n) and block.var(n).persistable)
        or n in rest_reads)
    fetch_fwd = sorted(n for n in fetch_names
                       if n in fwd_out and n != loss_name
                       and n not in persist_written)
    carried = [n for n in persist_written if n in env]
    computed = [n for n in persist_written if n not in env]
    micro_b = next(iter(feeds.values()))[0].shape[0]
    persist = {n: env[n] for n in carried}
    gsum: Dict[str, torch.Tensor] = {}
    losses, fetched, last = [], {n: [] for n in fetch_fwd}, {}
    for idx in range(accum_steps):
        e_in = dict(base_env)
        e_in.update(persist)
        e_in.update({n: chunks[idx] for n, chunks in feeds.items()})
        loss, grads, _, e_after = _forward_backward(
            program, e_in, tuple(seed) + (MICRO_SEED_BASE + idx,), device,
            fwd_ops, live, dense, [], scale, keep, dp)
        for p, g in grads.items():
            g32 = g.to(torch.float32)
            gsum[p] = g32 if p not in gsum else gsum[p] + g32
        losses.append(loss)
        persist = {n: e_after[n] for n in carried}
        for n in fetch_fwd:
            fetched[n].append(e_after[n])
        last = {n: e_after[n] for n in computed if n in e_after}
        del e_after, grads
    inv = 1.0 / accum_steps
    grads = {p: (g * inv).to(env[p].dtype) for p, g in gsum.items()}
    loss_val = torch.stack(losses).mean()
    out = dict(base_env)
    decl = block.var(loss_name).shape if block.has_var(loss_name) else ()
    out[loss_name] = (loss_val.reshape(tuple(decl))
                      if all(d > 0 for d in decl) else loss_val)
    for n, vs in fetched.items():
        out[n] = _merge_micro(vs, micro_b)
    out.update(persist)
    out.update(last)
    for n, chunks in feeds.items():
        out[n] = env[n]
    return loss_val, grads, out


def _merge_micro(vs, micro_b):
    """One fetched forward value from its K micro-batch values: a value
    whose leading dim is the micro batch concatenated back to the full
    batch, any other averaged (the reference's rule, :1048-1055); a
    tensor array's (buffer, length) pair part by part."""
    v0 = vs[0]
    if isinstance(v0, tuple):
        return tuple(_merge_micro(list(p), micro_b) for p in zip(*vs))
    if v0.dim() >= 1 and v0.shape[0] == micro_b:
        return torch.cat(vs, dim=0)
    st = torch.stack(vs)
    return (st if st.is_floating_point()
            else st.to(torch.float32)).mean(dim=0)


def _update(program, env, seed, device, rest_ops, k, loss, grads,
            trainable, guard_cfg, scale, num_on, accumulated=False,
            dp=None):
    """After the gradients, in the reference's order
    (paddle_tpu/core/executor.py:538-617): unscale, finite check and
    snapshot, the update ops, the guard's select, then telemetry, the
    guard's counters and the numerics latch.  `accumulated`: the loss in
    env is the micro-batches' mean of the scaled loss, unscaled here
    too (:564-566)."""
    finite = None
    pre_update: Dict[str, Any] = {}
    if scale is not None:
        # unscale before the finite check and the update ops: the
        # optimizer must see master-scale gradients
        inv = 1.0 / scale
        loss = loss * inv
        grads = _guard.scale_grads(grads, inv)
        loss_name = program._backward_info["loss"]
        if accumulated and loss_name in env:
            env[loss_name] = env[loss_name] * inv
    if guard_cfg is not None:
        finite = _guard.all_finite(loss, grads)
        written = set()
        for op in rest_ops[1:]:
            written.update(op.desc.output_names())
        pre_update = _guard.snapshot_env(env, written)
    env[grad_var_name(program._backward_info["loss"])] = loss * 0 + 1.0
    for p, g in grads.items():
        env[grad_var_name(p)] = g
    # rest_ops[0] is the backward_marker itself
    run_ops(rest_ops[1:], env, seed, start_index=k + 1, program=program,
            device=device, dp=dp)
    if (dp is not None and dp.local_state and dp.group is not None
            and NUMERICS_BITS_VAR in env):
        # the update ops' bits were taken on this rank's slices
        env[NUMERICS_BITS_VAR] = _obs_num.or_across_axis(
            env[NUMERICS_BITS_VAR], dp.group)
    if finite is not None:
        # a non-finite step becomes a full state no-op: every value the
        # update ops wrote selects back to its pre-update snapshot
        _guard.select_updates(finite, env, pre_update)
    tel_var = _obs_metrics.TELEMETRY_VAR
    if getattr(program, "_telemetry_enabled", False) and tel_var in env:
        env[tel_var] = _obs_metrics.device_update(env[tel_var], loss, grads,
                                                  trainable, env)
        if finite is not None:
            env[tel_var] = _guard.guard_telemetry_update(env[tel_var],
                                                         finite, guard_cfg)
        if num_on:
            bits = env.pop(NUMERICS_BITS_VAR)
            tel = _obs_num.device_group_update(
                env[tel_var], grads, trainable, env,
                _obs_num.param_groups(trainable))
            env[tel_var] = _obs_num.latch_step_bits(
                tel, bits,
                poisoned_extra=None if finite is None else ~finite)
    return env


def _to_numpy(t):
    """A fetched value as numpy; a tensor array's (buffer, length) pair
    as a pair of arrays (the reference returns the pair only with
    return_numpy=False)."""
    if isinstance(t, tuple):
        return tuple(_to_numpy(p) for p in t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


class Executor:
    """Run programs on one device (reference: python/paddle/fluid/
    executor.py:445 Executor.run and paddle/fluid/framework/executor.cc).

    place: CUDAPlace(id) or CPUPlace(); None means CUDAPlace(0) and
    raises when CUDA is not available.
    """

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Any]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True,
            iterations: int = 1,
            accumulation_steps: int = 1):
        """Run `program` (reference: paddle_tpu/core/executor.py:1141).

        use_program_cache: accepted for the reference's signature; the
            port compiles nothing per program, so there is no cache to
            turn off (the pruned op lists it memoizes are keyed by the
            program's version and always valid).
        iterations: run the step K times on the same feeds and return
            the last run's fetches, as the reference's
            `chain_iterations` (:1089-1108).  Each iteration is one run
            of the RNG counter, so `iterations=3` draws the same dropout
            streams as three `run` calls (the reference also advances
            its key once per chained step, :1339).
        accumulation_steps: K > 1 splits every fed array into K
            micro-batches along dim 0 and averages their gradients
            before one update (`_accumulate_gradients`); each
            micro-batch draws its own random streams, and the run
            counter advances once a step.  Composes with `iterations`.
        """
        from .program import default_main_program

        if int(iterations) < 1:
            raise ValueError(f"iterations must be >= 1, got {iterations}")
        if int(accumulation_steps) < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got "
                             f"{accumulation_steps}")

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        # `program` may be a CompiledProgram (passed directly, fluid
        # style) or a Program a CompiledProgram wrapped
        compiled = program if (hasattr(program, "_program")
                               and hasattr(program, "run")) \
            else getattr(program, "_compiled_wrapper", None)
        if compiled is not None:
            return compiled.run(self, dict(feed or {}), fetch_names, scope,
                                return_numpy=return_numpy,
                                iterations=int(iterations),
                                accumulation_steps=int(accumulation_steps))
        return self._run_program(program, feed, fetch_names, scope,
                                 return_numpy, int(iterations),
                                 int(accumulation_steps))

    def _run_program(self, program: Program, feed, fetch_names, scope,
                     return_numpy=True, iterations: int = 1,
                     accum_steps: int = 1, dp=None):
        """`run` after the CompiledProgram dispatch; `dp` is a
        data-parallel run's DataParallelRunner."""
        block = program.global_block()
        feeds = {name: self._to_tensor(value, block, name)
                 for name, value in (feed or {}).items()}
        if dp is not None:
            dp.prepare_state(program, scope, self.device)
            feeds = dp.shard_feeds(feeds, accum_steps)
        # one dispatch in runtime_stats, with its host time: on a card
        # the time to enqueue the step's kernels, not the device time
        with dispatch_timer():
            for _ in range(iterations):
                env = self._run_once(program, scope, feeds, fetch_names,
                                     accum_steps, dp)
        if dp is not None:
            dp.end_step()
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch target(s) {missing} were not computed "
                           f"by the program")
        # a SparseGrad fetch is the dense gradient it stands for
        fetches = [densify(env[n]) for n in fetch_names]
        if dp is not None:
            fetches = [dp.fetch_value(n, f)
                       for n, f in zip(fetch_names, fetches)]
        if return_numpy:
            # numpy has no bf16: a bf16 fetch (an AMP program's
            # intermediate) comes back widened, exactly, to float32
            fetches = [_to_numpy(f) for f in fetches]
        return fetches

    def _run_once(self, program: Program, scope: Scope, feeds,
                  fetch_names, accum_steps: int = 1, dp=None):
        """One step: the scope's persistable state and the telemetry
        accumulator (seeded as the reference's `_prepare` does,
        paddle_tpu/core/executor.py:1268-1280) in, the program
        interpreted, the new state written back."""
        block = program.global_block()
        run = scope.find_var(RNG_STATE_VAR) or 0
        scope.set_var(RNG_STATE_VAR, run + 1)
        env: Dict[str, Any] = {}
        for v in block.vars.values():
            if v.persistable and scope.find_var(v.name) is not None:
                env[v.name] = scope.find_var(v.name)
                if dp is not None:
                    env[v.name] = dp.load_state(v.name, env[v.name])
                    if env[v.name] is None:
                        # a pipelined layer's state another pp stage holds
                        del env[v.name]
        tel_var = _obs_metrics.TELEMETRY_VAR
        if getattr(program, "_telemetry_enabled", False):
            tel = scope.find_var(tel_var)
            if tel is None:
                tel = _obs_metrics.init_telemetry_for(program, self.device)
            else:
                tel = _obs_metrics.ensure_numerics_fields(program, tel,
                                                          self.device)
            env[tel_var] = tel
        env.update(feeds)
        env = interpret_program(program, env, (program.random_seed, run),
                                fetch_names=fetch_names, device=self.device,
                                accum_steps=accum_steps,
                                feed_names=tuple(feeds), dp=dp)
        for v in block.vars.values():
            if v.persistable and v.name in env:
                scope.set_var(v.name, env[v.name] if dp is None
                              else dp.store_state(v.name, env[v.name]))
        if tel_var in env:
            scope.set_var(tel_var, env[tel_var])
        return env

    def close(self):
        """Drop the memoized step records (`compiled_step`)."""
        self.__dict__.pop("_step_records", None)

    def compiled_step(self, program: Program, feed=None, fetch_list=None,
                      scope: Optional[Scope] = None,
                      with_names: bool = False):
        """The step record of `program` (observe/cost.py `StepRecord`):
        one run of its step, recorded, on copies of the scope's state —
        the port's counterpart of the reference's compiled step, which
        it has no compile to return (ROADMAP C21).  The scope, its run
        counter and the kernels' launch counts are left as they were.
        Memoized per (program, version, feeds' shapes and dtypes,
        fetches), as the reference's AOT cache is.  Exposes
        `cost_analysis()` and `memory_analysis()`.

        with_names=True returns (record, labels): one ("state"|"feed",
        name) label per input of the step."""
        from ..observe.cost import record_step

        feed = dict(feed or {})
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        block = program.global_block()
        sig = []
        for n, v in sorted(feed.items()):
            t = v if isinstance(v, torch.Tensor) \
                else self._to_tensor(v, block, n)
            sig.append((n, tuple(t.shape), str(t.dtype)))
        key = (program._uid, program._version, tuple(sig),
               tuple(fetch_names))
        cache = self.__dict__.setdefault("_step_records", {})
        record = cache.get(key)
        if record is None:
            record = cache[key] = record_step(
                self, program, feed, fetch_names,
                scope if scope is not None else global_scope())
        return (record, record.labels) if with_names else record

    def cost_analysis(self, program: Program, feed=None, fetch_list=None,
                      scope: Optional[Scope] = None):
        """{"flops", "transcendentals", "bytes accessed"} of the
        program's recorded step (`compiled_step`), the hand-written
        kernels' registered costs included: the totals of
        observe.cost's per-op table."""
        return self.compiled_step(program, feed=feed,
                                  fetch_list=fetch_list,
                                  scope=scope).cost_analysis()

    def _to_tensor(self, value, block, name):
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        arr = np.asarray(value)
        if block.has_var(name):
            from ..ops.common import to_torch_dtype

            return torch.as_tensor(arr).to(
                device=self.device,
                dtype=to_torch_dtype(block.var(name).dtype))
        return torch.as_tensor(arr, device=self.device)
