"""The data-parallel step: one process per rank, explicit collectives.

The port of what the reference gets from GSPMD (its default mode) and
from `_dp_sync_value_and_grad` (paddle_tpu/core/executor.py:692-930,
its explicit `grad_sync` mode).  A `DataParallelRunner` belongs to one
CompiledProgram; the Executor hands it each run (`core/executor.py`).

Feeds.  A feed whose dim 0 divides the data ranks (`ShardingRules.
feed_spec_for` over every data axis) is sliced, each rank keeping its
dim-0 slice; under K-step accumulation the rank keeps its slice of each
of the K global micro-batches, so micro-batch k is the reference's.  A
run with no sliced feed (a final partial batch) runs replicated: every
rank computes the whole batch and no exchange runs, exact as in the
reference.  A feed that divides the batch axis but not every data axis
replicates too (the reference keeps the batch axis; ROADMAP C16).

Classification.  The live forward runs on "meta" tensors at the rank's
batch and at the global batch, the two runs in lockstep op by op
(memoized per program version and feed shapes): a var whose dim 0
scales with the batch is "batch", one whose shape does not change is
"rep", any other "other" — the reference's local-against-global
`eval_shape` (:797-829), each op through the executor's own dispatch.
An op that reads values on the host (NO_META_OPS) takes its outputs'
declared shapes (-1 = batch).  In the default mode an op that mixes
rows along the batch dim of a batch input raises before it runs
(`mixes_batch_rows`, ROADMAP C17): an axis attr naming the batch dim
(softmax, cumsum, argsort, reverse, concat, slice, split, ...), a
gather/scatter whose index and data are both of the batch, or an
`expand` tiling it; and after it runs, an output whose shape changes
with the batch on more than one dim (x @ y^T of two batch inputs) or a
reshape that leaves a rank's rows other than its slice
(`breaks_batch_layout`).

Default mode (no grad_sync): the global-batch program.  An op with a
batch (or "other") input and a "rep" output reduces over the batch dim;
it runs with `OpContext.cross_rank` (a `collectives.DataGroup`) and its
own cross-rank branch computes the global value: `mean`, `reduce_sum`,
`reduce_mean`, `batch_norm` (sums of x, x^2 and the count over the ranks,
then the reference's E[x^2] - mean^2), `accuracy`, `auc`, `shape`,
`moe_ffn` (the data ranks' tokens gathered and routed together, each
rank keeping its rows; the gather's backward sums its cotangents over
the ranks).  Any other such op raises NotImplementedError (ROADMAP
C16).  The sums are
`CrossRankSum`s, whose backward all-reduces the cotangent, so with each
rank seeding its (global) loss with 1 the all-reduced MEAN of the
ranks' gradients is the global loss's gradient for any loss the forward
builds from those reductions — a mean, a sum, or the Transformer's and
BERT's ratio of sums — and every replicated output (fetches, batch-norm
moving statistics) is the global run's, bit-identical on every rank.
`dropout` draws its mask at the global batch and keeps its rows, so a
rank's mask is the one-process program's.

Explicit mode (grad_sync "bf16"/"int8"): each rank runs its own shard's
program (local batch-norm statistics), the loss and the replicated float
outputs pmean, int outputs pmax, dense gradients pmean or go through
the blockwise-int8 exchange, and the RNG folds in the data-rank index.
It refuses what the reference refuses: gradient accumulation, and
params sharded over a data axis.

Both modes: a SparseGrad gathers its ids and its rows (scaled 1/n) over
the data group, unquantized; fetches of batch vars are gathered back to
the global batch; the numerics bitmap ORs across the ranks.

ZeRO.  A state var whose `state_spec_for` shards it over a data axis is
held in the scope as a DTensor of this rank's slice (its logical value
is the global one).  Optimizer state (ZeRO-1, an `fsdp` axis) stays a
slice inside the step: each update op runs on the slices of its
param, gradient and state (`run_update_op`), and the param slices are
all-gathered.  Other sharded state (ZeRO-3: `ReduceStrategy.Reduce`'s
params) is all-gathered before the forward, its gradient all-reduced
(the reduce-scatter, as an all-reduce then a slice) and its update run
on the slice.  `lars_momentum` all-reduces its norms over the slice's
group.

The model axes share this runner (ROADMAP A step 10b).  State that the
rules shard over a model axis (`mp`, `ep`) is held as this rank's chunk
through the whole step (`model_specs`), beside a data axis too (a
DTensor over both); on an `mp` axis each forward runs under the
tensor-parallel plan (`model_run`, parallel/tensor_parallel.py), the
classification's meta runs included.  On a `pp` axis each rank holds
only its stage's pipelined layers and their optimizer state
(`StageHeld`, parallel/pipeline_engine.py), the update ops of the
others' are skipped (`absent`), and each pipeline_scope group runs as
the GPipe schedule (`run_pipelined`), which the meta runs take as a
whole.  The data group is the mesh's data axes' group beside the model
axes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.selected_rows import SparseGrad, densify
from .compiler import MODEL_AXES
from .collectives import (DataGroup, data_group_of,
                          quantized_all_reduce_local,
                          quantized_all_reduce_psum)

# ops whose own cross-rank branch computes the global value (see the
# module docstring); dropout draws its global mask
CROSS_RANK_OPS = {"mean", "reduce_sum", "reduce_mean", "batch_norm",
                  "accuracy", "auc", "shape", "moe_ffn"}
GLOBAL_DRAW_OPS = {"dropout"}

# folded into the seed material under an explicit grad_sync mode (the
# reference's fold_in(key, data-rank index))
RANK_SEED_BASE = 7331

# ops that read tensor values on the host, which "meta" tensors do not
# hold: the meta run takes their outputs' declared shapes
NO_META_OPS = {"while", "switch", "dynamic_rnn", "print", "py_func",
               "paged_kv_write", "paged_kv_prefill_write"}

# ops whose cross-rank form takes the batch as dim 0: an input whose
# batch dim is elsewhere ("other", e.g. time-major) raises (C16)
BATCH_DIM0_OPS = {"shape", "dropout"}

# a feed stands in on the meta run at this many rows a rank, against n
# times as many: any two sizes classify
_META_ROWS = 3


def _meta(v):
    if isinstance(v, torch.Tensor):
        return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
    if isinstance(v, SparseGrad):
        return _meta(v.rows)
    if isinstance(v, tuple):
        return tuple(_meta(p) for p in v)
    return v


def _shape_of(v):
    if isinstance(v, torch.Tensor):
        return tuple(v.shape)
    if isinstance(v, tuple):
        return tuple(_shape_of(p) for p in v)
    return None


def _is_shape(s):
    return isinstance(s, tuple) and all(isinstance(d, int) for d in s)


def _batch_dim(sl, sg, n):
    """The one dim of a value that holds the batch (the global run's
    size n times the rank's, every other dim equal), or None."""
    if not (_is_shape(sl) and _is_shape(sg) and len(sl) == len(sg)):
        return None
    diff = [d for d in range(len(sl)) if sl[d] != sg[d]]
    if len(diff) == 1 and sg[diff[0]] == n * sl[diff[0]]:
        return diff[0]
    return None


def _classify(sl, sg, n):
    if sl == sg:
        return "rep"
    return "batch" if _batch_dim(sl, sg, n) == 0 else "other"


# the attrs that name dims of an op's inputs
AXIS_ATTRS = ("axis", "axes", "dim")
# ops that act along a dim without the attr when their builder leaves it
# out (the last dim)
IMPLICIT_LAST_AXIS = {"softmax", "log_softmax", "top_k", "argsort",
                      "cumsum", "arg_max", "arg_min"}
# elementwise ops: their `axis` aligns Y's dims with X's (broadcasting),
# it names no dim the op acts along
BROADCAST_OPS = {"less_than", "less_equal", "greater_than", "greater_equal",
                 "equal", "not_equal", "logical_and", "logical_or",
                 "logical_xor"}
# ops whose axis attrs move or add dims without mixing rows: a
# permutation, size-1 dims and a stack of whole tensors (the batch dim
# of their output is then another dim, class "other")
AXIS_KEEPS_ROWS = {"transpose", "squeeze", "unsqueeze", "stack"}
# the gather/scatter family: an index input selects rows of another
# input (batched_gather indexes within each row and mixes none)
INDEX_OPS = {"gather", "scatter", "sequence_scatter"}
INDEX_SLOTS = ("Index", "Ids")


def _named_axes(op_type, attrs):
    for key in AXIS_ATTRS:
        if key in attrs and attrs[key] is not None:
            v = attrs[key]
            return [int(a) for a in v] if isinstance(v, (list, tuple)) \
                else [int(v)]
    return [-1] if op_type in IMPLICIT_LAST_AXIS else []


def mixes_batch_rows(op_type, attrs, inputs, in_cls, in_shapes,
                     in_dims=None):
    """Why an op mixes rows along the batch dim of an input (a reason
    string), or None: an axis attr naming the batch dim of an input
    (softmax, cumsum, argsort, reverse, concat, slice, split, ...; dim 0
    of a "batch" input, `in_dims` gives the batch dim of the others),
    an index input of the batch selecting rows of a batch input
    (gather, scatter), or `expand` tiling the batch dim.  On a rank's
    batch slice such an op computes on that rank's rows alone (ROADMAP
    C17).  Reductions (`reduce_*`, the cross-rank ops) reduce the batch
    to a replicated value and are the plan's `reducing` rule's;
    elementwise broadcasting and the AXIS_KEEPS_ROWS ops mix nothing."""
    dims = {n: 0 for n, c in in_cls.items() if c == "batch"}
    dims.update({n: d for n, d in (in_dims or {}).items() if d is not None})
    batch = list(dims)
    if not batch:
        return None
    index_in = {n for slot in INDEX_SLOTS for n in inputs.get(slot, ())}
    if op_type in INDEX_OPS and index_in:
        data_in = {n for names in inputs.values() for n in names} - index_in
        if any(in_cls.get(n) not in (None, "rep") for n in index_in) and \
                any(in_cls.get(n) not in (None, "rep") for n in data_in):
            return "indexes rows of the batch by an index of the batch"
    if (op_type.startswith(("elementwise_", "reduce_"))
            or op_type in BROADCAST_OPS or op_type in AXIS_KEEPS_ROWS
            or op_type in CROSS_RANK_OPS):
        return None
    axes = _named_axes(op_type, attrs)
    for n in batch:
        shape = in_shapes.get(n)
        if not isinstance(shape, tuple) or not shape:
            continue
        if any(a % len(shape) == dims[n] for a in axes):
            return f"acts along the batch dim (dim {dims[n]}) of {n!r}"
        if op_type == "expand":
            times = list(attrs.get("expand_times") or ())
            times = [1] * max(0, len(shape) - len(times)) + times
            if times[dims[n] + len(times) - len(shape)] != 1:
                return f"tiles the batch dim (dim {dims[n]}) of {n!r}"
    return None


# ops that lay a value's elements out anew in row-major order
RESHAPE_OPS = {"reshape", "flatten"}


def breaks_batch_layout(op_type, in_dims, in_shapes, out_dims, out_shapes):
    """Why an op's output holds the batch in a layout that is not this
    rank's slice of the global run's value (a reason string), or None.
    `in_dims`/`out_dims`: each non-replicated value's batch dim, None
    where no one dim holds it.  An output whose shape changes with the
    batch on more than one dim pairs rows of the batch (x @ y^T of two
    batch inputs gives (b, b) on a rank, (B, B) globally: a rank
    computes only its diagonal block); a reshape keeps a rank's rows its
    slice only while every dim before the batch dim is 1.  Empty values
    (a reshape's XShape) hold no rows."""
    if not in_dims:
        return None
    for n, d in out_dims.items():
        if d is None and 0 not in out_shapes[n]:
            return (f"gives {n!r} a shape that changes with the batch on "
                    f"more than its batch dim ({out_shapes.get(n)} on a "
                    f"rank): it pairs rows of the batch")
    if op_type in RESHAPE_OPS:
        for dims, shapes in ((in_dims, in_shapes), (out_dims, out_shapes)):
            for n, d in dims.items():
                if d is not None and 0 not in shapes[n] \
                        and int(np.prod(shapes[n][:d])) != 1:
                    return (f"reshapes {n!r}, whose batch dim (dim {d}) "
                            f"follows dims of size {shapes[n][:d]}: a "
                            f"rank's rows are then not its slice")
    return None


class _MetaRun:
    """One meta run of the live forward with every sliced feed at
    `rows` rows: each op through the executor's dispatch on "meta"
    tensors; an op of NO_META_OPS takes its outputs' declared shapes
    (-1 = the batch)."""

    def __init__(self, program, env, feeds, rows, tp_run=None):
        self.program, self.rows, self.tp_run = program, rows, tp_run
        self.env = {k: _meta(v) for k, v in env.items()}
        for name in feeds:
            v = self.env.get(name)
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                self.env[name] = torch.empty((rows,) + tuple(v.shape[1:]),
                                             dtype=v.dtype, device="meta")
        self.amp_lists = getattr(program, "_amp_lists", None)

    def in_shapes(self, op):
        return {n: _shape_of(self.env.get(n)) for n in op.desc.input_names()}

    def run(self, i, op):
        from ..core.executor import _run_one_op
        from ..ops.common import to_torch_dtype

        d = op.desc
        if d.type in NO_META_OPS:
            block = self.program.global_block()
            for n in d.output_names():
                if block.has_var(n):
                    var = block.var(n)
                    self.env[n] = torch.empty(
                        tuple(self.rows if s == -1 else s
                              for s in var.shape),
                        dtype=to_torch_dtype(var.dtype), device="meta")
        else:
            import contextlib

            from .tensor_parallel import activated

            with (contextlib.nullcontext() if self.tp_run is None
                  else activated(self.tp_run)):
                _run_one_op(op, self.env, None, i, program=self.program,
                            device=torch.device("meta"),
                            amp_lists=self.amp_lists)
        return {n: _shape_of(self.env.get(n)) for n in d.output_names()}


class _Plan:
    """One classification: the class of every name the forward writes
    or reads as a feed, and the op descs that reduce over the batch."""

    def __init__(self, cls, reducing, drawing, other_in):
        self.cls = cls
        self.reducing = reducing
        self.drawing = drawing
        self.other_in = other_in


class DataParallelRunner:
    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.mesh = wrapper._mesh
        self.axes = tuple(wrapper.data_axes())
        self.n = int(np.prod([self.mesh.shape[a] for a in self.axes],
                             dtype=np.int64)) if self.axes else 1
        self.group: Optional[DataGroup] = (
            data_group_of(self.mesh, self.axes) if self.n > 1 else None)
        self.index = self.group.index if self.group is not None else 0
        self.cfg = getattr(wrapper._program, "_grad_sync", None)
        self.active = False          # this run's feeds are sliced
        self.accum = 1
        self.plan: Optional[_Plan] = None
        self._plans: Dict[Any, _Plan] = {}
        self._specs_key = None
        self.specs: Dict[str, tuple] = {}    # name -> (dim, data axis)
        # name -> [(dim, model axis)]: state held as this rank's chunk
        # over the model axes through the whole step
        self.model_specs: Dict[str, list] = {}
        self.local_state: set = set()
        # a state var's shape in the step (its chunk over the model
        # axes) and its logical shape
        self.global_shapes: Dict[str, tuple] = {}
        self.logical_shapes: Dict[str, tuple] = {}
        from .tensor_parallel import AxisGroup

        self.tp = (AxisGroup(self.mesh)
                   if self.mesh.shape.get("mp", 1) > 1 else None)
        self.tp_run = None
        self.device = None
        # pipelining: {state var: its pp stage}, and the ones another
        # stage holds (absent from this rank's step)
        self.pp_active = self.mesh.shape.get("pp", 1) > 1
        self.stage_of: Dict[str, int] = {}
        self.absent: set = set()

    @property
    def explicit(self) -> bool:
        return self.cfg is not None

    # -- state ----------------------------------------------------------
    def prepare_state(self, program, scope, device=None):
        """The sharded state vars of `program` (memoized per program
        version): their (dim, axis), their global shapes, and which stay
        a slice inside the step (optimizer state).  `device`: where the
        step runs (a DTensor on a gloo mesh keeps its slice on the
        host)."""
        self.device = device
        key = (program._uid, program._version)
        if key == self._specs_key:
            return
        from .compiler import program_var_buckets

        params, opt = program_var_buckets(program)
        specs, shapes, model, logical = {}, {}, {}, {}
        for v in program.global_block().vars.values():
            if not v.persistable:
                continue
            val = scope.find_var(v.name)
            if not isinstance(val, torch.Tensor):
                continue
            shape = tuple(val.shape)
            spec = self.wrapper.state_spec_for(v.name, shape)
            dims = [(d, a) for d, a in enumerate(spec) if a is not None]
            if not dims:
                continue
            if any(isinstance(a, (tuple, list)) for _, a in dims):
                raise NotImplementedError(
                    f"state var {v.name!r}: a dim sharded over several "
                    f"axes at once {spec} is not supported; shard each "
                    f"dim over one axis")
            mdims = [(d, a) for d, a in dims if a in MODEL_AXES]
            ddims = [(d, a) for d, a in dims if a not in MODEL_AXES]
            if len(ddims) > 1:
                raise NotImplementedError(
                    f"state var {v.name!r} sharded over the data axes "
                    f"{[a for _, a in ddims]} on separate dims; one data "
                    f"axis a var (ZeRO composes one)")
            step = list(shape)
            for d, a in mdims:
                step[d] //= self.mesh.shape[a]
            if mdims:
                model[v.name] = mdims
            if ddims:
                specs[v.name] = ddims[0]
            shapes[v.name] = tuple(step)
            logical[v.name] = shape
        if self.pp_active:
            self._hold_stages(program, scope)
        if self.explicit:
            bad = sorted(p for p in params if p in specs
                         and specs[p][1] in self.axes)
            if bad:
                raise ValueError(
                    f"grad_sync={self.cfg.mode!r} cannot run with params "
                    f"sharded over the data axes {self.axes}: {bad[:4]}… "
                    f"every rank's exchange would have to all-gather them "
                    f"every step.  Keep params replicated, or use the "
                    f"default sync for ZeRO-3-style param sharding.")
        self.specs, self.global_shapes = specs, shapes
        self.model_specs, self.logical_shapes = model, logical
        self.local_state = {n for n in specs if n in opt}
        self._specs_key = key

    def _axis_n(self, axis):
        return self.mesh.shape[axis]

    def _slice(self, value, name):
        dim, axis = self.specs[name]
        return value.chunk(self._axis_n(axis), dim=dim)[
            self.mesh.coordinate(axis)].contiguous()

    def _gather(self, local, name):
        dim, axis = self.specs[name]
        g = DataGroup(self.mesh.group(axis), self._axis_n(axis),
                      self.mesh.coordinate(axis))
        return g.all_gather(local, dim=dim)

    def load_state(self, name, value):
        """A scope value as the step's env holds it: its chunk over the
        model axes; optimizer state on a data axis as this rank's slice,
        other data-sharded state whole over the data axes."""
        from torch.distributed.tensor import DTensor

        from .pipeline_engine import StageHeld

        if isinstance(value, StageHeld):
            return value.value
        if name not in self.specs and name not in self.model_specs:
            return value.full_tensor() if isinstance(value, DTensor) \
                else value
        if isinstance(value, DTensor):
            local = value.to_local()
            if self.device is not None and local.device != self.device:
                # DTensor.from_local moved it to a gloo mesh's host
                local = local.to(self.device)
            if name in self.specs and name not in self.local_state:
                local = self._gather(local, name)
            return local
        from .tensor_parallel import state_chunk

        value = state_chunk(value, self.mesh, self.model_specs.get(name, ()))
        return self._slice(value, name) if name in self.local_state \
            else value

    def store_state(self, name, value):
        """An env value as the scope holds it: a sharded var as a
        DTensor of this rank's slice."""
        if name in self.stage_of and isinstance(value, torch.Tensor):
            from .pipeline_engine import StageHeld

            return StageHeld(value, self.stage_of[name], self.mesh,
                             value.shape, value.dtype)
        if (name not in self.specs and name not in self.model_specs) or \
                not isinstance(value, torch.Tensor):
            return value
        from torch.distributed.tensor import DTensor, Replicate, Shard

        local = value
        if name in self.specs and name not in self.local_state:
            local = self._slice(value, name)
        dims = list(self.model_specs.get(name, ()))
        if name in self.specs:
            dims.append(self.specs[name])
        shape = torch.Size(self.logical_shapes[name])
        stride = torch.empty(shape, device="meta").stride()
        by_axis = {a: d for d, a in dims}
        placements = [Shard(by_axis[a]) if a in by_axis else Replicate()
                      for a in self.mesh.axis_names]
        return DTensor.from_local(local.contiguous(),
                                  self.mesh.device_mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)

    # -- the model axes ---------------------------------------------------
    def _hold_stages(self, program, scope):
        """Each pipelined layer's state on its pp stage only: the scope
        holds a `StageHeld` for it, the tensor on its stage's rank."""
        from .pipeline_engine import StageHeld, stage_ownership

        self.stage_of = stage_ownership(program, self.mesh.shape["pp"])
        me = self.mesh.coordinate("pp")
        self.absent = {n for n, st in self.stage_of.items() if st != me}
        for n, st in self.stage_of.items():
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor):
                scope.set_var(n, StageHeld(v if st == me else None, st,
                                           self.mesh, v.shape, v.dtype))

    def run_pipelined(self, ops, env, seed, start_index, program, device,
                      amp_lists, downstream_reads=None):
        """A pipeline_scope group through the GPipe schedule."""
        from .pipeline_engine import run_pipelined_group

        ctx_n = self.wrapper._pp_microbatches
        run_pipelined_group(ops, env, seed, start_index, program, self.mesh,
                            batch_axis=self.wrapper._batch_axis,
                            n_micro_req=ctx_n, amp_lists=amp_lists,
                            downstream_reads=downstream_reads,
                            device=device,
                            data_n=self.n if self.active else 1)

    def model_sharded(self) -> set:
        """The state vars held as chunks over a model axis."""
        return set(self.model_specs)

    def model_run(self):
        """The tensor-parallel run of a forward (a context manager; a
        no-op off an `mp` mesh)."""
        import contextlib

        if self.tp is None:
            return contextlib.nullcontext()
        from .tensor_parallel import activated

        self.tp_run = self.tp.run(self._tp_state_place())
        return activated(self.tp_run)

    def _tp_state_place(self):
        from .tensor_parallel import SHARDED

        return {n: (SHARDED, d) for n, dims in self.model_specs.items()
                for d, a in dims if a == "mp"}

    def end_step(self):
        if self.tp is not None:
            self.tp.end_step()

    # -- feeds ----------------------------------------------------------
    def shard_feeds(self, feeds: Dict[str, torch.Tensor], accum: int):
        """This rank's feeds; sets `active` (some feed is sliced)."""
        self.accum = accum
        self.active = False
        if self.tp is not None:
            self.tp.begin_step()
            self.tp_run = None
        if self.n <= 1:
            return dict(feeds)
        rules, mesh = self.wrapper._rules, self.mesh
        entry = self.axes[0] if len(self.axes) == 1 else tuple(self.axes)
        sliced = {name for name, v in feeds.items()
                  if v.dim() >= 1 and rules.feed_spec_for(
                      name, tuple(v.shape), mesh,
                      batch_axis=self.wrapper._batch_axis)[:1] == (entry,)}
        if not sliced:
            return dict(feeds)
        self.active = True
        out = {}
        n, i = self.n, self.index
        for name, v in feeds.items():
            if name not in sliced:
                out[name] = v
                continue
            b = v.shape[0]
            if accum > 1 and b % (n * accum) == 0:
                # rank i's rows of each of the K global micro-batches
                v = v.reshape((accum, n, b // (n * accum))
                              + tuple(v.shape[1:]))[:, i]
                out[name] = v.reshape((b // n,) + tuple(v.shape[2:]))
            else:
                out[name] = v.chunk(n, dim=0)[i]
        return out

    def fold_seed(self, seed):
        """The explicit mode's per-rank random streams."""
        if not self.explicit or not self.active or seed is None:
            return seed
        return tuple(seed) + (RANK_SEED_BASE + self.index,)

    # -- classification -------------------------------------------------
    def classify(self, program, ops, env, feed_names):
        """Classify the names `ops` (the live forward, as (index, op))
        write, and pick the ops that reduce over the batch; memoized."""
        if not self.active:
            self.plan = None
            return None
        fed = tuple(sorted((n, _shape_of(env[n])) for n in feed_names
                           if n in env))
        key = (program._uid, program._version, fed,
               tuple(i for i, _ in ops), self.accum)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._build_plan(
                program, ops, env, set(feed_names))
        self.plan = plan
        return plan

    def _build_plan(self, program, ops, env, feed_names):
        """Classify by two meta runs in lockstep, op by op: the rank's
        rows and the global batch's.  In the default mode an op that
        mixes rows along the batch dim raises before it runs
        (`mixes_batch_rows`, ROADMAP C17)."""
        sliced = {n for n in feed_names if n in env}
        runs = [_MetaRun(program, env, sliced, rows,
                         None if self.tp is None
                         else self.tp.run(self._tp_state_place()))
                for rows in (_META_ROWS, _META_ROWS * self.n)]
        cls = {}
        for n in sliced:
            v = env[n]
            cls[n] = "batch" if isinstance(v, torch.Tensor) \
                and v.dim() >= 1 else "rep"
        reducing, drawing, other_in = set(), set(), set()
        groups = self._pp_meta_groups(ops)
        skip = set()
        for i, op in ops:
            if i in groups:
                skip.update(self._pp_meta_group(groups[i], runs, cls))
            if i in skip:
                continue
            il, ig = (r.in_shapes(op) for r in runs)
            in_cls = {n: _classify(il[n], ig[n], self.n) for n in il}
            in_dims = {n: _batch_dim(il[n], ig[n], self.n)
                       for n, c in in_cls.items() if c != "rep"}
            if not self.explicit:
                self._refuse_mixing(op, mixes_batch_rows(
                    op.desc.type, op.desc.attrs, op.desc.inputs, in_cls,
                    il, in_dims))
            ol, og = (r.run(i, op) for r in runs)
            out_cls = {n: _classify(ol[n], og[n], self.n) for n in ol}
            if not self.explicit:
                self._refuse_mixing(op, breaks_batch_layout(
                    op.desc.type, in_dims, il,
                    {n: _batch_dim(ol[n], og[n], self.n)
                     for n, c in out_cls.items()
                     if c != "rep" and _is_shape(ol[n])}, ol))
            cls.update(out_cls)
            batch_in = any(c != "rep" for c in in_cls.values())
            if "other" in in_cls.values():
                other_in.add(id(op.desc))
            if batch_in and any(c == "rep" and ol[n] is not None
                                for n, c in out_cls.items()):
                reducing.add(id(op.desc))
            if batch_in and op.desc.type in GLOBAL_DRAW_OPS:
                drawing.add(id(op.desc))
        return _Plan(cls, reducing, drawing, other_in)

    @staticmethod
    def _refuse_mixing(op, why):
        if why:
            raise NotImplementedError(
                f"op {op.desc.type!r} {why} (inputs "
                f"{op.desc.input_names()}); on a rank's batch slice it "
                f"would mix that rank's rows only, not the global "
                f"batch's, and the port has no cross-rank form of it "
                f"(ROADMAP C16, C17).  grad_sync='bf16' runs each rank's "
                f"shard on its own instead")

    def _pp_meta_groups(self, ops):
        """On a pp mesh, {index of a pipeline_scope group's first op:
        (the group's analysis, its op indices)}."""
        if not self.pp_active:
            return {}
        from .pipeline_engine import analyze_group, pipeline_groups

        listed = [op for _, op in ops]
        block = self.wrapper._program.global_block()
        return {ops[a][0]: (analyze_group(listed[a:b], block),
                            [i for i, _ in ops[a:b]])
                for a, b in pipeline_groups(listed)}

    @staticmethod
    def _pp_meta_group(group, runs, cls):
        """The meta runs take a pipeline_scope group as a whole: its
        final carry keeps the shape and class of its input carry (the
        stage layers map the carry to itself).  Returns the group's op
        indices, which the classification skips."""
        info, indices = group
        ext0 = info["infos"][0]["externals"]
        for k, pos in enumerate(info["carry_pos"]):
            out = info["final_out_names"][k]
            for r in runs:
                r.env[out] = r.env[ext0[pos]]
            cls[out] = cls.get(ext0[pos], "rep")
        return indices

    def check_plan(self, program, ops, keep):
        """Raise for what the port cannot run: (default mode) an op that
        reduces over the batch without a cross-rank branch, or a
        BATCH_DIM0_OPS op on an input whose batch dim is not dim 0;
        (both) a kept forward output whose batch dim is not dim 0."""
        plan = self.plan
        if plan is None:
            return
        if not self.explicit:
            for _, op in ops:
                d = op.desc
                if id(d) in plan.reducing and d.type not in CROSS_RANK_OPS:
                    raise NotImplementedError(
                        f"op {d.type!r} reduces over the batch dim "
                        f"(outputs {d.output_names()}); the global-batch "
                        f"program needs its cross-rank form, which the "
                        f"port lacks (ROADMAP C16).  grad_sync='bf16' runs "
                        f"each rank's shard on its own instead")
                if (d.type in BATCH_DIM0_OPS and id(d) in plan.other_in
                        and (id(d) in plan.reducing
                             or id(d) in plan.drawing)):
                    raise NotImplementedError(
                        f"op {d.type!r} reads an input whose batch dim is "
                        f"not dim 0 (inputs {d.input_names()}); its "
                        f"global-batch form takes the batch as dim 0 "
                        f"(ROADMAP C16).  grad_sync='bf16' runs each "
                        f"rank's shard on its own instead")
        bad = sorted(n for n in keep if plan.cls.get(n) == "other")
        if bad:
            raise ValueError(
                f"data parallelism cannot classify forward output(s) "
                f"{bad[:4]}: their shapes change with the batch beyond "
                f"the leading dim")

    def cross_rank_for(self, desc):
        """The DataGroup an op runs with (None: a plain local op)."""
        plan = self.plan
        if plan is None or self.explicit:
            return None
        key = id(desc)
        if key in plan.reducing or key in plan.drawing:
            return self.group
        return None

    # -- the exchange ---------------------------------------------------
    def exchange(self, loss, grads, env, out_names):
        """Synchronize after this rank's forward and backward: the
        gradients (and, in the explicit mode, the loss and the kept
        forward outputs) over the data group; the numerics bitmap ORs
        across it."""
        from ..observe.numerics import NUMERICS_BITS_VAR, or_across_axis

        g, n = self.group, self.n
        if self.explicit:
            loss = g.all_reduce(loss) / n
            for name in sorted(out_names):
                if self.plan.cls.get(name) != "rep" or name not in env:
                    continue
                v = env[name]
                if not isinstance(v, torch.Tensor):
                    continue
                if v.is_floating_point():
                    env[name] = g.all_reduce(v) / n
                elif v.dtype == torch.bool:
                    env[name] = g.all_reduce(v.to(torch.int32), "max") > 0
                else:
                    env[name] = g.all_reduce(v, "max")
        out = {}
        for p, grad in grads.items():
            out[p] = self._sync_grad(grad)
        if NUMERICS_BITS_VAR in env:
            env[NUMERICS_BITS_VAR] = or_across_axis(env[NUMERICS_BITS_VAR], g)
        return loss, out, env

    def _sync_grad(self, grad):
        g, n = self.group, self.n
        if isinstance(grad, SparseGrad):
            # ids + rows over the data group: densifies to the global
            # batch's scatter-add; never quantized
            scale = torch.tensor(1.0 / n, dtype=torch.float64).to(
                grad.rows.dtype)
            return SparseGrad(g.all_gather(grad.ids),
                              g.all_gather(grad.rows * scale),
                              grad.dense_shape)
        if self.explicit and self.cfg.mode == "int8":
            kw = dict(block_size=self.cfg.block_size,
                      min_quant_numel=self.cfg.min_quant_numel, op="mean")
            if len(self.axes) > 1:
                return quantized_all_reduce_psum(grad, g.group, n, **kw)
            return quantized_all_reduce_local(grad, g.group, n, **kw)
        return g.all_reduce(grad) / n

    def fetch_value(self, name, value):
        """A fetch as the global program's: a batch var gathered back
        to the global batch (in global row order under accumulation), a
        sharded state slice gathered whole."""
        if name in self.local_state and isinstance(value, torch.Tensor) \
                and tuple(value.shape) != self.global_shapes[name]:
            value = self._gather(value, name)
        base = name[:-len("@GRAD")] if name.endswith("@GRAD") else name
        if base in self.model_specs and isinstance(value, torch.Tensor) \
                and tuple(value.shape) == self.global_shapes[base]:
            from .tensor_parallel import gather_model_dims

            return gather_model_dims(value, self.mesh,
                                     self.model_specs[base])
        if self.tp_run is not None and name in self.tp_run.place:
            from .tensor_parallel import logical

            value = logical(self.tp, self.tp_run.place[name], value)
        plan = self.plan
        if (not self.active or plan is None
                or plan.cls.get(name) != "batch"
                or not isinstance(value, torch.Tensor)):
            return value
        parts = self.group.all_gather(value.unsqueeze(0), dim=0)
        k = self.accum
        if k > 1 and value.shape[0] % k == 0:
            parts = parts.reshape((self.n, k, value.shape[0] // k)
                                  + tuple(value.shape[1:])).transpose(0, 1)
        return parts.reshape((-1,) + tuple(value.shape[1:]))

    # -- update ops on ZeRO slices --------------------------------------
    def sliced_ref(self, desc):
        """The first ZeRO-sliced state var an update op reads, or None."""
        for n in desc.input_names():
            if n in self.local_state:
                return n
        return None

    def run_update_op(self, op, env, ref, run_one):
        """Run an update op on this rank's slices: inputs of the sliced
        var's global shape are sliced like it; outputs that are sliced
        state stay slices, the others are all-gathered whole.
        `run_one(op, env, cross_rank)` is the executor's op dispatch."""
        desc = op.desc
        gshape = self.global_shapes[ref]
        dim, axis = self.specs[ref]
        size, coord = self._axis_n(axis), self.mesh.coordinate(axis)
        tmp = dict(env)
        for n in desc.input_names():
            v = env[n]
            if n in self.local_state:
                continue
            if isinstance(v, SparseGrad) and tuple(v.dense_shape) == gshape:
                v = densify(v)
            if isinstance(v, torch.Tensor) and tuple(v.shape) == gshape:
                tmp[n] = v.chunk(size, dim=dim)[coord]
        group = DataGroup(self.mesh.group(axis), size, coord)
        run_one(op, tmp, group)
        local_shape = list(gshape)
        local_shape[dim] //= size
        for n in desc.output_names():
            v = tmp[n]
            if (n not in self.local_state and isinstance(v, torch.Tensor)
                    and list(v.shape) == local_shape):
                v = group.all_gather(v, dim=dim)
            env[n] = v
        from ..observe.numerics import NUMERICS_BITS_VAR

        if NUMERICS_BITS_VAR in tmp:
            env[NUMERICS_BITS_VAR] = tmp[NUMERICS_BITS_VAR]
        return env


def opt_state_bytes(scope, program) -> int:
    """This rank's bytes of optimizer state in `scope` (a DTensor counts
    its local slice): the per-rank bytes ZeRO cuts."""
    from torch.distributed.tensor import DTensor

    from .compiler import program_var_buckets

    _params, opt = program_var_buckets(program)
    total = 0
    for name in opt:
        v = scope.find_var(name)
        if isinstance(v, DTensor):
            v = v.to_local()
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total


def logical_value(value):
    """A scope value's logical (global) tensor: a DTensor gathered whole,
    a pipelined layer's `StageHeld` broadcast from its stage (both
    collectives: every rank of the mesh calls them), anything else as
    it is."""
    from torch.distributed.tensor import DTensor

    from .pipeline_engine import StageHeld

    return value.full_tensor() if isinstance(value, (DTensor, StageHeld)) \
        else value
