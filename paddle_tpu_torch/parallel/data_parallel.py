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

Classification.  The live forward runs once on "meta" tensors at the
rank's batch and at the global batch (memoized per program version and
feed shapes): a var whose dim 0 scales with the batch is "batch", one
whose shape does not change is "rep", any other "other" — the
reference's local-against-global `eval_shape` (:797-829), each op
through the executor's own dispatch.  An op that reads values on the
host (NO_META_OPS) takes its outputs' declared shapes (-1 = batch).

Default mode (no grad_sync): the global-batch program.  An op with a
batch (or "other") input and a "rep" output reduces over the batch dim;
it runs with `OpContext.cross_rank` (a `collectives.DataGroup`) and its
own cross-rank branch computes the global value: `mean`, `reduce_sum`,
`reduce_mean`, `batch_norm` (sums of x, x^2 and the count over the ranks,
then the reference's E[x^2] - mean^2), `accuracy`, `auc`, `shape`.  Any
other such op raises NotImplementedError (ROADMAP C16).  The sums are
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
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.selected_rows import SparseGrad, densify
from .collectives import (DataGroup, data_group_of,
                          quantized_all_reduce_local,
                          quantized_all_reduce_psum)

# ops whose own cross-rank branch computes the global value (see the
# module docstring); dropout draws its global mask
CROSS_RANK_OPS = {"mean", "reduce_sum", "reduce_mean", "batch_norm",
                  "accuracy", "auc", "shape"}
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


def _classify(sl, sg, n):
    if sl == sg:
        return "rep"
    if (isinstance(sl, tuple) and isinstance(sg, tuple) and len(sl) == len(sg)
            and len(sl) >= 1 and all(isinstance(d, int) for d in sl)
            and sl[1:] == sg[1:] and sg[0] == n * sl[0]):
        return "batch"
    return "other"


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
        self.specs: Dict[str, tuple] = {}    # name -> (dim, axis)
        self.local_state: set = set()
        self.global_shapes: Dict[str, tuple] = {}

    @property
    def explicit(self) -> bool:
        return self.cfg is not None

    # -- state ----------------------------------------------------------
    def prepare_state(self, program, scope):
        """The sharded state vars of `program` (memoized per program
        version): their (dim, axis), their global shapes, and which stay
        a slice inside the step (optimizer state)."""
        key = (program._uid, program._version)
        if key == self._specs_key:
            return
        from .compiler import program_var_buckets

        params, opt = program_var_buckets(program)
        specs, shapes = {}, {}
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
            if len(dims) > 1 or isinstance(dims[0][1], (tuple, list)):
                raise NotImplementedError(
                    f"state var {v.name!r} sharded over several axes "
                    f"{spec}: ROADMAP A step 10b")
            specs[v.name] = dims[0]
            shapes[v.name] = shape
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
        """A scope value as the step's env holds it: optimizer state as
        this rank's slice, other sharded state whole."""
        from torch.distributed.tensor import DTensor

        if name not in self.specs:
            return value.full_tensor() if isinstance(value, DTensor) \
                else value
        if isinstance(value, DTensor):
            local = value.to_local()
            return local if name in self.local_state \
                else self._gather(local, name)
        return self._slice(value, name) if name in self.local_state \
            else value

    def store_state(self, name, value):
        """An env value as the scope holds it: a sharded var as a
        DTensor of this rank's slice."""
        if name not in self.specs or not isinstance(value, torch.Tensor):
            return value
        from torch.distributed.tensor import DTensor, Replicate, Shard

        dim, axis = self.specs[name]
        local = value if name in self.local_state \
            else self._slice(value, name)
        shape = torch.Size(self.global_shapes[name])
        stride = torch.empty(shape, device="meta").stride()
        placements = [Shard(dim) if a == axis else Replicate()
                      for a in self.mesh.axis_names]
        return DTensor.from_local(local.contiguous(),
                                  self.mesh.device_mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)

    # -- feeds ----------------------------------------------------------
    def shard_feeds(self, feeds: Dict[str, torch.Tensor], accum: int):
        """This rank's feeds; sets `active` (some feed is sliced)."""
        self.accum = accum
        self.active = False
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

    def _meta_run(self, program, ops, env, feeds, rows):
        """The shapes `ops` read and write with every feed at `rows`
        rows, each op run through the executor's dispatch on "meta"
        tensors; an op of NO_META_OPS takes its outputs' declared
        shapes (-1 = the batch)."""
        from ..core.executor import _run_one_op
        from ..ops.common import to_torch_dtype

        menv = {k: _meta(v) for k, v in env.items()}
        for name in feeds:
            v = menv.get(name)
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                menv[name] = torch.empty((rows,) + tuple(v.shape[1:]),
                                         dtype=v.dtype, device="meta")
        block = program.global_block()
        meta = torch.device("meta")
        amp_lists = getattr(program, "_amp_lists", None)
        ins_shapes, outs_shapes = [], []
        for i, op in ops:
            d = op.desc
            ins_shapes.append({n: _shape_of(menv.get(n))
                               for n in d.input_names()})
            if d.type in NO_META_OPS:
                for n in d.output_names():
                    if block.has_var(n):
                        var = block.var(n)
                        menv[n] = torch.empty(
                            tuple(rows if s == -1 else s for s in var.shape),
                            dtype=to_torch_dtype(var.dtype), device=meta)
            else:
                _run_one_op(op, menv, None, i, program=program, device=meta,
                            amp_lists=amp_lists)
            outs_shapes.append({n: _shape_of(menv.get(n))
                                for n in d.output_names()})
        return ins_shapes, outs_shapes

    def _build_plan(self, program, ops, env, feed_names):
        sliced = {n for n in feed_names if n in env}
        loc = self._meta_run(program, ops, env, sliced, _META_ROWS)
        glo = self._meta_run(program, ops, env, sliced,
                             _META_ROWS * self.n)
        cls = {}
        for n in sliced:
            v = env[n]
            cls[n] = "batch" if isinstance(v, torch.Tensor) \
                and v.dim() >= 1 else "rep"
        reducing, drawing, other_in = set(), set(), set()
        for (i, op), il, ig, ol, og in zip(ops, loc[0], glo[0], loc[1],
                                          glo[1]):
            in_cls = [_classify(il[n], ig[n], self.n) for n in il]
            out_cls = {n: _classify(ol[n], og[n], self.n) for n in ol}
            cls.update(out_cls)
            batch_in = any(c != "rep" for c in in_cls)
            if "other" in in_cls:
                other_in.add(id(op.desc))
            if batch_in and any(c == "rep" and ol[n] is not None
                                for n, c in out_cls.items()):
                reducing.add(id(op.desc))
            if batch_in and op.desc.type in GLOBAL_DRAW_OPS:
                drawing.add(id(op.desc))
        return _Plan(cls, reducing, drawing, other_in)

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
            return self._gather(value, name)
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
    """A scope value's logical (global) tensor: a DTensor gathered whole
    (a collective: every rank of its mesh calls it), anything else as
    it is."""
    from torch.distributed.tensor import DTensor

    return value.full_tensor() if isinstance(value, DTensor) else value
